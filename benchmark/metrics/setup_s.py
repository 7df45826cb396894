"""setup_s: process start to the first timed call (imports, kernel build or
load, inputs, encoding, capture, one call of every batch)."""


def read(run):
    return run.setup_s
