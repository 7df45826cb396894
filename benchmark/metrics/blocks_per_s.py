"""blocks_per_s: every block verified in the window (one check a block) over
the window's seconds."""


def read(run):
    return len(run.calls) * run.batch / (run.window[1] - run.window[0])
