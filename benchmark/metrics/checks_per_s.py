"""checks_per_s: every verdict of the window over the window's seconds."""


def read(run):
    return len(run.calls) * run.batch / (run.window[1] - run.window[0])
