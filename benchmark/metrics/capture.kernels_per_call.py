"""capture.kernels_per_call: kernels the device ran per call in the traced
stretch of replays."""


def read(run):
    if not run.trace or not run.trace["calls"]:
        return None
    return run.trace["kernels"] / run.trace["calls"]
