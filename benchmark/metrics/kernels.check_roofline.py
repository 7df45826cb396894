"""kernels.check_roofline: the least time of a call's checks (work/model.py:
the frozen operation counts at the card's peak rates, work/peak.py) over the
device's kernel time per call in the traced stretch, in percent."""

from benchmark.work.model import least_seconds


def read(run):
    if not run.trace or not run.trace["kernel_s"] or run.peak is None:
        return None
    per_call = run.trace["kernel_s"] / run.trace["calls"]
    terms = int(run.cell.config["terms_per_check"])
    return 100.0 * least_seconds(run.batch, terms, run.peak) / per_call
