"""kernels.aggregate_roofline: the key-sum kernel's share of its roofline, in
percent: the least time of a call's key additions (work/aggregate.py: the
frozen operation counts at the card's peak rates, work/peak.py) over the
device time per call of the kernel g1_sum_kernel (csrc/g1_aggregate.cu) in
the traced stretch, its entries among the trace's device operations. Where
the trace holds no such kernel it is left out."""

from benchmark.work.aggregate import least_seconds

KERNEL = "g1_sum_kernel"


def read(run):
    if not run.trace or run.peak is None or not run.trace["calls"]:
        return None
    seconds = sum(s for name, s in run.trace["breakdown"]["device_ops"] if KERNEL in name)
    if not seconds:
        return None
    return 100.0 * least_seconds(run.cell, run.peak) / (seconds / run.trace["calls"])
