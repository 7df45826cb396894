"""batch_p95_ms: the 95th percentile of all the window's call latencies, each
from the start of its copy-in to its verdicts on the host."""

import statistics


def read(run):
    lat = [(end - start) * 1e3 for start, end in run.calls]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
