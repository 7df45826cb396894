"""device.host_wait_share: the share (%) of the span loop's time, from the
first call's anchor to the last call's end, in which the device ran none of
the calls' device spans (bench.copy_in, capture.copy_in, capture.graph,
capture.clone_out, bench.read_back), on the host's clock with no profiler
running (harness/spans_loop.py host_wait). Gaps between the graph's own nodes
count as busy: events do not see inside the graph."""

from benchmark.harness import spans_loop


def measure(run, system, args):
    wait = spans_loop.host_wait(spans_loop.result(run, system, args))
    return None if wait is None else wait[0]
