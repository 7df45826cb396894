"""aggregate.keys_span_ms: the median over the timed calls of the device ms of
the span aggregate.keys (models/aggregate.py: the sets' words and offsets and
the key sums, csrc/g1_aggregate.cu), read inside the captured call with spans
on (harness/spans_loop.py). Where the port has no such span it is left out."""

from benchmark.harness import spans_loop


def measure(run, system, args):
    return spans_loop.median_ms(spans_loop.result(run, system, args), "aggregate.keys")
