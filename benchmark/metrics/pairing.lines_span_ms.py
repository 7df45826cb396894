"""pairing.lines_span_ms: the median over the timed calls of the device ms of
the span pairing.prepare_g2 (prepare_g2_stepmajor in multi_pairing: the line
steps), read inside the captured call with spans on (harness/spans_loop.py)."""

from benchmark.harness import spans_loop


def measure(run, system, args):
    return spans_loop.median_ms(spans_loop.result(run, system, args), "pairing.prepare_g2")
