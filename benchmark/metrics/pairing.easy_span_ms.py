"""pairing.easy_span_ms: the median over the timed calls of the device ms of
the span pairing.final_exp.easy (final_exponentiation up to its cyclotomic
t2), read inside the captured call with spans on (harness/spans_loop.py)."""

from benchmark.harness import spans_loop


def measure(run, system, args):
    return spans_loop.median_ms(spans_loop.result(run, system, args),
                                "pairing.final_exp.easy")
