"""pairing.cyc_exp_span_ms: the five spans pairing.final_exp.cyc_exp (the hard
part's exponentiations by |x|, the cyc_exp kernel) of a timed call summed, in
device ms, the median over calls; read inside the captured call with spans on
(harness/spans_loop.py)."""

from benchmark.harness import spans_loop


def measure(run, system, args):
    return spans_loop.median_ms(spans_loop.result(run, system, args),
                                "pairing.final_exp.cyc_exp")
