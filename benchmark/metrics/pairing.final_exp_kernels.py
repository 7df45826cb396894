"""pairing.final_exp_kernels: the kernel nodes that the spans
pairing.final_exp.easy and pairing.final_exp.hard put into the captured
call's graph, counted at capture (harness/spans_loop.py)."""

from benchmark.harness import spans_loop


def measure(run, system, args):
    return spans_loop.kernel_nodes(spans_loop.result(run, system, args),
                                   ("pairing.final_exp.easy", "pairing.final_exp.hard"))
