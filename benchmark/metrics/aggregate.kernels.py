"""aggregate.kernels: the kernel nodes that the spans aggregate.keys and
aggregate.to_affine put into the captured call's graph, counted at capture
(harness/spans_loop.py). Where the port has no such span it is left out."""

from benchmark.harness import spans_loop


def measure(run, system, args):
    return spans_loop.kernel_nodes(spans_loop.result(run, system, args),
                                   ("aggregate.keys", "aggregate.to_affine"))
