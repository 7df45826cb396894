"""Slope test of the port's limb Fq12 ops under "fused", the counterpart of
tools/slope_bench.py: the cost of N chained ops in one CUDA graph.

    python tools/slope_bench_torch.py [--batch 512 2048] [--reps 3] [--out F.json]

For each batch and each of fq12.square and fq12.cyclotomic_square, a chain
of N = 8 and of N = 40 dependent calls is captured once into a CUDA graph
(utils/capture.py; the counterpart of the JAX tool's one jax.jit of a
lax.scan) and replayed; CUDA events time each replay (copy-in, the chain and
the output's clone). The slope (t40 - t8) / 32 is one op's cost inside the
graph, the intercept t8 - 8 * slope a replay's own.
"""

from __future__ import annotations

import numpy as np
import torch

import torch_tool_common as common
from plonky2_bls12_381_pairing_torch.ops import fp, fq12
from phase_bench_torch import fq12_limb_rows

OPS = {"square": fq12.square, "cyclotomic_square": fq12.cyclotomic_square}
LENGTHS = (8, 40)
PHASES = tuple(OPS)


def chain(op, n: int):
    def fn(a):
        for _ in range(n):
            a = op(a)
        return a
    return fn


def chain_ms(dev: torch.device, op, n: int, a: torch.Tensor, reps: int) -> float:
    """Median ms of a replay of the n-op chain on the card; on the CPU of an
    eager call, by the host clock."""
    fn = chain(op, n)
    if dev.type == "cuda":
        times, _ = common.captured_ms(fn, [(a,)] * reps)
    else:
        fn(a)
        times = common.call_ms(dev, fn, [(a,)] * reps)
    return float(np.median(times))


def main(argv=None) -> int:
    ap = common.parser(__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[512, 2048], help="elements")
    args = ap.parse_args(argv)
    opened = common.open_device(args.device)
    if opened is None:
        return 2
    dev, card = opened
    names = common.selected(args.phases, PHASES)
    key = "captured_ms" if dev.type == "cuda" else "cpu_ms"
    rng = np.random.default_rng(0)
    runs = []
    prev = fp.get_strategy()
    fp.set_strategy("fused")
    try:
        for batch in args.batch:
            a = fq12_limb_rows(rng, batch, dev)
            for name in names:
                op = OPS[name]
                t8, t40 = (chain_ms(dev, op, n, a, args.reps) for n in LENGTHS)
                per = (t40 - t8) / (LENGTHS[1] - LENGTHS[0])
                rec = {"batch": batch, "op": name, key: {"t8": t8, "t40": t40},
                       "per_op_ms": per, "intercept_ms": t8 - LENGTHS[0] * per,
                       "per_element_ns": per / batch * 1e6,
                       "launches_per_op": sum(common.launches(op, (a,)).values())}
                runs.append(rec)
                print(f"B={batch:5d} {name:17s} t8={t8:8.3f} ms t40={t40:8.3f} ms "
                      f"per-op={per:7.4f} ms intercept={rec['intercept_ms']:7.3f} ms "
                      f"per-elem={rec['per_element_ns']:7.1f} ns ({key})", flush=True)
    finally:
        fp.set_strategy(prev)
    common.write(args.out, {
        "tool": "slope_bench_torch", "card": card, "device": str(dev), "reps": args.reps,
        "strategy": "fused", "clock": "cuda events" if dev.type == "cuda" else "host (cpu_ms)",
        "phases": list(PHASES), "runs": runs})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
