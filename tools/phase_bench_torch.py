"""Per-phase timing of the port's limb-tier pairing on the card, the
counterpart of tools/phase_bench.py.

    python tools/phase_bench_torch.py [--batch 512 2048] [--strategy fused auto]
                                      [--reps 3] [--out F.json]

Each phase of models/pairing.py alone, at every batch under every strategy
of ops/fp.py set_strategy: prepare_g2, the scaling and stacking of the line
coefficients (scale+stack), the Miller steps (miller_steps and the closing
conjugate), final_exponentiation and pairing. For each: CUDA-event ms per
call eager (after a warm-up) and replayed from a CUDA graph
(utils/capture.py), the hand-written kernels' launches in one call, and one
profiled call (the card's events only: a limb call makes up to a quarter of
a million launches). The points are the generators, reused by every call;
the Miller steps and the final exponentiation take fresh random stored rows
for each timed call, as the JAX tool does.
"""

from __future__ import annotations

import numpy as np
import torch

import torch_tool_common as common
from plonky2_bls12_381_pairing_torch import constants as LC
from plonky2_bls12_381_pairing_torch.models import pairing as mp
from plonky2_bls12_381_pairing_torch.models.schedule import _DO_SQUARE
from plonky2_bls12_381_pairing_torch.ops import fp, fq12
from plonky2_bls12_381_pairing_torch.ops.curve import G1Affine, G2Affine

PHASES = ("prepare_g2", "scale+stack", "miller_steps", "final_exponentiation", "pairing")


def fq12_limb_rows(rng: np.random.Generator, batch: int, dev: torch.device) -> torch.Tensor:
    """(batch, 12, 48) stored rows: uniform digits with the top limb below
    p's, so every Fp is a residue below p."""
    rows = rng.integers(0, 256, (batch, 12, LC.NLIMBS), dtype=np.int32)
    rows[..., -1] = rng.integers(0, int(LC.P_LIMBS[-1]), (batch, 12), dtype=np.int32)
    return torch.from_numpy(rows).to(dev)


def scale_stack(p, q, coeffs):
    _, scaled = mp.scale_all_coeffs(p, coeffs, q.infinity)
    return mp.stack_steps(scaled)


def miller_only(f0, xs):
    return fq12.conjugate(mp.miller_steps(f0, xs, _DO_SQUARE))


def phases(batch: int, reps: int, dev: torch.device) -> dict:
    """phase name -> (fn, the arguments of each timed call)."""
    p = G1Affine.generator((batch,), dev)
    q = G2Affine.generator((batch,), dev)
    coeffs = mp.prepare_g2(q)
    xs = scale_stack(p, q, coeffs)
    rng = np.random.default_rng(1)
    f0s = [fq12_limb_rows(rng, batch, dev) for _ in range(reps)]
    fs = [fq12_limb_rows(rng, batch, dev) for _ in range(reps)]
    return {
        "prepare_g2": (mp.prepare_g2, [(q,)] * reps),
        "scale+stack": (scale_stack, [(p, q, coeffs)] * reps),
        "miller_steps": (miller_only, [(f0, xs) for f0 in f0s]),
        "final_exponentiation": (mp.final_exponentiation, [(f,) for f in fs]),
        "pairing": (mp.pairing, [(p, q)] * reps),
    }


def main(argv=None) -> int:
    ap = common.parser(__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[512, 2048], help="elements")
    ap.add_argument("--strategy", nargs="+", default=["fused", "auto"],
                    choices=fp.STRATEGIES)
    args = ap.parse_args(argv)
    opened = common.open_device(args.device)
    if opened is None:
        return 2
    dev, card = opened
    names = common.selected(args.phases, PHASES)
    runs = []
    prev = fp.get_strategy()
    try:
        for strategy in args.strategy:
            fp.set_strategy(strategy)
            for batch in args.batch:
                print(f"-- strategy {strategy!r}, B = {batch}", flush=True)
                table = phases(batch, args.reps, dev)
                results = {name: common.run_phase(dev, name, *table[name], host_ops=False)
                           for name in names}
                runs.append({"strategy": strategy, "batch": batch,
                             "phases": {name: results.get(name) for name in PHASES}})
    finally:
        fp.set_strategy(prev)
    common.write(args.out, {
        "tool": "phase_bench_torch", "card": card, "device": str(dev), "reps": args.reps,
        "clock": "cuda events" if dev.type == "cuda" else "host (cpu_ms)", "runs": runs})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
