"""Per-phase timing of the port's RNS pairing on the card, the counterpart
of tools/rns_phase_bench.py.

    python tools/rns_phase_bench_torch.py [--batch 2048] [--reps 3] [--out F.json]

Each phase is timed alone at the pipeline's scale (B elements, B/2 packed
rows): prepare_g2_stepmajor, miller_loop (the split form that multi_pairing
runs), miller_loop_fused (pairing's fused prepare and Miller loop), fp.inv on
one Fq12 slot, the easy part tower.mul(tower.conjugate(f), tower.inv(f)),
final_exponentiation, pairing, and pairing_check with 2, 65 and 130 terms
(true: [P, ..., P, -(T-1) P] x [Q, ..., Q]; each call one prepare_g2_lines
and one miller_run launch). For each: CUDA-event ms per call eager
(after a warm-up) and replayed from a CUDA graph (utils/capture.py), the
hand-written kernels' launches in one call, and one profiled call (its kernel
time and count, and how much of it is the hand-written kernels).

The points are the generators; the pure phases take representative stored
Fq12 rows (a pool of encoded random values tiled over the batch: random lane
words would not be reduced residues), fresh rows for each timed call.
"""

from __future__ import annotations

import random

import numpy as np
import torch

import torch_tool_common as common
from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.ops.rns import fp, tower
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm

PHASES = ("prepare_g2_stepmajor", "miller_loop", "miller_loop_fused", "fp.inv",
          "easy_part", "final_exponentiation", "pairing", "pairing_check_2",
          "pairing_check_65", "pairing_check_130")
#: packed rows of encoded values tiled over the batch
POOL = 32


def fq12_rows(seed: int, rows: int, dev: torch.device) -> torch.Tensor:
    """(rows, 12, LANES): a pool of encoded random Fq12 values, tiled."""
    r = random.Random(seed)
    pool = min(POOL, rows)
    enc = tower.encode([rm.rand_fq12(r) for _ in range(RC.PACK * pool)])  # (pool, 12, LANES)
    return torch.from_numpy(np.tile(enc, (-(-rows // pool), 1, 1))[:rows]).to(dev)


def easy_part(f: torch.Tensor) -> torch.Tensor:
    return tower.mul(tower.conjugate(f), tower.inv(f))


def check_terms(n_terms: int, p: G1Affine, q: G2Affine, batch: int) -> tuple[list, list]:
    """pairing_check's n_terms terms, true: P n_terms - 1 times, then
    -(n_terms - 1) P, each against Q (P, Q the generators)."""
    last = G1Affine.encode([rm.G1Affine.generator().mul(n_terms - 1).neg()] * batch,
                           device=p.y.device)
    return [p] * (n_terms - 1) + [last], [q] * n_terms


def main(argv=None) -> int:
    ap = common.parser(__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2048, help="elements (two per packed row)")
    args = ap.parse_args(argv)
    opened = common.open_device(args.device)
    if opened is None:
        return 2
    dev, card = opened
    names = common.selected(args.phases, PHASES)
    rows = -(-args.batch // RC.PACK)
    p = G1Affine.generator((args.batch,), dev)
    q = G2Affine.generator((args.batch,), dev)
    coeffs = mpr.prepare_g2_stepmajor(q)
    fs = [fq12_rows(seed, rows, dev) for seed in range(args.reps)]
    points = [(p, q)] * args.reps
    phases = {
        "prepare_g2_stepmajor": (mpr.prepare_g2_stepmajor, [(q,)] * args.reps),
        "miller_loop": (lambda c, p, q: mpr.miller_loop(p, c, q.infinity),
                        [(coeffs, p, q)] * args.reps),
        "miller_loop_fused": (mpr.miller_loop_fused, points),
        "fp.inv": (fp.inv, [(f[:, 0, :].contiguous(),) for f in fs]),
        "easy_part": (easy_part, [(f,) for f in fs]),
        "final_exponentiation": (mpr.final_exponentiation, [(f,) for f in fs]),
        "pairing": (mpr.pairing, points),
        **{f"pairing_check_{n}": (mpr.pairing_check, [check_terms(n, p, q, args.batch)]
                                  * args.reps)
           for n in (2, 65, 130) if f"pairing_check_{n}" in names},
    }
    results = {name: common.run_phase(dev, name, *phases[name]) for name in names}
    common.write(args.out, {
        "tool": "rns_phase_bench_torch", "card": card, "device": str(dev),
        "batch_elements": args.batch, "rows": rows, "reps": args.reps,
        "clock": "cuda events" if dev.type == "cuda" else "host (cpu_ms)",
        "phases": {name: results.get(name) for name in PHASES}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
