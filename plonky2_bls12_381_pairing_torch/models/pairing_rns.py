"""Batched BLS12-381 optimal-ate pairing on the RNS arithmetic tier (the JAX
package's models/pairing_rns.py, main path): the fused prepare+Miller loop,
then the final exponentiation whose five exponentiations by |BLS_X| run the
whole-exponent Granger-Scott kernel and whose one Fq12 inverse ends in the
Fermat-pow kernel (ops/rns/kernels.py).

Stored rows are bit-identical to the JAX package's for the same inputs where
the algorithm is the same (the Miller loop, the Granger-Scott exponentiation).
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..ops.rns import fp, kernels, tower
from ..ops.rns.lines import (G1Affine, G2Affine, G2Projective, addition_step,
                             doubling_step)
from .schedule import _FUSED_RUNS, _FUSED_TAIL, _GS_SEGMENTS


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------


def miller_loop_fused(p: G1Affine, q: G2Affine) -> torch.Tensor:
    """Single-term Miller loop with the G2 preparation fused into the
    accumulation: (R, f) run through the 68-step schedule together, so each
    line's coefficients are consumed the step they are produced. The ell
    coefficient scaling rides the line steps' last stacked REDC (scale=...).
    Infinity inputs are replaced by the generator for the line arithmetic and
    leave f unchanged (identity-select)."""
    qs = G2Affine.generator_like(q).conditional_select(q.infinity, q)
    r = G2Projective.from_affine(qs)
    py = fp.wrap(p.y[..., None, :])
    px = fp.wrap(p.x[..., None, :])
    skip = ((p.infinity != 0) | (q.infinity != 0))[..., None, :]
    rows = p.infinity.shape[:-1]
    f = tower.one(rows, p.y.device)

    def ell_pre(f, sc0, sc1, c2):
        """mul_by_014 with pre-scaled coefficients + the identity-select for
        infinity terms."""
        return torch.where(skip, f, tower.mul_by_014(f, c2, sc1, sc0))

    def uniform(r, f):
        r2, (sc0, sc1, c2) = doubling_step(r, scale=(py, px))
        return r2, tower.square(ell_pre(f, sc0, sc1, c2))

    for n in _FUSED_RUNS:
        for _ in range(n):
            r, f = uniform(r, f)
        r, (sc0, sc1, c2) = doubling_step(r, scale=(py, px))
        f = ell_pre(f, sc0, sc1, c2)
        r, (sc0, sc1, c2) = addition_step(r, qs, scale=(py, px))
        f = tower.square(ell_pre(f, sc0, sc1, c2))
    for _ in range(_FUSED_TAIL):
        r, f = uniform(r, f)
    r, (sc0, sc1, c2) = doubling_step(r, scale=(py, px))
    f = ell_pre(f, sc0, sc1, c2)
    if C.BLS_X_IS_NEGATIVE:
        f = tower.conjugate(f)
    return f


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def cyclotomic_exp(f: torch.Tensor) -> torch.Tensor:
    """conj(f^|x|) = f^BLS_X (x < 0) for cyclotomic f: one whole-exponent
    Granger-Scott square-and-multiply (kernels.cyc_exp)."""
    return tower.conjugate(kernels.cyc_exp(f, _GS_SEGMENTS))


#: The hard part's five exponentiations as uniform steps y = exp(a * b * c)
#: (the JAX package's _EXP_STEPS). Flag columns: a_is_t2, a_is_t1pre (else
#: a = previous y), bc_t3_count (how many of b/c are t3, the rest are one).
_EXP_STEPS = (
    (1, 0, 0),  # t3 = exp(t2)
    (0, 1, 1),  # t1 = exp(t1pre * t3);     x -> t5
    (0, 0, 0),  # t0 = exp(t1)
    (0, 0, 0),  # t6 = exp(t0)
    (0, 0, 2),  # t4 = exp(t6 * t3 * t3);   x -> t6m
)


def final_exponentiation(f: torch.Tensor) -> torch.Tensor:
    """Easy part + the zkcrypto hard-part chain (f^(3*(p^12-1)/r)).

    The step loop keeps the JAX package's multiplies by one: each is a REDC
    that changes the stored representative, and keeping them keeps the rows
    identical."""
    t0 = tower.conjugate(f)
    t1 = tower.inv(f)
    t2 = tower.mul(t0, t1)
    t1 = t2
    t2 = tower.frobenius_pow(t2, 2)
    t2 = tower.mul(t2, t1)  # easy part done; t2 is cyclotomic

    t1pre = tower.conjugate(tower.cyclotomic_square(t2))
    one_b = tower.one(t2.shape[:-2], t2.device)

    y, t3 = one_b, one_b
    xs, ys = [], []
    for a_is_t2, a_is_t1pre, bc_t3 in _EXP_STEPS:
        a = t2 if a_is_t2 else (t1pre if a_is_t1pre else y)
        b = t3 if bc_t3 >= 1 else one_b
        c = t3 if bc_t3 >= 2 else one_b
        x = tower.mul(tower.mul(a, b), c)
        y = cyclotomic_exp(x)
        if a_is_t2:  # t3 is the first step's output
            t3 = y
        xs.append(x)
        ys.append(y)
    t5, t6m = xs[1], xs[4]
    t1, t0, t4 = ys[1], ys[2], ys[4]

    # tail of the chain: four independent muls in one stacked call —
    #   A = conj(t5)*t2 (feeds t4), B = t1*t2 (-> frob^3),
    #   C = t6m*conj(t2) (-> frob^1), D = t3*t0 (-> frob^2)
    # — then the frobenius powers as a peeling stack ([B,C,D] -> [B,D] -> [B])
    m = tower.mul(torch.stack([tower.conjugate(t5), t1, t6m, t3]),
                  torch.stack([t2, t2, tower.conjugate(t2), t0]))
    t4 = tower.mul(t4, m[0])
    s1 = tower.frobenius_map(m[1:])          # [B, C, D] ^p
    t6 = s1[1]
    s2 = tower.frobenius_map(s1[[0, 2]])     # [B, D] ^p^2
    t3 = s2[1]
    t1 = tower.frobenius_map(s2[0])          # B ^p^3
    t3 = tower.mul(t3, t1)
    t3 = tower.mul(t3, t6)
    return tower.mul(t3, t4)


# ---------------------------------------------------------------------------
# Top-level API
# ---------------------------------------------------------------------------


def pairing(p: G1Affine, q: G2Affine) -> torch.Tensor:
    """Batched full pairing e(P, Q) -> (rows, 12, LANES) Gt elements, on the
    device the points lie on (G1Affine.encode / G2Affine.encode choose it)."""
    return final_exponentiation(miller_loop_fused(p, q))
