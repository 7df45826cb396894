"""The inversion-free numerator/denominator Miller loop on the limb tier, the
counterpart of the JAX package's models/pairing_numden.py.

The Miller value is accumulated as a fraction f_num / f_den, the denominator
collecting the vertical-line factors that the flagship path (models/pairing.py)
elides by denominator elimination, with one field inversion at the end:

  per doubling:  f_num <- f_num^2 * l_{R,R}(P),   f_den <- f_den^2 * v_{2R}(P)
  per addition:  f_num <- f_num   * l_{R,Q}(P),   f_den <- f_den   * v_{R+Q}(P)
  f = f_num * f_den^{-1}

With the zkcrypto basis (Fq12 = Fq6[w]/(w^2 - v), untwist x~ = x * v), a
vertical evaluated at P is x_P * Z_R^2 - X_R * v (Jacobian, cleared
denominators), an element of Fq6: the denominator stays a (..., 6, NLIMBS)
Fq6 tensor, and the easy part of the final exponentiation kills it, so
final_exponentiation(f_num / f_den) == final_exponentiation(f_num).

The JAX package runs the 62 Miller iterations as one scan whose body computes
the addition on every iteration and keeps it by a select where the iteration
has none (_HAS_ADD). The select and the skipped addition give the same rows,
so here the loop over the 62 iterations runs the addition only where the
schedule has one: 5 ells and Fq6 products, not 62. The single fq6.inv at the
end is the one Fermat chain (mont_pow on a card).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import fp, fq2, fq6, fq12, lines
from ..ops.curve import G1Affine, G2Affine, G2Projective
from . import pairing as mp
from .schedule import _SEGMENTS

NUM_COEFFS = C.NUM_LINE_COEFFS  # 68


def prepare_g2_with_verticals(q: G2Affine) -> tuple[torch.Tensor, torch.Tensor]:
    """Like pairing.prepare_g2, with per-step vertical-line data: for each of
    the 68 steps, (Z'^2, X') of the point after the step. Returns the
    coefficients (..., 68, 3, 2, NLIMBS) and the verticals (..., 68, 2, 2,
    NLIMBS)."""
    batch = q.infinity.shape
    q = G2Affine.generator(batch, q.infinity.device).conditional_select(q.infinity, q)
    r = G2Projective.from_affine(q)
    coeffs, verts = [], []

    def push(r2, c0, c1, c2):
        coeffs.append(torch.stack([c0, c1, c2], dim=-3))
        verts.append(torch.stack([fq2.square(r2.z), r2.x], dim=-3))

    for n_dbl, has_add in _SEGMENTS:
        for _ in range(n_dbl):
            r, triple = lines.doubling_step(r)
            push(r, *triple)
        if has_add:
            r, triple = lines.addition_step(r, q)
            push(r, *triple)
    r, triple = lines.doubling_step(r)
    push(r, *triple)
    assert len(coeffs) == NUM_COEFFS
    return torch.stack(coeffs, dim=-4), torch.stack(verts, dim=-4)


def _scale_verticals(p: G1Affine, q_infinity: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Vertical factors as Fq6 elements (..., 68, 6, NLIMBS): x_P*Z^2 - X*v,
    with a multiply by one in place of an infinity term."""
    zsq = verts[..., 0, :, :]  # (..., 68, 2, L)
    xr = verts[..., 1, :, :]
    px = p.x[..., None, :].expand(zsq.shape[:-2] + (fp.NLIMBS,))
    c0 = fq2.scale_fp(zsq, px)
    c1 = fq2.neg(xr)
    v = fq6.pack(c0, c1, fq2.zero(c0.shape[:-2], c0.device))
    one = fq6.one((), v.device).expand(v.shape)
    skip = ((p.infinity != 0) | (q_infinity != 0))[..., None, None, None]
    return torch.where(skip, one, v)


def _step_tables():
    """Per Miller iteration (62): the index of its doubling triple, of its
    addition triple (the doubling's where it has none) and whether it has
    an addition."""
    dbl, add, has = [], [], []
    idx = 0
    for b in C.MILLER_BITS:
        dbl.append(idx)
        idx += 1
        if b:
            add.append(idx)
            has.append(1)
            idx += 1
        else:
            add.append(dbl[-1])
            has.append(0)
    assert idx == NUM_COEFFS - 1 and sum(has) == 5
    return np.array(dbl), np.array(add), np.array(has, dtype=np.int32)


_DBL_IDX, _ADD_IDX, _HAS_ADD = _step_tables()


def miller_loop_numden(ps, prepared, verticals, q_infinities=None) -> torch.Tensor:
    """The num/den Miller loop over T terms: f = f_num / f_den as a (...,
    12, NLIMBS) Fq12 tensor, with one inversion (of an Fq6 element)."""
    ps, scaled = mp.scale_all_coeffs(ps, prepared, q_infinities)
    if not isinstance(verticals, (list, tuple)):
        verticals = [verticals]
    if q_infinities is None or not isinstance(q_infinities, (list, tuple)):
        q_infinities = [q_infinities] * len(ps)
    verts = []
    for p, v, qinf in zip(ps, verticals, q_infinities):
        if qinf is None:
            qinf = torch.zeros_like(p.infinity)
        verts.append(_scale_verticals(p, qinf, v))

    batch = ps[0].infinity.shape
    dev = ps[0].infinity.device

    def lines_at(f_num, f_den, j):
        """Step j's line and vertical of every term, term by term."""
        for c, v in zip(scaled, verts):
            f_num = mp._ell(f_num, c[..., j, :, :, :])
            f_den = fq6.mul(f_den, v[..., j, :, :])
        return f_num, f_den

    f_num = fq12.one((), dev).expand(*batch, 12, fp.NLIMBS)
    f_den = fq6.one((), dev).expand(*batch, 6, fp.NLIMBS)
    for dbl, add, has_add in zip(_DBL_IDX.tolist(), _ADD_IDX.tolist(), _HAS_ADD.tolist()):
        f_num, f_den = lines_at(f_num, f_den, dbl)
        if has_add:
            f_num, f_den = lines_at(f_num, f_den, add)
        f_num, f_den = fq12.square(f_num), fq6.square(f_den)
    # the final doubling step, no square (as pairing.miller_loop's last step)
    f_num, f_den = lines_at(f_num, f_den, NUM_COEFFS - 1)

    den_inv = fq6.inv(f_den)  # the single inversion of the whole loop
    f = fq12.mul(f_num, fq12.pack(den_inv, fq6.zero(batch, dev)))
    if C.BLS_X_IS_NEGATIVE:
        f = fq12.conjugate(f)
    return f


def optimized_pairing(p: G1Affine, q: G2Affine) -> torch.Tensor:
    """e(P, Q) through the num/den Miller loop and the final exponentiation
    (the zkcrypto chain, as pairing.pairing)."""
    coeffs, verts = prepare_g2_with_verticals(q)
    f = miller_loop_numden(p, coeffs, verts, q.infinity)
    return mp.final_exponentiation(f)
