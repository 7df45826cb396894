"""G2 line-evaluation steps and point containers on RNS channels (the JAX
package's ops/rns/lines.py).

Algorithms 26/27 of eprint 2010/354 (point doubling/mixed addition with the
tangent/chord line), staged on the RNS core: all products within a stage
share one stacked REDC; linear pieces ride the bound-tracked R accumulator;
bare stored values entering a product-domain sum are lifted with fp.to_prod.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import rns_constants as RC
from ...utils import refmodel as rm
from . import fp
from .tower import _pair_scale, _pair_sub, fq2_mul_r

R = fp.R
LANES = fp.LANES


# ---------------------------------------------------------------------------
# Point containers (packed RNS payloads)
# ---------------------------------------------------------------------------


def _pad_inf(inf: np.ndarray) -> np.ndarray:
    """Mark odd-batch padding slots as infinity so the duplicated tail
    element pairs to the identity."""
    if inf.ndim and inf.shape[0] % RC.PACK:
        inf = np.concatenate(
            [inf, np.ones((1,) + inf.shape[1:], dtype=inf.dtype)], axis=0)
    return inf


def _t(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _rows(batch_shape) -> tuple:
    """Element batch shape -> packed row shape (axis 0 halved)."""
    if not batch_shape:
        return ()
    return (-(-batch_shape[0] // RC.PACK),) + tuple(batch_shape[1:])


def _slot_any(t: torch.Tensor) -> torch.Tensor:
    """Packed lane mask (..., LANES) -> per-element bools (..., PACK)."""
    return (t.reshape(*t.shape[:-1], RC.PACK, RC.SUB) != 0).any(dim=-1)


def _points_equal(a, b, coords: torch.Tensor) -> torch.Tensor:
    """Per packed element (..., PACK): both points at infinity, or neither
    and their coordinates equal (coords)."""
    ai, bi = _slot_any(a.infinity), _slot_any(b.infinity)
    return (ai & bi) | (~ai & ~bi & coords)


def _filled(tag, np_val, rows: tuple, tail: tuple, device) -> torch.Tensor:
    """A constant (cached per device) broadcast to (*rows, *tail), as a new
    contiguous tensor: the kernels take these operands as dense rows."""
    return fp.const_on(tag, device, np_val).expand(*rows, *tail).clone()


def _fq2_encode(x: rm.Fq2) -> np.ndarray:
    return np.stack([fp.encode(x.c0), fp.encode(x.c1)])


_ONE2 = np.zeros((2, LANES), dtype=np.int32)
_ONE2[0] = RC.ONE


@dataclass
class G1Affine:
    """x, y: (rows..., LANES) packed residues; infinity: (rows..., LANES)
    int32 lane mask (each packed element's mask broadcast over its slot)."""

    x: torch.Tensor
    y: torch.Tensor
    infinity: torch.Tensor

    @staticmethod
    def generator(batch_shape=(), device=None) -> "G1Affine":
        """The generator at every element of `batch_shape` (packed two to a
        row), on the card unless `device` names another."""
        dev = fp.resolve_device(device)
        g = rm.G1Affine.generator()
        rows = _rows(batch_shape)
        return G1Affine(_filled(("g1_gen_x",), fp.encode(g.x), rows, (LANES,), dev),
                        _filled(("g1_gen_y",), fp.encode(g.y), rows, (LANES,), dev),
                        torch.zeros((*rows, LANES), dtype=torch.int32, device=dev))

    @staticmethod
    def identity(batch_shape=(), device=None) -> "G1Affine":
        """The point at infinity, (0, 1) with the infinity mask set."""
        dev = fp.resolve_device(device)
        rows = _rows(batch_shape)
        return G1Affine(torch.zeros((*rows, LANES), dtype=torch.int32, device=dev),
                        _filled(("one",), None, rows, (LANES,), dev),
                        torch.ones((*rows, LANES), dtype=torch.int32, device=dev))

    def conditional_select(self, mask, other: "G1Affine") -> "G1Affine":
        """mask: packed lane mask (rows..., LANES); != 0 selects self."""
        m = mask != 0
        return G1Affine(torch.where(m, self.x, other.x), torch.where(m, self.y, other.y),
                        torch.where(m, self.infinity, other.infinity))

    def is_point_equal_to(self, other: "G1Affine") -> torch.Tensor:
        """Equality with infinity handled, per packed element (..., PACK)."""
        return _points_equal(self, other,
                             fp.is_equal(self.x, other.x) & fp.is_equal(self.y, other.y))

    @staticmethod
    def encode(points, device=None) -> "G1Affine":
        dev = fp.resolve_device(device)
        arr = np.asarray(points, dtype=object)
        xs = np.empty(arr.shape, dtype=object)
        ys = np.empty(arr.shape, dtype=object)
        inf = np.zeros(arr.shape, dtype=np.int32)
        for idx in np.ndindex(arr.shape):
            p = arr[idx]
            xs[idx], ys[idx], inf[idx] = p.x, p.y, int(p.infinity)
        return G1Affine(_t(fp.encode(xs), dev), _t(fp.encode(ys), dev),
                        _t(fp.pack_mask(_pad_inf(inf)), dev))


@dataclass
class G2Affine:
    x: torch.Tensor  # (..., 2, LANES)
    y: torch.Tensor
    infinity: torch.Tensor

    @staticmethod
    def generator(batch_shape=(), device=None) -> "G2Affine":
        """The generator at every element of `batch_shape` (packed two to a
        row), on the card unless `device` names another."""
        dev = fp.resolve_device(device)
        g = rm.G2Affine.generator()
        rows = _rows(batch_shape)
        return G2Affine(_filled(("g2_gen_x",), _fq2_encode(g.x), rows, (2, LANES), dev),
                        _filled(("g2_gen_y",), _fq2_encode(g.y), rows, (2, LANES), dev),
                        torch.zeros((*rows, LANES), dtype=torch.int32, device=dev))

    @staticmethod
    def identity(batch_shape=(), device=None) -> "G2Affine":
        """The point at infinity, (0, 1) with the infinity mask set."""
        dev = fp.resolve_device(device)
        rows = _rows(batch_shape)
        return G2Affine(torch.zeros((*rows, 2, LANES), dtype=torch.int32, device=dev),
                        _filled(("one2",), _ONE2, rows, (2, LANES), dev),
                        torch.ones((*rows, LANES), dtype=torch.int32, device=dev))

    def is_point_equal_to(self, other: "G2Affine") -> torch.Tensor:
        """Equality with infinity handled, per packed element (..., PACK)."""
        return _points_equal(self, other, fp.is_equal(self.x, other.x).all(dim=-2)
                             & fp.is_equal(self.y, other.y).all(dim=-2))

    @staticmethod
    def encode(points, device=None) -> "G2Affine":
        dev = fp.resolve_device(device)
        arr = np.asarray(points, dtype=object)
        xs = np.empty(arr.shape + (2,), dtype=object)
        ys = np.empty(arr.shape + (2,), dtype=object)
        inf = np.zeros(arr.shape, dtype=np.int32)
        for idx in np.ndindex(arr.shape):
            p = arr[idx]
            xs[idx + (0,)], xs[idx + (1,)] = p.x.c0, p.x.c1
            ys[idx + (0,)], ys[idx + (1,)] = p.y.c0, p.y.c1
            inf[idx] = int(p.infinity)
        # fp.encode packs axis 0 and keeps the trailing (2,) component axis
        return G2Affine(_t(fp.encode(xs), dev), _t(fp.encode(ys), dev),
                        _t(fp.pack_mask(_pad_inf(inf)), dev))

    @staticmethod
    def generator_like(q: "G2Affine") -> "G2Affine":
        """Generator broadcast to q's (row-level) shapes, infinity false."""
        g = rm.G2Affine.generator()
        dev = q.x.device
        return G2Affine(
            fp.const_on(("g2_gen_x",), dev, _fq2_encode(g.x)).expand(q.x.shape),
            fp.const_on(("g2_gen_y",), dev, _fq2_encode(g.y)).expand(q.y.shape),
            torch.zeros_like(q.infinity))

    def conditional_select(self, mask, other: "G2Affine") -> "G2Affine":
        """mask: packed lane mask (rows..., LANES)."""
        m = mask[..., None, :] != 0
        return G2Affine(torch.where(m, self.x, other.x),
                        torch.where(m, self.y, other.y),
                        torch.where(mask != 0, self.infinity, other.infinity))


@dataclass
class G2Projective:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_affine(q: G2Affine) -> "G2Projective":
        one2 = fp.const_on(("one2",), q.x.device, _ONE2).expand(q.x.shape)
        z = torch.where(q.infinity[..., None, :] != 0, torch.zeros_like(q.x), one2)
        return G2Projective(q.x, q.y, z)

    @staticmethod
    def identity(batch_shape=(), device=None) -> "G2Projective":
        """The point at infinity, (0, 1, 0)."""
        dev = fp.resolve_device(device)
        rows = _rows(batch_shape)
        zero2 = torch.zeros((*rows, 2, LANES), dtype=torch.int32, device=dev)
        return G2Projective(zero2, _filled(("one2",), _ONE2, rows, (2, LANES), dev),
                            zero2.clone())

    @staticmethod
    def generator(batch_shape=(), device=None) -> "G2Projective":
        """The generator with z = 1."""
        return G2Projective.from_affine(G2Affine.generator(batch_shape, device))


# ---------------------------------------------------------------------------
# Step helpers
# ---------------------------------------------------------------------------


def _wpair(t: torch.Tensor) -> tuple[R, R]:
    return fp.wrap(t[..., 0, :]), fp.wrap(t[..., 1, :])


def _ppair(t: torch.Tensor) -> tuple[R, R]:
    return fp.to_prod(t[..., 0, :]), fp.to_prod(t[..., 1, :])


def _sq(p: tuple[R, R]) -> tuple[R, R]:
    return fq2_mul_r(p[0], p[1], p[0], p[1])


def _slice2(s: torch.Tensor, i: int) -> torch.Tensor:
    return s[..., 2 * i : 2 * i + 2, :]


def scale_terms(c0: torch.Tensor, c1: torch.Tensor, py: R, px: R) -> list[R]:
    """The ell coefficient scaling before its REDC: c0*P.y and c1*P.x, two
    (..., 2, LANES) products (py, px: R wraps of the G1 coordinates,
    (..., 1, LANES))."""
    return [fp.mul_rr(fp.wrap(c0), py), fp.mul_rr(fp.wrap(c1), px)]


def doubling_step(r: G2Projective, scale: tuple | None = None
                  ) -> tuple[G2Projective, tuple]:
    """Point doubling + tangent line (three stacked REDCs). Returns
    (2R, (c0, c1, c2)).

    With scale=(py, px) (R wraps of the G1 coordinates, (..., 1, LANES)), the
    ell coefficient scaling (c0*P.y, c1*P.x) rides the stage-3 REDC instead
    of a separate pass, and the return is (2R, (sc0, sc1, c2)) with
    sc0 = c0*py, sc1 = c1*px stored."""
    x, y, z = _wpair(r.x), _wpair(r.y), _wpair(r.z)

    # stage 1: input squares (one stacked REDC: 4 Fq2 = 8 rows)
    tmp0_w = _sq(x)                      # x^2
    tmp1_w = _sq(y)                      # y^2
    zsq_w = _sq(z)                       # z^2
    zy2_w = _sq((z[0] + y[0], z[1] + y[1]))
    zout_w = _pair_sub(_pair_sub(zy2_w, tmp1_w), zsq_w)
    s1 = fp.redc_stack([tmp0_w[0], tmp0_w[1], tmp1_w[0], tmp1_w[1],
                        zsq_w[0], zsq_w[1], zout_w[0], zout_w[1]])
    tmp0s, tmp1s = _slice2(s1, 0), _slice2(s1, 1)
    zsqs, zouts = _slice2(s1, 2), _slice2(s1, 3)

    tmp1 = _wpair(tmp1s)
    zsq = _wpair(zsqs)
    # tmp4 = 3*x^2 as a canonical multiply operand
    tmp4 = tuple(fp.wrap(tmp0s[..., i, :]).scale(3).canon() for i in range(2))
    tmp6 = tuple((fp.wrap(tmp0s[..., i, :]).scale(3) + x[i]).canon() for i in range(2))

    # stage 2: products + wide linear combinations (one stacked REDC: 10 rows)
    tmp2_w = _sq(tmp1)                   # y^4
    t13_w = _sq((tmp1[0] + x[0], tmp1[1] + x[1]))
    tmp5_w = _sq(tmp4)
    t66_w = _sq(tmp6)
    t4z_w = fq2_mul_r(tmp4[0], tmp4[1], zsq[0], zsq[1])
    tzz_w = fq2_mul_r(*_wpair(zouts), zsq[0], zsq[1])

    tmp3_w = _pair_scale(_pair_sub(_pair_sub(t13_w, tmp0_w), tmp2_w), 2)
    xout_w = _pair_sub(tmp5_w, _pair_scale(tmp3_w, 2))
    c1_w = _pair_sub((tmp5_w[0].scale(0), tmp5_w[1].scale(0)),
                     _pair_scale(t4z_w, 2))          # -2 * tmp4 * z^2
    c2_w = _pair_sub(_pair_sub(_pair_sub(t66_w, tmp0_w), tmp5_w),
                     _pair_scale(tmp1_w, 4))         # tmp6^2 - x^2 - tmp5 - 4 y^2
    c0_w = _pair_scale(tzz_w, 2)                     # 2 * z_out * z^2
    s2 = fp.redc_stack([xout_w[0], xout_w[1], tmp3_w[0], tmp3_w[1],
                        c0_w[0], c0_w[1], c1_w[0], c1_w[1], c2_w[0], c2_w[1]])
    xouts, tmp3s = _slice2(s2, 0), _slice2(s2, 1)
    c0, c1, c2 = _slice2(s2, 2), _slice2(s2, 3), _slice2(s2, 4)

    # stage 3: y_out = (tmp3 - x_out) * tmp4 - 8 y^4 (one REDC: 2 rows);
    # scaled mode adds the 4 ell-scaling rows c0*py, c1*px to the same REDC
    d = tuple((fp.wrap(tmp3s[..., i, :]) - fp.wrap(xouts[..., i, :])).canon()
              for i in range(2))
    prod_w = fq2_mul_r(d[0], d[1], tmp4[0], tmp4[1])
    yout_w = _pair_sub(prod_w, _pair_scale(tmp2_w, 8))
    if scale is None:
        youts = fp.redc_stack([yout_w[0], yout_w[1]])
        return G2Projective(xouts, youts, zouts), (c0, c1, c2)
    s3 = fp.redc_cat([fp.row1(yout_w[0]), fp.row1(yout_w[1]),
                      *scale_terms(c0, c1, *scale)])
    youts, sc0, sc1 = s3[..., 0:2, :], s3[..., 2:4, :], s3[..., 4:6, :]
    return G2Projective(xouts, youts, zouts), (sc0, sc1, c2)


def addition_step(r: G2Projective, q: G2Affine, scale: tuple | None = None
                  ) -> tuple[G2Projective, tuple]:
    """Mixed addition + chord line (Algorithm 27, restaged for the RNS
    product domain).

    With scale=(py, px), c0/c1 move up into the stage-D REDC and the ell
    scaling rides the stage-E REDC; returns (R', (sc0, sc1, c2)) like
    doubling_step."""
    z, qx, qy = _wpair(r.z), _wpair(q.x), _wpair(q.y)
    rx, ry = _wpair(r.x), _wpair(r.y)

    # stage A: zsq = z^2, ysq = qy^2, u = (qy+z)^2 - ysq - zsq
    zsq_w = _sq(z)
    ysq_w = _sq(qy)
    u_w = _pair_sub(_pair_sub(_sq((qy[0] + z[0], qy[1] + z[1])), ysq_w), zsq_w)
    sA = fp.redc_stack([zsq_w[0], zsq_w[1], ysq_w[0], ysq_w[1], u_w[0], u_w[1]])
    zsqs, ysqs, us = _slice2(sA, 0), _slice2(sA, 1), _slice2(sA, 2)

    # stage B: t0 = zsq*qx, t1 = u*zsq
    zsq = _wpair(zsqs)
    t0_w = fq2_mul_r(zsq[0], zsq[1], qx[0], qx[1])
    t1_w = fq2_mul_r(*_wpair(us), zsq[0], zsq[1])
    sB = fp.redc_stack([t0_w[0], t0_w[1], t1_w[0], t1_w[1]])
    t0s, t1s = _slice2(sB, 0), _slice2(sB, 1)

    # stage C: t3 = t2^2, t6sq = t6^2 (kept wide), t9 = t6*qx, zout
    t2 = tuple((fp.wrap(t0s[..., i, :]) - rx[i]).canon() for i in range(2))
    t6 = tuple((fp.wrap(t1s[..., i, :]) - ry[i].scale(2)).canon() for i in range(2))
    t3_w = _sq(t2)
    t6sq_w = _sq(t6)
    t9_w = fq2_mul_r(t6[0], t6[1], qx[0], qx[1])
    zt2 = tuple((z[i] + t2[i]).canon() for i in range(2))
    zout_w = _pair_sub(_pair_sub(_sq(zt2), zsq_w), t3_w)
    sC = fp.redc_stack([t3_w[0], t3_w[1], t9_w[0], t9_w[1],
                        zout_w[0], zout_w[1]])
    t3s, t9s, zouts = _slice2(sC, 0), _slice2(sC, 1), _slice2(sC, 2)

    # stage D: t5 = 4*t3*t2, t7 = 4*t3*rx, xout = t6^2 - t5 - 2 t7,
    #          t10b = (qy+zout)^2 - ysq - zout^2, c2 = 2 t9 - t10b
    t3 = _wpair(t3s)
    t5_w = _pair_scale(fq2_mul_r(t3[0], t3[1], t2[0], t2[1]), 4)
    t7_w = _pair_scale(fq2_mul_r(t3[0], t3[1], rx[0], rx[1]), 4)
    xout_w = _pair_sub(_pair_sub(t6sq_w, t5_w), _pair_scale(t7_w, 2))
    zout = _wpair(zouts)
    qyz = tuple((qy[i] + zout[i]).canon() for i in range(2))
    t10b_w = _pair_sub(_pair_sub(_sq(qyz), ysq_w), _sq(zout))
    c2_w = _pair_sub(_pair_scale(_ppair(t9s), 2), t10b_w)
    # c0 = 2 zout, c1 = -2 t6 = 4 ry - 2 t1 (linear lifts); in scaled mode
    # they join the stage-D REDC so stage E can scale them by py/px
    c0_w = _pair_scale(_ppair(zouts), 2)
    t1p = _ppair(t1s)
    ryp = _ppair(r.y)
    c1_w = _pair_sub(_pair_scale(ryp, 4), _pair_scale(t1p, 2))  # -2*(t1 - 2 ry)
    rowsD = [t5_w[0], t5_w[1], t7_w[0], t7_w[1], xout_w[0], xout_w[1],
             c2_w[0], c2_w[1]]
    if scale is not None:
        rowsD += [c0_w[0], c0_w[1], c1_w[0], c1_w[1]]
    sD = fp.redc_stack(rowsD)
    t5s, t7s, xouts, c2 = (_slice2(sD, 0), _slice2(sD, 1),
                           _slice2(sD, 2), _slice2(sD, 3))

    # stage E: t8 = (t7 - xout)*t6, t0b = ry*t5, yout = t8 - 2 t0b
    d = tuple((fp.wrap(t7s[..., i, :]) - fp.wrap(xouts[..., i, :])).canon()
              for i in range(2))
    t8_w = fq2_mul_r(d[0], d[1], t6[0], t6[1])
    t0b_w = fq2_mul_r(ry[0], ry[1], *_wpair(t5s))
    yout_w = _pair_sub(t8_w, _pair_scale(t0b_w, 2))
    if scale is None:
        sE = fp.redc_stack([yout_w[0], yout_w[1], c0_w[0], c0_w[1],
                            c1_w[0], c1_w[1]])
        youts, c0, c1 = _slice2(sE, 0), _slice2(sE, 1), _slice2(sE, 2)
        return G2Projective(xouts, youts, zouts), (c0, c1, c2)
    sE = fp.redc_cat([fp.row1(yout_w[0]), fp.row1(yout_w[1]),
                      *scale_terms(_slice2(sD, 4), _slice2(sD, 5), *scale)])
    youts, sc0, sc1 = sE[..., 0:2, :], sE[..., 2:4, :], sE[..., 4:6, :]
    return G2Projective(xouts, youts, zouts), (sc0, sc1, c2)
