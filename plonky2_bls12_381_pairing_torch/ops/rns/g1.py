"""G1 point addition on RNS channels: the complete projective formulas of
Renes, Costello and Batina (eprint 2015/1060), Algorithm 7 (P + Q) and
Algorithm 8 (P + Q with Q affine) for a = 0 and b3 = 3b = 12. They have no
case split: doubling, P + (-P) and the point at infinity (0 : 1 : 0) on
either side (Algorithm 8: on the projective side) come out right with no
branch, since BLS12-381's G1 curve has no point of order two.

Each formula is two stages, each one stacked REDC: the products of the
inputs (6 for Algorithm 7, 5 for Algorithm 8), then the three outputs as
sums of two products of the first stage's values (lazy linear pieces on the
bound-tracked R accumulator, fp.py), which share their form between the two
algorithms (_level2_terms). The plain versions of csrc/g1_aggregate.cu's
kernels (ops/rns/kernels.py g1_sum, g1_combine), which add each REDC input's
bias row from kernel_tables.static_biases ("g1_madd", "g1_add").
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...utils import refmodel as rm
from . import fp
from .lines import G1Affine, _filled, _rows

R = fp.R
LANES = fp.LANES
#: 3 b of y^2 = x^3 + b
B3 = 3 * rm.B_G1


@dataclass
class G1Projective:
    """(X : Y : Z) with affine (X / Z, Y / Z); Z == 0 is the point at
    infinity. x, y, z: (rows..., LANES) packed stored residues."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), device=None) -> "G1Projective":
        """(0 : 1 : 0) at every element of `batch_shape`."""
        dev = fp.resolve_device(device)
        rows = _rows(batch_shape)
        zero = torch.zeros((*rows, LANES), dtype=torch.int32, device=dev)
        return G1Projective(zero, _filled(("one",), None, rows, (LANES,), dev), zero.clone())

    @staticmethod
    def from_affine(p: G1Affine) -> "G1Projective":
        """(x : y : 1), or (0 : 1 : 0) where p is the point at infinity."""
        inf = p.infinity != 0
        one = fp.cst(("one",), p.x).expand(p.x.shape)
        zero = torch.zeros_like(p.x)
        return G1Projective(torch.where(inf, zero, p.x), torch.where(inf, one, p.y),
                            torch.where(inf, zero, one))

    @staticmethod
    def unstack(t: torch.Tensor) -> "G1Projective":
        return G1Projective(t[..., 0, :], t[..., 1, :], t[..., 2, :])


def _level2_terms(t0: R, t1: R, t3: R, t4: R, y3: R, t2: R) -> list[R]:
    """X3, Y3, Z3 before their REDC (both algorithms' steps from b3 t2 on):
    X3 = t3 (t1 - t2) - t4 (b3 y3), Y3 = (t1 - t2)(t1 + t2) + (b3 y3)(3 t0),
    Z3 = (t1 + t2) t4 + (3 t0) t3, with t2 already b3 times its product.
    Operands whose channels could overflow a product are canonicalized."""
    t0x3 = t0.scale(3).maybe_canon()
    z3 = (t1 + t2).maybe_canon()
    t1m = (t1 - t2).maybe_canon()
    y3s = y3.scale(B3).maybe_canon()
    t3, t4 = t3.maybe_canon(), t4.maybe_canon()
    return [fp.mul_rr(t3, t1m) - fp.mul_rr(t4, y3s),
            fp.mul_rr(t1m, z3) + fp.mul_rr(y3s, t0x3),
            fp.mul_rr(z3, t4) + fp.mul_rr(t0x3, t3)]


def madd_terms(p: G1Projective, x2: torch.Tensor, y2: torch.Tensor) -> list[R]:
    """Algorithm 8's first stage: X1 x2, Y1 y2, (x2 + y2)(X1 + Y1), y2 Z1,
    x2 Z1."""
    x1, y1, z1 = fp.wrap(p.x), fp.wrap(p.y), fp.wrap(p.z)
    a, b = fp.wrap(x2), fp.wrap(y2)
    return [fp.mul_rr(x1, a), fp.mul_rr(y1, b), fp.mul_rr(a + b, x1 + y1),
            fp.mul_rr(b, z1), fp.mul_rr(a, z1)]


def madd_level2_terms(p: G1Projective, s1: torch.Tensor) -> list[R]:
    """Algorithm 8's second stage from the first's stored values s1
    (rows..., 5, LANES)."""
    t0, t1, t3, u, v = (fp.wrap(s1[..., k, :]) for k in range(5))
    return _level2_terms(t0, t1, t3 - (t0 + t1), u + fp.wrap(p.y), v + fp.wrap(p.x),
                         fp.wrap(p.z).scale(B3))


def madd(p: G1Projective, x2: torch.Tensor, y2: torch.Tensor) -> G1Projective:
    """p + (x2, y2) for projective p and affine (x2, y2), never the point at
    infinity (Algorithm 8): two stacked REDCs, of 5 and 3 values."""
    s1 = fp.redc_stack(madd_terms(p, x2, y2))
    return G1Projective.unstack(fp.redc_stack(madd_level2_terms(p, s1)))


def add_terms(p: G1Projective, q: G1Projective) -> list[R]:
    """Algorithm 7's first stage: X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2),
    (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)."""
    x1, y1, z1 = fp.wrap(p.x), fp.wrap(p.y), fp.wrap(p.z)
    x2, y2, z2 = fp.wrap(q.x), fp.wrap(q.y), fp.wrap(q.z)
    return [fp.mul_rr(x1, x2), fp.mul_rr(y1, y2), fp.mul_rr(z1, z2),
            fp.mul_rr(x1 + y1, x2 + y2), fp.mul_rr(y1 + z1, y2 + z2),
            fp.mul_rr(x1 + z1, x2 + z2)]


def add_level2_terms(s1: torch.Tensor) -> list[R]:
    """Algorithm 7's second stage from the first's stored values s1
    (rows..., 6, LANES)."""
    t0, t1, t2, a, b, c = (fp.wrap(s1[..., k, :]) for k in range(6))
    return _level2_terms(t0, t1, a - (t0 + t1), b - (t1 + t2), c - (t0 + t2), t2.scale(B3))


def add(p: G1Projective, q: G1Projective) -> G1Projective:
    """p + q for projective points, either or both at infinity
    (Algorithm 7): two stacked REDCs, of 6 and 3 values."""
    s1 = fp.redc_stack(add_terms(p, q))
    return G1Projective.unstack(fp.redc_stack(add_level2_terms(s1)))


def to_affine(p: G1Projective) -> G1Affine:
    """(X / Z, Y / Z), the infinity mask where Z == 0 (x 0, y 1 there, as
    G1Affine.identity): one batched inverse, fp.inv's tree (on a card its
    kernels, kernels.inv_nonzero), a zero Z going into it as one."""
    from . import kernels

    zero = fp.slot_lanes(fp.is_zero(p.z))
    one = fp.cst(("one",), p.z).expand(p.z.shape)
    zi = fp.wrap(kernels.inv_nonzero(torch.where(zero, one, p.z)))
    xy = fp.redc_stack([fp.mul_rr(fp.wrap(p.x), zi), fp.mul_rr(fp.wrap(p.y), zi)])
    return G1Affine(torch.where(zero, torch.zeros_like(p.x), xy[..., 0, :]),
                    torch.where(zero, one, xy[..., 1, :]), zero.to(torch.int32))
