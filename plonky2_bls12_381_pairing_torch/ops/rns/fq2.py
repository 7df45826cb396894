"""Fq2 stored-element API on the RNS tier (the JAX package's ops/rns/fq2.py).

An element is (..., 2, LANES) stored rows, the component axis -2, as the Fq2
slices of ops/rns/tower.py. Products are the tower's R-level Karatsuba
(tower.fq2_mul_r) ending in one stacked REDC; the inverse is the tower's
(one batched fp.inv); sgn0 and the square test ride the Fp core's CRT bridge
(fp.to_limbs) and Legendre power; the exponentiations are square-and-multiply
loops over the exponent's static bits. Rows are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import rns_constants as RC
from . import fp, tower

LANES = fp.LANES
P = fp.P

_ONE2 = np.zeros((2, LANES), dtype=np.int32)
_ONE2[0] = RC.ONE


def zero(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, 2, LANES), dtype=torch.int32,
                       device=fp.resolve_device(device))


def one(batch_shape=(), device=None) -> torch.Tensor:
    o = fp.const_on(("one2",), fp.resolve_device(device), _ONE2)
    return o.expand(*batch_shape, 2, LANES)


def _pair(a: torch.Tensor):
    return fp.wrap(a[..., 0, :]), fp.wrap(a[..., 1, :])


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp.barrett(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp.barrett(a - b + fp.cst(("pmul", 4), a))


def neg(a: torch.Tensor) -> torch.Tensor:
    return fp.neg(a)


def conjugate(a: torch.Tensor) -> torch.Tensor:
    """(a0, -a1)."""
    return torch.cat([a[..., 0:1, :], fp.neg(a[..., 1:2, :])], dim=-2)


def neg_conjugate(a: torch.Tensor) -> torch.Tensor:
    """(-a0, a1)."""
    return torch.cat([fp.neg(a[..., 0:1, :]), a[..., 1:2, :]], dim=-2)


def mul_by_nonresidue(a: torch.Tensor) -> torch.Tensor:
    """(u+1) a = (a0 - a1) + (a0 + a1) u."""
    p4 = fp.cst(("pmul", 4), a)
    return torch.cat([fp.barrett(a[..., 0:1, :] - a[..., 1:2, :] + p4),
                      fp.barrett(a[..., 0:1, :] + a[..., 1:2, :])], dim=-2)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    o0, o1 = tower.fq2_mul_r(*_pair(a), *_pair(b))
    return fp.redc_stack([o0, o1])


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def inv(a: torch.Tensor) -> torch.Tensor:
    """(a0 - a1 u)/(a0^2 + a1^2); 0 -> 0. Records an rns_fq2_inv row."""
    out = tower._fq2_inv(a)
    fp._record("rns_fq2_inv", a, out)
    return out


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b = a * b^-1 (b == 0 gives 0)."""
    return mul(a, inv(b))


def connect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The equality constraint (fp.connect): an rns_connect row, and a == b
    per packed element (..., PACK)."""
    return fp.connect(a, b).all(dim=-2)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask: packed lane mask (..., LANES)."""
    return torch.where(mask[..., None, :] != 0, a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return fp.is_zero(a).all(dim=-2)


def is_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp.is_equal(a, b).all(dim=-2)


def sgn0(a: torch.Tensor) -> torch.Tensor:
    """The RFC 9380 sign of a0 + a1 u per packed element (..., PACK)."""
    s0 = fp.sgn0(a[..., 0, :])
    z0 = fp.is_zero(a[..., 0, :]).to(torch.int32)
    s1 = fp.sgn0(a[..., 1, :])
    return s0 | (z0 & s1)


def is_square(a: torch.Tensor) -> torch.Tensor:
    """The square test through the norm a0^2 + a1^2, per packed element."""
    c0, c1 = _pair(a)
    return fp.is_square(fp.redc(fp.mul_rr(c0, c0) + fp.mul_rr(c1, c1)))


def pow_static(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """MSB-first square-and-multiply over the static bits."""
    if exponent == 0:
        return one(device=a.device).expand(a.shape)
    acc = a
    for bit in fp.exponent_bits(exponent):
        acc = mul(acc, acc)
        if bit:
            acc = mul(acc, a)
    return acc


def _minus_one(device) -> torch.Tensor:
    """(fp.neg(one), 0): the stored rows of -1, made once per device."""
    neg_one = np.mod(RC.p_mult_row(4) - RC.ONE, RC.M_I32).astype(np.int32)
    m = np.stack([neg_one, np.zeros(LANES, np.int32)])
    return fp.const_on(("fq2_minus_one",), device, m)


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """Square root for p = 3 mod 4 (a root iff square(out) == a), the limb
    tier's case split: a1 = a^((p-3)/4), x0 = a1 a, alpha = a1 x0; x0 u where
    alpha == -1, else x0 (1 + alpha)^((p-1)/2)."""
    a1p = pow_static(a, (P - 3) // 4)
    x0 = mul(a1p, a)
    alpha = mul(a1p, x0)
    is_m1 = is_equal(alpha, _minus_one(a.device).expand(alpha.shape))  # (..., PACK)
    u_times = torch.cat([fp.neg(x0[..., 1:2, :]), x0[..., 0:1, :]], dim=-2)  # x0 u
    b = pow_static(add(alpha, one(device=a.device).expand(alpha.shape)), (P - 1) // 2)
    other = mul(b, x0)
    return select(fp.slot_lanes(is_m1), u_times, other)


def sqrt_with_sgn(a: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    """Of the roots +-s of a square a, the one whose sgn0 is sgn's low bit;
    sgn: per packed element (..., PACK). Records an rns_fq2_sqrt row."""
    s = sqrt(a)
    want = sgn0(s) == (sgn & 1)
    out = select(fp.slot_lanes(want), s, neg(s))
    fp._record("rns_fq2_sqrt", a, sgn, out)
    return out
