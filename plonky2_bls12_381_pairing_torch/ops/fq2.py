"""Batched Fq2 = Fp[u]/(u^2+1) on limb vectors, the counterpart of the JAX
package's ops/fq2.py: an element is (..., 2, NLIMBS) Montgomery limbs.

Three API tiers:
  * canonical ops (mul, square, inv, ...) returning reduced limbs;
  * ``*_wide`` ops returning pairs of fp.Wide — unreduced column accumulators
    that the Fq6/Fq12 layers combine before a single stacked Montgomery
    reduction per output component (lazy reduction);
  * ``*_products`` ops, the operand halves of the wide products (fp.Products:
    the convolutions' operand pairs and the combine that gives the wide
    pair), which callers gather so that a group of independent products is
    formed by one fp.form (one conv launch on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp
from ..utils import refmodel as rm

WidePair = tuple[fp.Wide, fp.Wide]


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------


def c0(a: torch.Tensor) -> torch.Tensor:
    return a[..., 0, :]


def c1(a: torch.Tensor) -> torch.Tensor:
    return a[..., 1, :]


def pack(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    return torch.stack([x0, x1], dim=-2)


def zero(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, 2, fp.NLIMBS), dtype=torch.int32,
                       device=fp.resolve_device(device))


def one(batch_shape=(), device=None) -> torch.Tensor:
    return pack(fp.one_mont(batch_shape, device), fp.zeros(batch_shape, device))


def encode(x) -> np.ndarray:
    """refmodel.Fq2 (or nested lists of them) -> (..., 2, NLIMBS) limbs."""
    arr = np.asarray(x, dtype=object)
    ints = np.empty(arr.shape + (2,), dtype=object)
    for idx in np.ndindex(arr.shape):
        ints[idx + (0,)] = arr[idx].c0
        ints[idx + (1,)] = arr[idx].c1
    return fp.encode(ints)


def decode(a):
    """(..., 2, NLIMBS) -> refmodel.Fq2 (object ndarray for batches)."""
    ints = fp.decode(a)
    shape = ints.shape[:-1]
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        out[idx] = rm.Fq2(int(ints[idx + (0,)]), int(ints[idx + (1,)]))
    return out if shape else out[()]


# ---------------------------------------------------------------------------
# Canonical linear ops
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp.add(a, b)  # component-wise; fp ops batch over the 2-axis


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp.sub(a, b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return fp.neg(a)


def neg_conjugate(a: torch.Tensor) -> torch.Tensor:
    """(-a0, a1) (reference fq2_target.rs:240-246)."""
    return pack(fp.neg(c0(a)), c1(a))


def conjugate(a: torch.Tensor) -> torch.Tensor:
    """a0 - a1 u; also the Fq2 Frobenius map (reference fq2_target_tree.rs:93-95)."""
    return pack(c0(a), fp.neg(c1(a)))


frobenius_map = conjugate


def mul_by_nonresidue(a: torch.Tensor) -> torch.Tensor:
    """(u+1)*a = (a0 - a1) + (a0 + a1)u (reference fq2_target_tree.rs:137-142)."""
    return pack(fp.sub(c0(a), c1(a)), fp.add(c0(a), c1(a)))


def scale_fp(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Multiply both components by an Fp scalar k (..., NLIMBS)."""
    return reduce(scale_fp_wide(a, k))


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = mask[..., None, None]
    return torch.where(m != 0, a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (fp.canonicalize(a) == 0).all(-1).all(-1)


def is_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (fp.canonicalize(a) == fp.canonicalize(b)).all(-1).all(-1)


# ---------------------------------------------------------------------------
# Wide (lazy) products
# ---------------------------------------------------------------------------


def _karatsuba(w: list) -> WidePair:
    t0, t1, tsum = w
    return (t0 - t1, tsum - t0 - t1)


def _schoolbook(w: list) -> WidePair:
    t0, t1, t01, t10 = w
    return (t0 - t1, t01 + t10)


def mul_products(a: torch.Tensor, b: torch.Tensor) -> fp.Products:
    """Karatsuba product, 3 convolutions:
    c0 = a0b0 - a1b1,  c1 = (a0+a1)(b0+b1) - a0b0 - a1b1."""
    a0, a1, b0, b1 = c0(a), c1(a), c0(b), c1(b)
    d2, v2 = 2 * fp.SEMI_DIG, 2 * fp.SEMI_VAL
    return fp.Products((fp.ConvPair(a0, b0), fp.ConvPair(a1, b1),
                        fp.ConvPair(a0 + a1, b0 + b1, d2, d2, v2, v2)), _karatsuba)


def square_products(a: torch.Tensor) -> fp.Products:
    return mul_products(a, a)


def mul_generic_products(x: torch.Tensor, y: torch.Tensor, x_max: int = fp.SEMI_DIG,
                         x_val: int = fp.SEMI_VAL, y_max: int = fp.SEMI_DIG,
                         y_val: int = fp.SEMI_VAL) -> fp.Products:
    """Wide Fq2 product for operands with relaxed (up to ~10-bit) limbs.

    Uses Karatsuba (3 convs) when the limb-sum operands stay below 2^24 per
    column (the JAX package's float32 budget, kept so that the rows agree),
    else falls back to 4-conv schoolbook."""
    a0, a1 = c0(x), c1(x)
    b0, b1 = c0(y), c1(y)
    t0 = fp.ConvPair(a0, b0, x_max, y_max, x_val, y_val)
    t1 = fp.ConvPair(a1, b1, x_max, y_max, x_val, y_val)
    if fp.NLIMBS * (2 * x_max) * (2 * y_max) < (1 << 24):
        tsum = fp.ConvPair(a0 + a1, b0 + b1, 2 * x_max, 2 * y_max, 2 * x_val, 2 * y_val)
        return fp.Products((t0, t1, tsum), _karatsuba)
    t01 = fp.ConvPair(a0, b1, x_max, y_max, x_val, y_val)
    t10 = fp.ConvPair(a1, b0, x_max, y_max, x_val, y_val)
    return fp.Products((t0, t1, t01, t10), _schoolbook)


def scale_fp_products(a: torch.Tensor, k: torch.Tensor, k_max: int = fp.SEMI_DIG,
                      k_val: int = fp.SEMI_VAL) -> fp.Products:
    """(a0*k, a1*k), k an Fp limb vector."""
    return fp.Products((fp.ConvPair(c0(a), k, b_max=k_max, b_val=k_val),
                        fp.ConvPair(c1(a), k, b_max=k_max, b_val=k_val)), tuple)


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> WidePair:
    return fp.form(mul_products(a, b))[0]


def square_wide(a: torch.Tensor) -> WidePair:
    return mul_wide(a, a)


def mul_wide_generic(x: torch.Tensor, y: torch.Tensor, x_max: int = fp.SEMI_DIG,
                     x_val: int = fp.SEMI_VAL, y_max: int = fp.SEMI_DIG,
                     y_val: int = fp.SEMI_VAL) -> WidePair:
    return fp.form(mul_generic_products(x, y, x_max, x_val, y_max, y_val))[0]


def mul_by_nonresidue_wide(w: WidePair) -> WidePair:
    return (w[0] - w[1], w[0] + w[1])


def add_wide(x: WidePair, y: WidePair) -> WidePair:
    return (x[0] + y[0], x[1] + y[1])


def sub_wide(x: WidePair, y: WidePair) -> WidePair:
    return (x[0] - y[0], x[1] - y[1])


def scale_fp_wide(a: torch.Tensor, k: torch.Tensor, k_max: int = fp.SEMI_DIG,
                  k_val: int = fp.SEMI_VAL) -> WidePair:
    """(a0*k, a1*k) as wides, k an Fp limb vector."""
    return fp.form(scale_fp_products(a, k, k_max, k_val))[0]


def as_wide(a: torch.Tensor, a_max: int = fp.SEMI_DIG, a_val: int = fp.SEMI_VAL) -> WidePair:
    """Embed Fq2 limbs as a wide pair with NO domain change (see fp.as_wide)."""
    return (fp.as_wide(c0(a), a_max, a_val), fp.as_wide(c1(a), a_max, a_val))


def to_wide_mont(a: torch.Tensor, a_max: int = fp.SEMI_DIG) -> WidePair:
    """Embed stored Fq2 Montgomery limbs into the conv-product domain."""
    return (fp.to_wide_mont(c0(a), a_max), fp.to_wide_mont(c1(a), a_max))


def scale_small_wide(w: WidePair, k: int) -> WidePair:
    return (w[0].scale_small(k), w[1].scale_small(k))


def neg_wide(w: WidePair) -> WidePair:
    zero0 = fp.Wide(torch.zeros_like(w[0].cols), 0, 0, 0, 0)
    zero1 = fp.Wide(torch.zeros_like(w[1].cols), 0, 0, 0, 0)
    return (zero0 - w[0], zero1 - w[1])


def sub_relaxed(a: torch.Tensor, b: torch.Tensor):
    """a - b as a relaxed non-negative conv operand (carry-free).

    Returns (limbs, limb_max, val_max); no carry propagation needed."""
    negc = fp.const("NEGC", a.device)
    return a + (negc - b), fp.SEMI_DIG + (fp.SEMI_DIG + 256), fp.SEMI_VAL + fp.C.NEG_K * fp.C.P


def reduce(w: WidePair) -> torch.Tensor:
    """Stacked Montgomery reduction of a wide pair -> canonical (..., 2, NLIMBS)."""
    return fp.mont_reduce_stack([w[0], w[1]])


# ---------------------------------------------------------------------------
# Canonical multiplicative ops
# ---------------------------------------------------------------------------


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return reduce(mul_wide(a, b))


def mul_group(*parts: fp.Products) -> list[torch.Tensor]:
    """Independent Fq2 products (mul_products, square_products, ...), each
    reduced on its own as mul gives it; their convolutions formed together."""
    return [reduce(w) for w in fp.form(*parts)]


def square(a: torch.Tensor) -> torch.Tensor:
    return reduce(square_wide(a))


def inv(a: torch.Tensor) -> torch.Tensor:
    """(a0 - a1 u)/(a0^2 + a1^2); 0 -> 0 via the Fermat-inverse inv0 property.
    Records an fq2_inv row."""
    n0, n1 = fp.conv_many([fp.ConvPair(c0(a), c0(a)), fp.ConvPair(c1(a), c1(a))])
    norm = fp.mont_reduce(n0 + n1)
    ninv = fp.inv(norm)
    neg_a1, m, v = fp.neg_relaxed(c1(a))
    out = fp.mont_reduce_stack(fp.conv_many([fp.ConvPair(c0(a), ninv),
                                             fp.ConvPair(neg_a1, ninv, m, a_val=v)]))
    fp._record("fq2_inv", a, out)
    return out


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b = a * b^-1 (b == 0 gives 0)."""
    return mul(a, inv(b))


def connect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The equality constraint (fp.connect): a connect row and a == b."""
    return fp.connect(a, b)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k for a small non-negative integer k (double-and-add on canonical limbs)."""
    return fp.mul_small(a, k)


def sgn0(a: torch.Tensor) -> torch.Tensor:
    """The RFC 9380 sign of a0 + a1 u."""
    s0 = fp.sgn0(c0(a))
    z0 = fp.is_zero(c0(a))
    s1 = fp.sgn0(c1(a))
    return s0 | (z0.to(torch.int32) & s1)


def legendre_norm(a: torch.Tensor) -> torch.Tensor:
    """The Legendre symbol of the norm a0^2 + a1^2 (the Fq2 square test)."""
    n0, n1 = fp.conv_many([fp.ConvPair(c0(a), c0(a)), fp.ConvPair(c1(a), c1(a))])
    return fp.legendre(fp.mont_reduce(n0 + n1))


def is_square(a: torch.Tensor) -> torch.Tensor:
    leg = legendre_norm(a)
    return ~fp.is_equal(leg, fp.neg(fp.one_mont(leg.shape[:-1], a.device)))


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """Square root in Fq2 for p = 3 mod 4 (a root iff square(out) == a):
    a1 = a^((p-3)/4), x0 = a1 a, alpha = a1 x0; x0 u if alpha == -1, else
    x0 (1 + alpha)^((p-1)/2)."""
    a1p = pow_static(a, (fp._P - 3) // 4)
    x0 = mul(a1p, a)
    alpha = mul(a1p, x0)
    batch = alpha.shape[:-2]
    minus_one = pack(fp.neg(fp.one_mont(batch, a.device)), fp.zeros(batch, a.device))
    is_m1 = is_equal(alpha, minus_one)
    u_times = pack(fp.neg(c1(x0)), c0(x0))  # x0 * u
    b = pow_static(add(alpha, one(device=a.device).expand(alpha.shape)), (fp._P - 1) // 2)
    other = mul(b, x0)
    return select(is_m1.to(torch.int32), u_times, other)


def sqrt_with_sgn(a: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    """Of the roots +-s of a square a, the one whose sgn0 is sgn's low bit.
    Records an fq2_sqrt row."""
    s = sqrt(a)
    want = sgn0(s) == (sgn & 1)
    out = select(want.to(torch.int32), s, neg(s))
    fp._record("fq2_sqrt", a, sgn, out)
    return out


def pow_static(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """MSB-first square-and-multiply by a static exponent."""
    if exponent == 0:
        return one(device=a.device).expand(a.shape)
    acc = a
    for i in range(exponent.bit_length() - 2, -1, -1):
        acc = square(acc)
        if (exponent >> i) & 1:
            acc = mul(acc, a)
    return acc
