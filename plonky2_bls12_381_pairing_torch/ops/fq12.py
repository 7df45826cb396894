"""Batched Fq12 = Fq6[w]/(w^2 - v) on limb vectors, the counterpart of the JAX
package's ops/fq12.py: an element is (..., 12, NLIMBS) Montgomery limbs in
flat tower order [c0.c0.c0, c0.c0.c1, c0.c1.c0, ..., c1.c2.c1].

All products are Karatsuba-over-Fq6 in wide (unreduced-column) form with one
stacked Montgomery reduction for all 12 Fp output components; each op's
convolutions are formed together (fp.form: one conv launch on the card, 63
pairs for mul, 42 for square, 43 for mul_by_014, 30 for cyclotomic_square).
Under the
"fused" strategy (fp.set_strategy) mul, square, mul_by_014 and
cyclotomic_square run the tower kernels of ops/kernels/tower.py instead: the
CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor, equal in
value to the composition path but other weakly reduced rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import refmodel as rm
from . import fp, fq2, fq6


def c0(a: torch.Tensor) -> torch.Tensor:
    return a[..., 0:6, :]


def c1(a: torch.Tensor) -> torch.Tensor:
    return a[..., 6:12, :]


def pack(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    return torch.cat([x0, x1], dim=-2)


def zero(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, 12, fp.NLIMBS), dtype=torch.int32,
                       device=fp.resolve_device(device))


def one(batch_shape=(), device=None) -> torch.Tensor:
    return pack(fq6.one(batch_shape, device), fq6.zero(batch_shape, device))


def encode(x) -> np.ndarray:
    arr = np.asarray(x, dtype=object)
    ints = np.empty(arr.shape + (12,), dtype=object)
    for idx in np.ndindex(arr.shape):
        for j, v in enumerate(arr[idx].coeffs()):
            ints[idx + (j,)] = v
    return fp.encode(ints)


def decode(a):
    ints = fp.decode(a)
    shape = ints.shape[:-1]
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        out[idx] = rm.Fq12.from_coeffs([int(ints[idx + (j,)]) for j in range(12)])
    return out if shape else out[()]


# ---------------------------------------------------------------------------
# Linear ops
# ---------------------------------------------------------------------------


def add(a, b):
    return fp.add(a, b)


def sub(a, b):
    return fp.sub(a, b)


def neg(a):
    return fp.neg(a)


def conjugate(a: torch.Tensor) -> torch.Tensor:
    """f^(p^6): negate the w-part."""
    return pack(c0(a), fp.neg(c1(a)))


def select(mask, a, b):
    return torch.where(mask[..., None, None] != 0, a, b)


def is_zero(a):
    return (fp.canonicalize(a) == 0).all(-1).all(-1)


def is_equal(a, b):
    return (fp.canonicalize(a) == fp.canonicalize(b)).all(-1).all(-1)


def connect(a, b):
    """The equality constraint (fp.connect): a connect row and a == b."""
    return fp.connect(a, b)


def div(a, b):
    """a / b = a * b^-1 (b == 0 gives 0)."""
    return mul(a, inv(b))


def conditional_mul(a, x, flag):
    """a * x where flag (...,) is set, else a."""
    return select(flag, mul(a, x), a)


def is_one(a):
    return is_equal(a, one((), a.device).expand_as(a))


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------


def _fused():
    from .kernels import tower as _kt

    return _kt


def _reduce12(w0: fq6.WideTriple, w1: fq6.WideTriple) -> torch.Tensor:
    wides = [p for tri in (w0, w1) for pair in tri for p in pair]
    return fp.mont_reduce_stack(wides)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba over Fq6 with w^2 = v."""
    if fp.use_fused():
        return _fused().fq12_mul(a, b)
    a0, a1, b0, b1 = c0(a), c1(a), c0(b), c1(b)
    t0, t1, t01 = fp.form(fq6.mul_products(a0, b0), fq6.mul_products(a1, b1),
                          fq6.mul_products(fp.add(a0, a1), fp.add(b0, b1)))
    out0 = fq6.add_wide(t0, fq6.mul_by_nonresidue_wide(t1))
    out1 = fq6.sub_wide(fq6.sub_wide(t01, t0), t1)
    return _reduce12(out0, out1)


def square(a: torch.Tensor) -> torch.Tensor:
    """Complex squaring:
    c0 = (a0+a1)(a0 + v a1) - ab - v ab;  c1 = 2 ab."""
    if fp.use_fused():
        return _fused().fq12_square(a)
    a0, a1 = c0(a), c1(a)
    s = fp.add(a0, a1)
    t = fp.add(a0, fq6.mul_by_nonresidue(a1))
    ab, st = fp.form(fq6.mul_products(a0, a1), fq6.mul_products(s, t))
    out0 = fq6.sub_wide(fq6.sub_wide(st, ab), fq6.mul_by_nonresidue_wide(ab))
    out1 = fq6.add_wide(ab, ab)
    return _reduce12(out0, out1)


def mul_by_014(a: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
               d4: torch.Tensor) -> torch.Tensor:
    """Sparse product with (d0 + d1 v) + (d4 v) w:
    aa = a0.mul_by_01(d0, d1); bb = a1.mul_by_1(d4)
    out0 = v*bb + aa;  out1 = (a0+a1).mul_by_01(d0, d1+d4) - aa - bb."""
    if fp.use_fused():
        # d0, d1, d4 broadcast over a's batch and packed into one (6, 48)
        # operand: a copy of three Fq2 values per element
        shape = a[..., :2, :].shape
        d = torch.cat([x.expand(shape) for x in (d0, d1, d4)], dim=-2)
        return _fused().fq12_mul_by_014(a, d)
    a0, a1 = c0(a), c1(a)
    d14 = fq2.add(d1, d4)
    aa, bb, t1 = fp.form(fq6.mul_by_01_products(a0, d0, d1), fq6.mul_by_1_products(a1, d4),
                         fq6.mul_by_01_products(fp.add(a0, a1), d0, d14))
    out0 = fq6.add_wide(fq6.mul_by_nonresidue_wide(bb), aa)
    out1 = fq6.sub_wide(fq6.sub_wide(t1, aa), bb)
    return _reduce12(out0, out1)


def inv(a: torch.Tensor) -> torch.Tensor:
    """(c0 - c1 w)/(c0^2 - v c1^2). Records an fq12_inv row."""
    a0, a1 = c0(a), c1(a)
    sq0, sq1 = fp.form(fq6.square_products(a0), fq6.square_products(a1))
    t = fq6.reduce(fq6.sub_wide(sq0, fq6.mul_by_nonresidue_wide(sq1)))
    tinv = fq6.inv(t)
    w0, w1 = fp.form(fq6.mul_products(a0, tinv), fq6.mul_products(a1, tinv))
    out0 = fq6.reduce(w0)
    out1 = fq6.neg(fq6.reduce(w1))
    out = pack(out0, out1)
    fp._record("fq12_inv", a, out)
    return out


def _fp4_square_combine(r: list):
    t0, t1, s = r
    t2 = fq2.sub_wide(fq2.sub_wide(s, t0), t1)
    c0 = fq2.add_wide(fq2.mul_by_nonresidue_wide(t1), t0)
    return c0, t2


def _fp4_square_products(a: torch.Tensor, b: torch.Tensor) -> fp.Products:
    """Squaring in Fq4 = Fq2[w]/(w^2 - xi), wide outputs: 10 convolutions."""
    d2, v2 = 2 * fp.SEMI_DIG, 2 * fp.SEMI_VAL
    return fp.gather([fq2.square_products(a), fq2.square_products(b),
                      fq2.mul_generic_products(a + b, a + b, x_max=d2, x_val=v2,
                                               y_max=d2, y_val=v2)],
                     _fp4_square_combine)


def cyclotomic_square(a: torch.Tensor) -> torch.Tensor:
    """Granger-Scott squaring, valid in the cyclotomic subgroup. Three Fq4
    squares (30 convolutions, formed together) + one stacked reduce."""
    if fp.use_fused():
        return _fused().fq12_cyclotomic_square(a)
    z0 = a[..., 0:2, :]
    z4 = a[..., 2:4, :]
    z3 = a[..., 4:6, :]
    z2 = a[..., 6:8, :]
    z1 = a[..., 8:10, :]
    z5 = a[..., 10:12, :]

    (t0, t1), (t2, t3), (t4, t5) = fp.form(
        _fp4_square_products(z0, z1), _fp4_square_products(z2, z3),
        _fp4_square_products(z4, z5))
    nz0 = fq2.sub_wide(fq2.scale_small_wide(t0, 3), fq2.scale_small_wide(fq2.to_wide_mont(z0), 2))
    nz1 = fq2.add_wide(fq2.scale_small_wide(t1, 3), fq2.scale_small_wide(fq2.to_wide_mont(z1), 2))
    nz4 = fq2.sub_wide(fq2.scale_small_wide(t2, 3), fq2.scale_small_wide(fq2.to_wide_mont(z4), 2))
    nz5 = fq2.add_wide(fq2.scale_small_wide(t3, 3), fq2.scale_small_wide(fq2.to_wide_mont(z5), 2))
    t5xi = fq2.mul_by_nonresidue_wide(t5)
    nz2 = fq2.add_wide(fq2.scale_small_wide(t5xi, 3), fq2.scale_small_wide(fq2.to_wide_mont(z2), 2))
    nz3 = fq2.sub_wide(fq2.scale_small_wide(t4, 3), fq2.scale_small_wide(fq2.to_wide_mont(z3), 2))

    return fp.mont_reduce_stack(
        [nz0[0], nz0[1], nz4[0], nz4[1], nz3[0], nz3[1],
         nz2[0], nz2[1], nz1[0], nz1[1], nz5[0], nz5[1]]
    )


def frobenius_map(a: torch.Tensor) -> torch.Tensor:
    """frob6(c0) + gamma12 * frob6(c1) w with the generated constant."""
    w0, w1 = fp.form(fq6.frobenius_products(c0(a)), fq6.frobenius_products(c1(a)))
    f0 = fq6.frobenius_finish(c0(a), w0)
    f1 = fq6.frobenius_finish(c1(a), w1)
    g = fq6.frob_const("FROB_GAMMA12_MONT", a.device)
    comps = [fq6.c(f1, i) for i in range(3)]
    return pack(f0, fq6.pack(*fq2.mul_group(
        *(fq2.mul_products(comp, g.expand_as(comp)) for comp in comps))))


def frobenius_pow(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = frobenius_map(a)
    return a


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
