"""Fq2/Fq6/Fq12 tower on RNS channels (the JAX package's ops/rns/tower.py).

Every product is one int32 lane-multiply; linear combinations ride the
bound-tracked `R` accumulator (negative channel values are fine, and `redc`
biases with a constant k*p row); each tower op ends in ONE stacked RNS
Montgomery reduction for all 12 (or 6/2) Fp output components. The formulas
and their order of operations are the JAX package's, so the stored rows are
bit-identical.

Element layout: Fq12 = (..., 12, LANES) int32 in flat tower order
[c0.c0.c0, c0.c0.c1, c0.c1.c0, ..., c1.c2.c1].

mul, square, mul_by_014, mul_by_014_square and cyclotomic_square go through
their wrappers in ops/rns/kernels.py (the JAX package's fused_op sites): the
plain formula `<op>_plain` for a tensor on the CPU, one CUDA kernel for a
tensor on a card. compressed_square is kernels.kara_square_run with n = 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import rns_constants as RC
from ...utils import refmodel as rm
from . import fp

R = fp.R
LANES = fp.LANES

#: Operand channel budget: multiply operands are canonicalized above this so
#: products stay int32-exact through the deepest combination sums.
_OPERAND_BUDGET = 2 * (RC.PRIME_MAX - 1)


def _canon_list(xs: list[R]) -> list[R]:
    return [x.maybe_canon(_OPERAND_BUDGET + 1) for x in xs]


# ---------------------------------------------------------------------------
# Fq2 on R pairs
# ---------------------------------------------------------------------------


def fq2_mul_r(a0: R, a1: R, b0: R, b1: R) -> tuple[R, R]:
    """Karatsuba complex product over u^2 = -1, outputs channel-canonical."""
    a0, a1, b0, b1 = _canon_list([a0, a1, b0, b1])
    t0 = fp.mul_rr(a0, b0)
    t1 = fp.mul_rr(a1, b1)
    tsum = fp.mul_rr((a0 + a1).maybe_canon(_OPERAND_BUDGET + 1),
                     (b0 + b1).maybe_canon(_OPERAND_BUDGET + 1))
    return (t0 - t1).canon(), (tsum - t0 - t1).canon()


def fq2_nonres(x: tuple[R, R]) -> tuple[R, R]:
    """(u+1) * (x0 + x1 u) = (x0 - x1) + (x0 + x1) u."""
    return x[0] - x[1], x[0] + x[1]


def _pair_add(x, y):
    return x[0] + y[0], x[1] + y[1]


def _pair_sub(x, y):
    return x[0] - y[0], x[1] - y[1]


def _pair_scale(x, k):
    return x[0].scale(k), x[1].scale(k)


# ---------------------------------------------------------------------------
# Fq6 on flat 6-lists of R
# ---------------------------------------------------------------------------


def _fq6_mul(a: list[R], b: list[R]) -> list[R]:
    """Interpolation (Karatsuba) product."""
    a = _canon_list(a)
    b = _canon_list(b)
    t0 = fq2_mul_r(a[0], a[1], b[0], b[1])
    t1 = fq2_mul_r(a[2], a[3], b[2], b[3])
    t2 = fq2_mul_r(a[4], a[5], b[4], b[5])
    m12 = fq2_mul_r(a[2] + a[4], a[3] + a[5], b[2] + b[4], b[3] + b[5])
    m01 = fq2_mul_r(a[0] + a[2], a[1] + a[3], b[0] + b[2], b[1] + b[3])
    m02 = fq2_mul_r(a[0] + a[4], a[1] + a[5], b[0] + b[4], b[1] + b[5])
    s0 = _pair_add(t0, fq2_nonres(_pair_sub(_pair_sub(m12, t1), t2)))
    s1 = _pair_add(_pair_sub(_pair_sub(m01, t0), t1), fq2_nonres(t2))
    s2 = _pair_add(_pair_sub(_pair_sub(m02, t0), t2), t1)
    return [s0[0], s0[1], s1[0], s1[1], s2[0], s2[1]]


def _fq6_nonres(t: list[R]) -> list[R]:
    x = fq2_nonres((t[4], t[5]))
    return [x[0], x[1], t[0], t[1], t[2], t[3]]


def _fq6_mul_by_01(a: list[R], b00: R, b01: R, b10: R, b11: R) -> list[R]:
    """Sparse product with (b0 + b1 v)."""
    a = _canon_list(a)
    b00, b01, b10, b11 = _canon_list([b00, b01, b10, b11])
    t0 = fq2_mul_r(a[0], a[1], b00, b01)
    t1 = fq2_mul_r(a[2], a[3], b10, b11)
    m12 = fq2_mul_r(a[2] + a[4], a[3] + a[5], b10, b11)
    m01 = fq2_mul_r(a[0] + a[2], a[1] + a[3], b00 + b10, b01 + b11)
    t2 = fq2_mul_r(a[4], a[5], b00, b01)
    s0 = _pair_add(fq2_nonres(_pair_sub(m12, t1)), t0)
    s1 = _pair_sub(_pair_sub(m01, t0), t1)
    s2 = _pair_add(t2, t1)
    return [s0[0], s0[1], s1[0], s1[1], s2[0], s2[1]]


def _fq6_mul_by_1(a: list[R], b10: R, b11: R) -> list[R]:
    """Sparse product with (b1 v): (xi*(a2*b1), a0*b1, a1*b1)."""
    a = _canon_list(a)
    b10, b11 = _canon_list([b10, b11])
    x = fq2_nonres(fq2_mul_r(a[4], a[5], b10, b11))
    s1 = fq2_mul_r(a[0], a[1], b10, b11)
    s2 = fq2_mul_r(a[2], a[3], b10, b11)
    return [x[0], x[1], s1[0], s1[1], s2[0], s2[1]]


def _list_add(x, y):
    return [a + b for a, b in zip(x, y)]


def _list_sub(x, y):
    return [a - b for a, b in zip(x, y)]


# ---------------------------------------------------------------------------
# Fq12 stored-element API
# ---------------------------------------------------------------------------


def _comps(a: torch.Tensor, lo: int, hi: int) -> list[R]:
    return [fp.wrap(a[..., i, :]) for i in range(lo, hi)]


_ONE12 = np.zeros((12, LANES), dtype=np.int32)
_ONE12[0] = RC.ONE


def zero(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, 12, LANES), dtype=torch.int32,
                       device=fp.resolve_device(device))


def one(batch_shape=(), device=None) -> torch.Tensor:
    o = fp.const_on(("one12",), fp.resolve_device(device), _ONE12)
    return o.expand(*batch_shape, 12, LANES)


def encode(x) -> np.ndarray:
    """refmodel.Fq12 (nested lists ok) -> (..., 12, LANES) numpy rows."""
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


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask: packed lane mask (..., LANES): each element's 64-lane slot
    selects on its own."""
    return torch.where(mask[..., None, :] != 0, a, b)


def is_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., PACK) bools per packed element."""
    return fp.is_equal(a, b).all(dim=-2)  # reduce the 12-comp axis


def connect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The equality constraint (fp.connect): an rns_connect row of the 12
    components, and a == b per packed element (..., PACK)."""
    return fp.connect(a, b).all(dim=-2)


def _kernels():
    from . import kernels  # imported late: kernels imports this module

    return kernels


def is_one(a: torch.Tensor) -> torch.Tensor:
    return is_equal(a, one(a.shape[:-2], a.device))


def _mul_terms(a: torch.Tensor, b: torch.Tensor) -> list[R]:
    """The 12 lazy outputs of the Fq12 product, before their REDC."""
    a0, a1 = _comps(a, 0, 6), _comps(a, 6, 12)
    b0, b1 = _comps(b, 0, 6), _comps(b, 6, 12)
    asum = _canon_list(_list_add(a0, a1))
    bsum = _canon_list(_list_add(b0, b1))
    t0 = _fq6_mul(a0, b0)
    t1 = _fq6_mul(a1, b1)
    t01 = _fq6_mul(asum, bsum)
    out0 = _list_add(t0, _fq6_nonres(t1))
    out1 = _list_sub(_list_sub(t01, t0), t1)
    return out0 + out1


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp.redc_stack(_mul_terms(a, b))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba over Fq6 with w^2 = v."""
    return _kernels().fq12_mul(a, b)


def _square_terms(a: torch.Tensor) -> list[R]:
    """The 12 lazy outputs of the complex squaring, before their REDC."""
    a0, a1 = _comps(a, 0, 6), _comps(a, 6, 12)
    s = _canon_list(_list_add(a0, a1))
    # t = a0 + v*a1 with v*a1 = (xi*(a1c2), a1c0, a1c1); negatives are free.
    va1 = _fq6_nonres(a1)
    t = _canon_list(_list_add(a0, va1))
    ab = _fq6_mul(a0, a1)
    st = _fq6_mul(s, t)
    out0 = _list_sub(_list_sub(st, ab), _fq6_nonres(ab))
    out1 = [x.scale(2) for x in ab]
    return out0 + out1


def square_plain(a: torch.Tensor) -> torch.Tensor:
    return fp.redc_stack(_square_terms(a))


def square(a: torch.Tensor) -> torch.Tensor:
    """Complex squaring: c0 = (a0+a1)(a0 + v a1) - ab - v ab, c1 = 2 ab."""
    return _kernels().fq12_square(a)


def _mul014_terms(a: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
                  d4: torch.Tensor) -> list[R]:
    """The 12 lazy outputs of the sparse product, before their REDC."""
    a0, a1 = _comps(a, 0, 6), _comps(a, 6, 12)
    d00, d01 = fp.wrap(d0[..., 0, :]), fp.wrap(d0[..., 1, :])
    d10, d11 = fp.wrap(d1[..., 0, :]), fp.wrap(d1[..., 1, :])
    d40, d41 = fp.wrap(d4[..., 0, :]), fp.wrap(d4[..., 1, :])
    asum = _canon_list(_list_add(a0, a1))
    aa = _fq6_mul_by_01(a0, d00, d01, d10, d11)
    bb = _fq6_mul_by_1(a1, d40, d41)
    t1 = _fq6_mul_by_01(asum, d00, d01, d10 + d40, d11 + d41)
    out0 = _list_add(_fq6_nonres(bb), aa)
    out1 = _list_sub(_list_sub(t1, aa), bb)
    return out0 + out1


def mul_by_014_plain(a: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
                     d4: torch.Tensor) -> torch.Tensor:
    return fp.redc_stack(_mul014_terms(a, d0, d1, d4))


def mul_by_014(a: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
               d4: torch.Tensor) -> torch.Tensor:
    """Sparse product with (d0 + d1 v) + (d4 v) w; d0/d1/d4: (..., 2, LANES)
    stored Fq2 operands."""
    return _kernels().fq12_mul_by_014(a, d0, d1, d4)


def mul_by_014_square_plain(a: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
                            d4: torch.Tensor, skip=None) -> torch.Tensor:
    f = mul_by_014_plain(a, d0, d1, d4)
    if skip is not None:
        f = select(skip, a, f)
    return square_plain(f)


def mul_by_014_square(a: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
                      d4: torch.Tensor, skip=None) -> torch.Tensor:
    """square(mul_by_014(a, d)): the Miller step's ell and square back to
    back. With skip (a packed lane mask (..., LANES)) the elements it marks
    keep a through the sparse product, as the Miller loop's identity-select
    for infinity terms does: square(select(skip, a, mul_by_014(a, d)))."""
    return _kernels().fq12_mul_by_014_square(a, d0, d1, d4, skip)


def conjugate(a: torch.Tensor) -> torch.Tensor:
    """f^(p^6): negate the w-part (4p - x, canonical channels)."""
    negc1 = fp.barrett(fp.cst(("pmul", 4), a) - a[..., 6:12, :])
    return torch.cat([a[..., 0:6, :], negc1], dim=-2)


# -- cyclotomic squaring ----------------------------------------------------


def _fp4_square(a0: R, a1: R, b0: R, b1: R):
    """Fq4 square."""
    t0 = fq2_mul_r(a0, a1, a0, a1)
    t1 = fq2_mul_r(b0, b1, b0, b1)
    t2 = fq2_mul_r(a0 + b0, a1 + b1, a0 + b0, a1 + b1)
    t2 = _pair_sub(_pair_sub(t2, t0), t1)
    return _pair_add(fq2_nonres(t1), t0), t2


def _cyc_square_terms(a: torch.Tensor) -> list[R]:
    """The 12 lazy outputs of the Granger-Scott squaring, before their REDC."""
    w = lambda i: fp.wrap(a[..., i, :])
    tp = lambda i: fp.to_prod(a[..., i, :])
    z0, z4, z3 = (w(0), w(1)), (w(2), w(3)), (w(4), w(5))
    z2, z1, z5 = (w(6), w(7)), (w(8), w(9)), (w(10), w(11))

    t0_01, t1_01 = _fp4_square(*z0, *z1)
    t0_23, t1_23 = _fp4_square(*z2, *z3)
    t2_45, t3_45 = _fp4_square(*z4, *z5)

    # the bare 2*z terms must be lifted into the product domain before mixing
    # with the Fq4-square products (fp.to_prod)
    z0w, z4w, z3w = (tp(0), tp(1)), (tp(2), tp(3)), (tp(4), tp(5))
    z2w, z1w, z5w = (tp(6), tp(7)), (tp(8), tp(9)), (tp(10), tp(11))

    nz0 = _pair_sub(_pair_scale(t0_01, 3), _pair_scale(z0w, 2))
    nz1 = _pair_add(_pair_scale(t1_01, 3), _pair_scale(z1w, 2))
    nz4 = _pair_sub(_pair_scale(t0_23, 3), _pair_scale(z4w, 2))
    nz5 = _pair_add(_pair_scale(t1_23, 3), _pair_scale(z5w, 2))
    t3xi = fq2_nonres(t3_45)
    nz2 = _pair_add(_pair_scale(t3xi, 3), _pair_scale(z2w, 2))
    nz3 = _pair_sub(_pair_scale(t2_45, 3), _pair_scale(z3w, 2))
    return [nz0[0], nz0[1], nz4[0], nz4[1], nz3[0], nz3[1],
            nz2[0], nz2[1], nz1[0], nz1[1], nz5[0], nz5[1]]


def cyclotomic_square_plain(a: torch.Tensor) -> torch.Tensor:
    return fp.redc_stack(_cyc_square_terms(a))


def cyclotomic_square(a: torch.Tensor) -> torch.Tensor:
    """Granger-Scott squaring of a cyclotomic element."""
    return _kernels().fq12_cyclotomic_square(a)


# -- Karabina compressed cyclotomic squaring --------------------------------
#
# eprint 2010/542 (Karabina, "Squaring in cyclotomic subgroups"), in the
# Granger-Scott Fp4-tower labelling used by cyclotomic_square: a cyclotomic
# element is represented by (g2, g3, g4, g5) alone; a squaring costs 4 Fq2
# products and 8 REDC rows (9 and 12 for full Granger-Scott), and the dropped
# (g0, g1) are recovered with one Fq2 inversion, which all decompressions of
# an exponentiation share through the batched fp.inv.

#: Flat component indices of (g2, g3, g4, g5): in the GS labelling
#: g2 = c1.c0, g3 = c0.c2, g4 = c0.c1, g5 = c1.c2.
_KARA_IDX = [6, 7, 4, 5, 2, 3, 10, 11]


def compress_cyclotomic(a: torch.Tensor) -> torch.Tensor:
    """(..., 12, LANES) cyclotomic element -> (..., 8, LANES) compressed: the
    Fq2 pairs of _KARA_IDX as slices (an index list would be a tensor made
    from host data on every call)."""
    return torch.cat([a[..., i:i + 2, :] for i in _KARA_IDX[::2]], dim=-2)


def _kpairs(c: torch.Tensor):
    g = lambda i: (fp.wrap(c[..., 2 * i, :]), fp.wrap(c[..., 2 * i + 1, :]))
    return g(0), g(1), g(2), g(3)  # g2, g3, g4, g5


def _to_prod_pair(c: torch.Tensor, i: int) -> tuple[R, R]:
    """The i-th Fq2 component lifted into the product domain."""
    return fp.to_prod(c[..., 2 * i, :]), fp.to_prod(c[..., 2 * i + 1, :])


def _kara_square_terms(c: torch.Tensor) -> list[R]:
    """The 8 lazy outputs of one Karabina squaring, before their REDC."""
    g2, g3, g4, g5 = _kpairs(c)
    B45 = fq2_mul_r(*g4, *g5)
    A45 = fq2_mul_r(g4[0] + g5[0], g4[1] + g5[1],
                    g4[0] + g5[0] - g5[1], g4[1] + g5[0] + g5[1])
    B23 = fq2_mul_r(*g2, *g3)
    A23 = fq2_mul_r(g2[0] + g3[0], g2[1] + g3[1],
                    g2[0] + g3[0] - g3[1], g2[1] + g3[0] + g3[1])
    t45 = _pair_sub(_pair_sub(A45, B45), fq2_nonres(B45))  # g4^2 + xi g5^2
    t23 = _pair_sub(_pair_sub(A23, B23), fq2_nonres(B23))  # g2^2 + xi g3^2
    g2p, g3p, g4p, g5p = (_to_prod_pair(c, i) for i in range(4))
    h2 = _pair_add(_pair_scale(g2p, 2), _pair_scale(fq2_nonres(B45), 6))
    h3 = _pair_sub(_pair_scale(t45, 3), _pair_scale(g3p, 2))
    h4 = _pair_sub(_pair_scale(t23, 3), _pair_scale(g4p, 2))
    h5 = _pair_add(_pair_scale(g5p, 2), _pair_scale(B23, 6))
    return [h2[0], h2[1], h3[0], h3[1], h4[0], h4[1], h5[0], h5[1]]


def compressed_square_plain(c: torch.Tensor) -> torch.Tensor:
    return fp.redc_stack(_kara_square_terms(c))


def compressed_square(c: torch.Tensor) -> torch.Tensor:
    """One Karabina squaring on (..., 8, LANES) compressed data."""
    return _kernels().kara_square_run(c, 1)


#: Stored row of 4^-1 mod p.
_QUARTER = RC.encode_int(pow(4, -1, RC.P))


def quarter(like: torch.Tensor) -> R:
    return fp.wrap(fp.cst(("kara_quarter",), like, _QUARTER))


# decompress_cyclotomic in its pieces, each the lazy inputs of one stacked
# REDC; kernels.kara_full_plain puts the same pieces together in the order of
# the whole-exponentiation kernel.


def _decompress_num_terms(c: torch.Tensor) -> list[R]:
    """The two candidate numerators of g1 (times 4): xi g5^2 + 3 g4^2 - 2 g3
    for g2 != 0 and 8 g4 g5 for g2 == 0, as 4 lazy values."""
    _, _, g4, g5 = _kpairs(c)
    g3p = _to_prod_pair(c, 1)
    g5sq = fq2_mul_r(*g5, *g5)
    g4sq = fq2_mul_r(*g4, *g4)
    g4g5 = fq2_mul_r(*g4, *g5)
    num1 = _pair_sub(_pair_add(fq2_nonres(g5sq), _pair_scale(g4sq, 3)),
                     _pair_scale(g3p, 2))
    num2 = _pair_scale(g4g5, 8)
    return [num1[0], num1[1], num2[0], num2[1]]


def _decompress_select(c: torch.Tensor, s1: torch.Tensor):
    """Numerator (of the reduced candidates s1) and denominator of g1 per
    packed element: (num2, g3) where g2 == 0, else (num1, g2)."""
    z2 = fp.is_zero(c[..., 0, :]) & fp.is_zero(c[..., 1, :])  # (..., PACK)
    zlane = fp.slot_lanes(z2)[..., None, :]
    num = torch.where(zlane, s1[..., 2:4, :], s1[..., 0:2, :])
    den = torch.where(zlane, c[..., 2:4, :], c[..., 0:2, :])
    return num, den


def _decompress_g1_terms(num: torch.Tensor, dq: torch.Tensor) -> list[R]:
    """g1 = num * dq, dq the denominator's inverse over 4."""
    return list(fq2_mul_r(fp.wrap(num[..., 0, :]), fp.wrap(num[..., 1, :]),
                          fp.wrap(dq[..., 0, :]), fp.wrap(dq[..., 1, :])))


def _decompress_g0_terms(c: torch.Tensor, g1s: torch.Tensor) -> list[R]:
    """g0 = xi (2 g1^2 + g2 g5 - 3 g3 g4) + 1."""
    g2, g3, g4, g5 = _kpairs(c)
    g1 = (fp.wrap(g1s[..., 0, :]), fp.wrap(g1s[..., 1, :]))
    g1sq = fq2_mul_r(*g1, *g1)
    g2g5 = fq2_mul_r(*g2, *g5)
    g3g4 = fq2_mul_r(*g3, *g4)
    inner = _pair_sub(_pair_add(_pair_scale(g1sq, 2), g2g5),
                      _pair_scale(g3g4, 3))
    one_p = fp.to_prod(fp.cst(("one",), c).expand(c[..., 0, :].shape))
    g0w = _pair_add(fq2_nonres(inner), (one_p, one_p.scale(0)))
    return [g0w[0], g0w[1]]


def _decompress_assemble(c: torch.Tensor, g0s: torch.Tensor,
                         g1s: torch.Tensor) -> torch.Tensor:
    """Flat tower order: c0 = (g0, g4, g3), c1 = (g2, g1, g5)."""
    return torch.cat([g0s, c[..., 4:6, :], c[..., 2:4, :], c[..., 0:2, :],
                      g1s, c[..., 6:8, :]], dim=-2)


def decompress_cyclotomic(c: torch.Tensor) -> torch.Tensor:
    """(..., 8, LANES) compressed -> (..., 12, LANES) full element.

    g1 = (xi g5^2 + 3 g4^2 - 2 g3) / (4 g2)            (g2 != 0)
       = (8 g4 g5) / (4 g3)                            (g2 == 0)
    g0 = xi (2 g1^2 + g2 g5 - 3 g3 g4) + 1  (covers both cases: g2 g5 = 0
    when g2 = 0), and all-zero input decompresses to one, the identity.
    All elements of c share one batched inversion."""
    s1 = fp.redc_stack(_decompress_num_terms(c))
    num, den = _decompress_select(c, s1)
    dinv = _fq2_inv(den)
    q = quarter(c)
    dq = fp.redc_stack([fp.mul_rr(fp.wrap(dinv[..., 0, :]), q),
                        fp.mul_rr(fp.wrap(dinv[..., 1, :]), q)])  # dinv / 4
    g1s = fp.redc_stack(_decompress_g1_terms(num, dq))
    g0s = fp.redc_stack(_decompress_g0_terms(c, g1s))
    return _decompress_assemble(c, g0s, g1s)


# -- Frobenius --------------------------------------------------------------

# Combined gamma constants: the fq6-level twists (gamma6_1, gamma6_2) and the
# fq12-level gamma12 products, in RNS Montgomery form.
def _enc_fq2(x: rm.Fq2) -> np.ndarray:
    return np.stack([RC.encode_int(x.c0), RC.encode_int(x.c1)])


_G6_1 = rm.FROB_GAMMA6_1[1]
_G6_2 = rm.FROB_GAMMA6_2[1]
_G12 = rm.FROB_GAMMA12[1]
FROB_C = {
    "g6_1": _enc_fq2(_G6_1),
    "g6_2": _enc_fq2(_G6_2),
    "g12": _enc_fq2(_G12),
    "g12_1": _enc_fq2(_G6_1 * _G12),
    "g12_2": _enc_fq2(_G6_2 * _G12),
}


def _const_pair(name: str, like: torch.Tensor):
    arr = FROB_C[name]
    return (fp.wrap(fp.cst(("frob", name, 0), like, arr[0])),
            fp.wrap(fp.cst(("frob", name, 1), like, arr[1])))


def _conj_pair(a: torch.Tensor, i: int) -> tuple[R, R]:
    """Conjugate of the i-th Fq2 component as an R pair (negation via 4p-x)."""
    c0 = fp.wrap(a[..., 2 * i, :])
    c1 = fp.neg_r(fp.wrap(a[..., 2 * i + 1, :]), 4)
    return c0, c1


def frobenius_map(a: torch.Tensor) -> torch.Tensor:
    """One Frobenius power with the gamma6*gamma12 products folded: out c0 =
    (conj c00, conj c01 * g6_1, conj c02 * g6_2), out c1 = (conj c10 * g12,
    conj c11 * g6_1*g12, conj c12 * g6_2*g12); ONE stacked REDC for the 10
    multiplied components."""
    names = [None, "g6_1", "g6_2", "g12", "g12_1", "g12_2"]
    outs: list[R] = []
    for i, name in enumerate(names):
        if name is None:
            continue
        pair = _conj_pair(a, i)
        g = _const_pair(name, a)
        outs.extend(fq2_mul_r(pair[0], pair[1], g[0], g[1]))
    prod = fp.redc_stack(outs)  # (..., 10, LANES)
    c01 = fp.barrett(fp.cst(("pmul", 4), a) - a[..., 1:2, :])
    return torch.cat([a[..., 0:1, :], c01, prod], dim=-2)


def frobenius_pow(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = frobenius_map(a)
    return a


# -- inversion --------------------------------------------------------------


def _fq2_norm(a: torch.Tensor) -> torch.Tensor:
    """c0^2 + c1^2 as a stored Fp element."""
    c0 = fp.wrap(a[..., 0, :])
    c1 = fp.wrap(a[..., 1, :])
    return fp.redc(fp.mul_rr(c0, c0) + fp.mul_rr(c1, c1))


def _fq2_conj_scaled_terms(a: torch.Tensor, w: R) -> list[R]:
    """The 2 lazy outputs of (c0 - c1 u) * w, w in Fp."""
    c0 = fp.wrap(a[..., 0, :])
    c1 = fp.wrap(a[..., 1, :])
    return [fp.mul_rr(c0, w), fp.mul_rr(fp.neg_r(c1, 4), w)]


def _fq2_inv(a: torch.Tensor) -> torch.Tensor:
    """(c0 - c1 u)/(c0^2 + c1^2): one batched Fp inverse."""
    w = fp.wrap(fp.inv(_fq2_norm(a)))
    return fp.redc_stack(_fq2_conj_scaled_terms(a, w))


def _fq6_inv(a: torch.Tensor) -> torch.Tensor:
    """Adjugate/norm closed form, a: (..., 6, LANES)."""
    c = [fp.wrap(a[..., i, :]) for i in range(6)]
    a0, a1, a2 = (c[0], c[1]), (c[2], c[3]), (c[4], c[5])
    sq0 = fq2_mul_r(*a0, *a0)
    m12 = fq2_mul_r(*a1, *a2)
    t0 = _pair_sub(sq0, fq2_nonres(m12))
    sq2 = fq2_mul_r(*a2, *a2)
    m01 = fq2_mul_r(*a0, *a1)
    t1 = _pair_sub(fq2_nonres(sq2), m01)
    sq1 = fq2_mul_r(*a1, *a1)
    m02 = fq2_mul_r(*a0, *a2)
    t2 = _pair_sub(sq1, m02)
    ts = fp.redc_stack([t0[0], t0[1], t1[0], t1[1], t2[0], t2[1]])
    t0s = (fp.wrap(ts[..., 0, :]), fp.wrap(ts[..., 1, :]))
    t1s = (fp.wrap(ts[..., 2, :]), fp.wrap(ts[..., 3, :]))
    t2s = (fp.wrap(ts[..., 4, :]), fp.wrap(ts[..., 5, :]))
    n0 = fq2_mul_r(*a0, *t0s)
    n1 = fq2_mul_r(*a2, *t1s)
    n2 = fq2_mul_r(*a1, *t2s)
    norm_w = _pair_add(n0, fq2_nonres(_pair_add(n1, n2)))
    norm = fp.redc_stack([norm_w[0], norm_w[1]])
    ninv = _fq2_inv(norm)
    iv = (fp.wrap(ninv[..., 0, :]), fp.wrap(ninv[..., 1, :]))
    outs = []
    for t in (t0s, t1s, t2s):
        outs.extend(fq2_mul_r(*t, *iv))
    return fp.redc_stack(outs)


def inv(a: torch.Tensor) -> torch.Tensor:
    """(c0 - c1 w)/(c0^2 - v c1^2)."""
    a0 = _comps(a, 0, 6)
    a1 = _comps(a, 6, 12)
    sq0 = _fq6_mul(a0, a0)
    sq1 = _fq6_mul(a1, a1)
    t = fp.redc_stack(_list_sub(sq0, _fq6_nonres(sq1)))
    ti = _comps(_fq6_inv(t), 0, 6)
    out0 = _fq6_mul(a0, ti)
    out1 = _fq6_mul([fp.neg_r(x, 4) for x in a1], ti)
    return fp.redc_stack(out0 + out1)


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b = a * b^-1 (b = 0 gives 0: inv maps 0 to 0)."""
    return mul(a, inv(b))


def conditional_mul(a: torch.Tensor, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """a * x where the packed lane mask (..., LANES) is set, else a."""
    return select(mask, mul(a, x), a)
