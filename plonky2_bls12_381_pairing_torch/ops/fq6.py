"""Batched Fq6 = Fq2[v]/(v^3 - (u+1)) on limb vectors, the counterpart of the
JAX package's ops/fq6.py: an element is (..., 6, NLIMBS) Montgomery limbs in
flat memory order [c0.c0, c0.c1, c1.c0, c1.c1, c2.c0, c2.c1].

Products use the interpolation-style formulas in *wide* (unreduced-column)
form: 6 Fq2 wide products are combined with cheap column adds/subs and
reduced once per output component (one stacked Montgomery reduction for all
6 Fp components).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..utils import refmodel as rm
from . import fp, fq2

WideTriple = tuple[fq2.WidePair, fq2.WidePair, fq2.WidePair]


def c(a: torch.Tensor, i: int) -> torch.Tensor:
    """i-th Fq2 component, (..., 2, NLIMBS)."""
    return a[..., 2 * i : 2 * i + 2, :]


def pack(x0: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return torch.cat([x0, x1, x2], dim=-2)


def zero(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, 6, fp.NLIMBS), dtype=torch.int32,
                       device=fp.resolve_device(device))


def one(batch_shape=(), device=None) -> torch.Tensor:
    return pack(fq2.one(batch_shape, device), fq2.zero(batch_shape, device),
                fq2.zero(batch_shape, device))


def encode(x) -> np.ndarray:
    arr = np.asarray(x, dtype=object)
    parts = np.empty(arr.shape + (3,), dtype=object)
    for idx in np.ndindex(arr.shape):
        parts[idx + (0,)] = arr[idx].c0
        parts[idx + (1,)] = arr[idx].c1
        parts[idx + (2,)] = arr[idx].c2
    enc = fq2.encode(parts)  # (..., 3, 2, NLIMBS)
    return enc.reshape(*enc.shape[:-3], 6, fp.NLIMBS)


def decode(a):
    arr = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    parts = fq2.decode(arr.reshape(*arr.shape[:-2], 3, 2, fp.NLIMBS))
    shape = parts.shape[:-1]
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        out[idx] = rm.Fq6(parts[idx + (0,)], parts[idx + (1,)], parts[idx + (2,)])
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


def mul_by_nonresidue(a: torch.Tensor) -> torch.Tensor:
    """v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2
    (reference fq6_target_tree.rs:219-230)."""
    return pack(fq2.mul_by_nonresidue(c(a, 2)), c(a, 0), c(a, 1))


def select(mask, a, b):
    return torch.where(mask[..., None, None] != 0, a, b)


def is_zero(a):
    return (fp.canonicalize(a) == 0).all(-1).all(-1)


def is_equal(a, b):
    return (fp.canonicalize(a) == fp.canonicalize(b)).all(-1).all(-1)


def connect(a, b):
    """The equality constraint (fp.connect): a connect row and a == b."""
    return fp.connect(a, b)


def conditional_mul(a, x, flag):
    """a * x where flag (...,) is set, else a."""
    return select(flag, mul(a, x), a)


# ---------------------------------------------------------------------------
# Wide products (interpolation formulas, lazily reduced)
# ---------------------------------------------------------------------------


def _mul_combine(r: list) -> WideTriple:
    """s0 = t0 + xi*(m12 - t1 - t2), s1 = m01 - t0 - t1 + xi*t2,
    s2 = m02 - t0 - t2 + t1."""
    t0, t1, t2, m12, m01, m02 = r
    s0 = fq2.add_wide(t0, fq2.mul_by_nonresidue_wide(fq2.sub_wide(fq2.sub_wide(m12, t1), t2)))
    s1 = fq2.add_wide(fq2.sub_wide(fq2.sub_wide(m01, t0), t1), fq2.mul_by_nonresidue_wide(t2))
    s2 = fq2.add_wide(fq2.sub_wide(fq2.sub_wide(m02, t0), t2), t1)
    return (s0, s1, s2)


def mul_products(a: torch.Tensor, b: torch.Tensor) -> fp.Products:
    """s0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    s1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    s2 = (a0+a2)(b0+b2) - t0 - t2 + t1        (fq6_target_tree.rs:172-214):
    21 convolutions."""
    a0, a1, a2 = c(a, 0), c(a, 1), c(a, 2)
    b0, b1, b2 = c(b, 0), c(b, 1), c(b, 2)
    return fp.gather([fq2.mul_products(a0, b0), fq2.mul_products(a1, b1),
                      fq2.mul_products(a2, b2), _sum_products(a1, a2, b1, b2),
                      _sum_products(a0, a1, b0, b1), _sum_products(a0, a2, b0, b2)],
                     _mul_combine)


def _sum_products(x0, x1, y0, y1) -> fp.Products:
    """fq2 product of limb-wise sums (x0+x1)(y0+y1), 9-bit operand limbs."""
    d2, v2 = 2 * fp.SEMI_DIG, 2 * fp.SEMI_VAL
    return fq2.mul_generic_products(x0 + x1, y0 + y1, x_max=d2, x_val=v2,
                                    y_max=d2, y_val=v2)


def square_products(a: torch.Tensor) -> fp.Products:
    return mul_products(a, a)


def _mul_by_01_combine(r: list) -> WideTriple:
    t0, t1, m12, m01, t2 = r
    s0 = fq2.add_wide(fq2.mul_by_nonresidue_wide(fq2.sub_wide(m12, t1)), t0)
    s1 = fq2.sub_wide(fq2.sub_wide(m01, t0), t1)
    s2 = fq2.add_wide(t2, t1)
    return (s0, s1, s2)


def mul_by_01_products(a: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor) -> fp.Products:
    """Sparse product with (b0 + b1 v) (reference fq6_target_tree.rs:232-259):
    s0 = xi*((a1+a2)*b1 - t1) + t0
    s1 = (b0+b1)(a0+a1) - t0 - t1
    s2 = a2*b0 + t1:  17 convolutions."""
    a0, a1, a2 = c(a, 0), c(a, 1), c(a, 2)
    return fp.gather([fq2.mul_products(a0, b0), fq2.mul_products(a1, b1),
                      _half_products(a1 + a2, b1), _half_products(a0 + a1, b0 + b1),
                      fq2.mul_products(a2, b0)], _mul_by_01_combine)


def _half_products(xs: torch.Tensor, ys: torch.Tensor) -> fp.Products:
    """fq2 product where either operand may have limbs <= 510."""
    d2, v2 = 2 * fp.SEMI_DIG, 2 * fp.SEMI_VAL
    return fq2.mul_generic_products(xs, ys, x_max=d2, x_val=v2,
                                    y_max=d2, y_val=v2)


def _mul_by_1_combine(r: list) -> WideTriple:
    t2, t0, t1 = r
    return (fq2.mul_by_nonresidue_wide(t2), t0, t1)


def mul_by_1_products(a: torch.Tensor, b1: torch.Tensor) -> fp.Products:
    """Sparse product with (b1 v) (reference fq6_target_tree.rs:261-268):
    (xi*(a2*b1), a0*b1, a1*b1): 9 convolutions."""
    return fp.gather([fq2.mul_products(c(a, 2), b1), fq2.mul_products(c(a, 0), b1),
                      fq2.mul_products(c(a, 1), b1)], _mul_by_1_combine)


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> WideTriple:
    return fp.form(mul_products(a, b))[0]


def square_wide(a: torch.Tensor) -> WideTriple:
    return mul_wide(a, a)


def mul_by_01_wide(a: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor) -> WideTriple:
    return fp.form(mul_by_01_products(a, b0, b1))[0]


def mul_by_1_wide(a: torch.Tensor, b1: torch.Tensor) -> WideTriple:
    return fp.form(mul_by_1_products(a, b1))[0]


def mul_by_nonresidue_wide(t: WideTriple) -> WideTriple:
    return (fq2.mul_by_nonresidue_wide(t[2]), t[0], t[1])


def add_wide(x: WideTriple, y: WideTriple) -> WideTriple:
    return tuple(fq2.add_wide(a, b) for a, b in zip(x, y))


def sub_wide(x: WideTriple, y: WideTriple) -> WideTriple:
    return tuple(fq2.sub_wide(a, b) for a, b in zip(x, y))


def reduce(t: WideTriple) -> torch.Tensor:
    """One stacked Montgomery reduction for all 6 Fp components."""
    return fp.mont_reduce_stack([t[0][0], t[0][1], t[1][0], t[1][1], t[2][0], t[2][1]])


# ---------------------------------------------------------------------------
# Canonical multiplicative ops
# ---------------------------------------------------------------------------


def mul(a, b):
    return reduce(mul_wide(a, b))


def square(a):
    return reduce(square_wide(a))


def mul_by_01(a, b0, b1):
    return reduce(mul_by_01_wide(a, b0, b1))


def mul_by_1(a, b1):
    return reduce(mul_by_1_wide(a, b1))


_FROB: dict = {}


def frob_const(name: str, device) -> torch.Tensor:
    """A Frobenius coefficient of constants.py, (2, NLIMBS), on `device`."""
    key = (name, torch.device(device))
    if key not in _FROB:
        _FROB[key] = torch.from_numpy(getattr(C, name)).to(device)
    return _FROB[key]


def inv(a: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate/norm inverse (reference fq6_target_tree.rs:59-89):
    t0 = a0^2 - xi a1 a2; t1 = xi a2^2 - a0 a1; t2 = a1^2 - a0 a2
    norm = a0 t0 + xi (a2 t1 + a1 t2);  out = (t0, t1, t2) * norm^-1.
    Three groups of products: the t's, the norm's, the scalings. Records an
    fq6_inv row."""
    a0, a1, a2 = c(a, 0), c(a, 1), c(a, 2)
    sq0, m12, sq2, m01, sq1, m02 = fp.form(
        fq2.square_products(a0), fq2.mul_products(a1, a2), fq2.square_products(a2),
        fq2.mul_products(a0, a1), fq2.square_products(a1), fq2.mul_products(a0, a2))
    t0 = fq2.reduce(fq2.sub_wide(sq0, fq2.mul_by_nonresidue_wide(m12)))
    t1 = fq2.reduce(fq2.sub_wide(fq2.mul_by_nonresidue_wide(sq2), m01))
    t2 = fq2.reduce(fq2.sub_wide(sq1, m02))
    n0, n2, n1 = fp.form(fq2.mul_products(a0, t0), fq2.mul_products(a2, t1),
                         fq2.mul_products(a1, t2))
    norm = fq2.reduce(fq2.add_wide(n0, fq2.mul_by_nonresidue_wide(fq2.add_wide(n2, n1))))
    ninv = fq2.inv(norm)
    out = pack(*fq2.mul_group(*(fq2.mul_products(t, ninv) for t in (t0, t1, t2))))
    fp._record("fq6_inv", a, out)
    return out


def frobenius_products(a: torch.Tensor) -> fp.Products:
    """The two products of frobenius_map: gamma6_1 c1^p and gamma6_2 c2^p."""
    g1 = frob_const("FROB_GAMMA6_1_MONT", a.device)
    g2 = frob_const("FROB_GAMMA6_2_MONT", a.device)
    return fp.gather([fq2.mul_products(fq2.conjugate(c(a, 1)), g1.expand_as(c(a, 1))),
                      fq2.mul_products(fq2.conjugate(c(a, 2)), g2.expand_as(c(a, 2)))])


def frobenius_finish(a: torch.Tensor, w: list) -> torch.Tensor:
    return pack(fq2.conjugate(c(a, 0)), fq2.reduce(w[0]), fq2.reduce(w[1]))


def frobenius_map(a: torch.Tensor) -> torch.Tensor:
    """c0^p + gamma6_1 c1^p v + gamma6_2 c2^p v^2 with the generated constants
    (reference fq6_target_tree.rs:129-169)."""
    return frobenius_finish(a, fp.form(frobenius_products(a))[0])
