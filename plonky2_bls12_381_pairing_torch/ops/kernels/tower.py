"""The limb tier's fused Fq12 tower kernels (the JAX package's
ops/pallas/tower.py): hand-written CUDA kernels, their plain PyTorch versions
and their wrappers.

  fq12_mul(a, b)               <- pallas/tower.py fq12_mul
  fq12_square(a)               <- pallas/tower.py fq12_square
  fq12_mul_by_014(a, d)        <- pallas/tower.py fq12_mul_by_014
  fq12_cyclotomic_square(a)    <- pallas/tower.py fq12_cyclotomic_square
                                                  (all in csrc/limb_tower.cu)

A whole Fq12 formula per call: every product of the formula is a product of
two linear combinations of the *input* components (no product feeds another),
so a formula is three tables, read off once by tracing it symbolically
(`formula`):
  operands   each product's two operands as signed sums of input components
             (and the constant rows NEGC and R mod p);
  outputs    each of the 12 output wides as a signed integer combination of
             the products;
  bounds     the merged column bounds of the 12 outputs, which fix the pass
             count of the one stacked reduction.
The plain version and the CUDA kernel both execute these tables: stacked
products, wide combines, one merged reduction. The formulas below mirror
ops/fq2.py / fq6.py / fq12.py in the Montgomery domain. One stacked reduction
with merged bounds yields another weakly reduced representative than the
composition path's per-stage reductions: equal in value, other rows.

Each wrapper runs its plain version for a tensor on the CPU and launches its
kernel for a tensor on a CUDA device; there is no fallback between the two.
`launches` counts kernel launches per wrapper.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ... import constants as C
from .. import cuda_build, fp
from ..cuda_build import INT, PTR, STRIDE
from . import mont

NLIMBS = C.NLIMBS
_P = C.P
_RP = (1 << C.R_BITS) * _P
_SD = C.SEMI_DIG
_PMAX = C.SEMI_VAL

#: operand slots: 12 components of a, up to 12 of the second operand, then
#: the constant rows NEGC (relaxed negation) and ONE_MONT (R mod p, which
#: lifts a stored component into the product domain: fp.to_wide_mont)
SLOT_B, SLOT_NEGC, SLOT_ONE, NSLOTS = 12, 24, 25, 26
#: most terms of an operand's sum, most products of a formula
MAX_TERMS, MAX_PRODUCTS = 8, 54

_KERNELS = {
    "limb_fq12_mul": ("limb_tower.cu", "limb_fq12_mul_launch",
                      [PTR, STRIDE] * 2 + [PTR, INT, PTR]),
    "limb_fq12_square": ("limb_tower.cu", "limb_fq12_square_launch",
                         [PTR, STRIDE, PTR, INT, PTR]),
    "limb_fq12_mul_by_014": ("limb_tower.cu", "limb_fq12_mul_by_014_launch",
                             [PTR, STRIDE] * 2 + [PTR, INT, PTR]),
    "limb_fq12_cyclotomic_square": ("limb_tower.cu",
                                    "limb_fq12_cyclotomic_square_launch",
                                    [PTR, STRIDE, PTR, INT, PTR]),
}

#: Kernel launches per wrapper since the last reset_launches().
launches = {name: 0 for name in _KERNELS}
cuda_build.register(_KERNELS, launches)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Symbolic tracing of a formula
# ---------------------------------------------------------------------------


class Lin:
    """A conv operand: a signed sum of operand slots."""

    def __init__(self, terms: dict):
        self.terms = {s: c for s, c in terms.items() if c}

    def __add__(self, o: "Lin") -> "Lin":
        return Lin({s: self.terms.get(s, 0) + o.terms.get(s, 0)
                    for s in {*self.terms, *o.terms}})

    def __sub__(self, o: "Lin") -> "Lin":
        return Lin({s: self.terms.get(s, 0) - o.terms.get(s, 0)
                    for s in {*self.terms, *o.terms}})


class W:
    """A wide with static bounds (fp.Wide's bound rules, with scale's floor
    at 0): a signed integer combination of the formula's products."""

    def __init__(self, terms, lo, hi, vlo, vhi):
        self.terms = {p: c for p, c in terms.items() if c}
        self.lo, self.hi, self.vlo, self.vhi = lo, hi, vlo, vhi

    def __add__(self, o):
        return W({p: self.terms.get(p, 0) + o.terms.get(p, 0)
                  for p in {*self.terms, *o.terms}},
                 self.lo + o.lo, self.hi + o.hi, self.vlo + o.vlo, self.vhi + o.vhi)

    def __sub__(self, o):
        return W({p: self.terms.get(p, 0) - o.terms.get(p, 0)
                  for p in {*self.terms, *o.terms}},
                 self.lo - o.hi, self.hi - o.lo, self.vlo - o.vhi, self.vhi - o.vlo)

    def scale(self, k: int):
        return W({p: c * k for p, c in self.terms.items()}, min(self.lo * k, 0),
                 self.hi * k, min(self.vlo * k, 0), self.vhi * k)


class ConvBatch:
    """Collects the operand pairs pushed while a formula is traced; get(i)
    hands back product i as a wide with its own static bounds."""

    def __init__(self):
        self.pairs, self._meta = [], []

    def push(self, a: Lin, b: Lin, am, bm, av, bv) -> int:
        assert NLIMBS * am * bm < (1 << 31), "int32 conv overflow"
        self.pairs.append((a, b))
        self._meta.append((am, bm, av, bv))
        return len(self.pairs) - 1

    def get(self, i: int) -> W:
        am, bm, av, bv = self._meta[i]
        return W({i: 1}, 0, NLIMBS * am * bm, 0, av * bv)

    def lift(self, x: Lin, x_max=_SD) -> W:
        """A stored component in the product domain: x * (R mod p), as the
        product of x with the constant row ONE_MONT (fp.to_wide_mont)."""
        i = self.push(x, Lin({SLOT_ONE: 1}), x_max, 255, 0, 0)
        x_val = x_max * (((1 << (8 * NLIMBS)) - 1) // 255)
        return W({i: 1}, 0, NLIMBS * x_max * 255, 0, x_val * C.ONE_MONT_INT)


# Fq2/Fq6 wide algebra in two phases. Component convention: a 6-list of
# operands in flat order [c0.c0, c0.c1, c1.c0, c1.c1, c2.c0, c2.c1]; operand
# metadata rides separately as (limb_max, val_max). The *_emit functions push
# operands into a ConvBatch and return index structures; the *_fin functions
# combine the products.


def _fq2_mul_emit(cb, a0, a1, b0, b1, am=_SD, av=_PMAX, bm=_SD, bv=_PMAX):
    i0 = cb.push(a0, b0, am, bm, av, bv)
    i1 = cb.push(a1, b1, am, bm, av, bv)
    i2 = cb.push(a0 + a1, b0 + b1, 2 * am, 2 * bm, 2 * av, 2 * bv)
    return (i0, i1, i2)


def _fq2_mul_fin(cb, ids):
    t0, t1, tsum = cb.get(ids[0]), cb.get(ids[1]), cb.get(ids[2])
    return (t0 - t1, tsum - t0 - t1)


def _fq2_nonres_w(w):
    return (w[0] - w[1], w[0] + w[1])


def _fq2_add_w(x, y):
    return (x[0] + y[0], x[1] + y[1])


def _fq2_sub_w(x, y):
    return (x[0] - y[0], x[1] - y[1])


def _fq6_mul_emit(cb, a, b, am=_SD, av=_PMAX, bm=_SD, bv=_PMAX):
    """Interpolation product (ops/fq6.py mul_wide): 6 Fq2 products on input
    linear combinations."""
    return [
        _fq2_mul_emit(cb, a[0], a[1], b[0], b[1], am, av, bm, bv),
        _fq2_mul_emit(cb, a[2], a[3], b[2], b[3], am, av, bm, bv),
        _fq2_mul_emit(cb, a[4], a[5], b[4], b[5], am, av, bm, bv),
        _fq2_mul_emit(cb, a[2] + a[4], a[3] + a[5], b[2] + b[4], b[3] + b[5],
                      2 * am, 2 * av, 2 * bm, 2 * bv),
        _fq2_mul_emit(cb, a[0] + a[2], a[1] + a[3], b[0] + b[2], b[1] + b[3],
                      2 * am, 2 * av, 2 * bm, 2 * bv),
        _fq2_mul_emit(cb, a[0] + a[4], a[1] + a[5], b[0] + b[4], b[1] + b[5],
                      2 * am, 2 * av, 2 * bm, 2 * bv),
    ]


def _fq6_mul_fin(cb, ids):
    t0 = _fq2_mul_fin(cb, ids[0])
    t1 = _fq2_mul_fin(cb, ids[1])
    t2 = _fq2_mul_fin(cb, ids[2])
    m12 = _fq2_mul_fin(cb, ids[3])
    m01 = _fq2_mul_fin(cb, ids[4])
    m02 = _fq2_mul_fin(cb, ids[5])
    s0 = _fq2_add_w(t0, _fq2_nonres_w(_fq2_sub_w(_fq2_sub_w(m12, t1), t2)))
    s1 = _fq2_add_w(_fq2_sub_w(_fq2_sub_w(m01, t0), t1), _fq2_nonres_w(t2))
    s2 = _fq2_add_w(_fq2_sub_w(_fq2_sub_w(m02, t0), t2), t1)
    return [s0[0], s0[1], s1[0], s1[1], s2[0], s2[1]]


def _fq6_nonres_w(t):
    x = _fq2_nonres_w((t[4], t[5]))
    return [x[0], x[1], t[0], t[1], t[2], t[3]]


def _fq6_mul_by_01_emit(cb, a, b00, b01, b10, b11, am=_SD, av=_PMAX, bm=_SD, bv=_PMAX):
    return [
        _fq2_mul_emit(cb, a[0], a[1], b00, b01, am, av, bm, bv),
        _fq2_mul_emit(cb, a[2], a[3], b10, b11, am, av, bm, bv),
        _fq2_mul_emit(cb, a[2] + a[4], a[3] + a[5], b10, b11,
                      2 * am, 2 * av, bm, bv),
        _fq2_mul_emit(cb, a[0] + a[2], a[1] + a[3], b00 + b10, b01 + b11,
                      2 * am, 2 * av, 2 * bm, 2 * bv),
        _fq2_mul_emit(cb, a[4], a[5], b00, b01, am, av, bm, bv),
    ]


def _fq6_mul_by_01_fin(cb, ids):
    t0 = _fq2_mul_fin(cb, ids[0])
    t1 = _fq2_mul_fin(cb, ids[1])
    m12 = _fq2_mul_fin(cb, ids[2])
    m01 = _fq2_mul_fin(cb, ids[3])
    t2 = _fq2_mul_fin(cb, ids[4])
    s0 = _fq2_add_w(_fq2_nonres_w(_fq2_sub_w(m12, t1)), t0)
    s1 = _fq2_sub_w(_fq2_sub_w(m01, t0), t1)
    s2 = _fq2_add_w(t2, t1)
    return [s0[0], s0[1], s1[0], s1[1], s2[0], s2[1]]


def _fq6_mul_by_1_emit(cb, a, b10, b11, am=_SD, av=_PMAX, bm=_SD, bv=_PMAX):
    return [
        _fq2_mul_emit(cb, a[4], a[5], b10, b11, am, av, bm, bv),
        _fq2_mul_emit(cb, a[0], a[1], b10, b11, am, av, bm, bv),
        _fq2_mul_emit(cb, a[2], a[3], b10, b11, am, av, bm, bv),
    ]


def _fq6_mul_by_1_fin(cb, ids):
    x = _fq2_nonres_w(_fq2_mul_fin(cb, ids[0]))
    s1 = _fq2_mul_fin(cb, ids[1])
    s2 = _fq2_mul_fin(cb, ids[2])
    return [x[0], x[1], s1[0], s1[1], s2[0], s2[1]]


def _wlist_add(x, y):
    return [a + b for a, b in zip(x, y)]


def _wlist_sub(x, y):
    return [a - b for a, b in zip(x, y)]


def _comps(first: int, n: int) -> list:
    return [Lin({first + i: 1}) for i in range(n)]


def _fq12_mul_body(cb):
    a, b = _comps(0, 12), _comps(SLOT_B, 12)
    a0, a1, b0, b1 = a[:6], a[6:], b[:6], b[6:]
    asum = [x + y for x, y in zip(a0, a1)]
    bsum = [x + y for x, y in zip(b0, b1)]
    i_t0 = _fq6_mul_emit(cb, a0, b0)
    i_t1 = _fq6_mul_emit(cb, a1, b1)
    i_t01 = _fq6_mul_emit(cb, asum, bsum, am=2 * _SD, av=2 * _PMAX,
                          bm=2 * _SD, bv=2 * _PMAX)
    t0 = _fq6_mul_fin(cb, i_t0)
    t1 = _fq6_mul_fin(cb, i_t1)
    t01 = _fq6_mul_fin(cb, i_t01)
    out0 = _wlist_add(t0, _fq6_nonres_w(t1))
    out1 = _wlist_sub(_wlist_sub(t01, t0), t1)
    return out0 + out1


def _fq12_square_body(cb):
    """Complex squaring (ops/fq12.py square): c0 = (a0+a1)(a0+v a1) - ab - v ab,
    c1 = 2ab; v*a1 realized with relaxed (NEGC-based) digits."""
    negc = Lin({SLOT_NEGC: 1})
    a = _comps(0, 12)
    a0, a1 = a[:6], a[6:]
    s = [x + y for x, y in zip(a0, a1)]  # digits <= 2 SD
    # t = a0 + v*a1, with v*a1 = (xi*(a1c2), a1c0, a1c1); xi*(x0,x1) relaxed:
    # (x0 + (NEGC - x1), x0 + x1)
    t = [
        a0[0] + (a1[4] + (negc - a1[5])),  # <= SD + SD + (SD+256)
        a0[1] + (a1[4] + a1[5]),  # <= 3*SD
        a0[2] + a1[0],
        a0[3] + a1[1],
        a0[4] + a1[2],
        a0[5] + a1[3],
    ]
    tv = (1 + C.NEG_K + 2) * _P  # value bound of worst t component
    i_ab = _fq6_mul_emit(cb, a0, a1)
    i_st = _fq6_mul_emit(cb, s, t, am=2 * _SD, av=2 * _PMAX,
                         bm=3 * _SD + 256, bv=tv)
    ab = _fq6_mul_fin(cb, i_ab)
    st = _fq6_mul_fin(cb, i_st)
    out0 = _wlist_sub(_wlist_sub(st, ab), _fq6_nonres_w(ab))
    out1 = [x.scale(2) for x in ab]
    return out0 + out1


def _fq12_mul014_body(cb):
    """Sparse product with (d0 + d1 v) + (d4 v) w; the second operand is
    (6, 48): [d0c0, d0c1, d1c0, d1c1, d4c0, d4c1] (ops/fq12.py mul_by_014)."""
    a, d = _comps(0, 12), _comps(SLOT_B, 6)
    a0, a1 = a[:6], a[6:]
    asum = [x + y for x, y in zip(a0, a1)]
    d14_0, d14_1 = d[2] + d[4], d[3] + d[5]  # digits <= 2 SD
    i_aa = _fq6_mul_by_01_emit(cb, a0, d[0], d[1], d[2], d[3])
    i_bb = _fq6_mul_by_1_emit(cb, a1, d[4], d[5])
    i_t1 = _fq6_mul_by_01_emit(cb, asum, d[0], d[1], d14_0, d14_1,
                               am=2 * _SD, av=2 * _PMAX, bm=2 * _SD, bv=2 * _PMAX)
    aa = _fq6_mul_by_01_fin(cb, i_aa)
    bb = _fq6_mul_by_1_fin(cb, i_bb)
    t1 = _fq6_mul_by_01_fin(cb, i_t1)
    out0 = _wlist_add(_fq6_nonres_w(bb), aa)
    out1 = _wlist_sub(_wlist_sub(t1, aa), bb)
    return out0 + out1


def _fp4_square_emit(cb, a0, a1, b0, b1):
    """Fq4 square on component pairs a=(a0,a1), b=(b0,b1) (ops/fq12.py)."""
    return [
        _fq2_mul_emit(cb, a0, a1, a0, a1),
        _fq2_mul_emit(cb, b0, b1, b0, b1),
        _fq2_mul_emit(cb, a0 + b0, a1 + b1, a0 + b0, a1 + b1,
                      2 * _SD, 2 * _PMAX, 2 * _SD, 2 * _PMAX),
    ]


def _fp4_square_fin(cb, ids):
    t0 = _fq2_mul_fin(cb, ids[0])
    t1 = _fq2_mul_fin(cb, ids[1])
    t2 = _fq2_mul_fin(cb, ids[2])
    t2 = _fq2_sub_w(_fq2_sub_w(t2, t0), t1)
    return _fq2_add_w(_fq2_nonres_w(t1), t0), t2


def _fq12_cyc_square_body(cb):
    """Granger-Scott cyclotomic squaring (ops/fq12.py cyclotomic_square)."""
    a = _comps(0, 12)
    z0, z4, z3 = (a[0], a[1]), (a[2], a[3]), (a[4], a[5])
    z2, z1, z5 = (a[6], a[7]), (a[8], a[9]), (a[10], a[11])

    i01 = _fp4_square_emit(cb, *z0, *z1)
    i23 = _fp4_square_emit(cb, *z2, *z3)
    i45 = _fp4_square_emit(cb, *z4, *z5)
    t0_01, t1_01 = _fp4_square_fin(cb, i01)
    t0_23, t1_23 = _fp4_square_fin(cb, i23)
    t2_45, t3_45 = _fp4_square_fin(cb, i45)

    def lifted(z):
        return (cb.lift(z[0]).scale(2), cb.lift(z[1]).scale(2))

    def times3(t):
        return (t[0].scale(3), t[1].scale(3))

    z0w, z1w, z4w, z5w, z2w, z3w = (lifted(z) for z in (z0, z1, z4, z5, z2, z3))
    nz0 = _fq2_sub_w(times3(t0_01), z0w)
    nz1 = _fq2_add_w(times3(t1_01), z1w)
    nz4 = _fq2_sub_w(times3(t0_23), z4w)
    nz5 = _fq2_add_w(times3(t1_23), z5w)
    nz2 = _fq2_add_w(times3(_fq2_nonres_w(t3_45)), z2w)
    nz3 = _fq2_sub_w(times3(t2_45), z3w)
    return [nz0[0], nz0[1], nz4[0], nz4[1], nz3[0], nz3[1],
            nz2[0], nz2[1], nz1[0], nz1[1], nz5[0], nz5[1]]


# ---------------------------------------------------------------------------
# Formula tables
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Formula:
    name: str
    n_second: int  # components of the second operand (0: none)
    #: (products, 2, MAX_TERMS): each operand's terms as slot and integer
    #: coefficient (0: no term)
    slots: np.ndarray
    coefs: np.ndarray
    #: (12, products): each output wide's integer combination of the products
    outputs: np.ndarray
    col_lo: int  # merged column bounds of the 12 output wides
    col_hi: int

    @property
    def products(self) -> int:
        return self.slots.shape[0]

    @property
    def first_passes(self) -> int:
        return mont.first_pass_count(self.col_lo, self.col_hi)


_BODIES = {
    "mul": (_fq12_mul_body, 12),
    "square": (_fq12_square_body, 0),
    "mul_by_014": (_fq12_mul014_body, 6),
    "cyclotomic_square": (_fq12_cyc_square_body, 0),
}
FORMULAS = tuple(_BODIES)


@lru_cache(maxsize=None)
def formula(name: str) -> Formula:
    """Trace a formula once into its tables, asserting every bound the
    reduction needs (each product int32-exact, each output within the bias
    row and below R*p)."""
    body, n_second = _BODIES[name]
    cb = ConvBatch()
    outs = body(cb)
    assert len(outs) == 12 and len(cb.pairs) <= MAX_PRODUCTS
    for w in outs:
        assert w.vlo > -C.BIAS_VALUE and w.vhi + C.BIAS_VALUE < _RP, "R*p exceeded"
    lo, hi = min(w.lo for w in outs), max(w.hi for w in outs)
    assert fp.scanfree_bounds_ok(mont.NCOLS, lo, hi, 0, 0)
    slots = np.zeros((len(cb.pairs), 2, MAX_TERMS), dtype=np.int32)
    coefs = np.zeros((len(cb.pairs), 2, MAX_TERMS), dtype=np.int32)
    for p, pair in enumerate(cb.pairs):
        for side, lin in enumerate(pair):
            terms = sorted(lin.terms.items())
            assert len(terms) <= MAX_TERMS
            for t, (slot, c) in enumerate(terms):
                slots[p, side, t], coefs[p, side, t] = slot, c
    outputs = np.zeros((12, len(cb.pairs)), dtype=np.int32)
    for j, w in enumerate(outs):
        for p, c in w.terms.items():
            outputs[j, p] = c
    return Formula(name, n_second, slots, coefs, outputs, lo, hi)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

_DEVICE_TABLES: dict = {}


def _tables(name: str, device) -> tuple:
    """A formula's tables as tensors: per operand term its slot and
    coefficient, and the output combination."""
    key = (name, torch.device(device))
    if key not in _DEVICE_TABLES:
        f = formula(name)
        slot = torch.from_numpy(f.slots).to(device)
        coef = torch.from_numpy(f.coefs).to(device)
        outputs = torch.from_numpy(f.outputs).to(device=device, dtype=torch.float64)
        _DEVICE_TABLES[key] = (slot.long(), coef, outputs)
    return _DEVICE_TABLES[key]


def _run_plain(name: str, a: torch.Tensor, second=None) -> torch.Tensor:
    """Execute a formula's tables in the kernel's order: the operand sums,
    all products in one stacked convolution, the 12 wide combines, one
    reduction with the merged bounds."""
    f = formula(name)
    dev = a.device
    batch = a.shape[:-2]
    slots = torch.zeros((*batch, NSLOTS, NLIMBS), dtype=torch.int32, device=dev)
    slots[..., :12, :] = a
    if second is not None:
        slots[..., SLOT_B:SLOT_B + f.n_second, :] = second
    slots[..., SLOT_NEGC, :] = fp.const("NEGC", dev)
    slots[..., SLOT_ONE, :] = fp.const("ONE_MONT", dev)
    slot, coef, outputs = _tables(name, dev)
    ops = sum(slots[..., slot[:, :, t], :] * coef[:, :, t, None]
              for t in range(MAX_TERMS))  # (..., products, 2, 48)
    prods = mont.conv_plain(ops[..., 0, :], ops[..., 1, :])  # (..., products, 95)
    # float64 holds the int32 products and their small combinations exactly
    wides = (outputs @ prods.to(torch.float64)).to(torch.int32)
    return mont.mont_reduce_plain(wides, f.col_lo, f.col_hi)


def fq12_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b for stored Fq12 (..., 12, 48)."""
    return _run_plain("mul", a, b.expand_as(a))


def fq12_square_plain(a: torch.Tensor) -> torch.Tensor:
    return _run_plain("square", a)


def fq12_mul_by_014_plain(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """a * ((d0 + d1 v) + (d4 v) w); d: (..., 6, 48) packed
    [d0c0, d0c1, d1c0, d1c1, d4c0, d4c1]."""
    return _run_plain("mul_by_014", a, d.expand(*a.shape[:-2], 6, NLIMBS))


def fq12_cyclotomic_square_plain(a: torch.Tensor) -> torch.Tensor:
    """a^2 for a in the cyclotomic subgroup."""
    return _run_plain("cyclotomic_square", a)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _launch(name: str, a: torch.Tensor, second=None, n_second: int = 0) -> torch.Tensor:
    """Launch one tower kernel: `a` (batch..., 12, 48) and the second operand
    (batch..., n_second, 48) are read through one row stride each, so a
    stride-0 broadcast over the batch or a slice of a wider stack is read in
    place; a layout whose batch axes do not merge is copied first."""
    ops = [(a, (12, NLIMBS))]
    if second is not None:
        if second.device != a.device:
            raise ValueError(f"operands on {a.device} and {second.device}")
        ops.append((second, (n_second, NLIMBS)))
    batch = tuple(torch.broadcast_shapes(*(t.shape[:-2] for t, _ in ops)))
    out = torch.empty((*batch, 12, NLIMBS), dtype=torch.int32, device=a.device)
    views, args = [], []
    for t, tail in ops:
        v, stride = cuda_build.rows(t, batch, tail)
        views.append(v)  # alive until the launch is enqueued
        args += [v.data_ptr(), stride]
    cuda_build.call(name, a.device, *args, out.data_ptr(), math.prod(batch))
    return out


def fq12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return fq12_mul_plain(a, b)
    return _launch("limb_fq12_mul", a, b, 12)


def fq12_square(a: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return fq12_square_plain(a)
    return _launch("limb_fq12_square", a)


def fq12_mul_by_014(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return fq12_mul_by_014_plain(a, d)
    return _launch("limb_fq12_mul_by_014", a, d, 6)


def fq12_cyclotomic_square(a: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return fq12_cyclotomic_square_plain(a)
    return _launch("limb_fq12_cyclotomic_square", a)
