"""The limb tier's extension tower of the PyTorch port (ops/fq2.py, fq6.py,
fq12.py) against the JAX modules of the same names on the CPU: every ported
function on the same inputs, made from a seed; integer rows identical under
the "plain" strategy (zero tolerance), and every wide's static bounds equal."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.ops import fp, fq2, fq6, fq12
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu.ops import fp as jfp
from plonky2_bls12_381_pairing_tpu.ops import fq2 as jfq2
from plonky2_bls12_381_pairing_tpu.ops import fq6 as jfq6
from plonky2_bls12_381_pairing_tpu.ops import fq12 as jfq12

torch.set_num_threads(1)

B = 3


@pytest.fixture(autouse=True)
def plain_strategy():
    fp.set_strategy("plain")
    yield
    fp.set_strategy("auto")


def t(arr) -> torch.Tensor:
    return interop.limbs_from_numpy(np.asarray(arr), device="cpu")


def same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out), interop.to_numpy(torch_out))


def same_wides(jw, tw) -> bool:
    """Nested tuples of Wides: equal columns and equal static bounds."""
    if isinstance(jw, jfp.Wide):
        return same(jw.cols, tw.cols) and (jw.col_lo, jw.col_hi, jw.val_lo, jw.val_hi) == (
            tw.col_lo, tw.col_hi, tw.val_lo, tw.val_hi)
    return len(jw) == len(tw) and all(same_wides(a, b) for a, b in zip(jw, tw))


def rows(level, seed: int, n: int = B) -> np.ndarray:
    r = random.Random(seed)
    rand = {2: rm.rand_fq2, 6: rm.rand_fq6, 12: rm.rand_fq12}[level]
    enc = {2: jfq2.encode, 6: jfq6.encode, 12: jfq12.encode}[level]
    return np.asarray(enc([rand(r) for _ in range(n)]))


def test_fq2_against_jax():
    a, b = rows(2, 0x21), rows(2, 0x22)
    a[0] = 0  # inv(0) = 0
    ta, tb = t(a), t(b)
    k, tk = a[:, 1], ta[:, 1]
    assert np.array_equal(fq2.encode(fq2.decode(tb)), b)
    assert [(v.c0, v.c1) for v in fq2.decode(tb)] == [(v.c0, v.c1) for v in jfq2.decode(b)]
    for name in ("add", "sub", "mul", "is_equal"):
        assert same(getattr(jfq2, name)(a, b), getattr(fq2, name)(ta, tb)), name
    for name in ("neg", "neg_conjugate", "conjugate", "frobenius_map", "mul_by_nonresidue",
                 "square", "is_zero"):
        assert same(getattr(jfq2, name)(a), getattr(fq2, name)(ta)), name
    assert same(jax.jit(jfq2.inv)(a), fq2.inv(ta))
    assert same(jfq2.scale_fp(a, k), fq2.scale_fp(ta, tk))
    assert same(jfq2.mul_small(a, 4), fq2.mul_small(ta, 4))
    mask = np.array([1, 0, 1], dtype=np.int32)
    assert same(jfq2.select(jnp.asarray(mask), a, b), fq2.select(t(mask), ta, tb))
    assert same(jfq2.one((2,)), fq2.one((2,), "cpu")) and same(jfq2.zero(()), fq2.zero((), "cpu"))
    # the wide tier
    d2, v2 = 2 * fp.SEMI_DIG, 2 * fp.SEMI_VAL
    assert same_wides(jfq2.mul_wide(a, b), fq2.mul_wide(ta, tb))
    assert same_wides(jfq2.square_wide(a), fq2.square_wide(ta))
    assert same_wides(jfq2.mul_wide_generic(a + b, b, x_max=d2, x_val=v2),
                      fq2.mul_wide_generic(ta + tb, tb, x_max=d2, x_val=v2))
    # operands too wide for Karatsuba: the schoolbook branch
    big = dict(x_max=d2, x_val=v2, y_max=d2, y_val=v2)
    assert same_wides(jfq2.mul_wide_generic(a, b, **big), fq2.mul_wide_generic(ta, tb, **big))
    jw, tw = jfq2.mul_wide(a, b), fq2.mul_wide(ta, tb)
    for name in ("mul_by_nonresidue_wide", "neg_wide"):
        assert same_wides(getattr(jfq2, name)(jw), getattr(fq2, name)(tw)), name
    assert same_wides(jfq2.add_wide(jw, jw), fq2.add_wide(tw, tw))
    assert same_wides(jfq2.sub_wide(jw, jfq2.square_wide(b)), fq2.sub_wide(tw, fq2.square_wide(tb)))
    assert same_wides(jfq2.scale_small_wide(jw, 3), fq2.scale_small_wide(tw, 3))
    assert same_wides(jfq2.scale_fp_wide(a, k), fq2.scale_fp_wide(ta, tk))
    assert same_wides(jfq2.as_wide(a), fq2.as_wide(ta))
    assert same_wides(jfq2.to_wide_mont(a), fq2.to_wide_mont(ta))
    js, jm, jv = jfq2.sub_relaxed(a, b)
    ts, tm, tv = fq2.sub_relaxed(ta, tb)
    assert same(js, ts) and (jm, jv) == (tm, tv)
    assert same(jfq2.reduce(jw), fq2.reduce(tw))


def test_fq6_against_jax():
    a, b = rows(6, 0x61), rows(6, 0x62)
    a[0] = 0
    ta, tb = t(a), t(b)
    assert np.array_equal(fq6.encode(fq6.decode(tb)), b)
    for name in ("add", "sub", "mul", "is_equal"):
        assert same(getattr(jfq6, name)(a, b), getattr(fq6, name)(ta, tb)), name
    for name in ("neg", "mul_by_nonresidue", "square", "is_zero", "frobenius_map"):
        assert same(getattr(jfq6, name)(a), getattr(fq6, name)(ta)), name
    assert same(jax.jit(jfq6.inv)(a), fq6.inv(ta))
    b0, b1 = b[:, 0:2], b[:, 2:4]
    tb0, tb1 = tb[:, 0:2], tb[:, 2:4]
    assert same(jfq6.mul_by_01(a, b0, b1), fq6.mul_by_01(ta, tb0, tb1))
    assert same(jfq6.mul_by_1(a, b1), fq6.mul_by_1(ta, tb1))
    mask = np.array([0, 1, 1], dtype=np.int32)
    assert same(jfq6.select(jnp.asarray(mask), a, b), fq6.select(t(mask), ta, tb))
    assert same(jfq6.one((2,)), fq6.one((2,), "cpu"))
    assert same_wides(jfq6.mul_wide(a, b), fq6.mul_wide(ta, tb))
    assert same_wides(jfq6.square_wide(a), fq6.square_wide(ta))
    assert same_wides(jfq6.mul_by_01_wide(a, b0, b1), fq6.mul_by_01_wide(ta, tb0, tb1))
    assert same_wides(jfq6.mul_by_1_wide(a, b1), fq6.mul_by_1_wide(ta, tb1))
    jw, tw = jfq6.mul_wide(a, b), fq6.mul_wide(ta, tb)
    assert same_wides(jfq6.mul_by_nonresidue_wide(jw), fq6.mul_by_nonresidue_wide(tw))
    assert same_wides(jfq6.add_wide(jw, jw), fq6.add_wide(tw, tw))
    assert same_wides(jfq6.sub_wide(jw, jfq6.square_wide(a)), fq6.sub_wide(tw, fq6.square_wide(ta)))
    assert same(jfq6.reduce(jw), fq6.reduce(tw))


def test_fq12_against_jax():
    a, b = rows(12, 0xC1), rows(12, 0xC2)
    ta, tb = t(a), t(b)
    vals = fq12.decode(tb)
    assert np.array_equal(fq12.encode(vals), b)
    assert [v.coeffs() for v in vals] == [v.coeffs() for v in jfq12.decode(b)]
    for name in ("add", "sub", "mul", "is_equal"):
        assert same(getattr(jfq12, name)(a, b), getattr(fq12, name)(ta, tb)), name
    for name in ("neg", "conjugate", "square", "is_zero", "is_one", "frobenius_map"):
        assert same(getattr(jfq12, name)(a), getattr(fq12, name)(ta)), name
    assert same(jfq12.frobenius_pow(a, 2), fq12.frobenius_pow(ta, 2))
    d = [b[:, i:i + 2] for i in (0, 2, 4)]
    td = [tb[:, i:i + 2] for i in (0, 2, 4)]
    assert same(jfq12.mul_by_014(a, *d), fq12.mul_by_014(ta, *td))
    got = fq12.inv(ta)
    assert same(jax.jit(jfq12.inv)(a), got)
    av = fq12.decode(ta)
    assert list(fq12.decode(got)) == [x.inv() for x in av]
    mask = np.array([1, 1, 0], dtype=np.int32)
    assert same(jfq12.select(jnp.asarray(mask), a, b), fq12.select(t(mask), ta, tb))
    ones = fq12.one((2,), "cpu")
    assert same(jfq12.one((2,)), ones) and bool(fq12.is_one(ones).all())
    assert same(jfq12.zero((2,)), fq12.zero((2,), "cpu"))
    # cyclotomic elements: the easy part of the final exponentiation
    cyc = [x.frobenius_pow(6) * x.inv() for x in av]
    cyc = fq12.encode([x.frobenius_pow(2) * x for x in cyc])
    got = fq12.cyclotomic_square(t(cyc))
    assert same(jfq12.cyclotomic_square(cyc), got)
    assert same(jfq12.square(cyc), fq12.square(t(cyc)))
    assert list(fq12.decode(got)) == [x * x for x in fq12.decode(cyc)]
