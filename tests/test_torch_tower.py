"""The PyTorch port's Fq12 tower against the JAX package's (ops/rns/tower.py):
the same encoded inputs give bit-identical stored rows (tolerance 0), and the
decoded values agree with the exact-integer oracle."""

import random

import jax
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch.ops.rns import tower as ttw
from plonky2_bls12_381_pairing_tpu import rns_constants as RC
from plonky2_bls12_381_pairing_tpu.ops.rns import fp as jfp
from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm

torch.set_num_threads(1)
P = RC.P


@pytest.fixture(scope="module")
def data():
    r = random.Random(0x70E1)
    xs = [rm.rand_fq12(r) for _ in range(2)]
    ys = [rm.rand_fq12(r) for _ in range(2)]
    cyc = []
    for x in xs:
        e = x.conjugate() * x.inv()
        cyc.append(e.frobenius_map().frobenius_map() * e)
    ds = [[rm.rand_fq2(r) for _ in range(2)] for _ in range(3)]
    return xs, ys, cyc, ds


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def coeffs(xs):
    """Oracle values as coefficient lists (the two packages' oracle classes
    differ, their coefficients compare)."""
    return [x.coeffs() for x in xs]


def enc_fq2(zs):
    ints = np.empty((len(zs), 2), dtype=object)
    for i, z in enumerate(zs):
        ints[i, 0], ints[i, 1] = z.c0, z.c1
    return jfp.encode(ints)


def test_encode_matches(data):
    xs = data[0]
    assert np.array_equal(ttw.encode(xs), jtw.encode(xs))
    assert coeffs(ttw.decode(ttw.encode(xs))) == coeffs(xs)
    assert np.array_equal(ttw.one((1,), "cpu").numpy(), np.asarray(jtw.one((1,))))


@pytest.mark.parametrize("op", ["mul", "square", "conjugate", "cyclotomic_square",
                                "frobenius_map", "inv"])
def test_op_rows_match_jax(data, op):
    xs, ys, cyc, _ = data
    ins = [cyc] if op == "cyclotomic_square" else ([xs, ys] if op == "mul" else [xs])
    enc = [jtw.encode(v) for v in ins]
    got = getattr(ttw, op)(*[t(a) for a in enc])
    want = jax.jit(getattr(jtw, op))(*enc)
    assert np.array_equal(got.numpy(), np.asarray(want))
    ref = {
        "mul": lambda: [x * y for x, y in zip(xs, ys)],
        "square": lambda: [x * x for x in xs],
        "conjugate": lambda: [x.conjugate() for x in xs],
        "cyclotomic_square": lambda: [rm.cyclotomic_square(u) for u in cyc],
        "frobenius_map": lambda: [x.frobenius_map() for x in xs],
        "inv": lambda: [x.inv() for x in xs],
    }[op]()
    assert coeffs(ttw.decode(got)) == coeffs(ref)


def test_mul_by_014_rows_match_jax(data):
    xs, _, _, (d0, d1, d4) = data
    a = jtw.encode(xs)
    d = [enc_fq2(v) for v in (d0, d1, d4)]
    got = ttw.mul_by_014(t(a), *[t(v) for v in d])
    want = jax.jit(jtw.mul_by_014)(a, *d)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert coeffs(ttw.decode(got)) == coeffs(
        [x.mul_by_014(c0, c1, c4) for x, c0, c1, c4 in zip(xs, d0, d1, d4)])


def test_frobenius_pow_and_is_one(data):
    xs = data[0]
    a = jtw.encode(xs)
    got = ttw.frobenius_pow(t(a), 2)
    assert np.array_equal(got.numpy(), np.asarray(jax.jit(
        lambda v: jtw.frobenius_pow(v, 2))(a)))
    assert ttw.is_one(ttw.one((1,), "cpu")).all()
    assert not ttw.is_one(t(a)).any()
