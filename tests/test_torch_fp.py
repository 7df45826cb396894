"""The PyTorch port's RNS Fp core against the JAX package's (ops/rns/fp.py):
the same inputs, encoded once, give bit-identical stored rows (tolerance 0)."""

import random

import jax
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch.ops.rns import fp as tfp
from plonky2_bls12_381_pairing_torch.ops.rns import kernels
from plonky2_bls12_381_pairing_tpu import rns_constants as RC
from plonky2_bls12_381_pairing_tpu.ops.rns import fp as jfp
from plonky2_bls12_381_pairing_tpu.ops.rns import pallas as rpk

torch.set_num_threads(1)
P = RC.P


@pytest.fixture
def rng():
    return random.Random(0x70FC)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def same(port: torch.Tensor, ref) -> bool:
    return np.array_equal(port.numpy(), np.asarray(ref))


def test_encode_decode_roundtrip(rng):
    xs = [rng.randrange(P) for _ in range(31)] + [0, 1, P - 1]
    enc = tfp.encode(xs)
    assert np.array_equal(enc, jfp.encode(xs))
    assert list(tfp.decode(enc))[: len(xs)] == xs
    assert list(tfp.decode(t(enc)))[: len(xs)] == xs
    assert np.array_equal(tfp.pack_mask([1, 0, 1]), jfp.pack_mask([1, 0, 1]))


def test_barrett_extremes():
    """Barrett at both ends of its stated domain, bit-identical to JAX."""
    dom = (1 << 31) - (1 << 27)
    vals = [dom - 1, -(dom - 1), 0, 1, -1, 12345678, -7654321]
    x = np.repeat(np.array(vals, dtype=np.int32)[:, None], RC.LANES, axis=1)
    out = tfp.barrett(t(x)).numpy()
    assert np.array_equal(out, np.asarray(jax.jit(jfp.barrett)(x)))
    assert np.array_equal(tfp.barrett_raw(t(x)).numpy(),
                          np.asarray(jax.jit(jfp.barrett_raw)(x)))
    for i, v in enumerate(vals):
        for lane in range(RC.LANES):
            m = int(RC.MODULI[lane])
            if m > 1:
                assert out[i, lane] == v % m, (i, lane)


def test_redc_mul_to_prod_rows(rng):
    """redc over products, lifted terms and negative lazy sums."""
    a, b, c, d = ([rng.randrange(P) for _ in range(8)] for _ in range(4))
    A, B, C, D = (tfp.encode(v) for v in (a, b, c, d))

    def lazy(mod, A, B, C, D):
        return mod.redc(mod.mul_ss(A, B).scale(3) - mod.mul_ss(C, D).scale(2)
                        + mod.to_prod(C).scale(2))

    got = lazy(tfp, t(A), t(B), t(C), t(D))
    assert same(got, jax.jit(lambda *x: lazy(jfp, *x))(A, B, C, D))
    assert list(tfp.decode(got))[:8] == [
        (3 * x * y - 2 * z * w + 2 * z) % P for x, y, z, w in zip(a, b, c, d)]
    assert same(tfp.mul(t(A), t(B)), jax.jit(jfp.mul)(A, B))
    stacked = tfp.redc_stack([tfp.mul_ss(t(A), t(B)),
                              tfp.neg_r(tfp.mul_ss(t(C), t(D)))])
    want = jax.jit(lambda *x: jfp.redc_stack(
        [jfp.mul_ss(x[0], x[1]), jfp.neg_r(jfp.mul_ss(x[2], x[3]))]))(A, B, C, D)
    assert same(stacked, want)


def test_predicates_and_select(rng):
    vals = [0, 0, 1, P - 1, rng.randrange(P), 0]
    A = tfp.encode(vals)
    assert np.array_equal(tfp.is_zero(t(A)).numpy(), np.asarray(jfp.is_zero(A)))
    neg = tfp.barrett(tfp.cst(("pmul", 4), t(A)) - t(A))  # 4p - a
    assert same(neg, jfp.neg(A))
    assert tfp.is_equal(t(A), tfp.barrett(tfp.cst(("pmul", 4), neg) - neg)).all()
    assert not tfp.is_equal(t(A), neg).all()
    mask = t(tfp.pack_mask([1, 0, 0, 1, 1, 0]))
    assert same(tfp.select(mask, t(A), neg),
                jfp.select(np.asarray(mask), A, np.asarray(neg)))


def test_inv_runs_the_tree(rng):
    """300 packed rows: the product tree folds down to 128 rows before the
    Fermat pow (_TREE_FLOOR), zeros map to zero."""
    xs = [rng.randrange(1, P) for _ in range(600)]
    xs[7] = xs[500] = 0
    A = tfp.encode(xs)
    got = tfp.inv(t(A))
    assert same(got, jax.jit(jfp.inv)(A))
    dec = list(tfp.decode(got))
    assert all((x == 0 and g == 0) or g * x % P == 1 for x, g in zip(xs, dec))


def test_pow_static_plain_vs_jax_and_pallas(rng):
    """The plain pow (the CUDA kernel's reference) is bit-identical to the
    JAX scan and to the Pallas kernel in interpret mode, including 0 -> 0;
    the wrapper takes it for a CPU tensor and launches nothing."""
    xs = [rng.randrange(1, P) for _ in range(6)] + [0, 0]
    A = tfp.encode(xs)
    e = 0xD201
    got = tfp.pow_static(t(A), e)
    assert same(got, jax.jit(lambda a: jfp.pow_static(a, e))(A))
    assert same(got, jax.jit(
        lambda a: rpk.pow_static_fused(a, e, block=8, interpret=True))(A))
    assert list(tfp.decode(got))[:8] == [pow(x, e, P) for x in xs]
    kernels.reset_launches()
    assert same(kernels.pow_static_fused(t(A), e), np.asarray(got))
    assert kernels.launches["pow_static"] == 0
