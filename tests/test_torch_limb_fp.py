"""The limb tier's Fp arithmetic of the PyTorch port (ops/fp.py) against the
JAX package's ops/fp.py on the CPU: the same inputs, made from a seed, through
both; integer rows compared with zero tolerance. On the CPU the JAX package
takes its scan-free reduction wherever the bounds allow, which is the row
contract of the port's kernels."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import constants as C
from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.ops import fp
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu import constants as JC
from plonky2_bls12_381_pairing_tpu.ops import fp as jfp

torch.set_num_threads(1)

B = 6


def t(arr) -> torch.Tensor:
    return interop.limbs_from_numpy(np.asarray(arr), device="cpu")


def same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out), interop.to_numpy(torch_out))


@pytest.fixture(scope="module")
def data():
    r = random.Random(0x11B)
    a = [r.randrange(rm.P) for _ in range(B)]
    b = [r.randrange(rm.P) for _ in range(B)]
    a[0], b[1], a[2], b[3] = 0, rm.P - 1, rm.P - 1, 1
    return a, b, jfp.encode(a), jfp.encode(b)


def test_limb_constants_match_jax():
    names = [n for n in dir(JC) if n.isupper()]
    assert {"P_LIMBS", "PPRIME_LIMBS", "R2_LIMBS", "ONE_MONT", "CSUB_LIMBS", "NEGC_LIMBS",
            "TWOP_LIMBS", "BIAS_DIGITS", "QMOD_WEIGHTS", "TOEP_PPRIME_MODR", "TOEP_P",
            "TOEP_ONE_MONT", "FROB_GAMMA6_1_MONT", "FROB_GAMMA6_2_MONT",
            "FROB_GAMMA12_MONT", "BLS_X_BITS", "MILLER_BITS"} <= set(names)
    for name in names:
        want, got = getattr(JC, name), getattr(C, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        else:
            assert got == want, name
    for x in (0, 1, rm.P - 1, (1 << 384) - 1):
        assert np.array_equal(C.int_to_limbs(x, 48), JC.int_to_limbs(x, 48))
        assert C.limbs_to_int(C.int_to_limbs(x, 48)) == x
    assert C.limbs_to_int(np.array([-1, 2, -3])) == JC.limbs_to_int(np.array([-1, 2, -3]))


def test_encode_decode(data):
    a, _, ja, _ = data
    assert np.array_equal(fp.encode(a), ja)
    assert np.array_equal(fp.encode(a, mont=False), jfp.encode(a, mont=False))
    assert list(fp.decode(t(ja))) == a == list(jfp.decode(ja))
    assert fp.decode(fp.encode(5)) == 5


def test_conv_and_wide_algebra(data):
    _, _, ja, jb = data
    ta, tb = t(ja), t(jb)
    jw, tw = jfp.conv(ja, jb), fp.conv(ta, tb)
    assert same(jw.cols, tw.cols)
    assert (jw.col_lo, jw.col_hi, jw.val_lo, jw.val_hi) == (
        tw.col_lo, tw.col_hi, tw.val_lo, tw.val_hi)
    j2 = (jw - jfp.conv(jb, jb)).double().scale_small(3) + jfp.to_wide_mont(ja, 258)
    t2 = (tw - fp.conv(tb, tb)).double().scale_small(3) + fp.to_wide_mont(ta, 258)
    assert same(j2.cols, t2.cols)
    assert (j2.col_lo, j2.col_hi, j2.val_lo, j2.val_hi) == (
        t2.col_lo, t2.col_hi, t2.val_lo, t2.val_hi)
    assert same(jfp.mont_reduce(j2), fp.mont_reduce(t2))
    j3, t3 = jw.shift_bias(2), tw.shift_bias(2)
    assert same(j3.cols, t3.cols) and j3.val_hi == t3.val_hi
    jn, tn = jfp.nonneg(jw - jfp.conv(jb, jb)), fp.nonneg(tw - fp.conv(tb, tb))
    assert same(jn.cols, tn.cols) and jn.val_lo == tn.val_lo >= 0
    # operands of unequal width broadcast over the batch
    js, ts = jfp.conv(ja[:, :20], jb[:1, :30]), fp.conv(ta[:, :20], tb[:1, :30])
    assert same(js.cols, ts.cols) and ts.ncols == 49
    assert same(jfp.normalize(jw, 100), fp.normalize(tw, 100))
    assert same(jfp.normalize_mod_r(js, 51), fp.normalize_mod_r(ts, 51))
    assert same(jfp.normalize_mod_r(js, 49)[:, :40], fp.normalize_mod_r(ts, 49)[:, :40])


def test_mont_reduce_three_branches(data):
    _, _, ja, jb = data
    ta, tb = t(ja), t(jb)
    # scan-free: a signed wide within the bias row
    jw, tw = jfp.conv(ja, jb) - jfp.conv(jb, jb), fp.conv(ta, tb) - fp.conv(tb, tb)
    assert jfp._scanfree_ok(jw) and fp._scanfree_ok(tw)
    assert same(jfp.mont_reduce(jw), fp.mont_reduce(tw))
    # exact with a negative value: the value bound exceeds the bias row
    deep = -(C.BIAS_VALUE + rm.P)
    jx = jfp.Wide(jw.cols, jw.col_lo, jw.col_hi, deep, jw.val_hi)
    tx = fp.Wide(tw.cols, tw.col_lo, tw.col_hi, deep, tw.val_hi)
    assert not jfp._scanfree_ok(jx) and not fp._scanfree_ok(tx)
    got = fp.mont_reduce(tx)
    assert same(jfp.mont_reduce(jx), got)
    a, b = fp.decode(ta), fp.decode(tb)
    assert list(fp.decode(got)) == [(x * y - y * y) % rm.P for x, y in zip(a, b)]
    assert int(got.max()) <= 255  # the exact path's output is canonical
    # more than 95 columns: the exact path again
    jy = jfp.Wide(jnp.pad(jw.cols, ((0, 0), (0, 2))), jw.col_lo, jw.col_hi, jw.val_lo, jw.val_hi)
    ty = fp.Wide(torch.nn.functional.pad(tw.cols, (0, 2)), tw.col_lo, tw.col_hi,
                 tw.val_lo, tw.val_hi)
    assert same(jfp.mont_reduce(jy), fp.mont_reduce(ty))
    # the adversarial columns of the kernel tests, as a Wide
    rows = np.zeros((4, 95), dtype=np.int32)
    rows[0, :] = 255 * 255 * 48
    rows[1, :48] = 255
    rows[2, 0], rows[2, 1] = -(1 << 25), 1 << 25
    rows[3, 94] = 255 * 255 * 48
    bounds = (-(1 << 25), 255 * 255 * 48, -(1 << 33), 1 << 786)
    assert same(jfp.mont_reduce(jfp.Wide(jnp.asarray(rows), *bounds)),
                fp.mont_reduce(fp.Wide(t(rows), *bounds)))
    assert same(jfp.mont_reduce_stack([jw, jw + jw]), fp.mont_reduce_stack([tw, tw + tw]))


def test_mont_mul_and_semi_reduced_feedback(data):
    a, b, ja, jb = data
    ta, tb = t(ja), t(jb)
    j1, t1 = jfp.mont_mul(ja, jb), fp.mont_mul(ta, tb)
    assert same(j1, t1)
    assert list(fp.decode(t1)) == [x * y % rm.P for x, y in zip(a, b)]
    assert same(jfp.mont_mul(j1, j1), fp.mont_mul(t1, t1))
    assert same(jfp.mont_square(j1), fp.mont_square(t1))
    assert same(jfp.from_mont(ja), fp.from_mont(ta))
    assert same(jfp.to_mont(jfp.from_mont(ja)), fp.to_mont(fp.from_mont(ta)))
    fp.set_strategy("plain")
    try:
        assert torch.equal(fp.mont_mul(ta, tb), t1)
    finally:
        fp.set_strategy("auto")


def test_ring_ops(data):
    _, _, ja, jb = data
    ta, tb = t(ja), t(jb)
    jm, tm = jfp.mont_mul(ja, jb), fp.mont_mul(ta, tb)  # weakly reduced operands
    for jx, tx in ((ja, ta), (jm, tm)):
        assert same(jfp.add(jx, jb), fp.add(tx, tb))
        assert same(jfp.neg(jx), fp.neg(tx))
        assert same(jfp.sub(jx, jb), fp.sub(tx, tb))
        assert same(jfp.canonicalize(jx), fp.canonicalize(tx))
        assert same(jfp.is_zero(jx), fp.is_zero(tx))
        assert same(jfp.is_equal(jx, jb), fp.is_equal(tx, tb))
    for k in (0, 1, 2, 3, 4, 8, 11):
        assert same(jfp.mul_small(ja, k), fp.mul_small(ta, k))
    jn, jmax, jval = jfp.neg_relaxed(jb)
    tn, tmax, tval = fp.neg_relaxed(tb)
    assert same(jn, tn) and (jmax, jval) == (tmax, tval)
    mask = np.array([1, 0, 1, 0, 0, 1], dtype=np.int32)
    assert same(jfp.select(jnp.asarray(mask), ja, jb), fp.select(t(mask), ta, tb))
    assert same(jfp.zeros((2,)), fp.zeros((2,), "cpu"))
    assert same(jfp.one_mont((2,)), fp.one_mont((2,), "cpu"))
    assert ta.data_ptr() != fp.neg(ta).data_ptr() and same(ja, ta)  # inputs not written


def test_carry_scan_matches_associative_scan():
    r = np.random.default_rng(0xCA)
    v = r.integers(-1, 257, (16, 55)).astype(np.int32)
    v[0], v[1], v[2] = 255, 256, -1  # full ripples
    v[3, ::2], v[3, 1::2] = 256, -1
    v[1, 0], v[0, 0] = 255, 256
    jc, jt = jfp._carry_scan(jnp.asarray(v))
    tc, tt = fp._carry_scan(t(v))
    assert same(jc, tc) and same(jt, tt)


def test_pow_static_and_inv(data):
    a, _, ja, _ = data
    ta = t(ja)
    assert same(jax.jit(lambda x: jfp.pow_static(x, 0xD201))(ja), fp.pow_static(ta, 0xD201))
    assert same(jfp.pow_static(ja, 0), fp.pow_static(ta, 0))
    got = fp.inv(ta)
    assert same(jax.jit(jfp.inv)(ja), got)
    dec = fp.decode(got)
    assert dec[0] == 0  # 0 -> 0
    assert all(v == 0 or dec[i] * v % rm.P == 1 for i, v in enumerate(a))
