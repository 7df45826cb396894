"""The limb tier's curve points and line steps of the PyTorch port
(ops/curve.py, ops/lines.py) against the JAX modules on the CPU: the same
points, made from a seed; integer rows identical (zero tolerance)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.ops import curve, fp, fq2, lines
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu.ops import curve as jcurve
from plonky2_bls12_381_pairing_tpu.ops import lines as jlines

torch.set_num_threads(1)


def same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out), interop.to_numpy(torch_out))


@pytest.fixture(scope="module")
def points():
    r = random.Random(0x11E5)
    ps = [rm.rand_g1(r), rm.G1Affine(0, 0, True), rm.rand_g1(r)]
    qs = [rm.rand_g2(r), rm.rand_g2(r), rm.G2Affine(rm.Fq2(0, 0), rm.Fq2(0, 0), True)]
    return ps, qs


def test_point_encode_select_infinity(points, monkeypatch):
    ps, qs = points
    jp, jq = jcurve.G1Affine.encode(ps), jcurve.G2Affine.encode(qs)
    tp = curve.G1Affine.encode(ps, device="cpu")
    tq = curve.G2Affine.encode(qs, device="cpu")
    for j, x in ((jp, tp), (jq, tq)):
        assert same(j.x, x.x) and same(j.y, x.y) and same(j.infinity, x.infinity)
        assert same(j.is_on_curve(), x.is_on_curve())
        assert same(j.neg().y, x.neg().y)
        assert same(j.is_point_equal_to(j.neg()), x.is_point_equal_to(x.neg()))
        assert bool(x.is_point_equal_to(x).all())
    assert [(p.x, p.y, p.infinity) for p in tp.decode()] == [
        (p.x, p.y, p.infinity) for p in ps]
    assert [(q.x, q.y, q.infinity) for q in tq.decode()] == [
        (q.x, q.y, q.infinity) for q in qs]
    assert tq.infinity.tolist() == [0, 0, 1] and tp.infinity.tolist() == [0, 1, 0]
    # interop carries the JAX package's points across unchanged
    ip = interop.g1_limb_from_numpy(np.asarray(jp.x), np.asarray(jp.y),
                                    np.asarray(jp.infinity), device="cpu")
    iq = interop.g2_limb_from_numpy(np.asarray(jq.x), np.asarray(jq.y),
                                    np.asarray(jq.infinity), device="cpu")
    assert torch.equal(ip.x, tp.x) and torch.equal(iq.y, tq.y)
    assert torch.equal(iq.infinity, tq.infinity)
    # generator, identity, select
    for jcls, tcls in ((jcurve.G1Affine, curve.G1Affine), (jcurve.G2Affine, curve.G2Affine)):
        jg, tg = jcls.generator((3,)), tcls.generator((3,), "cpu")
        ji, ti = jcls.identity((3,)), tcls.identity((3,), "cpu")
        assert same(jg.x, tg.x) and same(jg.y, tg.y) and same(jg.infinity, tg.infinity)
        assert same(ji.x, ti.x) and same(ji.y, ti.y) and same(ji.infinity, ti.infinity)
    mask = np.array([1, 0, 1], dtype=np.int32)
    js = jcurve.G2Affine.generator((3,)).conditional_select(jnp.asarray(mask), jq)
    ts = curve.G2Affine.generator((3,), "cpu").conditional_select(torch.from_numpy(mask), tq)
    assert same(js.x, ts.x) and same(js.y, ts.y) and same(js.infinity, ts.infinity)
    js1 = jp.conditional_select(jnp.asarray(mask), jcurve.G1Affine.generator((3,)))
    ts1 = tp.conditional_select(torch.from_numpy(mask), curve.G1Affine.generator((3,), "cpu"))
    assert same(js1.x, ts1.x) and same(js1.infinity, ts1.infinity)
    # projective points: z = 0 at infinity
    jr, tr = jcurve.G2Projective.from_affine(jq), curve.G2Projective.from_affine(tq)
    assert same(jr.z, tr.z) and bool(fq2.is_zero(tr.z)[2])
    jr2 = jcurve.G2Projective.conditional_select(jr, jcurve.G2Projective.identity((3,)),
                                                 jnp.asarray(mask))
    tr2 = curve.G2Projective.conditional_select(tr, curve.G2Projective.identity((3,), "cpu"),
                                                torch.from_numpy(mask))
    assert same(jr2.x, tr2.x) and same(jr2.y, tr2.y) and same(jr2.z, tr2.z)
    assert same(jcurve.G2Projective.generator((2,)).z,
                curve.G2Projective.generator((2,), "cpu").z)
    # entry points default to the card and raise without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        curve.G1Affine.encode(ps)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fq2.one((2,))


def test_doubling_and_addition_steps_match_jax(points):
    _, qs = points
    qs = qs[:2]
    jq, tq = jcurve.G2Affine.encode(qs), curve.G2Affine.encode(qs, device="cpu")
    jr, tr = jcurve.G2Projective.from_affine(jq), curve.G2Projective.from_affine(tq)
    jdbl, jadd = jax.jit(jlines.doubling_step), jax.jit(jlines.addition_step)
    for step in ("dbl", "dbl", "add", "dbl"):
        if step == "dbl":
            jr, jc = jdbl(jr)
            tr, tc = lines.doubling_step(tr)
        else:
            jr, jc = jadd(jr, jq)
            tr, tc = lines.addition_step(tr, tq)
        assert same(jr.x, tr.x) and same(jr.y, tr.y) and same(jr.z, tr.z), step
        assert all(same(a, b) for a, b in zip(jc, tc)), step
    # the running point is [10]Q = 2 (2 (2Q) + Q): x / z^2, y / z^3 against the oracle
    zi = fq2.inv(tr.z)
    zi2 = fq2.square(zi)
    x = fq2.decode(fq2.mul(tr.x, zi2))
    y = fq2.decode(fq2.mul(tr.y, fq2.mul(zi2, zi)))
    want = [q.mul(10) for q in qs]
    assert [(a, b) for a, b in zip(x, y)] == [(q.x, q.y) for q in want]
    assert fp.get_strategy() == "auto"
