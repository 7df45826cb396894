"""The limb tier's num/den Miller loop (models/pairing_numden.py) and
canonical final exponentiation (models/pairing.py _cyc_pow,
final_exponentiation_canonical) of the PyTorch port against the JAX package
on the CPU, and the refmodel additions they bring (roots, Legendre symbols,
signs, the hard part's base-p digits).

Row for row (zero tolerance, integer rows): prepare_g2_with_verticals
against the JAX package's line steps in its order (against its own jit of
the whole function in a `slow` test, as the JAX suite's numden tests are),
_scale_verticals and _cyc_pow against their JAX functions. In value:
optimized_pairing and final_exponentiation_canonical on two random pairs
(one at infinity) and two frozen vectors of tests/vectors/pairing_kat.json
(e_chain, e_canonical), against both packages' refmodels; the canonical
result's cube is the pairing."""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.models import pairing as tp
from plonky2_bls12_381_pairing_torch.models import pairing_numden as tnd
from plonky2_bls12_381_pairing_torch.ops import curve, fp, fq12
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu.models import pairing as jp
from plonky2_bls12_381_pairing_tpu.models import pairing_numden as jnd
from plonky2_bls12_381_pairing_tpu.ops import curve as jcurve
from plonky2_bls12_381_pairing_tpu.ops import fq2 as jfq2
from plonky2_bls12_381_pairing_tpu.ops import lines as jlines
from plonky2_bls12_381_pairing_tpu.utils import refmodel as jrm

torch.set_num_threads(1)

_KAT = os.path.join(os.path.dirname(__file__), "vectors", "pairing_kat.json")
INF1 = rm.G1Affine(0, 0, True)


def same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out), interop.to_numpy(torch_out))


def to_jax(pt):
    """A refmodel point of the port's package -> the JAX package's."""
    if isinstance(pt, rm.G1Affine):
        return jrm.G1Affine(pt.x, pt.y, pt.infinity)
    return jrm.G2Affine(jrm.Fq2(pt.x.c0, pt.x.c1), jrm.Fq2(pt.y.c0, pt.y.c1), pt.infinity)


@pytest.fixture(scope="module")
def pairs():
    """Two random pairs (the second P at infinity), then the first two frozen
    vectors' points."""
    r = random.Random(0x4D3)
    ps, qs = [rm.rand_g1(r), INF1], [rm.rand_g2(r), rm.rand_g2(r)]
    with open(_KAT) as f:
        kat = json.load(f)["vectors"][:2]
    for v in kat:
        ps.append(rm.G1Affine(int(v["p_x"], 16), int(v["p_y"], 16), False))
        qs.append(rm.G2Affine(rm.Fq2(*(int(h, 16) for h in v["q_x"])),
                              rm.Fq2(*(int(h, 16) for h in v["q_y"])), False))
    return ps, qs, kat


def test_refmodel_additions_match_jax():
    r = random.Random(0x5E1)
    xs = [0, 1, rm.P - 1] + [rm.rand_fp(r) for _ in range(8)]
    xs += [x * x % rm.P for x in xs[3:6]]
    for x in xs:
        assert rm.fp_legendre(x) == jrm.fp_legendre(x)
        assert rm.fp_is_square(x) == jrm.fp_is_square(x)
        assert rm.fp_sqrt(x) == jrm.fp_sqrt(x)
        assert rm.sgn0(x) == jrm.sgn0(x)
    assert sum(rm.fp_sqrt(x) is None for x in xs) > 0  # non-residues among them
    zs = [rm.Fq2(0, 0), rm.Fq2(0, 5), rm.Fq2(rm.P - 1, 0)] + [rm.rand_fq2(r) for _ in range(6)]
    zs += [z.square() for z in zs[3:6]]
    for z in zs:
        jz = jrm.Fq2(z.c0, z.c1)
        assert rm.sgn0_fq2(z) == jrm.sgn0_fq2(jz)
        got, want = z.sqrt(), jz.sqrt()
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.c0, got.c1) == (want.c0, want.c1) and got.square() == z
    assert rm.HARD_PART_MULTIPLE == jrm.HARD_PART_MULTIPLE == 3
    assert rm._H == jrm._H and rm.HARD_PART_DIGITS == jrm.HARD_PART_DIGITS
    assert tp.C_HARD_DIGITS == jp.C_HARD_DIGITS
    f = rm.rand_fq12(r)
    jf = jrm.Fq12.from_coeffs(f.coeffs())
    assert (rm.final_exponentiation_canonical(f).coeffs()
            == jrm.final_exponentiation_canonical(jf).coeffs())


@pytest.fixture(scope="module")
def verticals(pairs):
    """The port's coefficients and verticals for the two random pairs."""
    ps, qs, _ = pairs
    p = curve.G1Affine.encode(ps[:2], device="cpu")
    q = curve.G2Affine.encode(qs[:2], device="cpu")
    return p, q, tnd.prepare_g2_with_verticals(q)


def jax_verticals(q):
    """The JAX package's prepare_g2_with_verticals, step by step: its jitted
    line steps and fq2.square in its order (the scans of its _SEGMENTS)."""
    dbl, add, sq = jax.jit(jlines.doubling_step), jax.jit(jlines.addition_step), jax.jit(
        jfq2.square)
    q = jcurve.G2Affine.generator(q.infinity.shape).conditional_select(q.infinity, q)
    r = jcurve.G2Projective.from_affine(q)
    coeffs, verts = [], []
    for n_dbl, has_add in jp._SEGMENTS:
        for step in [dbl] * n_dbl + ([lambda r: add(r, q)] if has_add else []):
            r, c = step(r)
            coeffs.append(jnp.stack(c, axis=-3))
            verts.append(jnp.stack([sq(r.z), r.x], axis=-3))
    r, c = dbl(r)
    coeffs.append(jnp.stack(c, axis=-3))
    verts.append(jnp.stack([sq(r.z), r.x], axis=-3))
    return jnp.stack(coeffs, axis=-4), jnp.stack(verts, axis=-4)


def test_prepare_g2_with_verticals_rows_match_jax(pairs, verticals):
    ps, qs, _ = pairs
    _, q, (coeffs, verts) = verticals
    assert coeffs.shape == (2, 68, 3, 2, 48) and verts.shape == (2, 68, 2, 2, 48)
    want_c, want_v = jax_verticals(jcurve.G2Affine.encode([to_jax(x) for x in qs[:2]]))
    assert same(want_c, coeffs) and same(want_v, verts)
    # the coefficients are the flagship preparation's
    assert torch.equal(coeffs, tp.prepare_g2(q))


def test_scale_verticals_rows_match_jax(pairs, verticals):
    ps, qs, _ = pairs
    p, q, (_, verts) = verticals
    jpt = jcurve.G1Affine.encode([to_jax(x) for x in ps[:2]])
    qinf = jnp.asarray([0, 1], dtype=jnp.int32)
    want = jax.jit(jnd._scale_verticals)(jpt, qinf, jnp.asarray(verts.numpy()))
    got = tnd._scale_verticals(p, torch.tensor([0, 1], dtype=torch.int32), verts)
    assert got.shape == (2, 68, 6, 48) and same(want, got)
    # an infinity term is a multiply by one: P at infinity (element 1) too
    assert bool((got[1] == got[1, :1]).all())


def test_step_tables_match_jax():
    for name in ("_DBL_IDX", "_ADD_IDX", "_HAS_ADD"):
        assert np.array_equal(getattr(tnd, name), getattr(jnd, name))


def test_miller_loop_numden_two_terms(verticals):
    """Two terms in one accumulator: e(P, Q) e(-P, Q) is one."""
    p, q, (coeffs, verts) = verticals
    f = tnd.miller_loop_numden([p, p.neg()], [coeffs, coeffs], [verts, verts],
                               [q.infinity, q.infinity])
    assert bool(fq12.is_one(tp.final_exponentiation(f)).all())


def cyclotomic(f: rm.Fq12) -> rm.Fq12:
    m = f.frobenius_pow(6) * f.inv()
    return m.frobenius_pow(2) * m


def test_cyc_pow_rows_match_jax():
    r = random.Random(0xC9C)
    m = fq12.encode([cyclotomic(rm.rand_fq12(r)) for _ in range(2)])
    e = 0x2D5  # ten bits, six of them set
    want = jax.jit(jp._cyc_pow, static_argnums=1)(jnp.asarray(m), e)
    got = tp._cyc_pow(torch.from_numpy(m), e)
    assert same(want, got)
    assert list(fq12.decode(got)) == [x.pow(e) for x in fq12.decode(torch.from_numpy(m))]
    assert torch.equal(tp._cyc_pow(torch.from_numpy(m), 0), fq12.one((2,), "cpu"))


def test_optimized_pairing_and_canonical_final_exponentiation(pairs):
    """optimized_pairing under "auto" (the plain versions on the CPU) and
    "fused" (the fused tower kernels' plain versions), and
    final_exponentiation_canonical of the flagship Miller loop's output."""
    ps, qs, kat = pairs
    p, q = curve.G1Affine.encode(ps, device="cpu"), curve.G2Affine.encode(qs, device="cpu")
    chain = [rm.pairing(a, b) for a, b in zip(ps[:2], qs[:2])]
    assert [x.coeffs() for x in chain] == [
        jrm.pairing(to_jax(a), to_jax(b)).coeffs() for a, b in zip(ps[:2], qs[:2])]
    chain += [rm.Fq12.from_coeffs([int(h, 16) for h in v["e_chain"]]) for v in kat]
    e = tnd.optimized_pairing(p, q)
    assert list(fq12.decode(e)) == chain
    fp.set_strategy("fused")
    try:
        assert bool(fq12.is_equal(tnd.optimized_pairing(p, q), e).all())
    finally:
        fp.set_strategy("auto")

    f = tp.miller_loop(p, tp.prepare_g2(q), q.infinity)
    c = tp.final_exponentiation_canonical(f)
    canon = [rm.final_exponentiation_canonical(
        rm.multi_miller_loop([(ps[0], rm.prepare_g2(qs[0]))])), rm.Fq12.one()]
    assert canon[0].coeffs() == jrm.final_exponentiation_canonical(jrm.multi_miller_loop(
        [(to_jax(ps[0]), jrm.prepare_g2(to_jax(qs[0])))])).coeffs()
    canon += [rm.Fq12.from_coeffs([int(h, 16) for h in v["e_canonical"]]) for v in kat]
    assert list(fq12.decode(c)) == canon
    # the chain computes the canonical pairing's cube
    assert bool(fq12.is_equal(fq12.mul(fq12.square(c), c), e).all())


@pytest.mark.slow
def test_prepare_g2_with_verticals_rows_match_jax_jit(pairs, verticals):
    _, qs, _ = pairs
    _, _, (coeffs, verts) = verticals
    want_c, want_v = jax.jit(jnd.prepare_g2_with_verticals)(
        jcurve.G2Affine.encode([to_jax(x) for x in qs[:2]]))
    assert same(want_c, coeffs) and same(want_v, verts)


@pytest.mark.slow
def test_numden_and_canonical_rows_match_jax_jit(pairs):
    """The whole optimized_pairing and final_exponentiation_canonical row for
    row against the JAX package's jit of them (minutes of compile)."""
    ps, qs, _ = pairs
    p, q = curve.G1Affine.encode(ps, device="cpu"), curve.G2Affine.encode(qs, device="cpu")
    jpt = jcurve.G1Affine.encode([to_jax(x) for x in ps])
    jq = jcurve.G2Affine.encode([to_jax(x) for x in qs])
    assert same(jax.jit(jnd.optimized_pairing)(jpt, jq), tnd.optimized_pairing(p, q))
    f = tp.miller_loop(p, tp.prepare_g2(q), q.infinity)
    want = jax.jit(jp.final_exponentiation_canonical)(jnp.asarray(f.numpy()))
    assert same(want, tp.final_exponentiation_canonical(f))
