"""The PyTorch port's split G2 preparation and Miller loop against the JAX
package's (models/pairing_rns.py) on one packed row (two point pairs, one
input at infinity), every comparison bit for bit (tolerance 0):
  * prepare_g2_stepmajor / prepare_g2 rows, and prepare_g2_stepmajor_plain's
    (the prepare_g2_lines kernel's plain version);
  * miller_loop with one term against JAX's and the port's miller_loop_fused;
  * miller_loop with two terms (miller_run_plain with T = 2 on the CPU)
    against JAX's;
  * miller_run_plain (the miller_run kernel's plain version) against the
    Pallas miller_run kernel in interpret mode;
  * the plain tower formulas behind the per-op kernels against the Pallas
    fused_op kernels in interpret mode."""

import random

import jax
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.models import pairing_rns as tmpr
from plonky2_bls12_381_pairing_torch.models import schedule
from plonky2_bls12_381_pairing_torch.ops.rns import kernels
from plonky2_bls12_381_pairing_torch.ops.rns import tower as ttw
from plonky2_bls12_381_pairing_tpu import rns_constants as RC
from plonky2_bls12_381_pairing_tpu.models import pairing as jbase
from plonky2_bls12_381_pairing_tpu.models import pairing_rns as jmpr
from plonky2_bls12_381_pairing_tpu.ops.rns import fp as jfp
from plonky2_bls12_381_pairing_tpu.ops.rns import pallas as rpk
from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw
from plonky2_bls12_381_pairing_tpu.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm

torch.set_num_threads(1)

a = np.asarray


def port_g1(jp):
    return interop.g1_from_numpy(a(jp.x), a(jp.y), a(jp.infinity), device="cpu")


def port_g2(jq):
    return interop.g2_from_numpy(a(jq.x), a(jq.y), a(jq.infinity), device="cpu")


@pytest.fixture(scope="module")
def terms():
    """Two terms on one packed row; the first has a G1 input at infinity in
    slot 1, the second a G2 input at infinity in slot 0. With each term the
    JAX package's step-major coefficients."""
    r = random.Random(0x3117)
    inf2 = rm.G2Affine(rm.Fq2(0, 0), rm.Fq2(0, 0), True)
    pts = [([rm.rand_g1(r), rm.G1Affine(0, 0, True)], [rm.rand_g2(r), rm.rand_g2(r)]),
           ([rm.rand_g1(r), rm.rand_g1(r)], [inf2, rm.rand_g2(r)])]
    prep = jax.jit(jmpr.prepare_g2_stepmajor)
    out = []
    for ps, qs in pts:
        jp, jq = G1Affine.encode(ps), G2Affine.encode(qs)
        out.append((jp, jq, prep(jq)))
    return out


def test_miller_runs_match_jax():
    assert schedule._MILLER_RUNS == jmpr._MILLER_RUNS
    assert schedule._RUNS == jmpr._RUNS


@pytest.mark.parametrize("term", [0, 1])
def test_prepare_g2_stepmajor_rows_match_jax(terms, term):
    _, jq, want = terms[term]
    got = tmpr.prepare_g2_stepmajor(port_g2(jq))
    assert got.shape == (68, 1, 3, 2, RC.LANES) and got.is_contiguous()
    assert np.array_equal(interop.to_numpy(got), a(want))


@pytest.mark.parametrize("term", [0, 1])
def test_prepare_g2_stepmajor_plain_rows_match_jax(terms, term):
    """The plain version of the prepare_g2_lines kernel."""
    _, jq, want = terms[term]
    kernels.reset_launches()
    got = tmpr.prepare_g2_stepmajor_plain(port_g2(jq))
    assert np.array_equal(interop.to_numpy(got), a(want))
    assert all(n == 0 for n in kernels.launches.values())


def test_prepare_g2_rows_match_jax(terms):
    _, jq, _ = terms[0]
    got = tmpr.prepare_g2(port_g2(jq))
    assert got.shape == (1, 68, 3, 2, RC.LANES)
    assert np.array_equal(interop.to_numpy(got), a(jmpr.prepare_g2(jq)))


@pytest.mark.parametrize("term", [0, 1])
def test_miller_loop_one_term_rows_match_jax_and_fused(terms, term):
    jp, jq, jc = terms[term]
    tp, tq = port_g1(jp), port_g2(jq)
    coeffs = interop.coeffs_from_numpy(a(jc), device="cpu")
    kernels.reset_launches()
    got = tmpr.miller_loop(tp, coeffs, tq.infinity)
    assert kernels.launches["miller_run"] == 0  # the CPU takes the plain version
    want = jax.jit(jmpr.miller_loop)(jp, jc, jq.infinity)
    assert np.array_equal(interop.to_numpy(got), a(want))
    assert torch.equal(got, tmpr.miller_loop_fused(tp, tq))
    # the list form and the multi-term accumulation give the same rows
    assert torch.equal(got, tmpr.miller_loop([tp], [coeffs], [tq.infinity]))
    f0 = ttw.one((1,), "cpu")
    raw = tmpr.miller_steps_raw(
        f0, [coeffs], [tmpr.fp.wrap(tp.y[..., None, :])],
        [tmpr.fp.wrap(tp.x[..., None, :])],
        [((tp.infinity != 0) | (tq.infinity != 0)).to(torch.int32)])
    assert torch.equal(got, ttw.conjugate(raw))


def test_miller_loop_two_terms_rows_match_jax(terms):
    (jp0, jq0, jc0), (jp1, jq1, jc1) = terms
    got = tmpr.miller_loop(
        [port_g1(jp0), port_g1(jp1)],
        [interop.coeffs_from_numpy(a(c), device="cpu") for c in (jc0, jc1)],
        [port_g2(jq0).infinity, port_g2(jq1).infinity])
    want = jax.jit(lambda p0, p1, c0, c1, i0, i1: jmpr.miller_loop(
        [p0, p1], [c0, c1], [i0, i1]))(jp0, jp1, jc0, jc1, jq0.infinity, jq1.infinity)
    assert np.array_equal(interop.to_numpy(got), a(want))
    # without q_infinities the G2 point at infinity is not masked: other rows
    other = tmpr.miller_loop(
        [port_g1(jp0), port_g1(jp1)],
        [interop.coeffs_from_numpy(a(c), device="cpu") for c in (jc0, jc1)])
    assert not torch.equal(got, other)


def test_miller_run_plain_matches_pallas_interpret(terms):
    jp, jq, jc = terms[0]
    f0 = np.broadcast_to(a(jtw.one()), (1, 12, RC.LANES))
    skip = a((jp.infinity != 0).astype(np.int32) | (jq.infinity != 0))
    want = jax.jit(lambda f, c, y, x, s: rpk.miller_run(
        f, c, y, x, s, jbase._DO_SQUARE, block=8, interpret=True))(
        f0, jc, jp.y, jp.x, skip)
    t = lambda v: torch.from_numpy(np.array(v, dtype=np.int32))
    got = kernels.miller_run_plain(ttw.one((1,), "cpu"), t(jc), t(jp.y), t(jp.x),
                                   t(skip), schedule._DO_SQUARE)
    assert np.array_equal(got.numpy(), a(want))
    # the wrapper takes the same version for a CPU tensor
    assert torch.equal(got, kernels.miller_run(ttw.one((1,), "cpu"), t(jc), t(jp.y),
                                               t(jp.x), t(skip), schedule._DO_SQUARE))
    with pytest.raises(ValueError):
        kernels.miller_run(ttw.one((1,), "cpu"), t(jc), t(jp.y), t(jp.x), t(skip),
                           schedule._DO_SQUARE[:-1])


def enc_fq2(zs):
    ints = np.empty((len(zs), 2), dtype=object)
    for i, z in enumerate(zs):
        ints[i, 0], ints[i, 1] = z.c0, z.c1
    return jfp.encode(ints)


@pytest.fixture(scope="module")
def tower_data():
    r = random.Random(0x3118)
    xs = [rm.rand_fq12(r) for _ in range(4)]
    ys = [rm.rand_fq12(r) for _ in range(4)]
    ds = [[rm.rand_fq2(r) for _ in range(4)] for _ in range(3)]
    return xs, ys, ds


@pytest.mark.parametrize("op", ["mul", "square", "mul_by_014_square"])
def test_plain_tower_ops_match_fused_op_interpret(tower_data, op):
    """The formulas the per-op CUDA kernels are held to on the card give the
    rows of the Pallas per-op kernels."""
    xs, ys, (d0, d1, d4) = tower_data
    A, B = a(jtw.encode(xs)), a(jtw.encode(ys))
    t = lambda v: torch.from_numpy(np.array(v, dtype=np.int32))
    if op == "mul":
        k = rpk.fused_op(jtw._mul_impl, "tt_mul", (12, 12), 12, block=8, interpret=True)
        want, got = jax.jit(k)(A, B), ttw.mul_plain(t(A), t(B))
        ref = [x * y for x, y in zip(xs, ys)]
    elif op == "square":
        k = rpk.fused_op(jtw._square_impl, "tt_sq", (12,), 12, block=8, interpret=True)
        want, got = jax.jit(k)(A), ttw.square_plain(t(A))
        ref = [x * x for x in xs]
    else:
        e = [enc_fq2(v) for v in (d0, d1, d4)]
        k = rpk.fused_op(jtw._mul014_square_packed, "tt_014sq", (12, 6), 12, block=8,
                         interpret=True)
        want = jax.jit(k)(A, a(jtw._pack_d(A, *e)))
        got = ttw.mul_by_014_square_plain(t(A), *[t(v) for v in e])
        m = [x.mul_by_014(c0, c1, c4) for x, c0, c1, c4 in zip(xs, d0, d1, d4)]
        ref = [v * v for v in m]
    assert np.array_equal(got.numpy(), a(want))
    assert [v.coeffs() for v in ttw.decode(got)][:4] == [v.coeffs() for v in ref]


def test_mul_by_014_square_and_select_match_jax(tower_data):
    xs, _, (d0, d1, d4) = tower_data
    A = a(jtw.encode(xs))
    e = [enc_fq2(v) for v in (d0, d1, d4)]
    t = lambda v: torch.from_numpy(np.array(v, dtype=np.int32))
    kernels.reset_launches()
    got = ttw.mul_by_014_square(t(A), *[t(v) for v in e])
    assert np.array_equal(got.numpy(), a(jax.jit(jtw.mul_by_014_square)(A, *e)))
    # a packed lane mask selects per 64-lane slot: element 1 and element 2
    mask = np.zeros((2, RC.LANES), dtype=np.int32)
    mask[0, RC.SUB:] = 1
    mask[1, :RC.SUB] = 1
    sel = ttw.select(t(mask), t(A), got)
    assert np.array_equal(sel.numpy(), a(jtw.select(mask, A, got.numpy())))
    # with skip, the marked elements keep a through the sparse product
    skipped = ttw.mul_by_014_square(t(A), *[t(v) for v in e], t(mask))
    want = ttw.square(ttw.select(t(mask), t(A), ttw.mul_by_014(t(A), *[t(v) for v in e])))
    assert torch.equal(skipped, want)
    dec = [v.coeffs() for v in ttw.decode(skipped)]
    assert dec[1] == (xs[1] * xs[1]).coeffs() and dec[2] == (xs[2] * xs[2]).coeffs()
    assert dec[0] == ttw.decode(got)[0].coeffs()
    assert all(n == 0 for n in kernels.launches.values())
