"""The PyTorch port's G2 line steps and point containers against the JAX
package's (ops/rns/lines.py), with and without the ell scaling folded in:
the same encoded inputs give bit-identical rows (tolerance 0)."""

import random

import jax
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.ops.rns import fp as tfp
from plonky2_bls12_381_pairing_torch.ops.rns import lines as tl
from plonky2_bls12_381_pairing_tpu.ops.rns import fp as jfp
from plonky2_bls12_381_pairing_tpu.ops.rns import lines as jl
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def points():
    r = random.Random(0x711E)
    q = rm.rand_g2(r)
    return [rm.rand_g1(r), rm.G1Affine(0, 0, True)], [q, rm.rand_g2(r)]


def arrays(*ts):
    return [np.asarray(x) for x in ts]


def test_encode_and_interop(points):
    ps, qs = points
    jp, jq = jl.G1Affine.encode(ps), jl.G2Affine.encode(qs)
    tp, tq = tl.G1Affine.encode(ps, device="cpu"), tl.G2Affine.encode(qs, device="cpu")
    ip = interop.g1_from_numpy(*arrays(jp.x, jp.y, jp.infinity), device="cpu")
    iq = interop.g2_from_numpy(*arrays(jq.x, jq.y, jq.infinity), device="cpu")
    for port, via, ref in ((tp.x, ip.x, jp.x), (tp.y, ip.y, jp.y),
                           (tp.infinity, ip.infinity, jp.infinity),
                           (tq.x, iq.x, jq.x), (tq.y, iq.y, jq.y),
                           (tq.infinity, iq.infinity, jq.infinity)):
        assert np.array_equal(interop.to_numpy(port), np.asarray(ref))
        assert np.array_equal(interop.to_numpy(via), np.asarray(ref))
    # odd batches pad the tail slot as infinity
    odd = tl.G1Affine.encode(ps[:1], device="cpu")
    assert np.array_equal(odd.infinity.numpy(),
                          np.asarray(jl.G1Affine.encode(ps[:1]).infinity))
    # generator_like / conditional_select / from_affine
    jr = jl.G2Projective.from_affine(jl.G2Affine.generator_like(jq).conditional_select(
        jq.infinity, jq))
    tr = tl.G2Projective.from_affine(tl.G2Affine.generator_like(iq).conditional_select(
        iq.infinity, iq))
    for a, b in zip((tr.x, tr.y, tr.z), (jr.x, jr.y, jr.z)):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("step", ["doubling", "addition"])
@pytest.mark.parametrize("scaled", [False, True])
def test_line_step_rows_match_jax(points, step, scaled):
    ps, qs = points
    qq = [qs[0], qs[0]]
    jq, jp = jl.G2Affine.encode(qq), jl.G1Affine.encode(ps)
    tq = interop.g2_from_numpy(*arrays(jq.x, jq.y, jq.infinity), device="cpu")
    tp = interop.g1_from_numpy(*arrays(jp.x, jp.y, jp.infinity), device="cpu")

    def run(mod, fpm, q, p):
        r = mod.G2Projective.from_affine(q)
        if step == "addition":  # start from 2Q so the addition is generic
            r, _ = mod.doubling_step(r)
        sc = ((fpm.wrap(p.y[..., None, :]), fpm.wrap(p.x[..., None, :]))
              if scaled else None)
        if step == "doubling":
            r2, cs = mod.doubling_step(r, scale=sc)
        else:
            r2, cs = mod.addition_step(r, q, scale=sc)
        return (r2.x, r2.y, r2.z) + tuple(cs)

    got = run(tl, tfp, tq, tp)
    want = jax.jit(lambda q, p: run(jl, jfp, q, p))(jq, jp)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
