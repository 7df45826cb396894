"""The PyTorch port's multi_pairing and pairing_check (the split prepare +
Miller loop + final exponentiation) on one packed row:
  * multi_pairing with two terms equal in decoded value (tolerance 0 on the
    field elements) to JAX's multi_pairing, whose CPU path takes the Karabina
    exponentiation (equal mod p, other rows), and to the exact-integer oracle;
  * multi_pairing with one term row-identical to the port's pairing;
  * pairing_check true on e(aP, Q) e(-P, aQ) and false on a perturbed pair."""

import random

import jax
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.models import pairing_rns as tmpr
from plonky2_bls12_381_pairing_torch.ops.rns import kernels
from plonky2_bls12_381_pairing_torch.ops.rns import lines as tl
from plonky2_bls12_381_pairing_torch.ops.rns import tower as ttw
from plonky2_bls12_381_pairing_torch.utils import refmodel as trm
from plonky2_bls12_381_pairing_tpu.models import pairing_rns as jmpr
from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw
from plonky2_bls12_381_pairing_tpu.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm

torch.set_num_threads(1)

a = np.asarray


def port_g1(jp):
    return interop.g1_from_numpy(a(jp.x), a(jp.y), a(jp.infinity), device="cpu")


def port_g2(jq):
    return interop.g2_from_numpy(a(jq.x), a(jq.y), a(jq.infinity), device="cpu")


def coeffs(xs):
    return [x.coeffs() for x in xs]


@pytest.fixture(scope="module")
def pairs():
    """Two terms of two point pairs each; the second term's second G1 point
    is at infinity."""
    r = random.Random(0x3A17)
    ps0, qs0 = [rm.rand_g1(r), rm.rand_g1(r)], [rm.rand_g2(r), rm.rand_g2(r)]
    ps1, qs1 = [rm.rand_g1(r), rm.G1Affine(0, 0, True)], [rm.rand_g2(r), rm.rand_g2(r)]
    return (ps0, qs0), (ps1, qs1)


def test_multi_pairing_two_terms_values_match_jax_and_oracle(pairs):
    (ps0, qs0), (ps1, qs1) = pairs
    jps = [G1Affine.encode(ps0), G1Affine.encode(ps1)]
    jqs = [G2Affine.encode(qs0), G2Affine.encode(qs1)]
    kernels.reset_launches()
    got = tmpr.multi_pairing([port_g1(p) for p in jps], [port_g2(q) for q in jqs])
    assert all(n == 0 for n in kernels.launches.values())
    assert got.shape == (1, 12, 128) and got.dtype == torch.int32
    want = jax.jit(lambda p0, p1, q0, q1: jmpr.multi_pairing([p0, p1], [q0, q1]))(
        *jps, *jqs)
    dec = coeffs(ttw.decode(got))
    assert dec == coeffs(jtw.decode(a(want)))
    oracle = [rm.multi_pairing([(ps0[i], qs0[i]), (ps1[i], qs1[i])]) for i in range(2)]
    assert dec == coeffs(oracle)
    # the second element's second term is skipped: the first term's pairing
    assert dec[1] == rm.pairing(ps0[1], qs0[1]).coeffs()


def test_multi_pairing_one_term_rows_equal_pairing(pairs):
    (_, _), (ps1, qs1) = pairs
    tp = tl.G1Affine.encode(ps1, device="cpu")
    tq = tl.G2Affine.encode(qs1, device="cpu")
    got = tmpr.multi_pairing([tp], [tq])
    assert torch.equal(got, tmpr.pairing(tp, tq))
    assert coeffs(ttw.decode(got))[1] == rm.Fq12.one().coeffs()


def test_port_oracle_multi_pairing_matches_reference_oracle(pairs):
    (ps0, qs0), (ps1, qs1) = pairs
    conv1 = lambda p: trm.G1Affine(p.x, p.y, p.infinity)
    conv2 = lambda q: trm.G2Affine(trm.Fq2(q.x.c0, q.x.c1), trm.Fq2(q.y.c0, q.y.c1),
                                   q.infinity)
    for i in range(2):
        got = trm.multi_pairing([(conv1(ps0[i]), conv2(qs0[i])),
                                 (conv1(ps1[i]), conv2(qs1[i]))])
        want = rm.multi_pairing([(ps0[i], qs0[i]), (ps1[i], qs1[i])])
        assert got.coeffs() == want.coeffs()


def test_pairing_check_both_ways():
    r = random.Random(0x3A18)
    p, q = rm.rand_g1(r), rm.rand_g2(r)
    k = r.randrange(2, rm.R)
    # element 0: e(kP, Q) e(-P, kQ) = 1; element 1: the second pair perturbed
    ps = [tl.G1Affine.encode([p.mul(k), p.mul(k)], device="cpu"),
          tl.G1Affine.encode([p.neg(), p.neg()], device="cpu")]
    qs = [tl.G2Affine.encode([q, q], device="cpu"),
          tl.G2Affine.encode([q.mul(k), q.mul(k + 1)], device="cpu")]
    ok = tmpr.pairing_check(ps, qs)
    assert ok.shape == (1, 2) and ok.dtype == torch.bool
    assert ok.tolist() == [[True, False]]
    assert rm.multi_pairing([(p.mul(k), q), (p.neg(), q.mul(k))]) == rm.Fq12.one()
