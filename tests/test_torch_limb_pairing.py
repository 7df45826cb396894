"""The limb tier's pairing of the PyTorch port (models/pairing.py) against
jax.jit of the JAX package's models/pairing.py on the CPU, on a batch of two
with inputs at infinity: prepare_g2, miller_loop, final_exponentiation,
pairing, two-term multi_pairing and pairing_check row for row under the
"plain" strategy (and "auto", which on the CPU runs the same plain versions);
pairing under "fused" equal in decoded value; the nine frozen vectors of
tests/vectors/pairing_kat.json. Zero tolerance: integer rows."""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.models import pairing as tp
from plonky2_bls12_381_pairing_torch.models import schedule
from plonky2_bls12_381_pairing_torch.ops import curve, fp, fq12
from plonky2_bls12_381_pairing_torch.ops.kernels import mont, tower
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu.models import pairing as jp
from plonky2_bls12_381_pairing_tpu.ops import curve as jcurve

torch.set_num_threads(1)

_KAT = os.path.join(os.path.dirname(__file__), "vectors", "pairing_kat.json")
INF1 = rm.G1Affine(0, 0, True)
INF2 = rm.G2Affine(rm.Fq2(0, 0), rm.Fq2(0, 0), True)


def same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out), interop.to_numpy(torch_out))


def coeffs(xs) -> list:
    return [x.coeffs() for x in xs]


class Terms:
    """Two terms of two point pairs each, in both packages' encodings, and
    the JAX package's jitted stages on them."""

    def __init__(self):
        r = random.Random(0x9A1)
        p0, q0 = rm.rand_g1(r), rm.rand_g2(r)
        self.ps = [[p0, INF1], [p0.neg(), rm.rand_g1(r)]]
        self.qs = [[q0, rm.rand_g2(r)], [q0, INF2]]
        self.jp = [jcurve.G1Affine.encode(p) for p in self.ps]
        self.jq = [jcurve.G2Affine.encode(q) for q in self.qs]
        self.tp = [curve.G1Affine.encode(p, device="cpu") for p in self.ps]
        self.tq = [curve.G2Affine.encode(q, device="cpu") for q in self.qs]
        self.prepare = jax.jit(jp.prepare_g2)
        self.miller = jax.jit(jp.miller_loop)
        self.final_exp = jax.jit(jp.final_exponentiation)
        self.jcoeffs = [self.prepare(q) for q in self.jq]
        self.jf1 = self.miller(self.jp[0], self.jcoeffs[0], self.jq[0].infinity)
        self.jf2 = self.miller(self.jp, self.jcoeffs, [q.infinity for q in self.jq])
        self.je1 = self.final_exp(self.jf1)
        self.je2 = self.final_exp(self.jf2)


@pytest.fixture(scope="module")
def terms():
    return Terms()


@pytest.fixture(autouse=True)
def plain_strategy():
    fp.set_strategy("plain")
    yield
    fp.set_strategy("auto")


def test_schedule_tables_match_jax():
    assert np.array_equal(schedule._IS_ADD, jp._IS_ADD)
    assert np.array_equal(schedule._DO_SQUARE, jp._DO_SQUARE)
    assert np.array_equal(tp._HP_PROG, jp._HP_PROG)
    assert tp.NUM_COEFFS == jp.NUM_COEFFS == 68


def test_prepare_g2_rows_match_jax(terms):
    for jq, tq, want in zip(terms.jq, terms.tq, terms.jcoeffs):
        got = tp.prepare_g2(tq)
        assert got.shape == (2, 68, 3, 2, 48) and same(want, got)


def test_miller_loop_rows_match_jax(terms):
    tco = [interop.coeffs_limb_from_numpy(np.asarray(c), device="cpu") for c in terms.jcoeffs]
    got = tp.miller_loop(terms.tp[0], tco[0], terms.tq[0].infinity)
    assert same(terms.jf1, got)
    assert bool(fq12.is_one(got)[1])  # P at infinity: the term contributes one
    got2 = tp.miller_loop(terms.tp, tco, [q.infinity for q in terms.tq])
    assert same(terms.jf2, got2)
    # a chunk of the schedule, as checkpointed runs take it
    _, scaled = tp.scale_all_coeffs(terms.tp[0], tco[0], terms.tq[0].infinity)
    xs = tp.stack_steps(scaled)
    f = fq12.one((), "cpu").expand(2, 12, 48)
    half = tp.miller_steps(f, xs[:30], schedule._DO_SQUARE[:30])
    full = tp.miller_steps(half, xs[30:], schedule._DO_SQUARE[30:])
    assert torch.equal(fq12.conjugate(full), got)


def test_final_exponentiation_rows_match_jax(terms):
    f = interop.limbs_from_numpy(np.asarray(terms.jf1), device="cpu")
    got = tp.final_exponentiation(f)
    assert same(terms.je1, got)
    easy = fq12.mul(fq12.conjugate(f), fq12.inv(f))
    easy = fq12.mul(fq12.frobenius_pow(easy, 2), easy)
    assert same(jax.jit(jp.cyclotomic_exp)(np.asarray(easy)), tp.cyclotomic_exp(easy))


def test_pairing_rows_match_jax_and_oracle(terms):
    got = tp.pairing(terms.tp[0], terms.tq[0])
    assert same(terms.je1, got)
    vals = coeffs(fq12.decode(got))
    assert vals[0] == rm.pairing(terms.ps[0][0], terms.qs[0][0]).coeffs()
    assert vals[1] == rm.Fq12.one().coeffs()  # P_1 at infinity
    got_q = tp.pairing(terms.tp[1], terms.tq[1])  # Q_1 at infinity
    assert coeffs(fq12.decode(got_q))[1] == rm.Fq12.one().coeffs()
    # "auto" on the CPU: the wrappers' plain versions, the same rows, no launch
    fp.set_strategy("auto")
    mont.reset_launches()
    assert torch.equal(tp.pairing(terms.tp[0], terms.tq[0]), got)
    assert sum(mont.launches.values()) == 0


def test_multi_pairing_and_check_rows_match_jax(terms):
    got = tp.multi_pairing(terms.tp, terms.tq)
    assert same(terms.je2, got)
    want = [rm.multi_pairing(list(zip(p, q))).coeffs()
            for p, q in zip(zip(*terms.ps), zip(*terms.qs))]
    assert coeffs(fq12.decode(got)) == want
    ok = tp.pairing_check(terms.tp, terms.tq)
    assert same(jp.fq12.is_one(terms.je2), ok)
    assert ok.tolist() == [True, True]  # e(P,Q) e(-P,Q) = 1; both terms at infinity
    assert tp.pairing_check(terms.tp[:1], terms.tq[:1]).tolist() == [False, True]


def test_pairing_fused_equal_in_value(terms):
    want = interop.limbs_from_numpy(np.asarray(terms.je1), device="cpu")
    fp.set_strategy("fused")
    tower.reset_launches()
    got = tp.pairing(terms.tp[0], terms.tq[0])
    assert sum(tower.launches.values()) == 0  # the CPU takes the plain versions
    assert bool(fq12.is_equal(got, want).all())
    assert coeffs(fq12.decode(got)) == coeffs(fq12.decode(want))
    assert int(got.max()) <= fp.SEMI_DIG and int(got.min()) >= 0


@pytest.mark.parametrize("strategy", ["plain", "fused"])
def test_pairing_kat_vectors(strategy):
    with open(_KAT) as f:
        vectors = json.load(f)["vectors"]
    ps = [rm.G1Affine(int(v["p_x"], 16), int(v["p_y"], 16), False) for v in vectors]
    qs = [rm.G2Affine(rm.Fq2(int(v["q_x"][0], 16), int(v["q_x"][1], 16)),
                      rm.Fq2(int(v["q_y"][0], 16), int(v["q_y"][1], 16)), False)
          for v in vectors]
    fp.set_strategy(strategy)
    out = tp.pairing(curve.G1Affine.encode(ps, device="cpu"),
                     curve.G2Affine.encode(qs, device="cpu"))
    got = coeffs(fq12.decode(out))
    assert got == [[int(h, 16) for h in v["e_chain"]] for v in vectors]
    assert len(got) == 9
