"""The PyTorch port's pairing path against the JAX package's
(models/pairing_rns.py) and the frozen vectors, on one packed row:
  * miller_loop_fused rows bit-identical to JAX's, an infinity input included,
    and those of miller_loop_fused_plain (the miller_fused kernel's plain
    version);
  * the plain Granger-Scott exponentiation (the cyc_exp kernel's reference)
    bit-identical to the Pallas cyc_exp_run kernel in interpret mode;
  * pairing equal in value to JAX's pairing (whose CPU path runs the Karabina
    exponentiation: equal mod p, other rows; under impl="karabina" the rows
    agree too, tests/test_torch_karabina.py) and to every KAT e_chain;
  * the impl keyword reaches the final exponentiation's powers from pairing."""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.models import pairing_rns as tmpr
from plonky2_bls12_381_pairing_torch.models import schedule
from plonky2_bls12_381_pairing_torch.ops.rns import kernels
from plonky2_bls12_381_pairing_torch.ops.rns import lines as tl
from plonky2_bls12_381_pairing_torch.ops.rns import tower as ttw
from plonky2_bls12_381_pairing_tpu.models import pairing as jbase
from plonky2_bls12_381_pairing_tpu.models import pairing_rns as jmpr
from plonky2_bls12_381_pairing_tpu.ops.rns import pallas as rpk
from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw
from plonky2_bls12_381_pairing_tpu.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm

torch.set_num_threads(1)

_KAT = os.path.join(os.path.dirname(__file__), "vectors", "pairing_kat.json")


def port_points(jp, jq):
    """JAX-encoded points handed to the port through interop."""
    a = lambda x: np.asarray(x)
    return (interop.g1_from_numpy(a(jp.x), a(jp.y), a(jp.infinity), device="cpu"),
            interop.g2_from_numpy(a(jq.x), a(jq.y), a(jq.infinity), device="cpu"))


def coeffs(xs):
    return [x.coeffs() for x in xs]


def test_schedule_matches_jax():
    assert np.array_equal(schedule._IS_ADD, jbase._IS_ADD)
    assert np.array_equal(schedule._DO_SQUARE, jbase._DO_SQUARE)
    assert schedule._SEGMENTS == jbase._SEGMENTS
    assert (schedule._FUSED_RUNS, schedule._FUSED_TAIL) == (
        jmpr._FUSED_RUNS, jmpr._FUSED_TAIL)
    assert schedule._GS_SEGMENTS == jmpr._GS_SEGMENTS
    assert tuple(map(tuple, jmpr._EXP_STEPS.tolist())) == tmpr._EXP_STEPS


@pytest.fixture(scope="module")
def fused_case():
    """One packed row (a G1 input at infinity) as the port's points, and the
    JAX package's miller_loop_fused rows for it."""
    r = random.Random(0x70A1)
    ps = [rm.rand_g1(r), rm.G1Affine(0, 0, True)]
    qs = [rm.rand_g2(r), rm.rand_g2(r)]
    jp, jq = G1Affine.encode(ps), G2Affine.encode(qs)
    return port_points(jp, jq), np.asarray(jax.jit(jmpr.miller_loop_fused)(jp, jq))


def test_miller_loop_fused_rows_match_jax(fused_case):
    pts, want = fused_case
    got = tmpr.miller_loop_fused(*pts)
    assert np.array_equal(interop.to_numpy(got), want)


def test_miller_loop_fused_plain_rows_match_jax(fused_case):
    """The plain version of the miller_fused kernel."""
    pts, want = fused_case
    kernels.reset_launches()
    got = tmpr.miller_loop_fused_plain(*pts)
    assert np.array_equal(interop.to_numpy(got), want)
    assert all(n == 0 for n in kernels.launches.values())


def test_cyc_exp_plain_matches_pallas_interpret():
    r = random.Random(0xC1C)
    f = rm.rand_fq12(r)
    t = f.frobenius_pow(6) * f.inv()
    cyc = t.frobenius_pow(2) * t
    F = jtw.encode([cyc, cyc * cyc])
    kernels.reset_launches()
    got = kernels.cyc_exp(interop.fq12_from_numpy(F, device="cpu"),
                          schedule._GS_SEGMENTS)
    assert kernels.launches["cyc_exp"] == 0  # the CPU takes the plain version
    want = rpk.cyc_exp_run(F, jmpr._GS_SEGMENTS, interpret=True)
    assert np.array_equal(interop.to_numpy(got), np.asarray(want))
    out = ttw.decode(ttw.conjugate(got))
    assert coeffs(out) == coeffs([rm.cyclotomic_exp(cyc), rm.cyclotomic_exp(cyc * cyc)])


def test_pairing_value_matches_jax():
    g1 = rm.G1Affine.generator().mul(3)
    g2 = rm.G2Affine.generator().mul(5)
    jp, jq = G1Affine.encode([g1, g1]), G2Affine.encode([g2, g2])
    got = tmpr.pairing(*port_points(jp, jq))
    want = jax.jit(jmpr.pairing)(jp, jq)
    assert coeffs(ttw.decode(got)) == coeffs(jtw.decode(np.asarray(want)))
    assert coeffs(ttw.decode(got))[0] == rm.pairing(g1, g2).coeffs()


def test_pairing_kat_vectors():
    with open(_KAT) as f:
        vectors = json.load(f)["vectors"]
    ps = [rm.G1Affine(int(v["p_x"], 16), int(v["p_y"], 16), False) for v in vectors]
    qs = [rm.G2Affine(rm.Fq2(int(v["q_x"][0], 16), int(v["q_x"][1], 16)),
                      rm.Fq2(int(v["q_y"][0], 16), int(v["q_y"][1], 16)), False)
          for v in vectors]
    out = tmpr.pairing(tl.G1Affine.encode(ps, device="cpu"),
                       tl.G2Affine.encode(qs, device="cpu"))
    got = coeffs(ttw.decode(out))[: len(vectors)]
    assert got == [[int(h, 16) for h in v["e_chain"]] for v in vectors]
    assert len(got) == 9


def test_impl_keyword_reaches_the_exponentiations(monkeypatch):
    """pairing hands `impl` on unchanged to the five exponentiations; the
    default, and the form of multi_pairing and pairing_check, is "segments"."""
    seen = []
    exp = tmpr.cyclotomic_exp
    monkeypatch.setattr(tmpr, "cyclotomic_exp",
                        lambda f, impl="segments": seen.append(impl) or exp(f, impl))
    r = random.Random(0x70A2)
    p1, q1 = rm.rand_g1(r), rm.rand_g2(r)
    ps = tl.G1Affine.encode([p1, p1.mul(2)], device="cpu")
    ns = tl.G1Affine.encode([p1.neg(), p1.mul(2)], device="cpu")
    qs = tl.G2Affine.encode([q1, q1], device="cpu")
    default = tmpr.pairing(ps, qs)
    assert seen == ["segments"] * 5
    kara = tmpr.pairing(ps, qs, impl="karabina_full")
    assert ttw.is_equal(kara, default).all()
    assert seen[5:] == ["karabina_full"] * 5
    assert torch.equal(tmpr.multi_pairing([ps], [qs]), default)
    ok = tmpr.pairing_check([ps, ns], [qs, qs])
    assert ok.tolist() == [[True, False]]
    assert seen[10:] == ["segments"] * 10
    with pytest.raises(ValueError, match="impl"):
        tmpr.pairing(ps, qs, impl="kara")
