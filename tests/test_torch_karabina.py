"""The PyTorch port's Karabina final exponentiation against the JAX package's,
on one packed row (two elements), tolerance 0 on the stored int32 rows:
  * tower.compress_cyclotomic / compressed_square / decompress_cyclotomic rows
    equal to the JAX tower's, the identity (all-zero compressed state) included;
  * the plain versions of the square-run, chain and whole-exponentiation
    kernels against the Pallas kernels in interpret mode;
  * cyclotomic_exp under each of its six forms: one decoded value; "cond" and
    "runs" the rows of "segments"; "karabina" and "karabina_runs" the rows of
    the JAX package's default cyclotomic_exp;
  * the slice as a whole: final_exponentiation and pairing under
    impl="karabina" row for row the JAX package's, and the frozen vectors."""

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
from plonky2_bls12_381_pairing_tpu.models import pairing_rns as jmpr
from plonky2_bls12_381_pairing_tpu.ops.rns import fp as jfp
from plonky2_bls12_381_pairing_tpu.ops.rns import pallas as rpk
from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw
from plonky2_bls12_381_pairing_tpu.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm

torch.set_num_threads(1)

_KAT = os.path.join(os.path.dirname(__file__), "vectors", "pairing_kat.json")
_JAX_KARA_SEGMENTS = tuple(
    e - l for e, l in zip(jmpr._X_SET_BITS, [0] + jmpr._X_SET_BITS[:-1]))


def coeffs(xs):
    return [x.coeffs() for x in xs]


def port(a) -> torch.Tensor:
    return interop.fq12_from_numpy(np.asarray(a), device="cpu")


def rows(t: torch.Tensor) -> np.ndarray:
    return interop.to_numpy(t)


def rand_cyc(r: random.Random) -> rm.Fq12:
    f = rm.rand_fq12(r)
    t = f.frobenius_pow(6) * f.inv()
    return t.frobenius_pow(2) * t


@pytest.fixture(scope="module")
def cyc():
    """One packed row of two random cyclotomic elements, and one that pairs a
    random element with the identity (so the two slots take different
    branches of the decompression)."""
    r = random.Random(0x4A2A)
    u, v = rand_cyc(r), rand_cyc(r)
    return {"els": [u, v], "rows": np.asarray(jtw.encode([u, v])),
            "mixed_els": [u, rm.Fq12.one()],
            "mixed": np.asarray(jtw.encode([u, rm.Fq12.one()]))}


def test_karabina_schedule_matches_jax():
    assert schedule._KARA_SEGMENTS == _JAX_KARA_SEGMENTS == (16, 32, 9, 3, 2, 1)
    assert ttw._KARA_IDX == jtw._KARA_IDX
    for segs in (jmpr._GS_SEGMENTS, ((2, True), (1, True), (3, False))):
        assert (list(kernels._segments_to_flags(segs))
                == rpk._segments_to_flags(segs)[0].tolist())
    assert len(kernels._segments_to_flags(schedule._GS_SEGMENTS)) == 63
    assert not jfp.use_fused()  # the JAX package's default is the Karabina branch


@pytest.mark.parametrize("case", ["compress", "square4", "decompress_stack", "identity"])
def test_karabina_tower_rows_match_jax(cyc, case):
    U = cyc["mixed"] if case == "decompress_stack" else cyc["rows"]
    if case == "compress":
        got = ttw.compress_cyclotomic(port(U))
        want = jax.jit(jtw.compress_cyclotomic)(U)
    elif case == "square4":
        def chain(tw, c):
            for _ in range(4):
                c = tw.compressed_square(c)
            return c
        got = chain(ttw, ttw.compress_cyclotomic(port(U)))
        want = jax.jit(lambda a: chain(jtw, jtw.compress_cyclotomic(a)))(U)
    elif case == "decompress_stack":
        # six chain states, the second slot the identity's all-zero state
        # (stored as multiples of p after a squaring)
        stack = kernels.kara_exp(ttw.compress_cyclotomic(port(U)), (1, 2, 1, 0, 2, 1))
        assert stack.shape == (6, 1, 8, 128)
        got = ttw.decompress_cyclotomic(stack)
        want = jax.jit(jtw.decompress_cyclotomic)(rows(stack))
        u, n = cyc["mixed_els"][0], 0
        for k, seg in enumerate((1, 2, 1, 0, 2, 1)):
            n += seg
            full = list(ttw.decode(got[k]))
            assert coeffs(full) == coeffs([u.pow(1 << n), rm.Fq12.one()])
    else:
        one = np.asarray(jtw.encode([rm.Fq12.one(), rm.Fq12.one()]))
        c = ttw.compress_cyclotomic(port(one))
        assert not c.any()
        got = ttw.decompress_cyclotomic(c)
        want = jax.jit(lambda a: jtw.decompress_cyclotomic(jtw.compress_cyclotomic(a)))(one)
        assert coeffs(ttw.decode(got)) == coeffs([rm.Fq12.one()] * 2)
    assert np.array_equal(rows(got), np.asarray(want))


@pytest.mark.parametrize("kernel", ["kara_square_run", "kara_exp", "cyc_square_run"])
def test_run_kernels_plain_match_pallas_interpret(cyc, kernel):
    U = cyc["rows"]
    C = np.asarray(jtw.compress_cyclotomic(U))
    kernels.reset_launches()
    if kernel == "kara_square_run":
        got = kernels.kara_square_run(port(C), 3)
        want = jax.jit(lambda c: rpk.kara_square_run(c, 3, block=8, interpret=True))(C)
    elif kernel == "kara_exp":
        got = kernels.kara_exp(port(C), (2, 1, 3))
        want = jax.jit(lambda c: rpk.kara_exp_run(c, (2, 1, 3), block=8,
                                                  interpret=True))(C)
        assert got.shape == (3, 1, 8, 128)
    else:
        got = kernels.cyc_square_run(port(U), 3)
        want = jax.jit(lambda a: rpk.cyc_square_run(a, 3, block=8, interpret=True))(U)
        sq3 = cyc["els"]
        for _ in range(3):
            sq3 = [rm.cyclotomic_square(u) for u in sq3]
        assert coeffs(ttw.decode(got)) == coeffs(sq3)
    assert sum(kernels.launches.values()) == 0  # the CPU takes the plain versions
    assert np.array_equal(rows(got), np.asarray(want))


def test_kara_full_plain_matches_pallas_interpret(cyc):
    """The whole Karabina exponentiation on [cyc, cyc^2, 1, cyc]: the value
    of the exact-integer oracle, and the rows of the Pallas kernel at block =
    8, where its in-kernel inversion has no tree level and raises every norm
    to p - 2 itself, as the port's does."""
    u = cyc["els"][0]
    els = [u, u * u, rm.Fq12.one(), u]
    F = np.asarray(jtw.encode(els))
    got = kernels.kara_full(port(F), schedule._KARA_SEGMENTS)
    out = ttw.decode(ttw.conjugate(got))
    assert coeffs(out) == coeffs([rm.cyclotomic_exp(x) for x in els])
    want = rpk.kara_full_run(F, _JAX_KARA_SEGMENTS, block=8, interpret=True)
    assert np.array_equal(rows(got), np.asarray(want))


@pytest.fixture(scope="module")
def exp_rows(cyc):
    """cyclotomic_exp of the mixed row under every form, computed once."""
    f = port(cyc["mixed"])
    return {impl: tmpr.cyclotomic_exp(f, impl) for impl in tmpr.EXP_IMPLS}


@pytest.mark.parametrize("impl", tmpr.EXP_IMPLS)
def test_cyclotomic_exp_forms(cyc, exp_rows, impl):
    got = exp_rows[impl]
    want = [rm.cyclotomic_exp(x) for x in cyc["mixed_els"]]
    assert coeffs(ttw.decode(got)) == coeffs(want)
    if impl in ("segments", "cond", "runs"):
        assert torch.equal(got, exp_rows["segments"])
        if impl == "segments":
            pallas = rpk.cyc_exp_run(cyc["mixed"], jmpr._GS_SEGMENTS, interpret=True)
            assert np.array_equal(rows(got), np.asarray(jtw.conjugate(pallas)))
    elif impl in ("karabina", "karabina_runs"):
        assert torch.equal(got, exp_rows["karabina"])
        if impl == "karabina":
            want_rows = jax.jit(jmpr.cyclotomic_exp)(cyc["mixed"])
            assert np.array_equal(rows(got), np.asarray(want_rows))


def test_unknown_impl_raises(cyc):
    f = port(cyc["rows"])
    with pytest.raises(ValueError, match="impl"):
        tmpr.cyclotomic_exp(f, "fused")
    with pytest.raises(ValueError, match="impl"):
        tmpr.final_exponentiation(f, impl="")


def test_final_exponentiation_karabina_rows_match_jax():
    r = random.Random(0x4A2B)
    F = np.asarray(jtw.encode([rm.rand_fq12(r), rm.rand_fq12(r)]))
    got = tmpr.final_exponentiation(port(F), impl="karabina")
    want = jax.jit(jmpr.final_exponentiation)(F)
    assert np.array_equal(rows(got), np.asarray(want))


def test_pairing_karabina_rows_match_jax():
    """The slice as a whole: e(P, Q) row for row, one input at infinity."""
    r = random.Random(0x4A2C)
    ps = [rm.rand_g1(r), rm.G1Affine(0, 0, True)]
    qs = [rm.rand_g2(r), rm.rand_g2(r)]
    jp, jq = G1Affine.encode(ps), G2Affine.encode(qs)
    a = np.asarray
    p = interop.g1_from_numpy(a(jp.x), a(jp.y), a(jp.infinity), device="cpu")
    q = interop.g2_from_numpy(a(jq.x), a(jq.y), a(jq.infinity), device="cpu")
    got = tmpr.pairing(p, q, impl="karabina")
    want = jax.jit(jmpr.pairing)(jp, jq)
    assert np.array_equal(rows(got), np.asarray(want))
    assert coeffs(ttw.decode(got)) == coeffs([rm.pairing(ps[0], qs[0]), rm.Fq12.one()])


@pytest.mark.parametrize("impl", ["karabina", "karabina_full"])
def test_pairing_kat_vectors_karabina(impl):
    with open(_KAT) as f:
        vectors = json.load(f)["vectors"]
    ps = [rm.G1Affine(int(v["p_x"], 16), int(v["p_y"], 16), False) for v in vectors]
    qs = [rm.G2Affine(rm.Fq2(int(v["q_x"][0], 16), int(v["q_x"][1], 16)),
                      rm.Fq2(int(v["q_y"][0], 16), int(v["q_y"][1], 16)), False)
          for v in vectors]
    out = tmpr.pairing(tl.G1Affine.encode(ps, device="cpu"),
                       tl.G2Affine.encode(qs, device="cpu"), impl=impl)
    got = coeffs(ttw.decode(out))[: len(vectors)]
    assert got == [[int(h, 16) for h in v["e_chain"]] for v in vectors]
    assert len(got) == 9
