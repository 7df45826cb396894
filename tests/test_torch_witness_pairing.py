"""The traced RNS pairing on the CPU at one packed row (two pairings, one
input at infinity):
  * its trace checks clean, and its output is the untraced
    pairing(impl="karabina")'s rows (the form a trace takes, whose rows
    tests/test_torch_karabina.py holds to the JAX package's) and the oracle's
    values, whatever impl the caller passed;
  * its rows: 1 + 5 rns_inv records per call (the easy part's tower.inv and
    the five decompressions' shared inversions), and every row bit for bit
    the JAX package's eager traces of those two recording pieces,
    tower.inv and tower.decompress_cyclotomic, on the same inputs (a JAX
    trace of the whole pairing is not run: it is the slowest test of the
    JAX package's suite);
  * the limb tier's traced pairing checks clean and equals the oracle.
Tolerance 0 throughout."""

import random

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.models import pairing as tmp
from plonky2_bls12_381_pairing_torch.models import pairing_rns as tmpr
from plonky2_bls12_381_pairing_torch.models import witness as twt
from plonky2_bls12_381_pairing_torch.ops import curve as tcurve
from plonky2_bls12_381_pairing_torch.ops import fq12 as tfq12
from plonky2_bls12_381_pairing_torch.ops.rns import tower as ttw
from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw
from plonky2_bls12_381_pairing_tpu.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm
from torch_jax_witness import jax_trace

torch.set_num_threads(1)


def coeffs(xs):
    return [x.coeffs() for x in xs]


@pytest.fixture(scope="module")
def points():
    r = random.Random(0x7A11)
    ps = [rm.rand_g1(r), rm.G1Affine(0, 0, True)]
    qs = [rm.rand_g2(r), rm.rand_g2(r)]
    jp, jq = G1Affine.encode(ps), G2Affine.encode(qs)
    a = np.asarray
    p = interop.g1_from_numpy(a(jp.x), a(jp.y), a(jp.infinity), device="cpu")
    q = interop.g2_from_numpy(a(jq.x), a(jq.y), a(jq.infinity), device="cpu")
    return ps, qs, p, q


@pytest.fixture(scope="module")
def traced(points):
    """The port's trace of pairing, with the inputs of its recording pieces
    (tower.inv's and each decompress_cyclotomic's) kept on the side."""
    _, _, p, q = points
    pieces = []
    inv, dec = ttw.inv, ttw.decompress_cyclotomic

    def keep(name, fn):
        def run(x):
            pieces.append((name, x.clone()))
            return fn(x)
        return run

    ttw.inv, ttw.decompress_cyclotomic = keep("inv", inv), keep("dec", dec)
    try:
        out, tr = twt.trace(tmpr.pairing, p, q)
    finally:
        ttw.inv, ttw.decompress_cyclotomic = inv, dec
    return out, tr, pieces


def test_traced_pairing_checks_clean_and_is_the_karabina_form(points, traced):
    ps, qs, p, q = points
    out, tr, _ = traced
    assert set(tr.counts()) == {"rns_mul", "rns_inv"}
    # six inversions, none above the product tree's floor: six select-form
    # Fermat chains of two products per bit of p - 2 after its leading one
    assert tr.counts() == {"rns_mul": 6 * 2 * ((rm.P - 2).bit_length() - 1), "rns_inv": 1 + 5}
    assert all(v == 0 for v in twt.check_trace(tr).values())
    assert torch.equal(out, tmpr.pairing(p, q, impl="karabina"))
    assert coeffs(ttw.decode(out)) == coeffs([rm.pairing(ps[0], qs[0]), rm.Fq12.one()])


def test_traced_pairing_rows_match_jax_pieces(traced):
    """The JAX package's eager traces of the pieces, in the order the port's
    pairing ran them, give the port's rows of each kind in order."""
    _, tr, pieces = traced
    assert [name for name, _ in pieces] == ["inv"] + ["dec"] * 5
    jrows: dict = {}
    for name, x in pieces:
        fn = jtw.inv if name == "inv" else jtw.decompress_cyclotomic
        _, jtr = jax_trace(fn, x.numpy())
        for op, rows in jtr.rows.items():
            jrows.setdefault(op, []).extend(rows)
    assert {op: len(v) for op, v in jrows.items()} == tr.counts()
    for op, rows in jrows.items():
        for i, (jr, trow) in enumerate(zip(rows, tr.rows[op])):
            for a, b in zip(jr, trow):
                assert np.array_equal(np.broadcast_to(np.asarray(a), b.shape),
                                      b.numpy()), (op, i)


@pytest.mark.parametrize("impl", ["segments", "karabina_full"])
def test_trace_takes_the_karabina_form_for_any_impl(points, traced, impl):
    _, _, p, q = points
    out, tr, _ = traced
    out2, tr2 = twt.trace(tmpr.pairing, p, q, impl)
    assert torch.equal(out2, out) and tr2.counts() == tr.counts()
    assert tmpr._EXP_FORM is None  # the caller's form again after the trace


def test_limb_traced_pairing_checks_clean():
    r = random.Random(0x7A12)
    ps, qs = [rm.rand_g1(r)], [rm.rand_g2(r)]
    p = tcurve.G1Affine.encode(ps, device="cpu")
    q = tcurve.G2Affine.encode(qs, device="cpu")
    out, tr = twt.trace(tmp.pairing, p, q)
    assert set(tr.counts()) == {"mul", "inv", "fq2_inv", "fq6_inv", "fq12_inv"}
    assert all(v == 0 for v in twt.check_trace(tr).values())
    assert coeffs(tfq12.decode(out)) == coeffs([rm.pairing(ps[0], qs[0])])
