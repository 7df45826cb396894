"""Checkpoint and resume (utils/checkpoint.py) on the CPU, both tiers:
  * kill and resume: a run stopped by fail_after_steps, then resumed from
    its state file, gives the rows of the uninterrupted run and of the
    untraced miller_loop + final_exponentiation, and the oracle's values
    (one packed row on the RNS tier, one element on the limb tier);
  * the accumulator saved after each chunk is the Miller loop's after that
    many steps, also with a chunk length that does not divide the 68 steps;
  * state files cross between the packages: the port's load in the JAX
    package's load_state, the JAX package's in the port's.
Tolerance 0 throughout."""

import dataclasses
import os
import random

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch.models import pairing as tmp
from plonky2_bls12_381_pairing_torch.models import pairing_rns as tmpr
from plonky2_bls12_381_pairing_torch.ops import curve as tcurve
from plonky2_bls12_381_pairing_torch.ops import fq12 as tfq12
from plonky2_bls12_381_pairing_torch.ops.rns import kernels
from plonky2_bls12_381_pairing_torch.ops.rns import lines as tl
from plonky2_bls12_381_pairing_torch.ops.rns import tower as ttw
from plonky2_bls12_381_pairing_torch.utils import checkpoint as tck
from plonky2_bls12_381_pairing_tpu.utils import checkpoint as jck
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm

torch.set_num_threads(1)


def coeffs(xs):
    return [x.coeffs() for x in xs]


@pytest.fixture(scope="module")
def rns_job():
    r = random.Random(0xC4)
    ps = [rm.rand_g1(r), rm.G1Affine(0, 0, True)]
    qs = [rm.rand_g2(r), rm.rand_g2(r)]
    p = tl.G1Affine.encode(ps, device="cpu")
    q = tl.G2Affine.encode(qs, device="cpu")
    prepared = tmpr.prepare_g2_stepmajor(q)
    f = tmpr.miller_loop(p, prepared, q.infinity)
    return ps, qs, p, q, prepared, f, tmpr.final_exponentiation(f)


def test_rns_kill_and_resume(rns_job, tmp_path):
    ps, qs, p, q, prepared, _, want = rns_job
    ckpt = str(tmp_path / "rns.npz")
    with pytest.raises(RuntimeError, match="injected failure"):
        tck.run_pairing_checkpointed_rns(p, prepared, q.infinity, ckpt_path=ckpt,
                                         every=17, fail_after_steps=17)
    _, start = tck.load_state(ckpt)
    assert start == 17
    gt = tck.run_pairing_checkpointed_rns(p, prepared, q.infinity, ckpt_path=ckpt, every=17)
    assert torch.equal(gt, want)
    clean = tck.run_pairing_checkpointed_rns(p, prepared, q.infinity,
                                             ckpt_path=str(tmp_path / "clean.npz"), every=68)
    assert torch.equal(clean, want)
    assert coeffs(ttw.decode(gt)) == coeffs([rm.pairing(ps[0], qs[0]), rm.Fq12.one()])


@pytest.mark.parametrize("every", [17, 20])
def test_rns_chunks_save_the_miller_rows(rns_job, tmp_path, every):
    """Each chunk's saved accumulator is miller_run's over the steps so far,
    and the last is the uninterrupted loop's before its conjugation; 20 does
    not divide the 68 steps."""
    _, _, p, q, prepared, f, _ = rns_job
    saved = []
    save = tck.save_state
    tck.save_state = lambda path, f, step: (saved.append((f.clone(), step)),
                                            save(path, f, step))
    try:
        tck.run_pairing_checkpointed_rns(p, prepared, q.infinity,
                                         ckpt_path=str(tmp_path / "s.npz"), every=every)
    finally:
        tck.save_state = save
    steps = [s for _, s in saved]
    assert steps == list(range(every, 68, every)) + [68]
    skip = ((p.infinity != 0) | (q.infinity != 0)).to(torch.int32)
    for acc, stop in saved[:-1]:
        want = kernels.miller_run(ttw.one((1,), "cpu"), prepared[:stop], p.y, p.x, skip,
                                  tmpr._DO_SQUARE[:stop])
        assert torch.equal(acc, want), stop
    assert torch.equal(ttw.conjugate(saved[-1][0]), f)


def test_limb_kill_and_resume(tmp_path):
    r = random.Random(0xC5)
    ps, qs = [rm.rand_g1(r)], [rm.rand_g2(r)]
    p = tcurve.G1Affine.encode(ps, device="cpu")
    q = tcurve.G2Affine.encode(qs, device="cpu")
    prepared = tmp.prepare_g2(q)
    want = tmp.final_exponentiation(tmp.miller_loop(p, prepared, q.infinity))
    ckpt = str(tmp_path / "limb.npz")
    with pytest.raises(RuntimeError, match="injected failure"):
        tck.run_pairing_checkpointed(p, prepared, q.infinity, ckpt_path=ckpt, every=20,
                                     fail_after_steps=20)
    _, start = tck.load_state(ckpt)
    assert 0 < start < tmp.NUM_COEFFS
    gt = tck.run_pairing_checkpointed(p, prepared, q.infinity, ckpt_path=ckpt, every=20)
    assert torch.equal(gt, want)
    assert coeffs(tfq12.decode(gt)) == coeffs([rm.pairing(ps[0], qs[0])])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_state_files_cross_between_packages(tmp_path, writer):
    f = np.random.default_rng(0xC6).integers(0, 1 << 13, (2, 12, 128), dtype=np.int32)
    path = str(tmp_path / "state.npz")
    if writer == "port":
        tck.save_state(path, torch.from_numpy(f), 34)
        g, step = jck.load_state(path)
    else:
        jck.save_state(path, f, 34)
        g, step = tck.load_state(path)
    assert step == 34 and g.dtype == np.int32 and np.array_equal(g, f)
    assert not os.path.exists(path + ".tmp.npz")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: miller_run's kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_rns_kill_and_resume_on_card(cuda, rns_job, tmp_path):
    """One miller_run launch per chunk, and the CPU run's rows."""
    _, _, p, q, prepared, _, want = rns_job
    p = dataclasses.replace(p, x=p.x.to(cuda), y=p.y.to(cuda), infinity=p.infinity.to(cuda))
    qinf, prepared = q.infinity.to(cuda), prepared.to(cuda)
    ckpt = str(tmp_path / "rns.npz")
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="injected failure"):
        tck.run_pairing_checkpointed_rns(p, prepared, qinf, ckpt_path=ckpt, every=17,
                                         fail_after_steps=17)
    assert kernels.launches["miller_run"] == 1
    gt = tck.run_pairing_checkpointed_rns(p, prepared, qinf, ckpt_path=ckpt, every=17)
    assert kernels.launches["miller_run"] == 4
    assert torch.equal(gt.cpu(), want)
