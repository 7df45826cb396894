"""The port's sharded pairing across processes (parallel/mesh.py,
parallel/multihost.py, entry.dryrun_multichip) on the CPU: gloo ranks, one
packed row (or one element) per rank, each rank a spawned process running a
body of tests/torch_dist_worker.py (no jax in it) at a file:// rendezvous
under tmp_path, with its own timeout.

At one packed row per rank every shard and the whole batch are under fp.inv's
128-row tree floor, so each rank's e rows are the single-process rows bit
for bit; the product is the JAX package's rns_product_tree of the gathered
rows, and the oracle's product in value. Zero tolerance: integer rows."""

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from plonky2_bls12_381_pairing_torch import entry, interop
from plonky2_bls12_381_pairing_torch.models import pairing as tmp_
from plonky2_bls12_381_pairing_torch.models import pairing_rns as tmpr
from plonky2_bls12_381_pairing_torch.ops import curve, fq12
from plonky2_bls12_381_pairing_torch.ops.rns import tower
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.parallel import mesh as tpm
from plonky2_bls12_381_pairing_torch.parallel import multihost
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu.parallel import mesh as jpm

torch.set_num_threads(1)

#: seconds a spawn of ranks may take before its ranks are killed
SPAWN_TIMEOUT = 120.0
INF1 = rm.G1Affine(0, 0, True)


def spawn(tmp_path, fn, size, *args):
    return multihost.spawn_ranks(fn, size, f"file://{tmp_path}/rendezvous", *args,
                                 timeout=SPAWN_TIMEOUT)


def batch(n: int, seed: int):
    """n point pairs k*G1, (seed + k)*G2, the second G1 point at infinity."""
    g1, g2 = rm.G1Affine.generator(), rm.G2Affine.generator()
    ps = [g1.mul(k + 1) for k in range(n)]
    ps[1] = INF1
    return ps, [g2.mul(seed + k) for k in range(n)]


def oracle_product(ps, qs) -> rm.Fq12:
    out = rm.Fq12.one()
    for p, q in zip(ps, qs):
        out = out * rm.pairing(p, q)
    return out


@pytest.mark.parametrize("size", [2, 4])
def test_rns_sharded_at_world_sizes(tmp_path, size):
    ps, qs = batch(2 * size, 7 + size)  # one packed row per rank
    p, q = G1Affine.encode(ps, device="cpu"), G2Affine.encode(qs, device="cpu")
    ranks = spawn(tmp_path, worker.rns_rank, size, p, q)
    assert not any(r["jax"] for r in ranks)
    assert all(r["all_gather"] == 1 for r in ranks)
    e = np.concatenate([r["e"] for r in ranks])
    assert all(r["e"].shape == (1, 12, 128) for r in ranks)
    # the e shards are the single-process rows (all under the tree floor)
    assert np.array_equal(e, interop.to_numpy(tmpr.multi_pairing([p], [q])))
    assert list(tower.decode(torch.from_numpy(e)).reshape(-1)) == [
        rm.pairing(a, b) for a, b in zip(ps, qs)]
    # the product: the same rows on every rank, the JAX package's tree of the
    # gathered rows, the oracle's product in both packed slots
    want = np.asarray(jax.jit(jpm.rns_product_tree)(e))
    assert all(np.array_equal(r["gt"], want) for r in ranks)
    gt = tower.decode(torch.from_numpy(want.copy())[None])
    assert list(gt.reshape(-1)) == [oracle_product(ps, qs)] * 2


def test_limb_pairing_and_product_sharded(tmp_path):
    ps, qs = batch(2, 5)
    p, q = curve.G1Affine.encode(ps, device="cpu"), curve.G2Affine.encode(qs, device="cpu")
    ranks = spawn(tmp_path, worker.limb_rank, 2, p, q)
    assert not any(r["jax"] for r in ranks)
    assert all(r["all_gather"] == 1 for r in ranks)
    e = np.concatenate([r["e"] for r in ranks])
    assert np.array_equal(e, interop.to_numpy(tmp_.pairing(p, q)))
    want = interop.to_numpy(tpm.product_tree(torch.from_numpy(e)))
    assert all(np.array_equal(r["gt"], want) for r in ranks)
    assert fq12.decode(torch.from_numpy(want)) == oracle_product(ps, qs)


def test_multihost_run(tmp_path):
    ranks = spawn(tmp_path, worker.multihost_rank, 2, 2)
    assert not any(r["jax"] for r in ranks)
    g1, g2 = rm.G1Affine.generator(), rm.G2Affine.generator()
    want = [rm.pairing(g1.mul(k), g2.mul(k)) for k in range(1, 5)]
    got = [x for r in ranks for x in tower.decode(torch.from_numpy(r["e"])).reshape(-1)]
    assert got == want
    prod = want[0] * want[1] * want[2] * want[3]
    for r in ranks:
        assert list(tower.decode(torch.from_numpy(r["gt"])[None]).reshape(-1)) == [prod] * 2


def test_spawn_ranks_reports_a_failing_rank(tmp_path):
    """A rank that raises stops the run at once (not at the 120 s timeout
    that its partner's barrier would wait for), with its traceback."""
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*fails on purpose"):
        spawn(tmp_path, worker.failing_rank, 2)


def test_dryrun_multichip_cpu():
    entry.dryrun_multichip(2, device="cpu")


def test_initialize_picks_backend_and_device(monkeypatch):
    """nccl for a rank on a card, gloo on the CPU, unless one is named; the
    device cuda:<process id> unless named; a card index beyond the host's
    count raises; one process starts no group. (Card calls stood in for.)"""
    joined = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    assert multihost.initialize("host0:1234", 2, 1) == torch.device("cuda", 1)
    assert multihost.initialize("file:///tmp/r", 2, 0, device="cpu") == torch.device("cpu")
    multihost.initialize("host0:1234", 2, 0, backend="gloo", device="cuda:1")
    assert multihost.initialize(None, 1, 0, device="cpu") == torch.device("cpu")
    assert joined == [
        ("nccl", {"init_method": "tcp://host0:1234", "world_size": 2, "rank": 1}),
        ("gloo", {"init_method": "file:///tmp/r", "world_size": 2, "rank": 0}),
        ("gloo", {"init_method": "tcp://host0:1234", "world_size": 2, "rank": 0})]
    with pytest.raises(RuntimeError, match="no card cuda:2 on this host"):
        multihost.initialize("host0:1234", 3, 2)
    with pytest.raises(ValueError, match="needs a coordinator"):
        multihost.initialize(None, 2, 0, device="cpu")


def test_dryrun_multichip_needs_its_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 cards, have 1"):
        entry.dryrun_multichip(2)
