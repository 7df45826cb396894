"""The port's data-parallel mesh (parallel/mesh.py) in one process on the
CPU: the two product trees row for row against the JAX package's on random
rows (padding with ones included), the shard layouts (the trivial mesh of
one rank, and the blocks of a larger world as index arithmetic, with no
process group), the refusal of a batch that does not divide, and the
collectives each call issues, counted in a gloo group of one rank.
Zero tolerance: integer rows."""

import random

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.ops import curve, fq12
from plonky2_bls12_381_pairing_torch.ops.rns import tower
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.parallel import mesh as tpm
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu.parallel import mesh as jpm

torch.set_num_threads(1)

CPU = torch.device("cpu")


def fq12s(n: int, seed: int) -> list:
    r = random.Random(seed)
    return [rm.rand_fq12(r) for _ in range(n)]


def product(xs) -> rm.Fq12:
    out = rm.Fq12.one()
    for x in xs:
        out = out * x
    return out


@pytest.mark.parametrize("n", [3, 8])
def test_product_tree_rows_match_jax(n):
    xs = fq12s(n, 0x7EE + n)
    e = fq12.encode(xs)
    got = tpm.product_tree(torch.from_numpy(e))
    want = np.asarray(jax.jit(jpm.product_tree)(e))
    assert np.array_equal(interop.to_numpy(got), want)
    assert fq12.decode(got).coeffs() == product(xs).coeffs()


@pytest.mark.parametrize("n", [3, 8])
def test_rns_product_tree_rows_match_jax(n):
    """n packed rows (2n elements); 3 rows pad to 4 with ones."""
    xs = fq12s(2 * n, 0x7EF + n)
    e = tower.encode(xs)
    got = tpm.rns_product_tree(torch.from_numpy(e))
    want = np.asarray(jax.jit(jpm.rns_product_tree)(e))
    assert np.array_equal(interop.to_numpy(got), want)
    assert list(tower.decode(got[None])) == [product(xs)] * 2


def points(n: int, seed: int):
    """n point pairs k*G1, (seed + k)*G2: distinct, and quick to make."""
    g1, g2 = rm.G1Affine.generator(), rm.G2Affine.generator()
    return [g1.mul(k + 1) for k in range(n)], [g2.mul(seed + k) for k in range(n)]


def test_trivial_mesh_shards_whole_batch():
    assert not dist.is_initialized()
    mesh = tpm.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, CPU)
    assert mesh.axis_names == (tpm.DP_AXIS,) == ("dp",)
    ps, qs = points(4, 0x51)
    for p, q, shard in (
            (curve.G1Affine.encode(ps, device="cpu"), curve.G2Affine.encode(qs, device="cpu"),
             tpm.shard_points),
            (G1Affine.encode(ps, device="cpu"), G2Affine.encode(qs, device="cpu"),
             tpm.shard_points_rns)):
        sp, sq = shard(p, q, mesh)
        for a, b in ((p, sp), (q, sq)):
            for k in ("x", "y", "infinity"):
                assert torch.equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("tier", ["limb", "rns"])
def test_shard_blocks_of_a_larger_world(tier):
    """Four ranks as index arithmetic (no process group): rank r holds the
    r-th contiguous quarter of the elements (limb) or packed rows (RNS), as
    the JAX package's P("dp") places them."""
    ps, qs = points(8, 0x52)
    if tier == "limb":
        p, q = curve.G1Affine.encode(ps, device="cpu"), curve.G2Affine.encode(qs, device="cpu")
        shard, n = tpm.shard_points, 8
    else:
        p, q = G1Affine.encode(ps, device="cpu"), G2Affine.encode(qs, device="cpu")
        shard, n = tpm.shard_points_rns, 4
    blocks = []
    for rank in range(4):
        mesh = tpm.Mesh(None, rank, 4, CPU)
        assert tpm.shard_block(n, mesh) == slice(rank * n // 4, (rank + 1) * n // 4)
        blocks.append(shard(p, q, mesh))
    for pt, i in ((p, 0), (q, 1)):
        for k in ("x", "y", "infinity"):
            parts = [getattr(b[i], k) for b in blocks]
            assert all(t.shape[0] == n // 4 for t in parts)
            assert torch.equal(torch.cat(parts), getattr(pt, k))


def test_batch_that_does_not_divide_is_refused():
    ps, qs = points(6, 0x53)  # 6 elements, 3 packed rows
    mesh = tpm.Mesh(None, 0, 4, CPU)
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        tpm.shard_points(curve.G1Affine.encode(ps, device="cpu"),
                         curve.G2Affine.encode(qs, device="cpu"), mesh)
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        tpm.shard_points_rns(G1Affine.encode(ps, device="cpu"),
                             G2Affine.encode(qs, device="cpu"), mesh)
    with pytest.raises(ValueError, match="torch.distributed is not initialised"):
        tpm.make_mesh(group=object(), device="cpu")


@pytest.fixture
def one_rank_group(tmp_path, monkeypatch):
    """A gloo group of one rank in this process, with dist.all_gather
    counted apart from the module's own counter."""
    calls = []
    gather = dist.all_gather

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return gather(*args, **kwargs)

    monkeypatch.setattr(dist, "all_gather", counted)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        yield calls
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_points():
    """Two RNS elements (one packed row) and the first as a limb element,
    with the RNS tier's single-process pairing and product of them."""
    ps, qs = points(2, 0x54)
    rp, rq = G1Affine.encode(ps, device="cpu"), G2Affine.encode(qs, device="cpu")
    lp = curve.G1Affine.encode(ps[:1], device="cpu")
    lq = curve.G2Affine.encode(qs[:1], device="cpu")
    return ps, qs, (rp, rq), (lp, lq), tpm.rns_pairing_and_product(rp, rq)


def test_collectives_per_call(one_rank_group, two_points):
    """One all_gather per call that forms the product, none in the
    per-instance pairing; a rank's results are the single-process ones."""
    calls = one_rank_group
    ps, qs, rns, limb, (we, wgt) = two_points
    mesh = tpm.make_mesh(device="cpu")
    assert (mesh.group is dist.group.WORLD, mesh.rank, mesh.size) == (True, 0, 1)
    rp, rq = tpm.shard_points_rns(*rns, mesh)
    lp, lq = tpm.shard_points(*limb, mesh)
    counts = {}
    results = {}
    for name, fn, args in (
            ("pairing_sharded", tpm.pairing_sharded(mesh), (lp, lq)),
            ("pairing_and_product_sharded", tpm.pairing_and_product_sharded(mesh), (lp, lq)),
            ("multi_pairing_product_sharded", tpm.multi_pairing_product_sharded(mesh),
             (lp, lq)),
            ("rns_pairing_and_product_sharded", tpm.rns_pairing_and_product_sharded(mesh),
             (rp, rq))):
        tpm.reset_collectives()
        before = len(calls)
        results[name] = fn(*args)
        counts[name] = (tpm.collectives["all_gather"], len(calls) - before)
    assert counts == {"pairing_sharded": (0, 0), "pairing_and_product_sharded": (1, 1),
                      "multi_pairing_product_sharded": (1, 1),
                      "rns_pairing_and_product_sharded": (1, 1)}
    e, gt = results["rns_pairing_and_product_sharded"]
    assert torch.equal(e, we) and torch.equal(gt, wgt)
    e01 = rm.pairing(ps[0], qs[0])
    assert list(tower.decode(gt[None])) == [e01 * rm.pairing(ps[1], qs[1])] * 2
    le = results["pairing_sharded"]
    assert fq12.decode(le[0]) == e01
    assert torch.equal(results["pairing_and_product_sharded"][0], le)
    assert torch.equal(results["pairing_and_product_sharded"][1], tpm.product_tree(le))
    assert fq12.decode(results["multi_pairing_product_sharded"]) == e01


def test_trivial_mesh_issues_no_collective(two_points):
    _, _, rns, _, (we, wgt) = two_points
    mesh = tpm.make_mesh(device="cpu")
    p, q = tpm.shard_points_rns(*rns, mesh)
    tpm.reset_collectives()
    e, gt = tpm.rns_pairing_and_product_sharded(mesh)(p, q)
    assert tpm.collectives["all_gather"] == 0
    assert torch.equal(e, we) and torch.equal(gt, wgt)


def test_scaling_report_curve(tmp_path, monkeypatch):
    """scaling_report_torch.py's curve over N = 1, 2, 4 ranks (each N's run
    stood in for by fixed times; its spawn of ranks is dryrun_multichip's):
    efficiency divided by the largest N run, the line written only where
    --out says."""
    import json

    import scaling_report_torch

    times = {1: 3.0, 2: 2.0, 4: 1.5}
    monkeypatch.setattr(scaling_report_torch, "run_on", lambda n, device, batch, reps: {
        "t_s": times[n], "first_call_s": 2 * times[n]})
    out = tmp_path / "scaling.json"
    rep = scaling_report_torch.main(["--device", "cpu", "--ranks", "6", "--batch", "4",
                                     "--out", str(out)])
    assert json.loads(out.read_text()) == rep
    assert sorted(rep["device_curve"]) == ["1", "2", "4"] and rep["n_devices"] == 4
    assert rep["efficiency"] == 3.0 / (4 * 1.5) and rep["speedup"] == 2.0
    assert rep["platform"] == "cpu" and rep["batch"] == 4
    assert list(tmp_path.iterdir()) == [out]
