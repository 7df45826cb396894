"""Rank bodies for the multi-process tests of the port's sharding
(tests/test_torch_multihost.py, tests/test_torch_mesh.py).

Each function runs in a process that parallel/multihost.py spawn_ranks
starts: a fresh interpreter that imports this module to find the function,
so the module imports only torch and the port, never jax. Each rank joins a
gloo process group on the CPU at the test's file:// rendezvous, runs its
shard and returns numpy rows, the collectives it issued and whether jax was
imported in its process.
"""

import sys

import torch

from plonky2_bls12_381_pairing_torch.parallel import mesh as pm
from plonky2_bls12_381_pairing_torch.parallel import multihost


def _join(rank: int, size: int, rendezvous: str) -> pm.Mesh:
    torch.set_num_threads(1)  # the ranks are the parallelism
    dev = multihost.initialize(rendezvous, size, rank, device="cpu")
    assert torch.distributed.get_backend() == "gloo"
    return pm.make_mesh(device=dev)


def _report(**rows) -> dict:
    return {**{k: v.numpy() for k, v in rows.items()},
            "all_gather": pm.collectives["all_gather"], "jax": "jax" in sys.modules}


def rns_rank(rank: int, size: int, rendezvous: str, p, q) -> dict:
    """rns_pairing_and_product_sharded on this rank's packed rows of the
    global RNS points (p, q)."""
    mesh = _join(rank, size, rendezvous)
    ps, qs = pm.shard_points_rns(p, q, mesh)
    e, gt = pm.rns_pairing_and_product_sharded(mesh)(ps, qs)
    return _report(e=e, gt=gt)


def limb_rank(rank: int, size: int, rendezvous: str, p, q) -> dict:
    """pairing_and_product_sharded on this rank's elements of the global
    limb points (p, q)."""
    mesh = _join(rank, size, rendezvous)
    ps, qs = pm.shard_points(p, q, mesh)
    e, gt = pm.pairing_and_product_sharded(mesh)(ps, qs)
    return _report(e=e, gt=gt)


def multihost_rank(rank: int, size: int, rendezvous: str, batch: int) -> dict:
    """multihost.run on this rank: its own points k*G1, k*G2."""
    torch.set_num_threads(1)
    multihost.initialize(rendezvous, size, rank, device="cpu")
    e, gt = multihost.run(batch, device="cpu")
    return _report(e=e, gt=gt)


def failing_rank(rank: int, size: int, rendezvous: str) -> dict:
    """Rank 1 raises after joining; rank 0 waits at a barrier it never
    passes, until spawn_ranks stops it."""
    _join(rank, size, rendezvous)
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()
    return {}
