"""The port's entry point (the JAX package's __graft_entry__.py).

    fn, args = entry()          # on the card
    out = fn(*args)             # eager: one call, launch by launch
    step = capture(fn, *args)   # utils/capture.py: the whole call as one
    out = step(*args)           # CUDA graph replay, the counterpart of jax.jit

    dryrun_multichip(n)         # the sharded pairing and product, one
                                # step on n ranks (parallel/mesh.py)

The JAX entry's persistent compilation cache has no counterpart: the CUDA
kernels are built once into build/torch_kernels/<hash>/ (ops/cuda_build.py),
which is the port's cache; a rank started later loads them from there.
"""

from __future__ import annotations

import tempfile

import torch

from .models import pairing_rns
from .ops.rns.lines import G1Affine, G2Affine
from .parallel import mesh as pm
from .parallel import multihost

#: elements of the entry's example batch (two packed rows)
BATCH = 4


def entry(device=None):
    """(fn, example_args): the batched BLS12-381 pairing e(P, Q) on the RNS
    tier (models/pairing_rns.py pairing) and BATCH generator pairs to call it
    on, on the card unless `device` names another (device="cpu")."""
    p = G1Affine.generator((BATCH,), device)
    q = G2Affine.generator((BATCH,), device)
    return pairing_rns.pairing, (p, q)


def _dryrun_rank(rank: int, size: int, rendezvous: str, device) -> list:
    """One rank of dryrun_multichip: its packed row of generator pairs, the
    sharded pairing and product, the shapes asserted; the product's values
    go back to compare across ranks."""
    dev = multihost.initialize(rendezvous, size, rank, device=device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks are the parallelism
    m = pm.make_mesh(device=dev)
    b = 2 * size  # one packed row per rank
    ps, qs = pm.shard_points_rns(G1Affine.generator((b,), "cpu"),
                                 G2Affine.generator((b,), "cpu"), m)
    e, gt = pm.rns_pairing_and_product_sharded(m)(ps, qs)
    assert e.shape == (1, 12, 128), e.shape
    assert gt.shape == (12, 128), gt.shape
    return gt.cpu().tolist()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Shard the RNS pairing step over n_devices ranks and run it once.

    Each rank is a process with one packed row of generator pairs (B = 2 *
    n_devices): the row-sharded pairing, then the product of the whole
    batch, whose rows every rank gathers once. On the cards (device None) it
    needs n_devices cards, one per rank, and raises otherwise; with
    device="cpu" the ranks run on the CPU over gloo.
    """
    if device is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_devices:
            raise RuntimeError(f"need {n_devices} cards, have {cards}")
    with tempfile.TemporaryDirectory() as tmp:
        gts = multihost.spawn_ranks(_dryrun_rank, n_devices, f"file://{tmp}/rendezvous",
                                    device)
    assert all(g == gts[0] for g in gts), "the ranks' products differ"
