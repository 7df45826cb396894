"""The port's entry point (the JAX package's __graft_entry__.py).

    fn, args = entry()          # on the card
    out = fn(*args)             # eager: one call, launch by launch
    step = capture(fn, *args)   # utils/capture.py: the whole call as one
    out = step(*args)           # CUDA graph replay, the counterpart of jax.jit

The JAX entry's persistent compilation cache has no counterpart: the CUDA
kernels are built once into build/torch_kernels/<hash>/ (ops/cuda_build.py),
which is the port's cache. Its multi-chip dry run waits for the port's
sharding.
"""

from __future__ import annotations

from .models import pairing_rns
from .ops.rns.lines import G1Affine, G2Affine

#: elements of the entry's example batch (two packed rows)
BATCH = 4


def entry(device=None):
    """(fn, example_args): the batched BLS12-381 pairing e(P, Q) on the RNS
    tier (models/pairing_rns.py pairing) and BATCH generator pairs to call it
    on, on the card unless `device` names another (device="cpu")."""
    p = G1Affine.generator((BATCH,), device)
    q = G2Affine.generator((BATCH,), device)
    return pairing_rns.pairing, (p, q)
