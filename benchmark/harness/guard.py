"""The run's own look for JAX: the modules a process has loaded, by whole
top-level name (the part before the first dot). The port's package name
begins with the JAX package's, so a prefix would not do."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "plonky2_bls12_381_pairing_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded() -> list[str]:
    """The forbidden top-level names among sys.modules."""
    return sorted({top_level(m) for m in list(sys.modules)} & FORBIDDEN)
