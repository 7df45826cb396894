"""The JAX package's witness trace as the port's tests take it.

The JAX package's eager `trace` records a scan's products through ordered
host callbacks, which run as the computation does, after `fn` has returned
its (not yet computed) outputs; it removes its sink when `fn` returns, and a
callback that runs after that records nothing. `jax_trace` waits for `fn`'s
outputs inside the trace, so every row is recorded however the host's load
delays the computation."""

import jax

from plonky2_bls12_381_pairing_tpu.models import witness as jwt


def jax_trace(fn, *args, **kwargs):
    """jwt.trace(fn, *args, **kwargs), with fn's outputs computed before the
    trace ends."""
    return jwt.trace(lambda *a: jax.block_until_ready(fn(*a)), *args, **kwargs)
