"""Checkpoint and resume of a long batched pairing (the JAX package's
utils/checkpoint.py).

A job's state is the Miller accumulator and the index of the next step of
the 68-step schedule. The schedule runs in chunks of `every` steps; after
each chunk the state is written atomically (np.savez to a temporary file,
then a rename over the target), and a run that finds the file resumes from
the step it names. The file's keys are the JAX package's (`f`, `next_step`),
so each package reads the other's state files.

  run_pairing_checkpointed      the limb tier: models/pairing.miller_steps
                                over each chunk of the scaled coefficients;
  run_pairing_checkpointed_rns  the RNS tier: one kernels.miller_run launch
                                per chunk of the step-major coefficients
                                (any step count: the JAX package pads its
                                last chunk to a uniform scan, with the same
                                rows).

`fail_after_steps` raises once at least that many steps have run and been
saved since the start (or the resume): the fault injection of the
kill-and-resume tests.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_state(path: str, f, next_step: int) -> None:
    """Atomic write: np.savez to a temporary file, then a rename over path."""
    if isinstance(f, torch.Tensor):
        f = f.cpu().numpy()
    tmp = path + ".tmp"
    np.savez(tmp, f=np.asarray(f), next_step=next_step)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_state(path: str):
    """(f as a numpy array, next_step)."""
    with np.load(path) as z:
        return z["f"], int(z["next_step"])


def _start(ckpt_path: str, fresh, device: torch.device):
    """The accumulator and step to start from: the state file's, or fresh()
    at step 0."""
    if os.path.exists(ckpt_path):
        f_np, start = load_state(ckpt_path)
        return torch.from_numpy(np.ascontiguousarray(f_np)).to(device), start
    return fresh(), 0


def _run_chunks(f, start: int, n_steps: int, chunk, ckpt_path: str, every: int,
                fail_after_steps):
    step = start
    while step < n_steps:
        stop = min(step + every, n_steps)
        f = chunk(f, step, stop)
        save_state(ckpt_path, f, stop)
        step = stop
        if fail_after_steps is not None and start + fail_after_steps <= step < n_steps:
            raise RuntimeError(f"injected failure after step {step}")
    return f


def run_pairing_checkpointed(ps, prepared, q_infinities=None, *, ckpt_path: str,
                             every: int = 17, fail_after_steps: int | None = None):
    """The limb tier's pairing (or product of T pairings) with the Miller
    schedule in chunks of `every` steps, checkpointed to ckpt_path after
    each; resumes from ckpt_path if it exists. Returns the Gt rows."""
    from ..models import pairing as mp
    from ..ops import fp, fq12

    ps, scaled = mp.scale_all_coeffs(ps, prepared, q_infinities)
    xs = mp.stack_steps(scaled)  # (68, T, ..., 3, 2, L)
    batch = ps[0].infinity.shape
    device = ps[0].infinity.device
    f, start = _start(ckpt_path,
                      lambda: fq12.one((), device).expand(*batch, 12, fp.NLIMBS), device)
    f = _run_chunks(f, start, mp.NUM_COEFFS,
                    lambda f, a, b: mp.miller_steps(f, xs[a:b], mp._DO_SQUARE[a:b]),
                    ckpt_path, every, fail_after_steps)
    if mp.C.BLS_X_IS_NEGATIVE:
        f = fq12.conjugate(f)
    return mp.final_exponentiation(f)


def run_pairing_checkpointed_rns(p, prepared_stepmajor, q_infinity=None, *,
                                 ckpt_path: str, every: int = 17,
                                 fail_after_steps: int | None = None,
                                 impl: str = "segments"):
    """The RNS tier's pairing from step-major line coefficients
    (models/pairing_rns.prepare_g2_stepmajor), the Miller schedule in
    chunks of `every` steps, each one kernels.miller_run (one launch on a
    card), checkpointed to ckpt_path after each; resumes from ckpt_path if
    it exists. Returns the Gt rows (final_exponentiation in the form
    `impl`)."""
    from ..models import pairing_rns as mpr
    from ..ops.rns import kernels, tower

    inf = p.infinity != 0
    skip = (inf if q_infinity is None else inf | (q_infinity != 0)).to(torch.int32)
    rows = p.infinity.shape[:-1]
    device = p.infinity.device
    f, start = _start(ckpt_path, lambda: tower.one(rows, device), device)
    f = _run_chunks(f, start, mpr.NUM_COEFFS,
                    lambda f, a, b: kernels.miller_run(f, prepared_stepmajor[a:b], p.y, p.x,
                                                       skip, mpr._DO_SQUARE[a:b]),
                    ckpt_path, every, fail_after_steps)
    if mpr.C.BLS_X_IS_NEGATIVE:
        f = tower.conjugate(f)
    return mpr.final_exponentiation(f, impl)
