"""The whole-call capture (utils/capture.py), the port's counterpart of
jax.jit.

On the CPU: the flattening of a call's arguments (tensors, the port's point
dataclasses, lists and tuples of them, other values), the signature check a
replay makes (structure, shape, dtype, device), the refusal of CPU tensors
before anything runs, and that a second call of each path copies nothing
from host memory (what a capture may not do).

On the card (marked gpu, skipped here): pairing, a two-term pairing_check and
the limb pairing under "fused" captured on one input set and replayed on
another, against the eager call's rows on that set, bit for bit."""

import functools
import gc
import random

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from plonky2_bls12_381_pairing_torch.entry import entry
from plonky2_bls12_381_pairing_torch.models import pairing as lmp
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.models import witness
from plonky2_bls12_381_pairing_torch.ops import curve as lcurve
from plonky2_bls12_381_pairing_torch.ops import fp as lfp
from plonky2_bls12_381_pairing_torch.ops.rns import kernels, tower
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_torch.utils.capture import (Signature, capture, flatten,
                                                           unflatten)

torch.set_num_threads(1)


def example():
    """pairing_check's arguments on the CPU: two terms of entry points."""
    _, (p, q) = entry(device="cpu")
    return ([p, p], [q, q])


def test_flatten_round_trip():
    args = (*example(), 3, "segments", None)
    leaves, spec = flatten(args)
    assert len(leaves) == 12  # two terms of x, y, infinity per point
    back = unflatten(spec, leaves)
    assert type(back) is tuple and back[2:] == (3, "segments", None)
    assert [type(x) for x in back[0]] == [G1Affine, G1Affine]
    assert back[1][1].infinity is args[1][1].infinity
    # the leaves come back in place, in order
    fresh = [torch.full_like(t, i) for i, t in enumerate(leaves)]
    rebuilt = unflatten(spec, fresh)
    assert int(rebuilt[0][1].y[0, 0]) == 4 and int(rebuilt[1][0].x[0, 0, 0]) == 6


def test_signature_accepts_arguments_like_the_example():
    sig = Signature(example())
    args = example()
    other = G1Affine(*(t.clone() for t in (args[0][0].x, args[0][0].y, args[0][0].infinity)))
    leaves = sig.check(([other, args[0][1]], args[1]))
    assert len(leaves) == 12 and leaves[0] is other.x


def _swap_first_x(args, x):
    p0 = args[0][0]
    return ([G1Affine(x, p0.y, p0.infinity), args[0][1]], args[1])


@pytest.mark.parametrize("change", ["shape", "dtype", "terms", "type", "value"])
def test_signature_refuses_other_arguments(change):
    sig = Signature((*example(), "segments"))
    p, q = example()
    x = p[0].x
    args = {
        "shape": (*_swap_first_x((p, q), torch.cat([x, x])), "segments"),
        "dtype": (*_swap_first_x((p, q), x.to(torch.int64)), "segments"),
        "terms": ([p[0]], [q[0]], "segments"),
        "type": ((p[0], p[1]), q, "segments"),
        "value": (p, q, "karabina"),
    }[change]
    with pytest.raises(ValueError):
        sig.check(args)


def test_signature_refuses_another_device():
    sig = Signature(example())
    p, q = example()
    meta = G1Affine(p[0].x.to("meta"), p[0].y, p[0].infinity)
    with pytest.raises(ValueError, match="meta"):
        sig.check(([meta, p[1]], q))


def test_capture_refuses_cpu_tensors():
    """Nothing is captured on the CPU, and nothing runs: fn is not called."""
    calls = []

    def fn(*args):
        calls.append(args)
        return mpr.pairing_check(*args)

    with pytest.raises(ValueError, match="CUDA"):
        capture(fn, *example())
    with pytest.raises(ValueError, match="tensor"):
        capture(fn, [1, 2], "no tensors")
    assert calls == []


class _HostTensors(TorchDispatchMode):
    """Counts the tensors made from host data inside the mode: a Python list
    or number made a tensor (torch.tensor, an index list) reaches the
    dispatcher as aten.lift_fresh."""

    def __init__(self):
        super().__init__()
        self.made = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.made += 1
        return func(*args, **(kwargs or {}))


def _limb(strategy, p, q):
    lfp.set_strategy(strategy)
    try:
        return lmp.pairing(p, q)
    finally:
        lfp.set_strategy("auto")


@pytest.mark.parametrize("path", ["pairing", "pairing_check", "limb_pairing_auto",
                                  "limb_pairing_fused", "pairing_karabina",
                                  "traced_pairing"])
def test_second_call_makes_no_host_tensor(path, monkeypatch):
    """After a first call has made the cached tables, a call of each path
    makes no tensor from host data (torch.from_numpy, torch.tensor, an index
    list): on the card each would be a copy from host memory, which a CUDA
    graph capture refuses (one packed row, the CPU's plain path)."""
    if path.startswith("limb"):
        p, q = lcurve.G1Affine.generator((2,), "cpu"), lcurve.G2Affine.generator((2,), "cpu")
        run = lambda: _limb(path.rsplit("_", 1)[1], p, q)
    else:
        _, (p, q) = entry(device="cpu")
        run = {"pairing": lambda: mpr.pairing(p, q),
               "pairing_check": lambda: mpr.pairing_check([p, p], [q, q]),
               "pairing_karabina": lambda: mpr.pairing(p, q, impl="karabina"),
               "traced_pairing": lambda: witness.trace(mpr.pairing, p, q)}[path]
    run()
    calls = []
    from_numpy = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda *a: calls.append(a) or from_numpy(*a))
    with _HostTensors() as mode:
        run()
    assert calls == [] and mode.made == 0


def test_miller_run_pointers_go_by_value(monkeypatch):
    """miller_run's launch passes each operand of its terms as one pointer
    and its strides (nothing copied to the card for them): 65 terms are not
    refused, an operand whose terms are views of one buffer reaches the
    launch as that buffer's pointer without a copy, and a second call makes
    no tensor from host data (the launch recorded, not run)."""
    from plonky2_bls12_381_pairing_torch.ops import cuda_build

    calls = []
    monkeypatch.setattr(kernels, "_check", lambda t, tail, contiguous=True: None)
    monkeypatch.setattr(kernels, "_rows", cuda_build.row_view)
    monkeypatch.setattr(kernels, "_call", lambda name, dev, *args: calls.append((name, args)))
    n = 65
    coeffs = torch.zeros((2, n, 1, 3, 2, 128), dtype=torch.int32)
    py = torch.zeros((n, 1, 128), dtype=torch.int32)
    rows = [torch.zeros((1, 128), dtype=torch.int32) for _ in range(n)]
    call = [list(coeffs.unbind(1)), list(py.unbind(0)), rows, [rows[0]] * n]
    f0 = tower.one((1,), "cpu")
    kernels._miller_run_kernel(f0, call, (1, 0))
    with _HostTensors() as mode:
        kernels._miller_run_kernel(f0, call, (1, 0))
    assert mode.made == 0 and [name for name, _ in calls] == ["miller_run"] * 2
    args = calls[1][1]
    # coeffs and py read in place; px's separate tensors stacked; skip one
    # tensor repeated, term stride 0
    assert args[2:5] == (coeffs.data_ptr(), n * 6 * 128, 6 * 128)
    assert args[5:7] == (py.data_ptr(), 128)
    assert args[7] not in {t.data_ptr() for t in rows} and args[8] == 128
    assert args[9:12] == (rows[0].data_ptr(), 0, n)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured only on the card")
    return torch.device("cuda")


def random_points(seed: int, n: int):
    r = random.Random(seed)
    ps = [rm.G1Affine.generator().mul(r.randrange(1, rm.R)) for _ in range(n)]
    qs = [rm.G2Affine.generator().mul(r.randrange(1, rm.R)) for _ in range(n)]
    ps[1] = rm.G1Affine(0, 0, True)
    return ps, qs


@pytest.mark.gpu
def test_captured_pairing_replays_new_inputs(cuda):
    fn, _ = entry(cuda)
    step = capture(fn, G1Affine.generator((8,), cuda), G2Affine.generator((8,), cuda))
    ps, qs = random_points(0xCA97, 8)
    p2, q2 = G1Affine.encode(ps, device=cuda), G2Affine.encode(qs, device=cuda)
    kernels.reset_launches()
    got = step(p2, q2)
    assert sum(kernels.launches.values()) == 0  # a replay makes no host launch
    want = fn(p2, q2)
    assert torch.equal(got, want)
    dec = tower.decode(got)[:8]
    assert [x.coeffs() for x in dec] == [rm.pairing(a, b).coeffs() for a, b in zip(ps, qs)]
    assert got.data_ptr() != step(p2, q2).data_ptr()  # a fresh tensor each call
    with pytest.raises(ValueError):
        step(p2, G2Affine.encode(qs[:6], device=cuda))


@pytest.mark.gpu
def test_released_captures_hold_no_memory(cuda):
    """A capture released gives back what it held: its graph and buffers,
    and no cuBLAS workspace of a stream of its own stays behind (the warm-up
    stream is one per device; a workspace is tens of MiB, far above the
    allocator's rounding allowed here). The first capture makes the
    workspaces of the warm-up and capture streams; later ones make none."""
    p, q = G1Affine.generator((8,), cuda), G2Affine.generator((8,), cuda)
    held = []
    for _ in range(4):
        step = capture(mpr.pairing, p, q)
        step(p, q)
        del step
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated(cuda))
    assert max(held[1:]) - min(held[1:]) < 2**20, held


@pytest.mark.gpu
def test_captured_pairing_check_replays_new_inputs(cuda):
    """A two-term pairing_check (the miller_run kernel's by-value pointer
    table) captured on one input set and replayed on another."""
    ps, qs = random_points(0x2C, 8)
    ps2, qs2 = random_points(0x2D, 8)

    def enc(ps, qs):
        p = G1Affine.encode(ps, device=cuda)
        n = G1Affine.encode([x.neg() for x in ps], device=cuda)
        q = G2Affine.encode(qs, device=cuda)
        return [p, n], [q, q]

    step = capture(mpr.multi_pairing, *enc(ps, qs))
    args = enc(ps2, qs2)
    got = step(*args)
    assert torch.equal(got, mpr.multi_pairing(*args))
    assert bool(tower.is_one(got).all())
    same = ([args[0][0], args[0][0]], args[1])
    assert torch.equal(step(*same), mpr.multi_pairing(*same))
    assert not bool(tower.is_one(step(*same)).reshape(-1)[[0, 2]].any())
    check = capture(mpr.pairing_check, *enc(ps, qs))
    assert bool(check(*args).all())
    assert check(*same).reshape(-1)[:8].tolist() == [False, True] + [False] * 6


@pytest.mark.gpu
def test_captured_limb_fused_pairing_replays_new_inputs(cuda):
    fused = functools.partial(_limb, "fused")
    step = capture(fused, lcurve.G1Affine.generator((4,), cuda),
                   lcurve.G2Affine.generator((4,), cuda))
    ps, qs = random_points(0x11B, 4)
    p2, q2 = lcurve.G1Affine.encode(ps, device=cuda), lcurve.G2Affine.encode(qs, device=cuda)
    got = step(p2, q2)
    assert torch.equal(got, fused(p2, q2))
    assert [[int(v) for v in row] for row in lfp.decode(got)] == [
        rm.pairing(a, b).coeffs() for a, b in zip(ps, qs)]
    assert np.array_equal(got.cpu().numpy(), step(p2, q2).cpu().numpy())
