"""One whole call captured into a CUDA graph: the port's counterpart of
jax.jit (the JAX package's bench.py runs jax.jit(pair_fn), and its
__graft_entry__.py returns a function meant for it).

    step = capture(mpr.pairing, p, q)        # warm up, then capture one call
    e = step(p2, q2)                         # copy in, replay, a fresh result

capture() copies the example arguments into static buffers on the card, runs
fn once on a side stream (which uploads every table the call reads on first
use and loads its kernels), and captures one call into a torch.cuda.CUDAGraph.
A call of the result checks that its arguments have the example's structure,
shapes, dtypes and device, copies them into the static buffers, replays the
graph and returns a clone of the outputs, so that every result is a fresh
tensor. The hand-written kernels launch on the current stream
(ops/cuda_build.py call), which is the capture stream, so they are captured
with the rest; their launch counters count host calls and see no replay.

Arguments are tensors, the port's point dataclasses, and lists and tuples of
them; any other value is part of the call's structure and must equal the
example's. Keyword arguments are fixed at capture. Nothing is captured on the
CPU: a CPU tensor is refused, there is no eager fallback.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import fields, is_dataclass
from typing import Any, NamedTuple

import torch


def flatten(x: Any) -> tuple[list[torch.Tensor], Any]:
    """The tensors in x (through dataclasses, lists and tuples), in order,
    and the structure that unflatten rebuilds x from."""
    leaves: list[torch.Tensor] = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            leaves.append(v)
            return ("tensor",)
        if is_dataclass(v) and not isinstance(v, type):
            names = tuple(f.name for f in fields(v))
            return ("dataclass", type(v), names, tuple(walk(getattr(v, n)) for n in names))
        if isinstance(v, (list, tuple)):
            return ("seq", type(v), tuple(walk(e) for e in v))
        return ("value", v)

    return leaves, walk(x)


def unflatten(spec: Any, leaves: list[torch.Tensor]) -> Any:
    """flatten's inverse: the structure `spec` with `leaves` in its tensors'
    places."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "tensor":
            return next(it)
        if kind == "dataclass":
            return s[1](**{n: build(c) for n, c in zip(s[2], s[3])})
        if kind == "seq":
            return s[1](build(c) for c in s[2])
        return s[1]

    return build(spec)


class TensorMeta(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    device: torch.device


class Signature:
    """The structure and the tensors' shapes, dtypes and devices of a call's
    arguments; check() holds another call's arguments to them."""

    def __init__(self, args: tuple):
        leaves, self.spec = flatten(tuple(args))
        self.metas = [TensorMeta(tuple(t.shape), t.dtype, t.device) for t in leaves]

    def check(self, args: tuple) -> list[torch.Tensor]:
        """The tensors of `args`; raises ValueError where they differ from
        the example's in structure, shape, dtype or device."""
        leaves, spec = flatten(tuple(args))
        if spec != self.spec:
            raise ValueError("the arguments differ from the captured call's in structure "
                             "or in a value that is not a tensor")
        for i, (t, m) in enumerate(zip(leaves, self.metas)):
            got = TensorMeta(tuple(t.shape), t.dtype, t.device)
            if got != m:
                raise ValueError(f"tensor argument {i}: expected shape {m.shape}, "
                                 f"{m.dtype} on {m.device}; got shape {got.shape}, "
                                 f"{got.dtype} on {got.device}")
        return leaves


#: One warm-up stream per device, reused by every capture: cuBLAS keeps a
#: workspace for each stream it has run on, so a new stream per capture
#: would hold one more workspace each time.
_WARMUP_STREAMS: dict = {}


def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[device]


class Captured:
    """A call of fn captured into a CUDA graph (made by capture()).
    during_capture: a context manager entered around the captured call only
    (not the warm-up), as the witness trace's recording is."""

    def __init__(self, fn, args: tuple, static_kwargs: dict, during_capture=None):
        self.signature = Signature(args)
        leaves, _ = flatten(tuple(args))
        if not leaves:
            raise ValueError("capture needs at least one tensor argument")
        devices = {t.device for t in leaves}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError("capture runs on one CUDA device; the arguments lie on "
                             f"{sorted(map(str, devices))}")
        self.device = leaves[0].device
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            self._inputs = [torch.empty(t.shape, dtype=t.dtype, device=self.device).copy_(t)
                            for t in leaves]
            static_args = unflatten(self.signature.spec, self._inputs)
            # one eager call on a side stream: lazily made tables and kernel
            # libraries are in place before the capture, which may not copy
            # from the host
            side = _warmup_stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                fn(*static_args, **static_kwargs)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph), during_capture or contextlib.nullcontext():
                out = fn(*static_args, **static_kwargs)
            torch.cuda.synchronize(self.device)
        self._outputs, self._out_spec = flatten(out)
        #: seconds of the warm-up call and the capture together
        self.capture_seconds = time.perf_counter() - t0

    def __call__(self, *args):
        leaves = self.signature.check(args)
        with torch.cuda.device(self.device):
            for buf, t in zip(self._inputs, leaves):
                buf.copy_(t)
            self.graph.replay()
            return unflatten(self._out_spec, [t.clone() for t in self._outputs])


def capture(fn, *example_args, **static_kwargs) -> Captured:
    """fn(*example_args, **static_kwargs) captured into a CUDA graph, to be
    called with arguments like the example's (module docstring)."""
    return Captured(fn, example_args, static_kwargs)
