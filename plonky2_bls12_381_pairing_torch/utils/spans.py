"""Spans: named, nested intervals of the port's calls, on one clock shared by
the host and the card. The port's only tracing module.

    with spans.recording() as rec:       # nothing is recorded outside this
        spans.begin_call()               # the stream idle: the call's anchor
        out = step(*args)                # utils/capture.py, or an eager call
        verdicts = out.cpu()             # the call's results on the host
        call = spans.end_call()          # its device times on the host clock
    for r in call.records: ...           # or rec.records, the whole ring

span(name, device) marks a layer boundary in the code (models/pairing_rns.py,
utils/capture.py). Outside recording() it returns one shared null context and
does nothing else. While recording, each span keeps its name, its parent, the
call it belongs to, and its host start and end (time.perf_counter_ns). On a
CUDA device it also records a pair of timing events on the device's current
stream; on the CPU it has host times only.

Under a CUDA graph capture (torch.cuda.graph) the Python of a call runs once,
at capture. A span there records its events into the graph as event-record
nodes (external events), which every replay records again, and counts the
kernel nodes and the other nodes that its body put into the graph: the
capturing graph's nodes by type, read through the CUDA runtime
(capture_nodes), less the span recorder's own event nodes. Such a span is not
a record of a call: the capture keeps it (take_captured), and each replay
made while recording adds one record of it (replayed), with the capture's
counters, the replay's device times and no host times.

One clock: begin_call notes perf_counter_ns and records an anchor event on the
idle stream; end_call, once the call's results are on the host, reads each of
the call's events as elapsed_time(anchor, event) and places it at the
anchor's host time plus that. The anchor's lag (from its record to the device
passing it) bounds the error of each device time so placed; the times are
early by at most that. A call replays each captured graph once: a second
replay's events overwrite the first's, whose records then keep no device
times.

Records are kept in a ring of `capacity`, the oldest dropped once it is full;
end_call also returns its call's records. The recorder serves one thread.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import torch

#: cudaGraphNodeType of a kernel node
_KERNEL_NODE = 0
#: what span() returns while nothing records
_NULL = contextlib.nullcontext()


@dataclass(eq=False)
class Record:
    """One span. Times are perf_counter_ns; device times are set by end_call
    (None on the CPU, outside a call, or for a replay overwritten in its
    call); host times are None for the replay of a captured span. The node
    counts are those its body put into a captured graph, None outside a
    capture."""

    name: str
    id: int
    parent: int | None
    call: int
    host_start: int | None = None
    host_end: int | None = None
    device_start: int | None = None
    device_end: int | None = None
    kernel_nodes: int | None = None
    other_nodes: int | None = None
    #: (start, end) timing events until end_call reads them
    events: tuple | None = field(default=None, repr=False)


@dataclass
class Call:
    """A call between begin_call and end_call: its id, the anchor's host
    time (start), end_call's host time (end), its records, and the host ns
    that end_call took to read its events (read_ns)."""

    id: int
    start: int
    end: int
    records: list
    read_ns: int = 0


def _cuda(device) -> torch.device | None:
    """The CUDA device a span's events go on, or None for host times only:
    `device` None is the current CUDA device once CUDA is initialized."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_initialized() else None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def _event() -> torch.cuda.Event:
    # external: recorded under a capture, it becomes an event-record node
    return torch.cuda.Event(enable_timing=True, external=True)


class _Runtime:
    """The CUDA runtime's capture and graph queries, through ctypes."""

    def __init__(self):
        major = (torch.version.cuda or "12").split(".")[0]
        lib = ctypes.CDLL(f"libcudart.so.{major}")  # the one torch has loaded
        # the capturing graph is the fourth argument of both versions; the
        # optional outputs after it are passed as NULL (v2 has one fewer)
        self.info = getattr(lib, "cudaStreamGetCaptureInfo_v3", None) \
            or lib.cudaStreamGetCaptureInfo_v2
        self.info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_ulonglong),
                              ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p]
        self.nodes = lib.cudaGraphGetNodes
        self.nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_size_t)]
        self.node_type = lib.cudaGraphNodeGetType
        self.node_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        for fn in (self.info, self.nodes, self.node_type):
            fn.restype = ctypes.c_int

    def graph_nodes(self, stream: int) -> tuple[int, int]:
        """(kernel nodes, other nodes) of the graph that `stream` is
        capturing into."""
        status, cid, graph = ctypes.c_int(), ctypes.c_ulonglong(), ctypes.c_void_p()
        rc = self.info(stream, ctypes.byref(status), ctypes.byref(cid),
                       ctypes.byref(graph), None, None, None)
        if rc or not graph.value:
            raise RuntimeError(f"cudaStreamGetCaptureInfo gave error {rc} and no "
                               "capturing graph")
        n = ctypes.c_size_t(0)
        self._check(self.nodes(graph, None, ctypes.byref(n)), "cudaGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        self._check(self.nodes(graph, nodes, ctypes.byref(n)), "cudaGraphGetNodes")
        kind, kernels = ctypes.c_int(), 0
        for node in nodes[: n.value]:
            self._check(self.node_type(node, ctypes.byref(kind)), "cudaGraphNodeGetType")
            kernels += kind.value == _KERNEL_NODE
        return kernels, n.value - kernels

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc:
            raise RuntimeError(f"{what} gave CUDA error {rc}")


_RUNTIME: _Runtime | None = None


def capture_nodes(device=None) -> tuple[int, int]:
    """(kernel nodes, other nodes) of the CUDA graph that the current stream
    of `device` is capturing into."""
    global _RUNTIME
    if _RUNTIME is None:
        _RUNTIME = _Runtime()
    return _RUNTIME.graph_nodes(torch.cuda.current_stream(device).cuda_stream)


class Recorder:
    """What recording() records into (module docstring)."""

    def __init__(self, capacity: int):
        self.records: deque = deque(maxlen=capacity)
        self._ids = itertools.count()
        self._call_ids = itertools.count()
        self._stack: list[Record] = []
        #: the open call: its id, anchor event and host time, and records
        self._call: int | None = None
        self._anchor: tuple = (None, 0)
        self._call_records: list[Record] = []
        #: spans recorded under the capture in progress, in start order
        self._captured: list[Record] = []
        #: event nodes this recorder has put into graphs
        self._own_nodes = 0

    def _new(self, name: str, parent: Record | None, **kw) -> Record:
        if parent is not None:
            call = parent.call
        else:
            call = self._call if self._call is not None else next(self._call_ids)
        return Record(name, next(self._ids), parent.id if parent else None, call, **kw)

    def _keep(self, rec: Record) -> None:
        self.records.append(rec)
        if self._call is not None and rec.call == self._call:
            self._call_records.append(rec)

    @contextlib.contextmanager
    def span(self, name: str, device):
        dev = _cuda(device)
        stream = torch.cuda.current_stream(dev) if dev is not None else None
        capturing = stream is not None and torch.cuda.is_current_stream_capturing()
        rec = self._new(name, self._stack[-1] if self._stack else None)
        if capturing:
            self._captured.append(rec)
        else:
            self._keep(rec)
        if stream is not None:
            rec.events = (_event(), _event())
            rec.events[0].record(stream)
            self._own_nodes += capturing
        if capturing:
            k0, o0 = capture_nodes(dev)
            own0 = self._own_nodes
        self._stack.append(rec)
        rec.host_start = time.perf_counter_ns()
        try:
            yield rec
        finally:
            rec.host_end = time.perf_counter_ns()
            self._stack.pop()
            if capturing:
                k1, o1 = capture_nodes(dev)
                rec.kernel_nodes = k1 - k0
                rec.other_nodes = o1 - o0 - (self._own_nodes - own0)
            if stream is not None:
                rec.events[1].record(stream)
                self._own_nodes += capturing

    def take_captured(self) -> tuple:
        out, self._captured = tuple(self._captured), []
        return out

    def replayed(self, captured: tuple) -> None:
        stale = {id(t.events) for t in captured}
        for rec in self._call_records:  # an earlier replay in this call
            if rec.events is not None and id(rec.events) in stale:
                rec.events = None
        outer = self._stack[-1] if self._stack else None
        ids: dict = {}
        for t in captured:  # in start order: a parent before its children
            parent = ids.get(t.parent, outer)
            rec = self._new(t.name, parent, kernel_nodes=t.kernel_nodes,
                            other_nodes=t.other_nodes, events=t.events)
            ids[t.id] = rec
            self._keep(rec)

    def begin_call(self, device=None) -> int:
        if self._call is not None:
            raise RuntimeError("begin_call: call %d is still open" % self._call)
        self._call = next(self._call_ids)
        self._call_records = []
        dev = _cuda(device)
        host = time.perf_counter_ns()
        anchor = None
        if dev is not None:
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record(torch.cuda.current_stream(dev))
        self._anchor = (anchor, host)
        return self._call

    def end_call(self) -> Call:
        if self._call is None:
            raise RuntimeError("end_call without begin_call")
        end = time.perf_counter_ns()
        anchor, host = self._anchor
        for rec in self._call_records:
            if rec.events is None:
                continue
            start, stop = rec.events
            if anchor is not None and start.device == anchor.device:
                rec.device_start = host + round(anchor.elapsed_time(start) * 1e6)
                rec.device_end = host + round(anchor.elapsed_time(stop) * 1e6)
            rec.events = None
        call = Call(self._call, host, end, self._call_records, time.perf_counter_ns() - end)
        self._call, self._anchor, self._call_records = None, (None, 0), []
        return call


_ACTIVE: Recorder | None = None


def span(name: str, device=None):
    """A span named `name` around a block (module docstring). `device`: where
    its work runs: a CUDA device gets a pair of events on its current
    stream, "cpu" host times only; None is the current CUDA device once CUDA
    is initialized."""
    rec = _ACTIVE
    if rec is None:
        return _NULL
    return rec.span(name, device)


@contextlib.contextmanager
def recording(capacity: int = 1 << 16):
    """Record spans inside the block, into the Recorder it yields, whose
    `records` ring keeps the newest `capacity`."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("spans are already recording")
    _ACTIVE = Recorder(capacity)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = None


def begin_call(device=None) -> int | None:
    """Open a call on the idle stream of `device` (span's meaning); its id,
    None while nothing records."""
    return None if _ACTIVE is None else _ACTIVE.begin_call(device)


def end_call() -> Call | None:
    """Close the open call once its results are on the host: its Call, with
    the device times placed on the host clock; None while nothing records."""
    return None if _ACTIVE is None else _ACTIVE.end_call()


def take_captured() -> tuple:
    """The spans recorded under the capture just made (module docstring);
    empty while nothing records."""
    return () if _ACTIVE is None else _ACTIVE.take_captured()


def replayed(captured: tuple) -> None:
    """A record of each captured span for the replay just launched."""
    if _ACTIVE is not None and captured:
        _ACTIVE.replayed(captured)
