"""The timed call with the port's spans on (plonky2_bls12_381_pairing_torch/
utils/spans.py), for the metrics that read spans: pairing.*_span_ms,
pairing.final_exp_kernels and device.host_wait_share (benchmark/metrics/).

On the card, result() captures the system's call inside spans.recording(), as
the system's prepare does, on a pinned host copy of the first batch that a
metric's measure is handed, and runs the closed loop's call on it: begin_call,
the copy-in (span bench.copy_in), one replay (the capture's own spans), the
read-back (bench.read_back: the copy of the verdicts into pinned memory;
bench.wait: the host's wait for it) and end_call. 3 calls warm up; then it
calls for 5 s, at least 20 and at most 400 times. It frees the capture before
it returns. One run records once, and every metric of the run reads that.
Where the port has no utils/spans.py, result() is None and its metrics are
left out.

Each measured call is a spans.Call: its anchor's host time (start),
end_call's (end), and its records, device times on the host clock. It logs
one [spans] line per span name to standard error: the calls it is in, the
median and p90 ms of a call's spans of that name (device times where the
span has them, else host times), the median self ms (less its child spans),
and the kernel and other nodes it put into the graph; then the share of time
the device waits on the host, by the host span that was open, the anchor's
lag and the host time of end_call.
"""

from __future__ import annotations

import statistics
import sys
import time

#: the spans of a call that hold its device work, end to end
DEVICE_SPANS = ("bench.copy_in", "capture.copy_in", "capture.graph", "capture.clone_out",
                "bench.read_back")
WARMUP, SECONDS, MIN_CALLS, MAX_CALLS = 3, 5.0, 20, 400
LAG_TRIALS = 200
#: the idle time of a call outside its host spans, and between calls
OTHER, BETWEEN = "bench.call", "bench.between_calls"

_CACHE: dict = {}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def port_spans():
    """The port's span module, or None where the port has none."""
    try:
        from plonky2_bls12_381_pairing_torch.utils import spans
    except ImportError:
        return None
    return spans


def run_calls(sp, system, pinned: tuple, seconds: float = SECONDS,
              max_calls: int = MAX_CALLS) -> tuple[list, float]:
    """The closed loop's call on `pinned` (module docstring) with the system
    prepared: each measured call's spans.Call (None while spans do not
    record), and their seconds."""
    import torch

    stream = torch.cuda.current_stream(system.device)
    host = None

    def one():
        nonlocal host
        sp.begin_call(system.device)
        with sp.span("bench.copy_in"):
            system.copy_in(pinned)
        out = system.launch(pinned)
        if host is None:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        with sp.span("bench.read_back"):
            host.copy_(out, non_blocking=True)
        with sp.span("bench.wait", "cpu"):
            stream.synchronize()
        return sp.end_call()

    for _ in range(WARMUP):
        one()
    calls = []
    t0 = time.perf_counter()
    end = t0 + seconds
    while len(calls) < max_calls and (len(calls) < MIN_CALLS or time.perf_counter() < end):
        calls.append(one())
    return calls, time.perf_counter() - t0


def _record(system, args: tuple):
    sp = port_spans()
    if sp is None:
        log("[spans] the port has no utils/spans.py: no span metrics")
        return None
    pinned = tuple(a.cpu().pin_memory() for a in args)
    try:
        with sp.recording():
            system.prepare(pinned)
            calls, seconds = run_calls(sp, system, pinned)
    finally:
        system.release()
    out = {"calls": calls, "seconds": seconds}
    _log(out, anchor_lag_ns(system.device))
    return out


def result(run, system, args: tuple):
    """The span loop's calls of this run (module docstring), recorded once."""
    if _CACHE.get("run") is not run:
        _CACHE.clear()
        _CACHE.update(run=run, result=_record(system, args))
    return _CACHE["result"]


def anchor_lag_ns(device) -> list:
    """ns from an event's record on an idle stream until the host sees it
    complete, LAG_TRIALS times: what bounds a device time placed on the host
    clock by begin_call's anchor."""
    import torch

    out = []
    for _ in range(LAG_TRIALS):
        torch.cuda.synchronize(device)
        ev = torch.cuda.Event()
        t = time.perf_counter_ns()
        ev.record(torch.cuda.current_stream(device))
        while not ev.query():
            pass
        out.append(time.perf_counter_ns() - t)
    return out


# ---------------------------------------------------------------------------
# What the metrics read
# ---------------------------------------------------------------------------


def _ns(r) -> int | None:
    if r.device_start is not None:
        return r.device_end - r.device_start
    if r.host_start is not None:
        return r.host_end - r.host_start
    return None


def per_call_ms(res, name: str) -> list:
    """Per call that has a span `name`: its spans of that name summed, ms."""
    out = []
    for call in res["calls"]:
        ns = [_ns(r) for r in call.records if r.name == name]
        ns = [n for n in ns if n is not None]
        if ns:
            out.append(sum(ns) / 1e6)
    return out


def median_ms(res, name: str) -> float | None:
    """The median over calls of per_call_ms; None without a result or span."""
    if res is None:
        return None
    ms = per_call_ms(res, name)
    return statistics.median(ms) if ms else None


def kernel_nodes(res, names: tuple) -> int | None:
    """The kernel nodes that the spans `names` put into the graph, in the
    first measured call (the capture's counters: the same in every call)."""
    if res is None or not res["calls"]:
        return None
    counts = [r.kernel_nodes for r in res["calls"][0].records if r.name in names]
    if not counts or None in counts:
        return None
    return sum(counts)


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def host_wait(res) -> tuple[float, dict] | None:
    """The share (%) of the loop's time, from the first call's anchor to the
    last call's end, in which the device ran none of the calls' DEVICE_SPANS,
    and that idle time in ns by the host span open then: a call's top-level
    span (these follow one another), OTHER in a call outside them, BETWEEN
    between calls. The time end_call takes to read a call's events is the
    recorder's own, which the untraced loop does not spend: it is left out of
    the loop's time and of the idle time. None without a result or device
    times."""
    if res is None or not res["calls"]:
        return None
    calls = res["calls"]
    idle: dict = {}

    def add(name, ns):
        idle[name] = idle.get(name, 0) + ns

    for k, call in enumerate(calls):
        busy = _union([(r.device_start, r.device_end) for r in call.records
                       if r.name in DEVICE_SPANS and r.device_start is not None])
        if not busy:
            return None
        hosts = [r for r in call.records if r.parent is None and r.host_start is not None]
        prev = call.start
        for s, e in busy + [[call.end, call.end]]:
            if s > prev:
                rest = s - prev
                for r in hosts:
                    part = min(r.host_end, s) - max(r.host_start, prev)
                    if part > 0:
                        add(r.name, part)
                        rest -= part
                add(OTHER, rest)
            prev = max(prev, e)
        if k + 1 < len(calls):
            add(BETWEEN, calls[k + 1].start - call.end - call.read_ns)
    wall = calls[-1].end - calls[0].start - sum(c.read_ns for c in calls[:-1])
    return 100.0 * sum(idle.values()) / wall, idle


def _self_ns(call, name: str) -> int | None:
    """A call's spans `name` less their child spans timed on the same clock
    (device times where the parent has them)."""
    own = [r for r in call.records if r.name == name and _ns(r) is not None]
    if not own:
        return None
    on_device = {r.id: r.device_start is not None for r in own}
    kids = [_ns(r) for r in call.records if r.parent in on_device and _ns(r) is not None
            and (r.device_start is not None) == on_device[r.parent]]
    return sum(map(_ns, own)) - sum(kids)


def _log(res, lags: list) -> None:
    calls = res["calls"]
    n = len(calls)
    log(f"[spans] {n} calls in {res['seconds']:.3f} s: {n / res['seconds']:.2f} calls/s "
        "with spans on")
    for name in dict.fromkeys(r.name for c in calls for r in c.records):
        ms = per_call_ms(res, name)
        selfs = [ns / 1e6 for ns in (_self_ns(c, name) for c in calls) if ns is not None]
        first = [r for r in calls[0].records if r.name == name]
        nodes = ("" if first[0].kernel_nodes is None else
                 f", kernel nodes {sum(r.kernel_nodes for r in first)}"
                 f", other nodes {sum(r.other_nodes for r in first)}")
        p90 = statistics.quantiles(ms, n=10)[-1] if len(ms) > 1 else ms[0]
        log(f"[spans] {name}: calls {len(ms)}, median {statistics.median(ms):.4f} ms, "
            f"p90 {p90:.4f} ms, self {statistics.median(selfs):.4f} ms{nodes}")
    phases = sum(median_ms(res, p) or 0.0 for p in (
        "pairing.prepare_g2", "pairing.miller_loop", "pairing.final_exp.easy",
        "pairing.final_exp.hard", "pairing.is_one"))
    graph = median_ms(res, "capture.graph")
    if graph:
        log(f"[spans] the pairing spans' medians sum to {phases:.4f} ms, "
            f"{100 * phases / graph:.2f} % of capture.graph's")
    wait = host_wait(res)
    if wait is not None:
        share, idle = wait
        by = ", ".join(f"{k} {v / n / 1e3:.2f}" for k, v in
                       sorted(idle.items(), key=lambda kv: -kv[1]))
        log(f"[spans] host_wait_share {share:.4f} %; idle us per call by host span: {by}")
    lag = sorted(lags)
    log(f"[spans] anchor lag us: median {statistics.median(lag) / 1e3:.2f}, "
        f"p90 {lag[int(0.9 * len(lag))] / 1e3:.2f}, max {lag[-1] / 1e3:.2f} "
        f"({len(lag)} trials)")
    reads = [c.read_ns for c in calls]
    log(f"[spans] end_call's reads us per call (left out of host_wait_share): median "
        f"{statistics.median(reads) / 1e3:.2f}, max {max(reads) / 1e3:.2f}")
