"""The device trace of a stretch of the loop: torch.profiler over some calls,
its chrome trace read back, reduced to what the per-layer metrics and the
breakdown read.

The profiler runs on a schedule: it warms up over the first calls, whose
events it drops (the first replays of a graph under the profiler are slow on
the host), and records the calls after them. Each call is annotated
("bench.call"), and so is its host work inside it ("bench.copy_in",
"bench.launch", "bench.read_back"), so that an idle gap of the device can be
named by what the host was doing. The stretch runs from the first recorded
call's start to the last one's end. Device operations are kernels, copies
and sets.

The stretch is no measure of the untraced loop's idle time: under the
profiler the host takes about 11 ms to launch a graph of some 4,400 nodes
(0.3 ms without it), and the device waits for it; busy_s / window_s and the
idle gaps show that wait under "bench.launch".
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL = "bench.call"
HOST_SPANS = ("bench.copy_in", "bench.launch", "bench.read_back")
TOP = 10
#: characters kept of an operation's name in the breakdown
NAME_CHARS = 160


def record(one_call, warmup: int, calls: int) -> list[dict]:
    """The trace events of `calls` calls of one_call() (each ends with its
    verdicts on the host) after `warmup` calls under the profiler whose
    events are dropped."""
    from torch.profiler import ProfilerActivity, profile, schedule

    events: list = []

    def ready(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events.extend(json.load(f)["traceEvents"])
        finally:
            os.unlink(path)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=calls, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(warmup + calls):
            one_call()
            prof.step()
    return events


def _union(intervals: list) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlaps(spans: list, starts: list, a: float, b: float) -> dict:
    """Seconds of [a, b) under each name of `spans` (sorted (start, end,
    name), none overlapping another)."""
    out: dict = defaultdict(float)
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    while k < len(spans) and spans[k][0] < b:
        s, e, name = spans[k]
        if min(b, e) > max(a, s):
            out[name] += (min(b, e) - max(a, s)) * 1e-6
        k += 1
    return out


def summarize(events: list[dict], calls: int) -> dict | None:
    """busy_s and window_s of the stretch (device operations' union over its
    length), kernels and kernel_s (their count and the union of their
    intervals), and the breakdown: device_ops (seconds by operation name) and
    idle_gaps (the device's idle seconds by the host span they fell in). None
    where the trace holds no stretch or no device operation in it."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("name") == CALL
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    t0, t1 = min(s for s, _ in spans), max(e for _, e in spans)
    dev, kern = [], []
    by_name: dict = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), t0)
        end = min(float(e["ts"]) + float(e.get("dur", 0)), t1)
        if end <= s:
            continue
        dev.append((s, end))
        by_name[e["name"][:NAME_CHARS]] += (end - s) * 1e-6
        if e["cat"] == "kernel":
            kern.append((s, end))
    if not kern:
        return None
    busy = _union(dev)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("name") in HOST_SPANS
                  and e.get("cat") == "user_annotation")
    calls_ = [(s, e, CALL) for s, e in sorted(spans)]
    host_starts, call_starts = [h[0] for h in host], [c[0] for c in calls_]
    gaps: dict = defaultdict(float)
    prev = t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            # a gap's seconds by the host span they fall in: a step of a
            # call, the call outside its steps, or between calls
            named = _overlaps(host, host_starts, prev, s)
            in_calls = _overlaps(calls_, call_starts, prev, s)[CALL]
            for name, sec in named.items():
                gaps[name] += sec
            gaps[CALL] += in_calls - sum(named.values())
            gaps["bench.between_calls"] += (s - prev) * 1e-6 - in_calls
        prev = max(prev, e)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP] if v > 0]

    return {
        "calls": calls,
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": len(kern),
        "kernel_s": sum(e - s for s, e in _union(kern)) * 1e-6,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
    }
