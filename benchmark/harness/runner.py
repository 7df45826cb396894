"""One run of one cell: set-up, the loop's window, on a --trace 1 run the
traced stretch and the metrics that measure on the card, then the judgement
and the metrics.

The traffic mix names the generator that makes the inputs, the system under
test and the loop that drives it (harness/spec.py). Set-up makes and encodes
the inputs, prepares the system (on the card: captures it) and calls it once
on every distinct batch; the window is the loop's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from . import guard, judge, trace
from .spec import Cell, metric


@dataclass
class Run:
    """What the metric readers (benchmark/metrics/<metric>.py) read."""

    cell: Cell
    batch: int
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    calls: list = field(default_factory=list)
    trace: dict | None = None
    peak: object = None


class ForbiddenModule(RuntimeError):
    pass


def _guard(when: str) -> None:
    found = guard.forbidden_loaded()
    if found:
        raise ForbiddenModule(f"{when}: the process has loaded {found}")


def _device(system, chips: int) -> dict:
    import torch

    if system.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(system.device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(system.device))}


def _measured(rec: Run, system, inputs: list, log) -> dict:
    """The values of the cell's per-layer metrics that measure on the card
    (spec.py), each on the first batch, with the system's capture freed."""
    import torch

    wanted = [(m["name"], metric(rec.cell, m["name"])) for m in rec.cell.per_layer]
    wanted = [(name, mod) for name, mod in wanted if hasattr(mod, "measure")]
    if not wanted or system.device.type != "cuda":
        return {}
    system.release()
    args = system.on_device(inputs[0])
    out = {}
    for name, mod in wanted:
        t0 = time.perf_counter()
        out[name] = mod.measure(rec, system, args)
        torch.cuda.empty_cache()
        log(f"[measure] {name} in {time.perf_counter() - t0:.3f} s")
    return out


def run(cell: Cell, seed: int, seconds: float, traced: bool, system,
        t_start: float, log=print) -> tuple[dict, list[str]]:
    """One run (module docstring): the result line's object, and the
    compared numbers beside their limits, one to a line."""
    t = cell.traffic
    gen, loop = cell.part("generator"), cell.part("loop")

    def stage(name):
        log(f"[setup] {name} at {time.perf_counter() - t_start:.3f} s")

    stage("imports done")
    tr = gen.make(seed, cell)
    stage("traffic made")
    inputs = system.encode(tr)
    stage("traffic encoded")
    system.prepare(inputs[0])
    stage("captured")
    for batch in inputs:  # every batch through the timed path once
        system(batch)
    _guard("at the end of set-up")
    rec = Run(cell, t["batch"])
    rec.setup_s = time.perf_counter() - t_start
    log(f"[setup] {rec.setup_s:.3f} s")
    answers, rec.calls = loop.window(system, inputs, seconds)
    rec.window = (rec.calls[0][0], rec.calls[-1][1])
    _guard("after the window")
    lat = sorted((e - s) * 1e3 for s, e in rec.calls)
    log(f"[window] {len(rec.calls)} calls in {rec.window[1] - rec.window[0]:.3f} s; "
        f"latency ms min {lat[0]:.3f} median {lat[len(lat) // 2]:.3f} max {lat[-1]:.3f}")
    measured = {}
    if traced:
        def call():
            answers.append(loop.one_call(system, inputs, len(answers), annotate=True))

        rec.trace = trace.summarize(trace.record(call, t["trace_warmup"], t["trace_calls"]),
                                    t["trace_calls"])
    device = _device(system, cell.chips)
    if traced and system.device.type == "cuda":
        from ..work.peak import card_peak

        rec.peak = card_peak(system.device.index or 0)
        log(f"[card] {rec.peak.name}, power limit {rec.peak.power_limit_w} W, "
            f"{rec.peak.sms} SMs at {rec.peak.clock_hz / 1e6:.0f} MHz")
        device["busy_s"] = rec.trace["busy_s"] if rec.trace else 0.0
        device["window_s"] = rec.trace["window_s"] if rec.trace else 0.0
        measured = _measured(rec, system, inputs, log)
    system.release()
    inputs.clear()
    t_judge = time.perf_counter()
    verdict = judge.judge(seed, answers, tr, gen, t["reference_checks"])
    log(f"[judge] {time.perf_counter() - t_judge:.3f} s")
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        mod = metric(cell, m["name"])
        value = measured.get(m["name"]) if hasattr(mod, "measure") else mod.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": verdict["correct"], "attempted": verdict["answers"],
           "failed": verdict["numbers"]["wrong_verdicts"], "metrics": metrics,
           "device": device}
    if traced and rec.trace:
        out["breakdown"] = rec.trace["breakdown"]
    out["compared"] = {k: {"value": v, "limit": judge.LIMITS[k]}
                       for k, v in verdict["numbers"].items()}
    return out, judge.lines(verdict)
