"""What the port's phase tools (tools/*_torch.py) share: their options, the
card they run on, the timing of a phase with CUDA events (eager, and replayed
from a CUDA graph of utils/capture.py), its launches of the hand-written
kernels, one profiled call, and the JSON they write to --out.

A tool runs on the card. Without one it refuses to run unless the caller
passes --device cpu (the tests do): it then times on the host clock and names
that number cpu_ms, captures nothing and profiles nothing, so that no device
number comes from a CPU run. It writes JSON only to --out, and never to the
repository's own PHASES_*.json, BENCH_*.json or XPROF_*.json records.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a script: the port's package
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from plonky2_bls12_381_pairing_torch.ops import cuda_build  # noqa: E402
from plonky2_bls12_381_pairing_torch.utils.capture import capture  # noqa: E402
from plonky2_bls12_381_pairing_torch.utils.profiling import device_profile  # noqa: E402

#: the repository's records, which a tool never writes
RECORDS = ("PHASES_*.json", "BENCH_*.json", "XPROF_*.json")


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cuda:K; cpu only for the tests")
    ap.add_argument("--reps", type=int, default=3, help="timed calls per phase")
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--phases", nargs="+", default=None, help="run only these phases")
    return ap


def open_device(name: str) -> tuple[torch.device, str] | None:
    """The device and the card's line (its name and power limit, from
    nvidia-smi), printed; None, with a message, where a card was asked for
    and there is none."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device is available: this tool runs on the card "
                  "(--device cpu only for the tests)", file=sys.stderr)
            return None
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        card = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    elif dev.type == "cpu":
        card = "cpu: no card (host clock; no device number)"
    else:
        raise ValueError(f"--device must be cuda[:K] or cpu, got {name}")
    print(f"[card] {card}")
    return dev, card


def selected(phases: list | None, names) -> list:
    """The phases to run, in the tool's order; an unknown name raises."""
    if phases is None:
        return list(names)
    unknown = sorted(set(phases) - set(names))
    if unknown:
        raise ValueError(f"unknown phases {unknown}; the tool has {list(names)}")
    return [n for n in names if n in phases]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def call_ms(dev: torch.device, fn, inputs: list) -> list[float]:
    """ms of fn(*args) for each args of `inputs`: CUDA events around each
    call on the card (the span the stream takes, host gaps included), the
    host clock around a synchronised call on the CPU."""
    times = []
    for args in inputs:
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t) * 1e3)
    return times


def launches(fn, args: tuple) -> dict[str, int]:
    """The hand-written kernels' launches in one call of fn(*args), by
    kernel (none on the CPU, where the wrappers run their plain versions)."""
    cuda_build.reset_all_launches()
    fn(*args)
    return {k: v for k, v in cuda_build.all_launches().items() if v}


def kernel_names() -> list[str]:
    """The __global__ functions of csrc/: the hand-written kernels."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    csrc = ROOT / "plonky2_bls12_381_pairing_torch" / "csrc"
    return sorted({m for src in csrc.glob("*.cu") for m in pat.findall(src.read_text())})


def profiled(fn, args: tuple, host_ops: bool = True) -> dict:
    """One call under torch.profiler (utils/profiling.py device_profile): the
    summed time of its CUDA kernels and their count, and the share of them
    that are the hand-written kernels. kernel_ms is None where the profiler
    saw no kernel; on a call of about a millisecond it has missed some."""
    prof = device_profile(lambda: fn(*args), host_ops=host_ops, top=1 << 30)
    names = kernel_names()
    mine = [(ms, n) for ms, n, key in prof["top"]
            if any(re.search(rf"\b{k}\b", key) for k in names)]
    return {"wall_ms": prof["wall_ms"], "kernel_ms": prof["device_ms"],
            "kernels": prof["kernel_launches"],
            "handwritten_ms": sum(ms for ms, _ in mine),
            "handwritten_kernels": sum(n for _, n in mine),
            "top": [list(t) for t in prof["top"][:8]]}


def captured_ms(fn, inputs: list) -> tuple[list[float], float]:
    """fn captured into a CUDA graph on inputs[0] (utils/capture.py), then
    replayed once per args of `inputs`: the ms of each call (copy-in, replay
    and the output's clone) by CUDA events, and the capture's seconds."""
    step = capture(fn, *inputs[0])
    step(*inputs[0])  # a first replay outside the timing
    return call_ms(torch.device(step.device), step, inputs), step.capture_seconds


def spread(times: list[float]) -> dict:
    return {"median": statistics.median(times), "min": min(times), "max": max(times),
            "all": times}


def run_phase(dev: torch.device, name: str, fn, inputs: list, host_ops: bool = True) -> dict:
    """A phase's record: one warm-up call, whose launches it counts, and
    each call of `inputs` timed; on the card also one profiled call and the
    calls replayed from a capture."""
    rec = {"launches": launches(fn, inputs[0])}
    sync(dev)
    if dev.type != "cuda":
        rec["cpu_ms"] = spread(call_ms(dev, fn, inputs))
        print(f"[{name}] cpu {rec['cpu_ms']['median']:.1f} ms (host clock)", flush=True)
        return rec
    rec["eager_ms"] = spread(call_ms(dev, fn, inputs))
    rec["profile"] = profiled(fn, inputs[0], host_ops)
    times, cap_s = captured_ms(fn, inputs)
    rec["captured_ms"] = spread(times)
    rec["capture_s"] = cap_s
    n = sum(rec["launches"].values())
    p = rec["profile"]
    seen = ("no kernel seen" if p["kernel_ms"] is None else
            f"{p['kernels']} kernels, {p['kernel_ms']:.3f} ms ({p['handwritten_ms']:.3f} ms "
            f"in {p['handwritten_kernels']} hand-written)")
    print(f"[{name}] eager {rec['eager_ms']['median']:.3f} ms, captured "
          f"{rec['captured_ms']['median']:.3f} ms (CUDA events); {n} hand-written "
          f"launches; profile: {seen}", flush=True)
    return rec


def write(out: str | None, payload: dict) -> None:
    """The JSON to --out, never onto one of the repository's records."""
    if out is None:
        return
    path = Path(out).resolve()
    if path.parent == ROOT and any(fnmatch.fnmatch(path.name, r) for r in RECORDS):
        raise ValueError(f"{path.name} is one of the repository's records; "
                         "name another --out")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1) + "\n")
    print(f"wrote {path}")
