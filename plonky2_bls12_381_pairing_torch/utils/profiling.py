"""Observability of the port (the JAX package's utils/profiling.py): Fp-op
counts, the RNS tier's operation model and roofline against the card's peak
rates, a measured REDC cost, torch.profiler traces, a step timer, and one
call's device time.

  rns_op_report       exact Fp-op counts of a computation (ops/rns/fp.py
                      count_fp_ops);
  static_op_report    rows per kind of a computation's witness trace
                      (models/witness.py), the reference's circuit-size
                      probe;
  card_peak           the card's peak int32 and u8 tensor-core rates, from
                      its SM count and maximum SM clock;
  rns_roofline        achieved operations per second (op counts x the
                      operation model below) over the card's peaks;
  roofline_fraction   an achieved rate of some operation over the int32 peak;
  measure_redc_unit_cost, rns_time_model
                      fp.redc's measured cost per row, and the share of a
                      call's time it explains;
  trace               a torch.profiler trace of a block, written to a
                      directory;
  StepTimer           per-step times with the card synchronised;
  device_profile      one call's kernel time, launches and busy share.

The JAX package's compiled_cost (XLA's cost model) has no counterpart: an
eager PyTorch call has no compiler cost model, and device_profile measures
what compiled_cost estimates.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import rns_constants as RC


def rns_op_report(fn, *args) -> dict:
    """Exact RNS Fp-op counts (fp_mul, redc; element units) of fn's
    computation, run at the arguments' size on the CPU
    (ops/rns/fp.py count_fp_ops)."""
    from ..ops.rns import fp

    return fp.count_fp_ops(fn, *args)


def recorded_elements(tr) -> dict:
    """{kind: recorded elements} of a WitnessTrace: per row the product of
    its first tensor's batch axes (a packed RNS row counts once)."""
    return {op: sum(max(1, int(np.prod(r[0].shape[:-1]))) for r in rows)
            for op, rows in tr.rows.items()}


def static_op_report(fn, *args) -> dict:
    """{kind: recorded elements} of fn's witness trace (recorded_elements)."""
    from ..models import witness

    return recorded_elements(witness.trace(fn, *args)[1])


# ---------------------------------------------------------------------------
# The RNS tier's operation model (the one chip_smoke.py bounds kernels by)
# ---------------------------------------------------------------------------


class Work(NamedTuple):
    """The operations of some RNS work: int32 operations outside the REDC
    base extensions, and the base extensions' multiply-adds, which are matrix
    products the card runs on its tensor cores (3 u8 plane products of 2
    operations each per multiply-add, csrc/rns_redc_tc.cuh)."""

    int_ops: int
    ext_macs: int

    def __add__(self, other: "Work") -> "Work":
        return Work(self.int_ops + other.int_ops, self.ext_macs + other.ext_macs)

    def __mul__(self, k) -> "Work":
        return Work(self.int_ops * k, self.ext_macs * k)

    __rmul__ = __mul__


def lane_work(products: int) -> Work:
    """`products` channel products, one operation per lane on the 63
    channel lanes."""
    return Work(products * 63, 0)


#: One REDC row (one element's component): the two base extensions'
#: multiply-adds (31 base-A sigmas onto 31 base-B lanes, the redundant lane
#: and the alpha column; 31 base-B sigmas onto 31 base-A lanes and the beta
#: column), plus five per-lane products (sigma, two for sigma', two for the
#: output) on the 63 channel lanes.
REDC_ROW = Work(5 * 63, 31 * 33 + 31 * 32)
#: the u8 tensor-core operations of one base-extension multiply-add
TC_OPS_PER_EXT_MAC = 6


def rns_work(counts: dict) -> Work:
    """The operations of fp_mul channel products and redc rows (counts in
    element units, as rns_op_report gives them)."""
    return lane_work(counts.get("fp_mul", 0)) + REDC_ROW * counts.get("redc", 0)


# ---------------------------------------------------------------------------
# The card's peak rates
# ---------------------------------------------------------------------------

#: Operations per SM and clock on compute capability 9.0 (Hopper; NVIDIA's
#: H100 architecture whitepaper): 64 INT32 lanes, a multiply-add counted as
#: two operations; 4 tensor cores of 1,024 dense int8 multiply-adds each.
#: At the maximum SM clock these give a little more than the data sheet's
#: tensor-core rate, which is quoted at a lower boost clock.
PER_SM_CLOCK = {(9, 0): {"int32_ops": 2 * 64, "u8_tc_ops": 2 * 4 * 1024}}


class Peak(NamedTuple):
    sms: int
    clock_hz: float
    int32_ops_per_s: float
    u8_tc_ops_per_s: float


def max_sm_clock_hz(index: int = 0) -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def card_peak(device=None) -> Peak:
    """Peak rates of the card: its SM count (torch.cuda.get_device_properties)
    and maximum SM clock (nvidia-smi) times the per-SM rates of its
    architecture (PER_SM_CLOCK)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"card_peak needs a CUDA device, got {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    rates = PER_SM_CLOCK.get((props.major, props.minor))
    if rates is None:
        raise ValueError(f"no per-SM rates for compute capability "
                         f"{props.major}.{props.minor}")
    clock = max_sm_clock_hz(index)
    sms = props.multi_processor_count
    return Peak(sms, clock, rates["int32_ops"] * sms * clock,
                rates["u8_tc_ops"] * sms * clock)


def rns_roofline(pairings_per_sec: float, counts_per_pairing: dict,
                 peak: Peak | None = None) -> dict:
    """The RNS tier's roofline: operations per pairing (exact op counts x
    the operation model) at the achieved rate, over the card's peaks; the
    int32 share prices the base extensions at the int32 rate as well, the
    bound share takes them on the tensor cores."""
    peak = card_peak() if peak is None else peak
    w = rns_work(counts_per_pairing)
    t_int = w.int_ops / peak.int32_ops_per_s
    t_tc = TC_OPS_PER_EXT_MAC * w.ext_macs / peak.u8_tc_ops_per_s
    t_int_only = (w.int_ops + 2 * w.ext_macs) / peak.int32_ops_per_s
    return {
        "int_ops_per_pairing": w.int_ops,
        "ext_macs_per_pairing": w.ext_macs,
        "int_ops_per_s": pairings_per_sec * w.int_ops,
        "bound_s_per_pairing": max(t_int, t_tc),
        "bound_fraction": pairings_per_sec * max(t_int, t_tc),
        "int32_only_fraction": pairings_per_sec * t_int_only,
    }


def roofline_fraction(pairings_per_sec: float, ops_per_pairing: float,
                      peak: Peak | None = None) -> float:
    """The achieved int32 operations per second over the card's int32
    peak."""
    peak = card_peak() if peak is None else peak
    return pairings_per_sec * ops_per_pairing / peak.int32_ops_per_s


# ---------------------------------------------------------------------------
# Measured costs
# ---------------------------------------------------------------------------


def _cuda_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise ValueError(f"this measurement times a CUDA device with CUDA events, got {dev}")
    return dev


def measure_redc_unit_cost(rows: int = 1024, comps: int = 12, reps: int = 5,
                           device=None) -> dict:
    """fp.redc's measured cost per (rows, comps, LANES) row, on the card:
    chains of n1 and n2 reductions (and of square + reduction) on random
    channel-valid residues, each timed with CUDA events (best of reps), the
    slope between the two lengths per row. The residues decode to no
    particular values: the arithmetic is the same for any."""
    from ..ops.rns import fp

    dev = _cuda_device(device)
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.integers(0, RC.PRIME_MAX // 2, (rows, comps, RC.LANES))
                          .astype(np.int32) * (RC.M_I32 > 1))).to(dev)

    def best_ms(body, n):
        a = body(x)  # the tables uploaded, the first matmul made
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            a = x
            for _ in range(n):
                a = body(a)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times)

    out = {}
    n1, n2 = 16, 144
    for name, body in (("redc", lambda a: fp.redc(fp.wrap(a))),
                       ("mul_redc", lambda a: fp.redc(fp.mul_ss(a, a)))):
        t1, t2 = best_ms(body, n1), best_ms(body, n2)
        out[f"{name}_us_per_row"] = max(0.0, (t2 - t1) * 1e3 / ((n2 - n1) * rows * comps))
    return out


def rns_time_model(pairings_per_sec: float, counts_per_pairing: dict,
                   unit: dict) -> dict:
    """The share of a pairing's time that its REDC rows explain at the
    measured cost per row (measure_redc_unit_cost): a row holds PACK
    elements."""
    t_redc = unit["redc_us_per_row"]
    predicted_us = counts_per_pairing.get("redc", 0) * t_redc / RC.PACK
    actual_us = 1e6 / pairings_per_sec
    return {
        "redc_us_per_row_measured": round(t_redc, 4),
        "mul_redc_us_per_row_measured": round(unit["mul_redc_us_per_row"], 4),
        "redc_time_share": round(predicted_us / actual_us, 4),
    }


# ---------------------------------------------------------------------------
# Traces and timers
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler trace of the block (host operators, and the card's
    kernels where there is a card), written to logdir/trace.json for
    Perfetto or chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Per-step wall times, the card synchronised before and after each
    step, so that a step's time holds its kernels."""

    def __init__(self, name: str):
        self.name = name
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.times.append(time.perf_counter() - t0)

    def summary(self, items_per_step: int = 1) -> dict:
        if not self.times:
            return {"name": self.name, "steps": 0}
        ts = self.times
        return {
            "name": self.name,
            "steps": len(ts),
            "best_s": min(ts),
            "median_s": statistics.median(ts),
            "mean_s": statistics.fmean(ts),
            "items_per_s": items_per_step / min(ts),
        }


def device_profile(run, host_ops: bool = True, top: int = 8) -> dict:
    """One call of `run` under torch.profiler, the card synchronised before
    and after: its wall ms, the summed time of its CUDA kernels (device_ms),
    their launches and the busy share, and its `top` kernels by time as
    (ms, launches, name). With host_ops False only the card's events are
    recorded (a call of a quarter of a million launches makes a host trace
    that takes minutes to digest). device_ms is None where the profiler saw
    no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not evs:
        return {"wall_ms": wall, "device_ms": None, "kernel_launches": None,
                "busy": None, "top": []}
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    ranked = sorted(evs, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {"wall_ms": wall, "device_ms": busy, "kernel_launches": sum(e.count for e in evs),
            "busy": busy / wall,
            "top": [(e.self_device_time_total / 1e3, e.count, e.key) for e in ranked]}
