"""Drive the PyTorch port's pairing on one CUDA card and hold it to its
references.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from csrc/ and report nvcc's resource use;
  2. run each kernel on the card at the shapes the pairing gives it and hold
     it bit for bit to its plain PyTorch version; time both;
  3. run `pairing` at B = 2048 over distinct points k*G1, k*G2 (two of them
     at infinity) with the launch counters reset just before; hold all
     2048 outputs to the exact-integer oracle (utils/refmodel.py, in a process
     pool started at the beginning) and the frozen vectors of
     tests/vectors/pairing_kat.json; check the launch counts; time pairings/s;
  4. profile one pairing call: device-busy share and the top kernels.
The second-to-last lines are the card's name and power limit and a JSON
object with each kernel's numbers; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.models.schedule import _GS_SEGMENTS
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernels, tower
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm

KAT = Path(__file__).resolve().parent / "tests" / "vectors" / "pairing_kat.json"
TPU_KERNELS = "plonky2_bls12_381_pairing_tpu/ops/rns/pallas.py"
PORT_CSRC = "plonky2_bls12_381_pairing_torch/csrc"
#: pairings per call: the JAX package's batch per chip on its main path
BATCH = 2048

# Peak rates of one H100 SXM at its full 700 W limit (NVIDIA data sheet):
# HBM at 3.35 TB/s; int32 multiply-adds on 64 INT32 lanes per SM x 132 SMs at
# the 1.98 GHz boost clock, counted as two operations each, i.e. half the
# 67 TFLOP/s float32 rate.
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 2 * 64 * 132 * CLOCK_HZ

# Operation model of one REDC row (one element's component): the two base
# extensions' multiply-adds (31 base-A sigmas onto 31 base-B lanes, the
# redundant lane and the alpha column; 31 base-B sigmas onto 31 base-A lanes
# and the beta column), two operations each, plus five per-lane products
# (sigma, two for sigma', two for the output) on the 63 channel lanes.
REDC_OPS = 2 * (31 * 33 + 31 * 32) + 5 * 63
#: channel products (one per lane) of a Granger-Scott squaring (9 Fq2
#: products of 3 each, 12 lifts) and of a full Fq12 product (18 Fq2 products)
CYC_SQ_PRODUCTS, FQ12_MUL_PRODUCTS = 9 * 3 + 12, 18 * 3


def cyc_exp_ops(elements: int, segments) -> int:
    squares = sum(n for n, _ in segments)
    muls = sum(1 for _, m in segments if m)
    per_sq = 12 * REDC_OPS + CYC_SQ_PRODUCTS * 63
    per_mul = 12 * REDC_OPS + FQ12_MUL_PRODUCTS * 63
    return elements * (squares * per_sq + muls * per_mul)


def pow_steps(exponent: int) -> int:
    """Dependent REDCs of one element: one per squaring and per multiply."""
    bits = fp.exponent_bits(exponent)
    return len(bits) + sum(bits)


def pow_ops(elements: int, exponent: int) -> int:
    return elements * pow_steps(exponent) * (REDC_OPS + 63)


# Latency model of one dependent pow step, redc(mul(acc, .)), on its
# critical path, in cycles. Assumed Hopper latencies: a dependent int32
# multiply-add 4, a shared-memory load 30, a barrier of 4 warps 24, a Barrett
# reduction (convert, float product, convert back, multiply-add, select) 24.
# The path: the product and step 1 (two Barretts), four barriers, two 31-term
# dot products each behind one shared load, step 3 (a shared load, two
# Barretts, three multiply-adds), and the last Barrett behind a shared load
# and a multiply-add.
IMAD_CYC, SMEM_CYC, SYNC_CYC, BARRETT_CYC = 4, 30, 24, 24
POW_STEP_CYC = (2 * BARRETT_CYC + 4 * SYNC_CYC + 2 * (SMEM_CYC + 31 * IMAD_CYC)
                + (SMEM_CYC + 2 * BARRETT_CYC + 3 * IMAD_CYC)
                + (SMEM_CYC + IMAD_CYC + BARRETT_CYC))


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_kernel(fn, reps: int) -> float:
    """Median milliseconds of one call, from CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_host(fn, reps: int) -> float:
    """Median milliseconds of one synchronised call, on the host clock."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def random_fq12_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    ints = np.empty((n, 12), dtype=object)
    for idx in np.ndindex(ints.shape):
        ints[idx] = int.from_bytes(rng.bytes(48), "little") % rm.P
    return fp.encode(ints)


def oracle_pairing(p: rm.G1Affine, q: rm.G2Affine) -> list[int]:
    """Exact-integer e(P, Q) coefficients (one at an infinity input)."""
    return rm.pairing(p, q).coeffs()


def points() -> tuple[list, list]:
    """P_i = (i+1) G1, Q_i = (2i+1) G2 for i < BATCH, with P_5 and Q_6 at
    infinity."""
    g1, g2 = rm.G1Affine.generator(), rm.G2Affine.generator()
    g2x2 = g2.add(g2)
    ps, qs = [g1], [g2]
    for _ in range(BATCH - 1):
        ps.append(ps[-1].add(g1))
        qs.append(qs[-1].add(g2x2))
    ps[5] = rm.G1Affine(0, 0, True)
    qs[6] = rm.G2Affine(rm.Fq2(0, 0), rm.Fq2(0, 0), True)
    return ps, qs


def profile_call(run) -> None:
    """Device-busy share of one call and the kernels that take its device
    time, from torch.profiler (CUDA kernel events only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not evs:
        print("[profile] device time not measured: the profiler saw no CUDA kernels")
        return
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    print(f"[profile] one call, profiler on: {wall:.1f} ms wall, {busy:.1f} ms of "
          f"kernels ({100 * busy / wall:.1f} % busy), "
          f"{sum(e.count for e in evs)} kernel launches")
    for e in sorted(evs, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} x "
              f"{e.key[:90]}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = -(-BATCH // RC.PACK)
    card = smi()

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=os.cpu_count(), mp_context=ctx) as pool:
        ps, qs = points()
        oracle = pool.map(oracle_pairing, ps, qs, chunksize=16)

        # -- 1. build ------------------------------------------------------
        t = time.perf_counter()
        out_dir = kernels.build()
        print(f"[build] {time.perf_counter() - t:.1f} s into {out_dir}")
        for name, log in kernels.build_log.items():
            for line in log.splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")
        print(f"[card] {card}")

        # -- 2. kernels vs plain at the path's shapes ------------------------
        rng = np.random.default_rng(2048)
        f_rows = torch.from_numpy(random_fq12_rows(rng, 2 * rows)).to(dev)
        # the easy part of the final exponentiation maps any f to a
        # cyclotomic element, as on the pairing's path
        t0 = tower.mul(tower.conjugate(f_rows), tower.inv(f_rows))
        cyc_in = tower.mul(tower.frobenius_pow(t0, 2), t0).contiguous()
        got = kernels.cyc_exp(cyc_in, _GS_SEGMENTS)
        want = kernels.cyc_exp_plain(cyc_in, _GS_SEGMENTS)
        torch.cuda.synchronize()
        cyc_err = max_abs_err(got, want)
        print(f"[cyc_exp] {tuple(cyc_in.shape)} kernel vs plain: max |diff| {cyc_err}")
        assert cyc_err == 0, "cyc_exp kernel disagrees with cyc_exp_plain"
        cyc_ms = time_kernel(lambda: kernels.cyc_exp(cyc_in, _GS_SEGMENTS), 10)
        cyc_plain_ms = time_host(lambda: kernels.cyc_exp_plain(cyc_in, _GS_SEGMENTS), 2)
        cyc_bound = bound_ms(2 * cyc_in.numel() * 4,
                             cyc_exp_ops(RC.PACK * cyc_in.shape[0], _GS_SEGMENTS))

        e = rm.P - 2
        vals = [int.from_bytes(rng.bytes(48), "little") % rm.P for _ in range(256)]
        vals[3] = vals[200] = vals[201] = 0
        pow_in = torch.from_numpy(fp.encode(vals)).to(dev)
        got = kernels.pow_static_fused(pow_in, e)
        want = fp.pow_static(pow_in, e)
        torch.cuda.synchronize()
        pow_err = max_abs_err(got, want)
        print(f"[pow_static] {tuple(pow_in.shape)} e=p-2 kernel vs plain: "
              f"max |diff| {pow_err}")
        assert pow_err == 0, "pow_static_fused kernel disagrees with pow_static"
        dec = fp.decode(got)
        assert [dec[i] for i in (3, 200, 201)] == [0, 0, 0], "0 must map to 0"
        assert all(v == 0 or dec[i] * v % rm.P == 1 for i, v in enumerate(vals))
        pow_ms = time_kernel(lambda: kernels.pow_static_fused(pow_in, e), 20)
        pow_plain_ms = time_host(lambda: fp.pow_static(pow_in, e), 2)
        pow_bound = bound_ms(2 * pow_in.numel() * 4, pow_ops(256, e))
        # what the chain of dependent steps costs: one row alone (one block,
        # no contention) against the latency model
        pow_one_ms = time_kernel(lambda: kernels.pow_static_fused(pow_in[:1], e), 20)
        steps = pow_steps(e)
        print(f"[pow_static] {steps} dependent REDCs: {pow_ms:.3f} ms at "
              f"{tuple(pow_in.shape)}, {pow_one_ms:.3f} ms for one row alone "
              f"({pow_one_ms / steps * 1e3:.3f} us per step); latency model "
              f"{steps * POW_STEP_CYC / CLOCK_HZ * 1e3:.3f} ms "
              f"({POW_STEP_CYC} cycles per step at {CLOCK_HZ / 1e9} GHz)")

        # -- 3. the pairing, end to end --------------------------------------
        p_dev = G1Affine.encode(ps, device=dev)
        q_dev = G2Affine.encode(qs, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        out = mpr.pairing(p_dev, q_dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        counts = dict(kernels.launches)
        print(f"[pairing] B={BATCH}: first call {first_s:.2f} s, launches {counts}")
        assert counts == {"cyc_exp": 5, "pow_static": 1}, counts
        assert out.shape == (rows, 12, RC.LANES) and out.dtype == torch.int32

        got_rows = fp.decode(out)[:BATCH]
        want_rows = list(oracle)
        bad = [i for i in range(BATCH) if list(got_rows[i]) != want_rows[i]]
        print(f"[pairing] vs oracle: {BATCH - len(bad)}/{BATCH} bit-exact")
        assert not bad, f"pairing disagrees with the oracle at {bad[:8]}"

        kat = json.loads(KAT.read_text())["vectors"]
        kp = [rm.G1Affine(int(v["p_x"], 16), int(v["p_y"], 16), False) for v in kat]
        kq = [rm.G2Affine(rm.Fq2(int(v["q_x"][0], 16), int(v["q_x"][1], 16)),
                          rm.Fq2(int(v["q_y"][0], 16), int(v["q_y"][1], 16)), False)
              for v in kat]
        kout = mpr.pairing(G1Affine.encode(kp, device=dev), G2Affine.encode(kq, device=dev))
        kgot = list(tower.decode(kout))[: len(kat)]
        kwant = [rm.Fq12.from_coeffs([int(h, 16) for h in v["e_chain"]]) for v in kat]
        nkat = sum(g == w for g, w in zip(kgot, kwant))
        print(f"[pairing] KAT e_chain: {nkat}/{len(kat)}")
        assert nkat == len(kat)

        pairing_ms = time_host(lambda: mpr.pairing(p_dev, q_dev), 3)
        rate = BATCH / (pairing_ms / 1e3)
        print(f"[pairing] B={BATCH}: {pairing_ms:.1f} ms per call, "
              f"{rate:.1f} pairings/s on {card}")
        print(json.dumps({"pairing": {"batch": BATCH, "ms": pairing_ms,
                                      "pairings_per_s": rate, "card": card}}))

        # -- 4. where the time goes ------------------------------------------
        profile_call(lambda: mpr.pairing(p_dev, q_dev))

    report = {"kernels": [
        {"name": "cyc_exp", "route": "cuda", "source": f"{PORT_CSRC}/cyc_exp.cu",
         "replaces": f"{TPU_KERNELS}:812", "launches": counts["cyc_exp"],
         "max_abs_err": cyc_err, "ms": cyc_ms, "plain_ms": cyc_plain_ms,
         "bound_ms": cyc_bound[0], "bound_by": cyc_bound[1], "library_ms": None},
        {"name": "pow_static", "route": "cuda", "source": f"{PORT_CSRC}/pow_static.cu",
         "replaces": f"{TPU_KERNELS}:1035", "launches": counts["pow_static"],
         "max_abs_err": pow_err, "ms": pow_ms, "plain_ms": pow_plain_ms,
         "bound_ms": pow_bound[0], "bound_by": pow_bound[1], "library_ms": None},
    ]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
