"""Scaling report of the port's data-parallel pairing, the counterpart of the
JAX package's scaling_report.py.

Times the same sharded RNS pairing and product
(parallel/mesh.py rns_pairing_and_product_sharded) on N = 1, 2, 4, ... ranks,
one process each: one rank per card, or gloo ranks on the CPU with
--device cpu. The batch is the same at every N (B generator pairs, split in
N blocks of packed rows). A rank's time per call runs from a barrier to the
end of its call (synchronised on a card); a call's time is its slowest rank's,
and the curve keeps each N's best call. Efficiency is t_1 / (N * t_N) at the
largest N run; on the CPU the ranks share the host's cores, so it measures
what the sharding costs, not a speedup.

    python scaling_report_torch.py [--device cuda|cpu] [--ranks N] [--batch B]
                                   [--reps R] [--out PATH]

Prints one JSON line; writes it to --out as well when given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.parallel import mesh as pm
from plonky2_bls12_381_pairing_torch.parallel import multihost


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if dist.is_initialized():
        dist.barrier()


def time_rank(rank: int, size: int, rendezvous: str, device, batch: int, reps: int) -> dict:
    """One rank: its first call's seconds and each later call's."""
    dev = multihost.initialize(rendezvous, size, rank,
                               device=None if device == "cuda" else device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks are the parallelism
    mesh = pm.make_mesh(device=dev)
    ps, qs = pm.shard_points_rns(G1Affine.generator((batch,), "cpu"),
                                 G2Affine.generator((batch,), "cpu"), mesh)
    fn = pm.rns_pairing_and_product_sharded(mesh)
    times = []
    for _ in range(reps + 1):
        _sync(dev)
        t = time.perf_counter()
        fn(ps, qs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t)
    return {"first_s": times[0], "times_s": times[1:]}


def run_on(n: int, device: str, batch: int, reps: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        ranks = multihost.spawn_ranks(time_rank, n, f"file://{tmp}/rendezvous", device,
                                      batch, reps)
    calls = [max(r["times_s"][i] for r in ranks) for i in range(reps)]
    return {"t_s": min(calls), "first_call_s": max(r["first_s"] for r in ranks)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="largest N (default: the card count; 4 on the CPU)")
    ap.add_argument("--batch", type=int, default=64, help="elements, two per packed row")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is available; pass --device cpu")
        cards = torch.cuda.device_count()
        n = cards if args.ranks is None else args.ranks
        if n > cards:
            raise SystemExit(f"{n} ranks need {n} cards, this host has {cards}")
        kind = torch.cuda.get_device_name(0)
    else:
        n = 4 if args.ranks is None else args.ranks
        kind = "cpu"
    curve = {}
    k = 1
    while k <= n:
        curve[k] = run_on(k, args.device, args.batch, args.reps)
        k *= 2
    top = max(curve)
    t1, tn = curve[1]["t_s"], curve[top]["t_s"]
    out = {
        "batch": args.batch,
        "n_devices": top,
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "kind": kind,
        "t_1dev_s": t1,
        "t_ndev_s": tn,
        "speedup": t1 / tn,
        # measured at the largest power of two run, so divided by it
        "efficiency": t1 / (top * tn),
        "sharding_overhead": tn / t1 - 1.0,
        "physical_cores": os.cpu_count(),
        "first_call_1dev_s": curve[1]["first_call_s"],
        "first_call_ndev_s": curve[top]["first_call_s"],
        "device_curve": {str(k): v for k, v in curve.items()},
        "note": "rns_pairing_and_product_sharded, one process per rank; a call is "
                "its slowest rank's barrier-to-end time; on the CPU the ranks "
                "share the host's cores",
    }
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
