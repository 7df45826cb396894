"""Multi-process distribution entry points, the counterpart of the JAX
package's parallel/multihost.py.

The JAX package calls jax.distributed.initialize in every process and builds
one mesh over the global device list. Here every rank is one process with one
device, in a torch.distributed process group:

  1. every process calls `initialize()` with the same rendezvous address, the
     number of processes and its own index; it picks the rank's device and
     the backend (NCCL on a card, gloo on the CPU, or the ones named);
  2. `global_mesh()` is the dp mesh over the process group (parallel/mesh.py);
  3. each process encodes ITS block of the global batch (`encode_local_batch`)
     and runs the sharded pairing and product on it: the per-instance work
     stays on the rank, the product gathers the ranks' rows once.

Launcher, one command per rank (device cuda:<process-id> unless named):

    python -m plonky2_bls12_381_pairing_torch.parallel.multihost \\
        --coordinator=HOST0:1234 --num-processes=N --process-id=K [--batch=B] \\
        [--device=cuda:K | --device=cpu] [--backend=nccl | gloo]

`--coordinator` is host:port (TCP) or a URL torch.distributed takes
(tcp://host:port, file:///shared/path). With one process, initialize()
starts no process group and the mesh is the trivial one of one rank.
`spawn_ranks` starts N such ranks on this host, one process each.
"""

from __future__ import annotations

import argparse
import multiprocessing
import queue
import time
import traceback

import torch
import torch.distributed as dist

from ..ops.rns import fp as rfp
from . import mesh as pm


def rank_device(process_id: int, device=None) -> torch.device:
    """The rank's device: `device` if named, else cuda:<process_id>. A card
    index at or beyond this host's card count raises: ranks are never packed
    onto one card unless the caller names that card for each."""
    dev = rfp.resolve_device(f"cuda:{process_id}" if device is None else device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {process_id}: no card cuda:{index} on this host "
                               f"({torch.cuda.device_count()} cards); name a device")
        dev = torch.device("cuda", index)
    return dev


def initialize(coordinator: str | None, num_processes: int = 1, process_id: int = 0,
               backend: str | None = None, device=None) -> torch.device:
    """The rendezvous, jax.distributed.initialize's counterpart: joins the
    process group of `num_processes` ranks at `coordinator` as rank
    `process_id`, with `backend` (None: "nccl" for a rank on a card, "gloo"
    on the CPU). Starts no process group for one process. Returns the rank's
    device (rank_device), made the current CUDA device on a card."""
    dev = rank_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if num_processes > 1:
        if coordinator is None:
            raise ValueError("more than one process needs a coordinator address")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes, rank=process_id)
    return dev


def global_mesh(device=None) -> pm.Mesh:
    """The dp mesh over the process group (identical on every rank), on
    this rank's device (the current CUDA device unless `device` names
    another)."""
    return pm.make_mesh(device=device)


def encode_local_batch(ps_local, qs_local, mesh: pm.Mesh):
    """This process's G1/G2 refmodel points -> RNS points on its device:
    its block of the global batch, whose packed rows stand in the global
    row order by rank."""
    from ..ops.rns.lines import G1Affine, G2Affine

    return (G1Affine.encode(ps_local, device=mesh.device),
            G2Affine.encode(qs_local, device=mesh.device))


def local_points(rank: int, batch_per_process: int) -> tuple[list, list]:
    """The refmodel points k*G1, k*G2 for k = 1 + rank*batch ...
    (rank + 1)*batch: made by the port's native oracle's batch scalar
    multiplication where it can be built, as the JAX package's run makes
    them, else by the refmodel's (the same points)."""
    from .. import native
    from ..utils import refmodel as rm

    ks = range(1 + rank * batch_per_process, 1 + (rank + 1) * batch_per_process)
    if native.available():
        return native.g1_mul_batch(ks), native.g2_mul_batch(ks)
    g1, g2 = rm.G1Affine.generator(), rm.G2Affine.generator()
    return [g1.mul(k) for k in ks], [g2.mul(k) for k in ks]


def run(batch_per_process: int = 64, device=None):
    """The sharded RNS pairing and product on this process's block, the
    points of local_points. Returns (this rank's e rows, the product)."""
    mesh = global_mesh(device)
    ps, qs = encode_local_batch(*local_points(mesh.rank, batch_per_process), mesh)
    e, gt = pm.rns_pairing_and_product_sharded(mesh)(ps, qs)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return e, gt


def _rank_main(fn, rank: int, size: int, results, args) -> None:
    try:
        out = fn(rank, size, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


def spawn_ranks(fn, size: int, *args, timeout: float = 600.0) -> list:
    """Run fn(rank, size, *args) in `size` new processes (spawned: a fresh
    interpreter each, fn found by its import path) and return their results
    in rank order. A rank that raises, or a run that outlasts `timeout`
    seconds, stops every rank and raises RuntimeError. A rank's process group
    is destroyed when fn returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, rank, size, results, args))
             for rank in range(size)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode]
                if dead:  # what it sent before it exited is in the queue by now
                    try:
                        rank, ok, value = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(f"ranks {dead} exited without a result") from None
                elif time.monotonic() > deadline:
                    raise RuntimeError(f"{size - len(out)} of {size} ranks gave no "
                                       f"result within {timeout} s") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [out[r] for r in range(size)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = initialize(args.coordinator, args.num_processes, args.process_id,
                     args.backend, args.device)
    try:
        e, gt = run(args.batch, dev)
        backend = dist.get_backend() if dist.is_initialized() else None
        print(f"process {args.process_id}/{args.num_processes} on {dev} ({backend}): "
              f"e shard {tuple(e.shape)}, product {tuple(gt.shape)} on every rank, "
              f"{pm.collectives['all_gather']} all_gather")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
