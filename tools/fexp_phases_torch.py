"""Sub-phase timing of the port's RNS final exponentiation on the card, the
counterpart of tools/fexp_phases.py.

    python tools/fexp_phases_torch.py [--batch 2048] [--reps 3] [--out F.json]

On a cyclotomic element F tiled over B/2 packed rows (the easy part of an
encoded random Fq12 value, as a pairing hands it on): the Karabina chain of
|x| with its six snapshots by the kara_exp kernel and in plain PyTorch
(kara_exp_plain), the decompression of 6 snapshots, fp.inv over 6 x rows,
tower.inv, cyclotomic_square, tower.mul, frobenius_map, the whole
final_exponentiation and cyclotomic_exp, and the Karabina walk in its three
stages: kara_exp from f, with the decompression, and with the snapshots'
product tree (cyclotomic_exp(impl="karabina")).

Each case's time is the JAX tool's rep slope, (t(4 calls) - t(1 call)) / 3,
with t from CUDA events around calls queued behind a held stream; beside it
the case replayed from a CUDA graph (utils/capture.py), by CUDA events, and
the hand-written kernels' launches in one call.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

import torch_tool_common as common
from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.models.schedule import _KARA_SEGMENTS
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernels, tower
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm

SNAPSHOTS = len(_KARA_SEGMENTS)
#: cycles of the card's SM clock per ms (about 1.98 GHz on an H100), for
#: holding the stream while the host queues a run of calls
CYCLES_PER_MS = 1.98e6


def cases(f: torch.Tensor) -> dict:
    """case name -> (fn, its argument) on the cyclotomic rows f."""
    rows = f.shape[0]
    c8 = tower.compress_cyclotomic(f).contiguous()
    snaps = c8[None].expand(SNAPSHOTS, *c8.shape).contiguous()
    den = f[:, None, 0, :].expand(rows, SNAPSHOTS, RC.LANES).reshape(-1, RC.LANES).contiguous()
    chain = lambda c: kernels.kara_exp(c, _KARA_SEGMENTS)
    return {
        "kara_chain (kernel)": (chain, c8),
        "kara_chain (plain)": (lambda c: kernels.kara_exp_plain(c, _KARA_SEGMENTS), c8),
        f"decompress ({SNAPSHOTS} snapshots)": (tower.decompress_cyclotomic, snaps),
        f"fp.inv ({SNAPSHOTS} x rows)": (fp.inv, den),
        "tower.inv": (tower.inv, f),
        "cyclotomic_square": (tower.cyclotomic_square, f),
        "tower.mul": (lambda a: tower.mul(a, a), f),
        "frobenius_map": (tower.frobenius_map, f),
        "final_exponentiation": (mpr.final_exponentiation, f),
        "cyclotomic_exp": (mpr.cyclotomic_exp, f),
        "kara_exp (from f)": (lambda a: chain(tower.compress_cyclotomic(a)), f),
        "kara_exp + decompress": (
            lambda a: tower.decompress_cyclotomic(chain(tower.compress_cyclotomic(a))), f),
        "kara_exp + decompress + tree": (
            lambda a: mpr.cyclotomic_exp(a, impl="karabina"), f),
    }


PHASES = ("kara_chain (kernel)", "kara_chain (plain)", f"decompress ({SNAPSHOTS} snapshots)",
          f"fp.inv ({SNAPSHOTS} x rows)", "tower.inv", "cyclotomic_square", "tower.mul",
          "frobenius_map", "final_exponentiation", "cyclotomic_exp", "kara_exp (from f)",
          "kara_exp + decompress", "kara_exp + decompress + tree")


def cyclotomic_rows(rows: int, dev: torch.device) -> torch.Tensor:
    """One encoded random Fq12 value's easy part, tiled over `rows`."""
    f12 = rm.rand_fq12(random.Random(5))
    f = torch.from_numpy(tower.encode([f12, f12])).to(dev)
    t0 = tower.mul(tower.conjugate(f), tower.inv(f))
    cyc = tower.mul(tower.frobenius_pow(t0, 2), t0)
    return cyc.expand(rows, 12, RC.LANES).contiguous()


def queued_ms(dev: torch.device, fn, args: tuple, n: int, hold_ms: float = 20.0) -> float:
    """ms of n calls of fn(*args) queued back to back: on the card CUDA
    events around them, behind a stream held busy for hold_ms so that the
    host queues ahead of the card (as far as the launch queue lets it); on
    the CPU the host clock."""
    common.sync(dev)
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(n):
            fn(*args)
        return (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_ms * CYCLES_PER_MS))
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def slope_ms(dev: torch.device, fn, arg, reps: int) -> dict:
    """The rep slope: the best of `reps` times of 1 and of 4 queued calls."""
    t1 = min(queued_ms(dev, fn, (arg,), 1) for _ in range(reps))
    t4 = min(queued_ms(dev, fn, (arg,), 4) for _ in range(reps))
    return {"slope": (t4 - t1) / 3, "t1": t1, "t4": t4}


def main(argv=None) -> int:
    ap = common.parser(__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2048, help="elements (two per packed row)")
    args = ap.parse_args(argv)
    opened = common.open_device(args.device)
    if opened is None:
        return 2
    dev, card = opened
    names = common.selected(args.phases, PHASES)
    rows = -(-args.batch // RC.PACK)
    table = cases(cyclotomic_rows(rows, dev))
    assert tuple(table) == PHASES
    results = {}
    for name in names:
        fn, arg = table[name]
        rec = {"launches": common.launches(fn, (arg,))}  # and the warm-up
        key = "slope_ms" if dev.type == "cuda" else "cpu_slope_ms"
        rec[key] = slope_ms(dev, fn, arg, args.reps)
        line = f"[{name}] {rec[key]['slope']:.3f} ms per call (rep slope"
        if dev.type == "cuda":
            times, cap_s = common.captured_ms(fn, [(arg,)] * args.reps)
            rec["captured_ms"], rec["capture_s"] = common.spread(times), cap_s
            line += f", CUDA events); captured {statistics.median(times):.3f} ms"
        else:
            line += ", host clock)"
        print(f"{line}; {sum(rec['launches'].values())} hand-written launches", flush=True)
        results[name] = rec
    common.write(args.out, {
        "tool": "fexp_phases_torch", "card": card, "device": str(dev),
        "batch_elements": args.batch, "rows": rows, "reps": args.reps,
        "clock": "cuda events" if dev.type == "cuda" else "host (cpu_slope_ms)",
        "phases": {name: results.get(name) for name in PHASES}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
