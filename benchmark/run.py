"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json; its
configuration, its traffic mix, the generator, system and loop that the mix
names, and its metrics are files under benchmark/ found by name
(harness/spec.py). The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), device, with --trace 1 the
breakdown, and last the compared numbers with their limits, which also end
standard error. Without enough CUDA cards, or if the process has loaded JAX
or the JAX package, it prints no result and exits with 2 or 3.

Build and kernel caches stay in build/ inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from benchmark.harness import spec

    cell = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}")
        return 2
    from benchmark.harness import guard, runner

    try:
        out, lines = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                                cell.part("system").System("cuda"), T_START, log)
    except runner.ForbiddenModule as e:
        log(str(e))
        return 3
    found = guard.forbidden_loaded()
    if found:
        log(f"before the result: the process has loaded {found}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
