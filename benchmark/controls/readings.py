"""The readings that the limits of `correct` are set from, for one cell, in
one process on the card: the compared numbers (harness/judge.py) of the
program on many seeds, and of the control and of planted faults on a few.

    python3 benchmark/controls/readings.py --workload attest-2048x2 \\
        --seeds 12 --control-seeds 3 --out chiprun_out/readings_attest.json

Each seed gets its own traffic, encoded and fed to one capture of the timed
path at the cell's own size; the loop then runs through every distinct batch
twice and the judge reads the answers, as a run does. Variants, each captured
anew with its change in place:

  control_bf16     the program's float32 plane products (ops/rns/fp.py _mm,
                   the base extensions of every REDC outside the kernels)
                   rounded to bfloat16: exact arithmetic broken;
  tf32             TF32 allowed for float32 matmuls, the precision below
                   the program's float32 with TF32 off;
  fexp_unchanged   the final exponentiation returns its input unchanged;
  miller_unchanged the Miller loop's accumulation returns its state
                   unchanged;
  half_batch       the first half of each batch checked and its verdicts
                   copied over the second half: half of the batch left out;
  answer_altered   one verdict of each call flipped where it is produced.

benchmark/tests/test_bench_faults.py plants the same VARIANTS on the CPU.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _bf16_mm(x, mat):
    import torch

    return torch.matmul(x.to(torch.bfloat16), mat.to(torch.bfloat16)).to(torch.int32)


def _tf32_mm(x, mat):
    """fp._mm with TF32 allowed for its one matmul (the program turns TF32
    off again on every call, fp.resolve_device)."""
    import torch

    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(x.to(torch.float32), mat).to(torch.int32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _half_batch(real):
    def check(px, py, pinf, qx, qy, qinf):
        import torch

        h = px.shape[1] // 2
        got = real(px[:, :h], py[:, :h], pinf[:, :h], qx[:, :h], qy[:, :h], qinf[:, :h])
        return torch.cat([got, got])
    return check


def _altered(real):
    def check(*args):
        out = real(*args).clone()
        out[0, 0] = ~out[0, 0]
        return out
    return check


#: each variant: (module, attribute, the replacement given the original);
#: the module is "fp", "kernels", "pairing_rns" of the port or "system", the
#: cell's system module
VARIANTS = {
    "control_bf16": ("fp", "_mm", lambda real: _bf16_mm),
    "tf32": ("fp", "_mm", lambda real: _tf32_mm),
    "fexp_unchanged": ("pairing_rns", "final_exponentiation",
                       lambda real: lambda f, impl="segments": f),
    "miller_unchanged": ("kernels", "miller_run", lambda real: lambda f, *args, **kw: f),
    "half_batch": ("system", "check", _half_batch),
    "answer_altered": ("system", "check", _altered),
}


@contextlib.contextmanager
def variant(name: str, cell):
    """The program with the named change in place (module docstring);
    "program" changes nothing."""
    if name == "program":
        yield
        return
    from plonky2_bls12_381_pairing_torch.models import pairing_rns
    from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernels

    where, attr, make = VARIANTS[name]
    obj = {"fp": fp, "kernels": kernels, "pairing_rns": pairing_rns,
           "system": cell.part("system")}[where]
    real = getattr(obj, attr)
    setattr(obj, attr, make(real))
    try:
        yield
    finally:
        setattr(obj, attr, real)


def readings(cell, seeds: list[int], name: str, system) -> list[dict]:
    from benchmark.harness import judge

    gen, loop = cell.part("generator"), cell.part("loop")
    out = []
    with variant(name, cell):
        for seed in seeds:
            tr = gen.make(seed, cell)
            inputs = system.encode(tr)
            if system.step is None:
                system.prepare(inputs[0])
            answers, _ = loop.window(system, inputs, 0.0, 2 * len(inputs))
            got = judge.judge(seed, answers, tr, gen, cell.traffic["reference_checks"])
            rec = {"variant": name, "seed": seed, "correct": got["correct"],
                   **got["numbers"], "answers": got["answers"], "sampled": got["sampled"]}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    system.release()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_011)
    ap.add_argument("--variants", nargs="+", default=["program", *VARIANTS])
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import torch

    from benchmark.harness import spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    system = cell.part("system").System("cuda")
    results, seed = [], args.first_seed
    for name in args.variants:
        n = args.seeds if name == "program" else args.control_seeds
        t0 = time.perf_counter()
        results += readings(cell, list(range(seed, seed + 7919 * n, 7919)), name, system)
        seed += 7919 * n
        print(f"[{name}] {n} seeds in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": cell.name,
                                          "card": torch.cuda.get_device_name(0),
                                          "readings": results}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
