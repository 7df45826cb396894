"""The traffic generator (generators/signature_checks.py): the same seed gives
the same batches, large seeds work, the checks built valid hold and those
built invalid fail under the plain reference, and the port receives the very
points the reference judges. Cells, configurations, traffic mixes, the parts
a mix names and metrics are found by name (harness/spec.py)."""

import json
import shutil

import numpy as np
import pytest

from benchmark.harness import spec
from benchmark.reference import bls12_381 as ref

SEED = 2**40 + 12345  # beyond 32 bits, as the driver's are
CELL = spec.load("attest-2048x2")
traffic = CELL.part("generator")


def same(a, b):
    return all(np.array_equal(x.keys, y.keys) and np.array_equal(x.msgs, y.msgs)
               and x.sigma == y.sigma and np.array_equal(x.valid, y.valid)
               for x, y in zip(a.batches, b.batches)) and a.keys == b.keys and a.msgs == b.msgs


def test_same_seed_same_batches():
    a = traffic.generate(SEED, 3, 8, 64, 2)
    assert same(a, traffic.generate(SEED, 3, 8, 64, 2))
    assert not same(a, traffic.generate(SEED + 1, 3, 8, 64, 2))
    assert not np.array_equal(a.batches[0].keys, a.batches[1].keys)


@pytest.mark.parametrize("terms", [2, 3])
def test_valid_checks_hold_and_invalid_ones_fail(terms):
    tr = traffic.generate(SEED + terms, terms, 4, 64, 2)
    for b, batch in enumerate(tr.batches):
        assert (~batch.valid).sum() == 1  # ceil(4 / 64)
        for c in range(4):
            assert traffic.reference(tr, b, c) == batch.valid[c]


def test_invalid_share_and_distinct_checks():
    tr = traffic.generate(SEED, 2, 256, 64, 1)
    b = tr.batches[0]
    assert (~b.valid).sum() == 4
    assert len(set(b.sigma)) == 256
    on_curve = [ref.G2Affine(ref.Fq2(*s[0]), ref.Fq2(*s[1])).is_on_curve() for s in b.sigma[:8]]
    assert all(on_curve)


@pytest.mark.parametrize("terms", [2, 3])
def test_port_receives_the_points_the_reference_judges(terms):
    """system.encode's rows equal the port's own G1Affine/G2Affine.encode of
    the same points, term by term."""
    from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
    from plonky2_bls12_381_pairing_torch.utils import refmodel as rm

    tr = traffic.generate(SEED, terms, 4, 64, 2)
    enc = CELL.part("system").System("cpu").encode(tr)
    for b in range(2):
        px, py, pinf, qx, qy, qinf = enc[b]
        for t in range(terms):
            pts = [tr.terms_of(b, c)[t] for c in range(4)]
            g1 = G1Affine.encode([rm.G1Affine(*p) for p, _ in pts], device="cpu")
            g2 = G2Affine.encode([rm.G2Affine(rm.Fq2(*q[0]), rm.Fq2(*q[1])) for _, q in pts],
                                 device="cpu")
            for got, want in ((px[t], g1.x), (py[t], g1.y), (pinf[t], g1.infinity),
                              (qx[t], g2.x), (qy[t], g2.y), (qinf[t], g2.infinity)):
                assert np.array_equal(got.numpy(), want.numpy())


def test_cells_are_found_by_name():
    for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]:
        cell = spec.load(w["name"])
        assert cell.config["terms_per_check"] >= 2 and cell.traffic["batch"] % 2 == 0
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer + cell.end_to_end:
            mod = spec.metric(cell, m["name"])
            assert callable(getattr(mod, "read", None) or mod.measure)
        assert {cell.part(k).__name__ for k in spec.PARTS} == {
            "bench_generator_signature_checks", "bench_system_pairing_check", "bench_loop_closed"}


def test_new_cell_and_metric_are_files_and_entries(tmp_path):
    """A cell, a configuration, a traffic mix with a generator, a system and
    a loop of its own, and per-layer metrics (one read, one measured on the
    card, one read by the file of its base name) added as new files and
    entries are found by name; no existing file is edited."""
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    (bench_dir / "configs" / "drand_tlock.json").write_text(json.dumps({"pairings": 1}))
    (bench_dir / "traffic" / "tlock_2048.json").write_text(json.dumps(
        {"generator": "gt_values", "system": "pairing_gt", "loop": "open_bursts",
         "batch": 2048, "reference_checks": 3, "trace_warmup": 1, "trace_calls": 3}))
    (bench_dir / "generators" / "gt_values.py").write_text(
        "from dataclasses import dataclass\n\n\n@dataclass\nclass T:\n    n: int\n\n\n"
        "def make(seed, cell):\n    return T(cell.traffic['batch'])\n")
    (bench_dir / "systems" / "pairing_gt.py").write_text("class System:\n    pass\n")
    (bench_dir / "loops" / "open_bursts.py").write_text("def window(*a):\n    return [], []\n")
    metrics = bench_dir / "metrics"
    (metrics / "pairing.easy_part_ms.py").write_text("def read(run):\n    return 1.5\n")
    (metrics / "pairing.hard_part_ms.py").write_text(
        "def measure(run, system, args):\n    return 2.5\n")
    bench["configs"].append({"name": "drand_tlock", "source": "https://example.org",
                             "file": "benchmark/configs/drand_tlock.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tlock-2048", "config": "drand_tlock",
                               "traffic": "tlock_2048", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "blocks_per_s.tlock", "unit": "1/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["tlock-2048"]})
    for name in ("pairing.easy_part_ms", "pairing.hard_part_ms", "pairing.miller_ms.tlock"):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "device_trace", "layer": "pairing",
                                   "moves": "blocks_per_s.tlock", "workloads": ["tlock-2048"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("tlock-2048", root=tmp_path)
    assert cell.config == {"pairings": 1} and cell.traffic["batch"] == 2048
    assert cell.part("generator").make(1, cell).n == 2048
    assert cell.part("system").System.__name__ == "System"
    assert cell.part("loop").window() == ([], [])
    assert [m["name"] for m in cell.per_layer] == ["pairing.easy_part_ms",
                                                   "pairing.hard_part_ms",
                                                   "pairing.miller_ms.tlock"]
    assert spec.metric(cell, "pairing.easy_part_ms").read(None) == 1.5
    assert spec.metric(cell, "pairing.hard_part_ms").measure(None, None, None) == 2.5
    assert spec.metric(cell, "pairing.miller_ms.tlock").__file__.endswith("pairing.miller_ms.py")
    assert spec.metric(cell, "blocks_per_s.tlock").__file__.endswith("blocks_per_s.py")
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "blocks_per_s.tlock"]
    old = spec.load("attest-2048x2", root=tmp_path)
    assert not {"pairing.easy_part_ms", "blocks_per_s.tlock"} & {
        m["name"] for m in old.per_layer + old.end_to_end}
    assert all(p.read_bytes() == data for p, data in before.items())
