"""What a cell is made of, found by name: its entry in BENCHMARK.json, the
configuration file that entry names, the traffic mix
benchmark/traffic/<traffic>.json, the parts that mix names, and the metrics
the cell reports. A new cell, configuration, traffic mix, part or metric is
new files and entries; no file here changes for it.

A traffic mix names three parts, each a file loaded by name:

  "generator"  benchmark/generators/<name>.py: make(seed, cell), the inputs
               and the answers they must give; expected(traffic, batch),
               notable(traffic, batch) and reference(traffic, batch, item)
               for the judge (harness/judge.py);
  "system"     benchmark/systems/<name>.py: System(device), the entry point
               under test (encode, prepare, copy_in, launch, read_back,
               release, on_device);
  "loop"       benchmark/loops/<name>.py: window(system, inputs, seconds),
               the timed calls, and one_call(system, inputs, k, annotate).

A metric <name> is read by benchmark/metrics/<name>.py, or where that file
is not there, by the file of the name less its last dotted parts
(pairing.miller_ms.block by pairing.miller_ms.py). The file has read(run),
or measure(run, system, args), which a --trace 1 run calls on the card once
the window and the trace are over, with the first batch on the device.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

#: the checkout's root, which holds BENCHMARK.json and benchmark/
ROOT = Path(__file__).resolve().parents[2]
#: a traffic mix's key for each part, and the folder the part's file is in
PARTS = {"generator": "generators", "system": "systems", "loop": "loops"}

_LOADED: dict = {}


def load_file(path: Path, name: str):
    """The module of a source file, loaded once per path."""
    key = str(path.resolve())
    if key not in _LOADED:
        mod_spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(mod_spec)
        sys.modules[name] = mod  # dataclasses look their module up there
        mod_spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path

    def part(self, kind: str):
        """The module of the traffic mix's generator, system or loop."""
        name = self.traffic[kind]
        return load_file(self.root / "benchmark" / PARTS[kind] / f"{name}.py",
                         f"bench_{kind}_{name}")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with a workloads list is reported in those cells; without
    one, an end-to-end metric in every cell and a per-layer one in every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload` of root/BENCHMARK.json, with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in spec['workloads']]}")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, int(entry["chips"]),
                json.loads((root / config["file"]).read_text()),
                json.loads((root / "benchmark" / "traffic" / f"{entry['traffic']}.json")
                           .read_text()),
                e2e, per_layer, root)


def metric(cell: Cell, name: str):
    """The module that reads the metric `name` (module docstring)."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        base = ".".join(parts[:k])
        path = cell.root / "benchmark" / "metrics" / f"{base}.py"
        if path.is_file():
            return load_file(path, "bench_metric_" + base.replace(".", "_"))
    raise FileNotFoundError(f"no benchmark/metrics/ file reads {name}")
