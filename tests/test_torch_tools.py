"""The port's phase tools (tools/*_torch.py) on the CPU: each through its
main(argv) at the smallest size with --device cpu, its JSON naming every
phase of the tool; without a card and without --device cpu, each refuses to
run. The slow phases of a CPU run (a whole pairing in plain PyTorch takes
seconds) are left out with --phases; the card runs them all."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import fexp_phases_torch  # noqa: E402
import phase_bench_torch  # noqa: E402
import rns_phase_bench_torch  # noqa: E402
import slope_bench_torch  # noqa: E402
import torch_tool_common  # noqa: E402

TOOLS = {
    "rns_phase_bench_torch": (rns_phase_bench_torch, [
        "--batch", "2", "--phases", "prepare_g2_stepmajor", "fp.inv", "easy_part"]),
    "fexp_phases_torch": (fexp_phases_torch, [
        "--batch", "2", "--phases", "kara_chain (kernel)", "cyclotomic_square",
        "tower.mul", "frobenius_map"]),
    "phase_bench_torch": (phase_bench_torch, [
        "--batch", "1", "--strategy", "fused", "auto", "--phases", "scale+stack",
        "miller_steps"]),
    "slope_bench_torch": (slope_bench_torch, ["--batch", "1"]),
}


def phase_argv(argv: list) -> list:
    """The phases an argv names (all where it names none)."""
    if "--phases" not in argv:
        return None
    i = argv.index("--phases") + 1
    return argv[i:]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers are the parallelism
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_the_cpu(name, tmp_path):
    mod, argv = TOOLS[name]
    out = tmp_path / "out.json"
    assert mod.main([*argv, "--device", "cpu", "--reps", "1", "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["tool"] == name and data["device"] == "cpu"
    assert data["card"].startswith("cpu: no card")
    ran = phase_argv(argv) or list(mod.PHASES)
    if name == "phase_bench_torch":
        assert [(r["strategy"], r["batch"]) for r in data["runs"]] == [("fused", 1),
                                                                      ("auto", 1)]
        tables = [r["phases"] for r in data["runs"]]
    elif name == "slope_bench_torch":
        assert data["phases"] == list(mod.PHASES)
        assert [r["op"] for r in data["runs"]] == list(mod.PHASES)
        for r in data["runs"]:
            assert r["cpu_ms"]["t40"] > 0 and "captured_ms" not in r
        return
    else:
        tables = [data["phases"]]
    for table in tables:
        assert list(table) == list(mod.PHASES)
        for phase, rec in table.items():
            if phase not in ran:
                assert rec is None
                continue
            # a CPU run names its time cpu_*: no device number, no capture
            assert not any(k in rec for k in ("eager_ms", "slope_ms", "captured_ms"))
            times = rec.get("cpu_ms") or rec["cpu_slope_ms"]
            assert times and rec["launches"] == {}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_refuses_to_run_without_a_card(name, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, argv = TOOLS[name]
    out = tmp_path / "out.json"
    assert mod.main([*argv, "--out", str(out)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_tools_write_no_record_of_the_repository(tmp_path):
    for record in ("PHASES_r06.json", "BENCH_r06.json", "XPROF_r06.json"):
        with pytest.raises(ValueError, match="records"):
            torch_tool_common.write(str(ROOT / record), {})
    torch_tool_common.write(str(tmp_path / "PHASES_r06.json"), {"x": 1})
    assert json.loads((tmp_path / "PHASES_r06.json").read_text()) == {"x": 1}


def test_unknown_phase_raises():
    with pytest.raises(ValueError, match="unknown phases"):
        torch_tool_common.selected(["pairing", "nope"], rns_phase_bench_torch.PHASES)
    assert torch_tool_common.selected(None, ("a", "b")) == ["a", "b"]
    assert torch_tool_common.selected(["b", "a"], ("a", "b")) == ["a", "b"]


def test_kernel_names_are_the_csrc_kernels():
    names = torch_tool_common.kernel_names()
    assert {"miller_fused_kernel", "mont_pow_kernel"} <= set(names)
    assert len(names) >= 12
