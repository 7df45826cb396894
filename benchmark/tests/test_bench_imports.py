"""No module of the benchmark imports JAX or the JAX package, by whole
top-level name; the plain reference and the comparison import nothing of the
program either; and the run's own look at sys.modules compares whole names."""

import ast
from pathlib import Path

import pytest

from benchmark.harness import guard

BENCH = Path(__file__).resolve().parents[1]
#: modules that must not import the program (plonky2_bls12_381_pairing_torch)
PLAIN = ("reference", "harness/judge.py", "generators", "harness/curve.py", "work")


def imports(path: Path) -> set[str]:
    """The top-level names of the absolute imports of a source file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


def test_sources_found():
    names = {p.relative_to(BENCH).as_posix() for p in SOURCES}
    assert {"run.py", "harness/runner.py", "reference/bls12_381.py",
            "metrics/checks_per_s.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax(path):
    assert not imports(path) & guard.FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.relative_to(BENCH).as_posix().startswith(PLAIN)],
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_plain_modules_import_nothing_of_the_program(path):
    assert "plonky2_bls12_381_pairing_torch" not in imports(path)
    assert not any(n.startswith("plonky2") for n in imports(path))


def test_relative_imports_stay_inside_the_benchmark():
    for path in SOURCES:
        depth = len(path.relative_to(BENCH).parts) - 1
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level <= depth + 1, path


def test_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    assert guard.top_level("jax.numpy") == "jax"
    for name in ("plonky2_bls12_381_pairing_torch_extra", "jaxfoo", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert guard.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "plonky2_bls12_381_pairing_tpu.ops",
                        types.ModuleType("plonky2_bls12_381_pairing_tpu.ops"))
    assert guard.forbidden_loaded() == ["plonky2_bls12_381_pairing_tpu"]
