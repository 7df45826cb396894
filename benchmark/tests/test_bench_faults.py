"""A whole run on the CPU, past the harness's look for a card, at B = 4: the
program as it is comes out correct, and the control and each fault that a
signature-check cell can have, planted underneath the timed path as the
chip's readings plant them (controls/readings.py VARIANTS), come out not
correct. One chip has no exchange between chips to leave out.

The control: the program's float32 plane products (ops/rns/fp.py _mm, the
base extensions of every REDC outside the kernels) rounded to bfloat16, the
precision below float32, which breaks the exact arithmetic the
configurations state. TF32 is no control: the plane products' inputs have 8
bits at most, which TF32 holds exactly (controls/readings.py reads it on the
card)."""

import time

import pytest

from benchmark.controls import readings
from benchmark.harness import runner, spec

SEED = 2**41 + 77


def cpu_cell(workload: str, terms: int | None = None):
    cell = spec.load(workload)
    cell.traffic = dict(cell.traffic, batch=4, distinct_batches=1, reference_checks=2)
    if terms is not None:
        cell.config = dict(cell.config, terms_per_check=terms)
    return cell


def run(cell):
    out, lines = runner.run(cell, SEED, 0.0, False, cell.part("system").System("cpu"),
                            time.perf_counter(), log=lambda msg: None)
    assert [k for k in out][-1] == "compared" and len(lines) == 2
    return out


@pytest.mark.parametrize("workload,terms", [("attest-2048x2", None), ("block-1024x132", 3)])
def test_the_program_comes_out_correct(workload, terms):
    out = run(cpu_cell(workload, terms))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 4
    assert all(v["value"] == 0 for v in out["compared"].values())


@pytest.mark.parametrize("fault", sorted(set(readings.VARIANTS) - {"tf32"}))
def test_a_fault_comes_out_not_correct(fault):
    cell = cpu_cell("attest-2048x2")
    with readings.variant(fault, cell):
        out = run(cell)
    assert not out["correct"]
    assert out["compared"]["wrong_verdicts"]["value"] > 0
