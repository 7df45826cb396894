"""The frozen yardstick (benchmark/work/model.py) equals the port's own
counts at this commit: pairing_rns.op_counts and fp.count_fp_ops of the line
steps and the sparse product, and the schedule's step counts."""

import pytest
import torch

from benchmark.work import model
from plonky2_bls12_381_pairing_torch.models import pairing_rns, schedule
from plonky2_bls12_381_pairing_torch.ops.rns import fp, tower
from plonky2_bls12_381_pairing_torch.ops.rns.lines import (G1Affine, G2Affine, G2Projective,
                                                           addition_step, doubling_step)


@pytest.mark.parametrize("batch", [512, 1024, 2048, 4096])
def test_pairing_counts_equal_the_ports_op_counts(batch):
    assert model.pairing_counts(batch) == pairing_rns.op_counts(batch)


def test_term_counts_equal_count_fp_ops_of_the_steps():
    rows = 2  # one packed row
    p = G1Affine.generator((rows,), device="cpu")
    q = G2Affine.generator((rows,), device="cpu")
    r = G2Projective.from_affine(q)
    f = tower.one((1,), "cpu")
    py, px = fp.wrap(p.y[..., None, :]), fp.wrap(p.x[..., None, :])
    sc2 = torch.zeros((1, 2, fp.LANES), dtype=torch.int32)

    def per(fn, *args):
        c = fp.count_fp_ops(fn, *args)
        return (c["fp_mul"] / rows, c["redc"] / rows)

    assert per(lambda rr: doubling_step(rr, scale=(py, px)), r) == model.DOUBLING_STEP
    assert per(lambda rr: addition_step(rr, q, scale=(py, px)), r) == model.ADDITION_STEP
    assert per(tower.mul_by_014, f, sc2, sc2, sc2) == model.SPARSE_PRODUCT


def test_steps_are_the_schedules():
    n_add = int(sum(schedule._IS_ADD))
    assert model.STEPS == (len(schedule._IS_ADD) - n_add, n_add, schedule.NUM_COEFFS)


def test_check_counts_add_a_term_per_further_pairing():
    assert model.term_counts() == {"fp_mul": 5268, "redc": 2498}
    two, three = model.check_counts(2048, 2), model.check_counts(2048, 3)
    assert {k: three[k] - two[k] for k in two} == model.term_counts()
    assert model.check_counts(2048, 1) == pairing_rns.op_counts(2048)


def test_least_time_at_the_h100s_peak():
    class Peak:
        int32_ops_per_s = 132 * 1.98e9 * 128
        u8_tc_ops_per_s = 132 * 1.98e9 * 8192

    # int32-bound: 0.1156 us a pairing and 0.0334 us a further term
    assert model.least_seconds(2048, 2, Peak) == pytest.approx(2048 * 0.1490e-6, rel=2e-3)
    assert model.least_seconds(1024, 132, Peak) == pytest.approx(4.605e-3, rel=1e-3)
