"""The Electra cells' parts: the electra_blocks generator's verdicts against
the plain reference (reference/aggregate.py, Python integers) at a tiny
registry, the same seed giving the same traffic; the aggregate_check system's
inputs equal to the port's own encodings and its eager verdicts those the
blocks were built to give; work/aggregate.py's frozen counts equal to the
port's; the cells, their parts and their metrics found by name; and the new
metrics' readers on made-up traces and spans."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import bls12_381 as ref
from benchmark.work import aggregate as work
from benchmark.work import model

SEED = 2**40 + 4321  # beyond 32 bits, as the driver's are
CELL = spec.load("electra-agg-64x12")
gen = CELL.part("generator")
#: a tiny deployment of the same shape: 512 validators (16 a slot), 2
#: attestations a block, a sync committee of 16, one epoch of blocks
TINY = {**CELL.config, "validators": 512, "attestations_per_block": 2,
        "sync_committee_size": 16}


@pytest.fixture(scope="module")
def tiny():
    return gen.generate(SEED, TINY, 32, 0.9, 8, 2)


def test_registry_keys_are_the_logs_multiples():
    xs, ys = gen.registry(40, 11, 7)
    for i in (0, 1, 5, 6, 7, 39):
        want = ref.G1Affine.generator().mul(11 + 7 * i)
        assert (xs[i], ys[i]) == (want.x, want.y)


def test_same_seed_same_traffic(tiny):
    other = gen.generate(SEED, TINY, 32, 0.9, 8, 2)
    assert other.keys_x == tiny.keys_x and np.array_equal(other.shuffling, tiny.shuffling)
    for a, b in zip(other.batches, tiny.batches):
        assert np.array_equal(a.att_bits, b.att_bits) and a.sigma == b.sigma
        assert np.array_equal(a.valid, b.valid)
    assert not np.array_equal(tiny.batches[0].att_bits, tiny.batches[1].att_bits)


def test_verdicts_match_the_reference(tiny):
    """Every block built invalid (4 a batch: a flipped bit or sigma off) and
    three valid ones of each batch."""
    for i, b in enumerate(tiny.batches):
        assert (~b.valid).sum() == 4
        picks = list(gen.notable(tiny, i)) + list(np.flatnonzero(b.valid)[:3])
        for c in picks:
            assert gen.reference(tiny, i, int(c)) == bool(b.valid[c])


def test_the_system_gets_the_ports_encodings_and_verdicts(tiny):
    """The system's rows equal the port's Registry and G2Affine encodings of
    the same keys and points, and its eager (plain) call on the CPU gives
    the verdicts the blocks were built to give."""
    from plonky2_bls12_381_pairing_torch.ops.rns import fp
    from plonky2_bls12_381_pairing_torch.ops.rns.lines import G2Affine
    from plonky2_bls12_381_pairing_torch.utils import refmodel as rm

    system = CELL.part("system").System("cpu")
    enc = system.encode(tiny)
    system.prepare(enc[0])
    reg = system.registry
    assert reg.slot_size == 16 and reg.epochs == 1
    assert torch.equal(reg.keys[:3, 0], torch.from_numpy(fp.encode(tiny.keys_x[:3]))
                       .reshape(-1, fp.RC.SUB)[:3])
    b = tiny.batches[0]
    qx = enc[0][4]
    pts = [tiny.msgs[j] for j in b.msgs[:, 1]]
    g2 = G2Affine.encode([rm.G2Affine(rm.Fq2(*q[0]), rm.Fq2(*q[1])) for q in pts], device="cpu")
    assert torch.equal(qx[1], g2.x)
    assert np.array_equal(system(enc[0]), b.valid)


def test_frozen_counts_equal_the_ports():
    from plonky2_bls12_381_pairing_torch.ops.rns import fp, g1

    p = g1.G1Projective.identity((2,), "cpu")
    madd = fp.count_fp_ops(lambda a: g1.madd(a, a.x, a.y), p)
    add = fp.count_fp_ops(lambda a: g1.add(a, a), p)
    assert (madd["fp_mul"] / 2, madd["redc"] / 2) == work.MADD
    assert (add["fp_mul"] / 2, add["redc"] / 2) == work.ADD


def test_least_time_of_the_cell():
    """15.5 M additions of 3,213 int32 operations a call, int32-bound on an
    H100 at 1,980 MHz: about 1.5 ms."""
    class Peak:
        int32_ops_per_s = 132 * 1.98e9 * 128
        u8_tc_ops_per_s = 132 * 1.98e9 * 8192

    assert work.additions(CELL) == pytest.approx(64 * (0.97 * (8 * 31250 + 512) + 2))
    assert model.work({"fp_mul": 11, "redc": 8}).int_ops == 3213
    assert work.least_seconds(CELL, Peak) == pytest.approx(
        work.additions(CELL) * 3213 / Peak.int32_ops_per_s)
    assert 1.4e-3 < work.least_seconds(CELL, Peak) < 1.6e-3
    assert work.input_bytes(CELL) / work.HBM_BYTES_PER_S < 2e-4


def test_cells_and_metrics_are_found_by_name():
    for name, parts in (("electra-agg-64x12", ("electra_blocks", "aggregate_check")),
                        ("block-1024x12", ("signature_checks", "pairing_check"))):
        cell = spec.load(name)
        assert cell.config["terms_per_check"] == 12
        assert (cell.traffic["generator"], cell.traffic["system"]) == parts
        assert {m["name"] for m in cell.end_to_end} == {"setup_s", "blocks_per_s"}
        for m in cell.per_layer:
            mod = spec.metric(cell, m["name"])
            assert callable(getattr(mod, "read", None) or mod.measure)
    spans = ("pairing.lines_span_ms", "pairing.miller_span_ms", "pairing.easy_span_ms",
             "pairing.hard_span_ms", "pairing.cyc_exp_span_ms", "pairing.final_exp_kernels",
             "device.host_wait_share", "capture.kernels_per_call", "kernels.check_roofline")
    agg = {m["name"] for m in spec.load("electra-agg-64x12").per_layer}
    assert agg == {"aggregate.keys_span_ms", "aggregate.kernels", "kernels.aggregate_roofline",
                   *(f"{s}.agg" for s in spans)}
    e12 = {m["name"] for m in spec.load("block-1024x12").per_layer}
    assert e12 == {f"{s}.e12" for s in spans}


def test_roofline_reads_the_kernels_device_time():
    cell = copy.copy(CELL)
    run = SimpleNamespace(cell=cell, peak=SimpleNamespace(
        int32_ops_per_s=132 * 1.98e9 * 128, u8_tc_ops_per_s=132 * 1.98e9 * 8192),
        trace={"calls": 10, "breakdown": {"device_ops": [
            ["(anonymous namespace)::g1_sum_kernel(int const*, ...)", 0.3],
            ["(anonymous namespace)::g1_combine_kernel(int const*, ...)", 0.01]]}})
    read = spec.metric(cell, "kernels.aggregate_roofline").read
    assert read(run) == pytest.approx(100 * work.least_seconds(cell, run.peak) / 0.03)
    run.trace["breakdown"]["device_ops"] = [["miller_run_kernel", 1.0]]
    assert read(run) is None


def test_span_metrics_read_the_aggregation_spans(monkeypatch):
    from benchmark.harness import spans_loop

    def rec(name, rid, dev, kernels):
        return SimpleNamespace(name=name, id=rid, parent=None, host_start=None, host_end=None,
                               device_start=dev[0], device_end=dev[1], kernel_nodes=kernels,
                               other_nodes=0)

    calls = [SimpleNamespace(records=[rec("aggregate.keys", 0, (0, 80_000_000 + k), 5),
                                      rec("aggregate.to_affine", 1, (0, 1_000_000), 12)])
             for k in range(3)]
    monkeypatch.setattr(spans_loop, "result", lambda *a: {"calls": calls, "seconds": 1.0})
    keys = spec.metric(CELL, "aggregate.keys_span_ms").measure(None, None, None)
    assert keys == pytest.approx(80.000001)
    assert spec.metric(CELL, "aggregate.kernels").measure(None, None, None) == 17
    monkeypatch.setattr(spans_loop, "result", lambda *a: None)
    assert spec.metric(CELL, "aggregate.keys_span_ms").measure(None, None, None) is None
