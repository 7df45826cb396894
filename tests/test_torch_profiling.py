"""The port's utils/profiling.py on the CPU: op-count reports against the JAX
package's, the RNS operation model and roofline at a given peak, and the
trace; the card's peak refuses the CPU. On the card (marked gpu, skipped
here): the card's peak from its SM count and clock, one call's device
profile."""

import json

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.ops.rns import tower
from plonky2_bls12_381_pairing_torch.utils import profiling
from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw
from plonky2_bls12_381_pairing_tpu.utils import profiling as jprofiling

torch.set_num_threads(1)

#: an H100 SXM's 132 SMs at its 1.98 GHz maximum SM clock
PEAK = profiling.Peak(132, 1.98e9, 128 * 132 * 1.98e9, 8192 * 132 * 1.98e9)


@pytest.mark.parametrize("op", ["mul", "cyclotomic_square"])
def test_rns_op_report_matches_jax(op):
    a = np.zeros((2, 12, RC.LANES), dtype=np.int32)  # 2 rows = 4 elements
    args = (a, a) if op == "mul" else (a,)
    got = profiling.rns_op_report(getattr(tower, op), *map(torch.from_numpy, args))
    assert got == jprofiling.rns_op_report(getattr(jtw, op), *args)
    if op == "mul":  # 18 Fq2 products of 3 Fp products and one 12-row REDC
        assert got == {"fp_mul": 54 * 4, "redc": 12 * 4}


def test_rns_roofline_prices_the_operation_model():
    counts = mpr.op_counts()
    out = profiling.rns_roofline(90_000.0, counts, PEAK)
    w = profiling.lane_work(counts["fp_mul"]) + profiling.REDC_ROW * counts["redc"]
    assert (out["int_ops_per_pairing"], out["ext_macs_per_pairing"]) == (w.int_ops, w.ext_macs)
    t_int = w.int_ops / PEAK.int32_ops_per_s
    t_tc = 6 * w.ext_macs / PEAK.u8_tc_ops_per_s
    assert out["bound_s_per_pairing"] == max(t_int, t_tc)
    assert out["bound_fraction"] == pytest.approx(90_000.0 * max(t_int, t_tc), rel=1e-12)
    assert out["int32_only_fraction"] > out["bound_fraction"]  # the extensions cost more


def test_trace_writes_a_chrome_trace(tmp_path):
    f = tower.one((1,), "cpu")
    with profiling.trace(str(tmp_path / "trace")):
        tower.mul(f, f)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_card_measurements_refuse_the_cpu():
    with pytest.raises(ValueError):
        profiling.card_peak("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these measure the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_measurements(cuda):
    peak = profiling.card_peak(cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert peak.sms == props.multi_processor_count and peak.clock_hz > 1e9
    f = tower.one((1024,), cuda)
    prof = profiling.device_profile(lambda: tower.mul(f, f), host_ops=False)
    assert prof["device_ms"] > 0 and prof["kernel_launches"] >= 1
