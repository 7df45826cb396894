"""The port's span recorder (utils/spans.py) on the CPU: nothing recorded and
one shared null context while it is off; nesting, parents and call ids; the
ring; the records of a captured graph's replays; pairing_check's phases as
spans, with the rows unchanged. On the card (marked gpu, skipped here): a
captured two-term pairing_check with spans on, its replay against the eager
rows, each device span inside the graph's, and the graph's kernel nodes with
spans on and off."""

import contextlib
import random

import pytest
import torch

from plonky2_bls12_381_pairing_torch.entry import entry
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_torch.utils import spans
from plonky2_bls12_381_pairing_torch.utils.capture import Captured, capture

torch.set_num_threads(1)

PHASES = ("pairing.prepare_g2", "pairing.miller_loop", "pairing.final_exp.easy",
          "pairing.final_exp.hard", "pairing.is_one")


def test_off_records_nothing():
    a, b = spans.span("a"), spans.span("b", "cpu")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    assert spans.begin_call() is None and spans.end_call() is None
    assert spans.take_captured() == ()
    with spans.recording() as rec:
        pass
    assert spans.span("c") is a and len(rec.records) == 0


def test_nesting_parents_and_calls():
    with spans.recording() as rec:
        first = spans.begin_call()
        with spans.span("outer", "cpu") as outer:
            with spans.span("inner", "cpu") as inner:
                pass
        with spans.span("second", "cpu"):
            pass
        call1 = spans.end_call()
        spans.begin_call()
        with spans.span("outer", "cpu") as outer2:
            with spans.span("inner", "cpu") as inner2:
                pass
        call2 = spans.end_call()
        with spans.span("loose", "cpu") as loose:
            pass
        with pytest.raises(RuntimeError):
            spans.end_call()
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert [r.name for r in rec.records] == ["outer", "inner", "second", "outer", "inner",
                                              "loose"]
    assert call1.id == first and [r.name for r in call1.records] == ["outer", "inner",
                                                                     "second"]
    assert [r.name for r in call2.records] == ["outer", "inner"]
    assert {r.call for r in call1.records} == {call1.id}
    assert {r.call for r in call2.records} == {call2.id} != {call1.id}
    assert loose.call not in (call1.id, call2.id) and loose.parent is None
    assert inner.parent == outer.id and outer.parent is None
    assert inner2.parent == outer2.id and call1.records[2].parent is None
    for r in call1.records + call2.records:
        assert r.device_start is None and r.kernel_nodes is None  # host times only
    assert call1.start <= outer.host_start <= inner.host_start <= inner.host_end
    assert inner.host_end <= outer.host_end <= call1.records[2].host_start <= call1.end
    assert call1.end <= call2.start


def test_ring_drops_the_oldest():
    with spans.recording(capacity=3) as rec:
        for k in range(5):
            with spans.span(f"s{k}", "cpu"):
                pass
    assert [r.name for r in rec.records] == ["s2", "s3", "s4"]


def test_replays_of_captured_spans():
    """Each replay adds a record of every captured span, under the span open
    at the replay, with the capture's counters; a second replay in one call
    leaves the first's records without device times."""
    graph = spans.Record("capture.graph", 100, None, 0, kernel_nodes=7, other_nodes=2,
                         events=(object(), object()))
    phase = spans.Record("pairing.is_one", 101, 100, 0, kernel_nodes=3, other_nodes=0,
                         events=(object(), object()))
    captured = (graph, phase)
    with spans.recording() as rec:
        spans.begin_call()
        with spans.span("capture.launch", "cpu") as launch:
            spans.replayed(captured)
        first = list(rec.records)[1:]
        assert [r.events for r in first] == [graph.events, phase.events]
        spans.replayed(captured)
        assert [r.events for r in first] == [None, None]
        call = spans.end_call()
    names = [(r.name, r.kernel_nodes, r.other_nodes) for r in call.records]
    assert names == [("capture.launch", None, None), ("capture.graph", 7, 2),
                     ("pairing.is_one", 3, 0), ("capture.graph", 7, 2),
                     ("pairing.is_one", 3, 0)]
    g1, p1, g2, p2 = call.records[1:]
    assert g1.parent == launch.id and p1.parent == g1.id
    assert g2.parent is None and p2.parent == g2.id
    assert g1.host_start is None and g1.device_start is None
    assert graph.events is not None  # the capture keeps its events


def test_pairing_check_records_its_phases():
    _, (p, q) = entry(device="cpu")
    ps, qs = [p, p], [q, q]
    off = mpr.pairing_check(ps, qs)
    with spans.recording() as rec:
        on = mpr.pairing_check(ps, qs)
    assert torch.equal(on, off)
    recs = list(rec.records)
    names = [r.name for r in recs]
    for name in PHASES:
        assert names.count(name) == 1, name
    hard = recs[names.index("pairing.final_exp.hard")]
    cyc = [r for r in recs if r.name == "pairing.final_exp.cyc_exp"]
    assert len(cyc) == 5 and all(r.parent == hard.id for r in cyc)
    assert len(recs) == len(PHASES) + 5
    assert len({r.call for r in recs}) == 5  # each phase's own call: no call was opened
    assert [r.name for r in recs if r.parent is None] == list(PHASES)
    for r in recs:
        assert r.host_start <= r.host_end and r.device_start is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: spans record device events only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_captured_spans_on_the_card(cuda):
    r = random.Random(0x5A)
    pts = [rm.G1Affine.generator().mul(r.randrange(1, rm.R)) for _ in range(8)]
    qts = [rm.G2Affine.generator().mul(r.randrange(1, rm.R)) for _ in range(8)]
    ps = [G1Affine.encode(pts, device=cuda), G1Affine.encode([x.neg() for x in pts],
                                                             device=cuda)]
    qs = [G2Affine.encode(qts, device=cuda)] * 2
    eager = mpr.pairing_check(ps, qs)
    assert bool(eager.all())
    calls = []
    with spans.recording():
        step = capture(mpr.pairing_check, ps, qs)
        for _ in range(2):
            spans.begin_call(cuda)
            got = step(ps, qs).cpu()
            calls.append(spans.end_call())
            assert torch.equal(got, eager.cpu())
    counted = {}

    @contextlib.contextmanager
    def count_nodes():
        yield
        counted["off"] = spans.capture_nodes(cuda)

    plain = Captured(mpr.pairing_check, (ps, qs), {}, during_capture=count_nodes())
    assert plain.spans == () and torch.equal(plain(ps, qs), eager)
    for call in calls:
        recs = call.records
        assert [r.name for r in recs if r.parent is None] == [
            "capture.check_args", "capture.copy_in", "capture.launch", "capture.clone_out"]
        graph = next(r for r in recs if r.name == "capture.graph")
        replay = [r for r in recs if r.host_start is None]
        assert graph in replay and len(replay) == 1 + len(PHASES) + 5
        for r in replay:
            assert graph.device_start <= r.device_start <= r.device_end <= graph.device_end
        for r in recs:
            if r.name != "capture.check_args":
                assert call.start <= r.device_start <= r.device_end <= call.end
        phases = [r for r in replay if r.parent == graph.id]
        assert [r.name for r in phases] == list(PHASES)
        # every kernel of pairing_check lies in one of its phases
        assert sum(r.kernel_nodes for r in phases) == graph.kernel_nodes > 0
        assert counted["off"] == (graph.kernel_nodes, graph.other_nodes)
    assert calls[0].records[1].device_start != calls[1].records[1].device_start
