"""The metrics that read the port's spans (harness/spans_loop.py), each fed a
made-up result of two calls through its file's measure: the phases' medians,
the exponentiations summed per call, the final exponentiation's kernel nodes
and the device's wait on the host, named by the host span open then."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spans_loop, spec

PHASES = [("pairing.prepare_g2", 10), ("pairing.miller_loop", 20),
          ("pairing.final_exp.easy", 30), ("pairing.final_exp.hard", 40),
          ("pairing.is_one", 5)]


def R(name, rid, parent=None, host=None, dev=None, kernels=None):
    return SimpleNamespace(name=name, id=rid, parent=parent,
                           host_start=host and host[0], host_end=host and host[1],
                           device_start=dev and dev[0], device_end=dev and dev[1],
                           kernel_nodes=kernels, other_nodes=kernels and 1)


def call(t0: int, stretch: int, read: int) -> SimpleNamespace:
    """A call at t0 (ns) whose pairing phases take `stretch` ns each, and
    whose end_call reads its events in `read` ns; its host spans and the
    device spans that hold its work (ns from t0): device busy 10-60, 70-80,
    100-880 + stretch, 890-950 (+ stretch)."""
    s = stretch
    recs = [R("bench.copy_in", 0, host=(0, 50), dev=(10, 60)),
            R("capture.check_args", 1, host=(50, 60)),
            R("capture.copy_in", 2, host=(60, 70), dev=(70, 80)),
            R("capture.launch", 3, host=(70, 100), dev=(80, 890 + s)),
            R("capture.graph", 4, parent=3, dev=(100, 880 + s), kernels=105)]
    t = 100
    for k, (name, kern) in enumerate(PHASES):
        recs.append(R(name, 5 + k, parent=4, dev=(t, t + s), kernels=kern))
        t += s
    recs += [R("pairing.final_exp.cyc_exp", 10 + k, parent=8,
               dev=(600, 600 + s // 10 * (k + 1)), kernels=1) for k in range(5)]
    recs += [R("capture.clone_out", 20, host=(100, 110), dev=(890 + s, 900 + s)),
             R("bench.read_back", 21, host=(110, 120), dev=(900 + s, 950 + s)),
             R("bench.wait", 22, host=(120, 990 + s))]
    for r in recs:
        for key in ("host_start", "host_end", "device_start", "device_end"):
            if getattr(r, key) is not None:
                setattr(r, key, getattr(r, key) + t0)
    return SimpleNamespace(start=t0, end=t0 + 1000 + s, records=recs, read_ns=read)


RESULT = {"calls": [call(0, 100, 30), call(1200, 300, 40)], "seconds": 1.0}
#: idle 270 ns of 2470 (host_wait_names_the_open_host_span)
SHARE = 100 * 270 / 2470


@pytest.fixture
def fed(monkeypatch):
    seen = []

    def result(run, system, args):
        seen.append((run, system, args))
        return RESULT

    monkeypatch.setattr(spans_loop, "result", result)
    return seen


@pytest.mark.parametrize("cell", ["attest-2048x2", "block-1024x132"])
def test_every_span_metric_reads_the_spans_result(fed, cell):
    c = spec.load(cell)
    names = {m["name"].removesuffix(".block") for m in c.per_layer
             if m["source"] in ("program_span", "program_counter")}
    want = {"pairing.lines_span_ms": 200e-6, "pairing.miller_span_ms": 200e-6,
            "pairing.easy_span_ms": 200e-6, "pairing.hard_span_ms": 200e-6,
            # five spans of 10, 20, ... 50 ns and of 30, 60, ... 150 ns
            "pairing.cyc_exp_span_ms": (150 + 450) / 2 * 1e-6,
            "pairing.final_exp_kernels": 70,
            "device.host_wait_share": None}
    assert names == set(want)
    for m in c.per_layer:
        base = m["name"].removesuffix(".block")
        if base not in want:
            continue
        got = spec.metric(c, m["name"]).measure("run", "system", "args")
        if base == "device.host_wait_share":
            assert got == pytest.approx(SHARE)
        else:
            assert got == pytest.approx(want[base], rel=1e-12), m["name"]
    assert set(fed) == {("run", "system", "args")}


def test_host_wait_names_the_open_host_span():
    share, idle = spans_loop.host_wait(RESULT)
    # per call: 0-10 in copy_in's host span, 60-70 in capture.copy_in's,
    # 80-100 in the launch, 880-890 and 950-990 (+ stretch) in the wait,
    # 990-1000 outside every host span; 100 ns between the calls, of which
    # the first end_call's 30 are left out, as from the loop's 2500
    assert idle == {"bench.copy_in": 20, "capture.copy_in": 20, "capture.launch": 40,
                    "bench.wait": 100, spans_loop.OTHER: 20, spans_loop.BETWEEN: 70}
    assert share == pytest.approx(SHARE)


def test_no_result_gives_no_metric(monkeypatch):
    monkeypatch.setattr(spans_loop, "port_spans", lambda: None)
    spans_loop._CACHE.clear()
    assert spans_loop.result("run", None, ()) is None
    assert spans_loop.median_ms(None, "pairing.prepare_g2") is None
    assert spans_loop.kernel_nodes(None, ("pairing.final_exp.easy",)) is None
    assert spans_loop.host_wait(None) is None
    spans_loop._CACHE.clear()
