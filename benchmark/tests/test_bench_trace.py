"""The reduction of a profiler trace (harness/trace.py) on a made-up trace:
the stretch, the device's busy union, kernels, and idle gaps named by the
host span they fall in."""

from benchmark.harness import trace


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_reads_busy_kernels_and_gaps():
    ev = [X("bench.call", "user_annotation", 100, 100),
          X("bench.copy_in", "user_annotation", 100, 10),
          X("bench.launch", "user_annotation", 110, 5),
          X("bench.read_back", "user_annotation", 115, 85),
          X("bench.call", "user_annotation", 220, 80),
          X("bench.read_back", "user_annotation", 225, 75),
          X("Memcpy HtoD", "gpu_memcpy", 104, 6),          # inside copy_in
          X("k1", "kernel", 120, 30), X("k2", "kernel", 140, 20),  # overlap: union 120-160
          X("k1", "kernel", 170, 30),
          X("k1", "kernel", 230, 60),
          X("early", "kernel", 50, 60),                   # clipped to the stretch: 100-110
          X("cpu op", "cpu_op", 0, 1000)]
    s = trace.summarize(ev, calls=2)
    assert abs(s["window_s"] - 200e-6) < 1e-12
    # device busy: 100-110 (early and the copy), 120-160, 170-200, 230-290
    assert abs(s["busy_s"] - 140e-6) < 1e-12
    assert s["kernels"] == 5 and abs(s["kernel_s"] - 140e-6) < 1e-12
    gaps = dict(s["breakdown"]["idle_gaps"])
    # 110-115 launch; 115-120, 160-170 read_back; 200-220 between calls;
    # 220-225 call; 225-230, 290-300 read_back
    assert abs(gaps["bench.launch"] - 5e-6) < 1e-12
    assert abs(gaps["bench.read_back"] - 30e-6) < 1e-12
    assert abs(gaps["bench.between_calls"] - 20e-6) < 1e-12
    assert abs(gaps["bench.call"] - 5e-6) < 1e-12
    ops = dict(s["breakdown"]["device_ops"])
    assert abs(ops["k1"] - 120e-6) < 1e-12 and abs(ops["early"] - 10e-6) < 1e-12


def test_summarize_without_a_stretch_or_kernels_gives_nothing():
    assert trace.summarize([X("k1", "kernel", 0, 5)], calls=1) is None
    assert trace.summarize([X("bench.call", "user_annotation", 0, 5)], calls=1) is None
