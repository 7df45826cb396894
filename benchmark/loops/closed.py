"""The closed loop of one client: each call copies its batch in from pinned
host memory, launches the system once and reads the answers back, and the
next call starts when they are on the host. The calls cycle through the
traffic's distinct batches. A call's latency runs from the start of its
copy-in to its answers on the host. The window opens with the first call
and closes when the first call that ends after `seconds` has ended; no call
starts after `seconds`.
"""

from __future__ import annotations

import contextlib
import time

from benchmark.harness.trace import CALL, HOST_SPANS


def one_call(system, inputs: list, k: int, annotate: bool = False) -> tuple:
    """The k-th call: (batch index, answers); with annotate, the call and
    each of its steps inside a profiler annotation."""
    import torch

    def span(name):
        return torch.profiler.record_function(name) if annotate else contextlib.nullcontext()

    b = k % len(inputs)
    with span(CALL):
        with span(HOST_SPANS[0]):
            system.copy_in(inputs[b])
        with span(HOST_SPANS[1]):
            out = system.launch(inputs[b])
        with span(HOST_SPANS[2]):
            return b, system.read_back(out)


def window(system, inputs: list, seconds: float, calls: int = 0) -> tuple[list, list]:
    """Calls until `seconds` have passed (and at least `calls`, and one):
    the answers (batch index, answers) and each call's (start, end)."""
    answers, times = [], []
    end = time.perf_counter() + seconds
    while True:
        start = time.perf_counter()
        if times and start >= end and len(times) >= calls:
            break
        answers.append(one_call(system, inputs, len(times)))
        times.append((start, time.perf_counter()))
    return answers, times
