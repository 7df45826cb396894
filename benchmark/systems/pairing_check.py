"""The system under test: the PyTorch port's pairing_check, captured whole
into one CUDA graph (the port's utils/capture.py, its counterpart of
jax.jit), so that a call is a copy-in, one replay and the verdicts read back.

It hands the port the traffic's points (generators/signature_checks.py) in
the port's own input format (packed RNS rows of ops/rns/fp.py encode) and
gives back per-check verdicts; on the CPU it calls the port eagerly (its
plain formulas), which the tests use. Besides the plain reference and the
judge, the metric readers that time a phase of the port alone
(benchmark/metrics/pairing.*) do so through captured_ms here.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns
from plonky2_bls12_381_pairing_torch.ops.rns import fp
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.utils.capture import capture

PACK, SUB, LANES = RC.PACK, RC.SUB, RC.LANES


def check(px, py, pinf, qx, qy, qinf) -> torch.Tensor:
    """pairing_check over T terms given as stacked tensors, term axis first:
    px, py, pinf (T, rows, LANES); qx, qy (T, rows, 2, LANES); qinf (T, rows,
    LANES). Returns (rows, PACK) verdicts."""
    ps = [G1Affine(px[t], py[t], pinf[t]) for t in range(px.shape[0])]
    qs = [G2Affine(qx[t], qy[t], qinf[t]) for t in range(qx.shape[0])]
    return pairing_rns.pairing_check(ps, qs)


def miller_phase(px, py, pinf, qx, qy, qinf) -> torch.Tensor:
    """The line preparation and the Miller loop of check() alone, as
    multi_pairing runs them: one prepare_g2_stepmajor over the T stacked G2
    points, one miller_loop over the terms' views of its output."""
    prepared = pairing_rns.prepare_g2_stepmajor(G2Affine(qx, qy, qinf))
    ps = [G1Affine(px[t], py[t], pinf[t]) for t in range(px.shape[0])]
    return pairing_rns.miller_loop(ps, list(prepared.unbind(1)), list(qinf.unbind(0)))


def _slots(values: list) -> np.ndarray:
    """Each value's encoded slot, (n, SUB): fp.encode packs two elements to a
    row, element 2r in lanes [0, SUB) of row r and 2r + 1 in [SUB, LANES)."""
    rows = fp.encode(values)
    return rows.reshape(-1, SUB)[: len(values)]


def _g2_rows(c0: np.ndarray, c1: np.ndarray) -> np.ndarray:
    """(..., B, SUB) slots of an Fq2 coordinate's two components -> packed
    rows (..., B / PACK, 2, LANES), as G2Affine.encode lays them out."""
    both = np.stack([c0, c1], axis=-2)                  # (..., B, 2, SUB)
    lead, b = both.shape[:-3], both.shape[-3]
    both = both.reshape(*lead, b // PACK, PACK, 2, SUB)
    return np.swapaxes(both, -3, -2).reshape(*lead, b // PACK, 2, LANES)


class System:
    """The port's pairing_check on one device ("cuda" on the card, "cpu" for
    the tests)."""

    miller_phase = staticmethod(miller_phase)

    def __init__(self, device: str = "cuda"):
        self.device = fp.resolve_device(device)
        self.step = None
        self.staging = None

    def encode(self, traffic) -> list[tuple]:
        """Each batch of the traffic as the six input tensors of check(), on
        the host (pinned on the card's host). The pools are encoded once and
        each batch gathered from them."""
        b0 = traffic.batches[0]
        batch = b0.valid.shape[0]
        if batch % PACK:
            raise ValueError(f"a batch packs {PACK} checks to a row; got {batch}")
        rows, n = batch // PACK, traffic.terms - 1
        kx, ky = _slots([p[0] for p in traffic.keys]), _slots([p[1] for p in traffic.keys])
        m = [_slots([q[i][j] for q in traffic.msgs]) for i in range(2) for j in range(2)]
        neg = [np.tile(_slots([c])[0], PACK) for c in traffic.neg_g1]
        out = []
        for b in traffic.batches:
            s = [_slots([q[i][j] for q in b.sigma]) for i in range(2) for j in range(2)]
            px = np.empty((n + 1, rows, LANES), np.int32)
            py = np.empty_like(px)
            px[:n] = kx[b.keys].reshape(n, rows, LANES)
            py[:n] = ky[b.keys].reshape(n, rows, LANES)
            px[n], py[n] = neg
            qx = np.empty((n + 1, rows, 2, LANES), np.int32)
            qy = np.empty_like(qx)
            qx[:n] = _g2_rows(m[0][b.msgs], m[1][b.msgs])
            qy[:n] = _g2_rows(m[2][b.msgs], m[3][b.msgs])
            qx[n], qy[n] = _g2_rows(s[0], s[1]), _g2_rows(s[2], s[3])
            inf = np.zeros((n + 1, rows, LANES), np.int32)
            out.append(tuple(self._host(a) for a in (px, py, inf, qx, qy, inf)))
        return out

    def _host(self, arr: np.ndarray) -> torch.Tensor:
        pinned = self.device.type == "cuda"
        t = torch.empty(arr.shape, dtype=torch.int32, pin_memory=pinned)
        t.numpy()[...] = arr
        return t

    def prepare(self, example: tuple) -> None:
        """On the card: device buffers that each call copies its batch into,
        and check() captured on the example (a warm-up call, then the
        capture)."""
        if self.device.type != "cuda":
            return
        self.staging = [h.to(self.device) for h in example]
        self.step = capture(check, *self.staging)

    def copy_in(self, inputs: tuple) -> None:
        if self.staging is not None:
            for s, h in zip(self.staging, inputs):
                s.copy_(h, non_blocking=True)

    def launch(self, inputs: tuple) -> torch.Tensor:
        """The call's verdicts, still on the device: one replay on the card,
        an eager call on the CPU."""
        if self.step is None:
            return check(*inputs)
        return self.step(*self.staging)

    @staticmethod
    def read_back(verdicts: torch.Tensor) -> np.ndarray:
        """(B,) bools on the host, in check order."""
        return verdicts.cpu().numpy().reshape(-1)

    def __call__(self, inputs: tuple) -> np.ndarray:
        self.copy_in(inputs)
        return self.read_back(self.launch(inputs))

    def release(self) -> None:
        """Free the capture and its buffers."""
        self.step = self.staging = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def on_device(self, inputs: tuple) -> tuple:
        """A batch's input tensors copied to the device."""
        return tuple(h.to(self.device) for h in inputs)

    @staticmethod
    def captured_ms(fn, *args, reps: int = 5) -> float:
        """fn(*args) captured alone (utils/capture.py) and replayed `reps`
        times between CUDA events after one replay: the median ms of a
        replay. The capture is freed on return."""
        step = capture(fn, *args)
        step.graph.replay()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step.graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)
