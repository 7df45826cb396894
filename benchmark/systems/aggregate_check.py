"""The system under test: the PyTorch port's aggregate_check (models/
aggregate.py), Electra blocks checked from the validator registry, captured
whole into one CUDA graph (utils/capture.py), so that a call is a copy-in of
the blocks' bits, offsets and G2 points, one replay and the verdicts read
back.

The registry (the keys as packed RNS slots, fp.encode_slots), the epochs'
shuffled lists and the sync committee are uploaded once, at set-up, and
outlive release(): the capture takes them as a fixed argument, which it does
not copy, and a capture made again (the span loop's) reads the same ones. On
the CPU it calls the port eagerly (its plain formulas), which the tests use.
"""

from __future__ import annotations

import numpy as np
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import aggregate as ag
from plonky2_bls12_381_pairing_torch.ops.rns import fp
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G2Affine
from plonky2_bls12_381_pairing_torch.utils.capture import capture

PACK, SUB, LANES = RC.PACK, RC.SUB, RC.LANES


def check(att_offset, att_bits, sync_bits, proposer, qx, qy, qinf, sx, sy, sinf, *,
          registry) -> torch.Tensor:
    """aggregate_check over the blocks given as tensors: att_offset (B, A),
    att_bits (B, A, W), sync_bits (B, Ws), proposer (B,); qx, qy (S, B / 2,
    2, LANES), qinf (S, B / 2, LANES); sx, sy (B / 2, 2, LANES), sinf (B / 2,
    LANES). Returns (B / 2, PACK) verdicts."""
    blocks = ag.ElectraBlocks(att_offset, att_bits, sync_bits, proposer,
                              G2Affine(qx, qy, qinf), G2Affine(sx, sy, sinf))
    return ag.aggregate_check(blocks, registry)


def words(bits: np.ndarray) -> np.ndarray:
    """(..., n) bools -> (..., ceil(n / 32)) int32 words, bit i of a word at
    1 << i."""
    n = bits.shape[-1]
    pad = np.zeros(bits.shape[:-1] + (-(-n // 32) * 32,), dtype=bool)
    pad[..., :n] = bits
    return (np.packbits(pad, axis=-1, bitorder="little").view("<u4").astype(np.int32)
            .reshape(bits.shape[:-1] + (-1,)))


def _g2_rows(points: list) -> tuple[np.ndarray, np.ndarray]:
    """B affine G2 points -> x, y packed rows (B / 2, 2, LANES), as
    G2Affine.encode lays them out."""
    def coord(i):
        c = [fp.encode_slots([q[i][j] for q in points]) for j in range(2)]
        both = np.stack(c, axis=-2)                                  # (B, 2, SUB)
        b = both.shape[0]
        return np.swapaxes(both.reshape(b // PACK, PACK, 2, SUB), 1, 2).reshape(
            b // PACK, 2, LANES)

    return coord(0), coord(1)


class System:
    """The port's aggregate_check on one device ("cuda" on the card, "cpu"
    for the tests)."""

    def __init__(self, device: str = "cuda"):
        self.device = fp.resolve_device(device)
        self.step = None
        self.staging = None
        self.registry = None
        self._registry_src = None

    def encode(self, traffic) -> list[tuple]:
        """The registry's source kept for prepare; each batch of the traffic
        as the ten input tensors of check(), on the host (pinned on the
        card's host)."""
        self._registry_src = traffic
        b0 = traffic.batches[0]
        batch, atts = b0.att_slot.shape
        if batch % PACK:
            raise ValueError(f"a batch packs {PACK} blocks to a row; got {batch}")
        n, spe, size = len(traffic.keys_x), traffic.slots_per_epoch, traffic.slot_size
        out = []
        for b in traffic.batches:
            offset = (b.att_slot // spe * n + b.att_slot % spe * size).astype(np.int32)
            sets = b.msgs.shape[1]
            qx, qy = zip(*(_g2_rows([traffic.msgs[j] for j in b.msgs[:, s]])
                           for s in range(sets)))
            sx, sy = _g2_rows(b.sigma)
            qinf = np.zeros((sets, batch // PACK, LANES), np.int32)
            arrays = (offset, words(b.att_bits), words(b.sync_bits), b.proposer.astype(np.int32),
                      np.stack(qx), np.stack(qy), qinf, sx, sy, qinf[0])
            out.append(tuple(self._host(a) for a in arrays))
        return out

    def _host(self, arr: np.ndarray) -> torch.Tensor:
        pinned = self.device.type == "cuda"
        t = torch.empty(arr.shape, dtype=torch.int32, pin_memory=pinned)
        t.numpy()[...] = arr
        return t

    def _upload_registry(self) -> None:
        if self.registry is None:
            tr = self._registry_src
            self.registry = ag.Registry.encode(tr.keys_x, tr.keys_y, tr.shuffling, tr.sync,
                                               tr.slots_per_epoch, device=self.device)

    def prepare(self, example: tuple) -> None:
        """The registry on the device (once); on the card device buffers that
        each call copies its batch into, and check() captured on the example
        (a warm-up call, then the capture)."""
        self._upload_registry()
        if self.device.type != "cuda":
            return
        self.staging = [h.to(self.device) for h in example]
        self.step = capture(check, *self.staging, registry=self.registry)

    def copy_in(self, inputs: tuple) -> None:
        if self.staging is not None:
            for s, h in zip(self.staging, inputs):
                s.copy_(h, non_blocking=True)

    def launch(self, inputs: tuple) -> torch.Tensor:
        """The call's verdicts, still on the device: one replay on the card,
        an eager call on the CPU."""
        if self.step is None:
            return check(*inputs, registry=self.registry)
        return self.step(*self.staging)

    @staticmethod
    def read_back(verdicts: torch.Tensor) -> np.ndarray:
        """(B,) bools on the host, in block order."""
        return verdicts.cpu().numpy().reshape(-1)

    def __call__(self, inputs: tuple) -> np.ndarray:
        self.copy_in(inputs)
        return self.read_back(self.launch(inputs))

    def release(self) -> None:
        """Free the capture and its buffers; the registry stays."""
        self.step = self.staging = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def on_device(self, inputs: tuple) -> tuple:
        """A batch's input tensors copied to the device."""
        return tuple(h.to(self.device) for h in inputs)
