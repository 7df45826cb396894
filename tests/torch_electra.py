"""Registries and Electra blocks with known discrete logs for the tests of
models/aggregate.py and csrc/g1_aggregate.cu: keys k_i = k0 + i d (a chain of
additions in the port's refmodel), or, for the card's shapes, a pool of such
keys repeated over the registry; blocks whose sets' bits are drawn at a
participation rate, whose G2 points have known logs, and whose verdicts are
known from the logs. Nothing here runs the port's arithmetic."""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from plonky2_bls12_381_pairing_torch.models import aggregate as ag
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G2Affine
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm


@dataclass
class Keys:
    """The registry's keys (points; key i is (k0 + (i % pool) d) G1), its
    shuffled lists and its sync committee, and the Registry on a device."""

    points: list
    k0: int
    d: int
    pool: int
    shuffling: np.ndarray
    sync: np.ndarray
    registry: ag.Registry

    def log_sum(self, idx) -> int:
        """The sum of the keys idx's discrete logs."""
        idx = np.asarray(idx, dtype=np.int64)
        return (len(idx) * self.k0 + self.d * int((idx % self.pool).sum())) % rm.R


_DOUBLINGS: dict = {}


def mul(base, k: int):
    """k * base by a table of base's doublings (made once per base): about
    half the additions of base.mul and no doubling."""
    if base not in _DOUBLINGS:
        table = [base]
        for _ in range(rm.R.bit_length()):
            table.append(table[-1].add(table[-1]))
        _DOUBLINGS[base] = table
    out = type(base).identity()
    k %= rm.R
    for i, p in enumerate(_DOUBLINGS[base]):
        if k >> i & 1:
            out = out.add(p)
    return out


def chain_points(n: int, k0: int, d: int) -> list:
    """n G1 points (k0 + i d) G1 by n - 1 additions."""
    g = rm.G1Affine.generator()
    points = [mul(g, k0)]
    step = mul(g, d)
    for _ in range(n - 1):
        points.append(points[-1].add(step))
    return points


def make_keys(n: int, epochs: int, slots_per_epoch: int, sync_size: int, seed: int,
              device="cpu", pool: int | None = None) -> Keys:
    """A registry of n keys; with `pool`, that many distinct keys repeated
    (key i is pool key i % pool)."""
    r = random.Random(seed)
    k0, d = r.randrange(1, rm.R), r.randrange(1, rm.R)
    pool = pool or n
    points = chain_points(pool, k0, d)
    points = [points[i % pool] for i in range(n)]
    rng = np.random.default_rng(seed)
    shuffling = np.stack([rng.permutation(n) for _ in range(epochs)]).astype(np.int32)
    sync = rng.choice(n, sync_size, replace=False).astype(np.int32)
    reg = ag.Registry.encode([p.x for p in points], [p.y for p in points], shuffling, sync,
                             slots_per_epoch, device=device)
    return Keys(points, k0, d, pool, shuffling, sync, reg)


def words(bits: np.ndarray) -> np.ndarray:
    """(..., n) bools -> (..., ceil(n / 32)) int32 words, bit i of a word at
    1 << i."""
    n = bits.shape[-1]
    pad = np.zeros(bits.shape[:-1] + (-(-n // 32) * 32,), dtype=bool)
    pad[..., :n] = bits
    packed = np.packbits(pad, axis=-1, bitorder="little")
    return packed.view("<u4").astype(np.int32).reshape(bits.shape[:-1] + (-1,))


@dataclass
class Blocks:
    """One call's inputs and what they must give: the entry point's
    ElectraBlocks, each set's validator indices (set s of block b at
    sets[b][s]), each block's G2 points (msgs[b][s], sigma[b]) and its
    verdict."""

    blocks: ag.ElectraBlocks
    sets: list
    msgs: list
    sigma: list
    valid: np.ndarray


def make_blocks(keys: Keys, n_blocks: int, atts: int, seed: int, participation: float = 0.97,
                empty: tuple = (), flipped: tuple = (), sigma_off: tuple = (),
                device="cpu") -> Blocks:
    """n_blocks blocks of `atts` attestations over random slots of the
    registry's epochs; block b's attestation 0 is empty where b in `empty`,
    has one bit flipped after signing where b in `flipped`, and its sum of
    signatures is off by G2 where b in `sigma_off`."""
    reg = keys.registry
    rng = np.random.default_rng(seed)
    r = random.Random(seed)
    size, spe = reg.slot_size, reg.slots_per_epoch
    slots = rng.integers(0, reg.epochs * spe, (n_blocks, atts))
    bits = rng.random((n_blocks, atts, size)) < participation
    sync_bits = rng.random((n_blocks, reg.sync_size)) < participation
    proposer = rng.integers(0, reg.validators, n_blocks).astype(np.int32)
    for b in empty:
        bits[b, 0] = False
    members = [[keys.shuffling[s // spe][(s % spe) * size:(s % spe + 1) * size]
                for s in row] for row in slots]
    sets = [[members[b][a][bits[b, a]] for a in range(atts)]
            + [keys.sync[sync_bits[b]], proposer[b:b + 1], proposer[b:b + 1]]
            for b in range(n_blocks)]
    n_sets = atts + ag.OTHER_SETS
    q = [[r.randrange(1, rm.R) for _ in range(n_sets)] for _ in range(n_blocks)]
    h = rm.G2Affine.generator()
    sigma = []
    for b in range(n_blocks):
        total = sum(keys.log_sum(idx) * qs for idx, qs in zip(sets[b], q[b]))
        sigma.append(mul(h, total % rm.R + (b in sigma_off)))
    for b in flipped:
        i = int(rng.integers(size))
        bits[b, 0, i] = not bits[b, 0, i]
        sets[b][0] = members[b][0][bits[b, 0]]
    valid = np.array([b not in empty + flipped + sigma_off for b in range(n_blocks)])
    msgs = [[mul(h, x) for x in row] for row in q]
    g2 = [G2Affine.encode([msgs[b][s] for b in range(n_blocks)], device=device)
          for s in range(n_sets)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)  # noqa: E731
    offsets = [[reg.slot_offset(s // spe, s % spe) for s in row] for row in slots]
    blocks = ag.ElectraBlocks(
        t(offsets), t(words(bits)), t(words(sync_bits)), t(proposer),
        G2Affine(*(torch.stack([getattr(m, k) for m in g2]) for k in ("x", "y", "infinity"))),
        G2Affine.encode(sigma, device=device))
    return Blocks(blocks, sets, msgs, sigma, valid)


def key_sum(keys: Keys, idx) -> rm.G1Affine:
    """The refmodel's sum of the keys idx."""
    out = rm.G1Affine.identity()
    for i in idx:
        out = out.add(keys.points[int(i)])
    return out


def reference_verdict(keys: Keys, data: Blocks, b: int) -> bool:
    """Block b's verdict by the refmodel: each set's keys summed point by
    point, an attestation with no key refused, and the product of the
    block's pairings compared with one."""
    sums = [key_sum(keys, idx) for idx in data.sets[b]]
    if any(len(idx) == 0 for idx in data.sets[b][:-ag.OTHER_SETS]):
        return False
    terms = [(p, q) for p, q in zip(sums, data.msgs[b]) if not p.infinity]
    terms.append((rm.G1Affine.generator().neg(), data.sigma[b]))
    return rm.multi_pairing(terms) == rm.Fq12.one()
