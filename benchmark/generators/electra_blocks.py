"""The generator of Electra blocks checked from the validator registry: a
registry of public keys with known discrete logs, two epochs' committee
shufflings and a sync committee, and batches of blocks whose signature sets
name their keys by participation bits, made from a seed.

The registry holds n keys k_i G1, k_i = k0 + i d (mod r), made without a
scalar multiplication per key: k_{jc+i} = (k0 + j c d) + i d is Q_j + D_i for
two chains Q, D of about sqrt(n) points each, and the n sums are affine
additions whose denominators share one inversion (Montgomery's trick). Each
epoch's committee shuffling is a seeded permutation of the validators (not
the spec's swap-or-not shuffle; the reference reads the same one), and slot s
of an epoch holds positions [s n / 32, (s + 1) n / 32) of it, the slot's 64
committees in order (phase0 compute_committee). The sync committee is a
seeded sample of 512 validators.

A block has A attestations, each over all committees of one slot (Electra,
EIP-7549): its bits are drawn at the traffic's participation over the slot's
validators; the sync aggregate's bits at the same rate over the sync
committee; the proposer is a seeded validator, whose key signs the proposer
and RANDAO sets. Block b of a batch of B (B / 32 epochs) attests the A slots
before its own in the batch's window of epochs (wrapping), shifted per batch.
The sets' G2 points r_s H(m_s) come from a pool h_j = h0 + j e, and the sum
sigma = sum_s r_s sigma_s = (sum_s sk_s q_s) G2 follows from the keys' logs
(sk_s = |set| k0 + d sum of its indices), one scalar multiplication a block:
no key is summed here.

A seeded ceil(B / invalid_one_in) blocks a batch are made invalid, half of
them (seeded) by one attestation bit flipped after signing (the aggregate key
is one key off), the others by sigma + G2. Nothing here depends on the
program.

Traffic parameters (benchmark/traffic/<mix>.json): batch (blocks a call, a
multiple of 32), participation, invalid_one_in, distinct_batches. The
configuration gives validators, slots_per_epoch, attestations_per_block and
sync_committee_size. The answer of a block is its verdict, a bool.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np

from benchmark.harness import curve
from benchmark.harness.curve import Fp, Fq2
from benchmark.reference import aggregate as ref_aggregate
from benchmark.reference.bls12_381 import P, R

#: signature sets of a block besides its attestations: the sync aggregate,
#: the proposer's signature and the RANDAO reveal
OTHER_SETS = 3


@dataclass
class Batch:
    """One call's blocks. att_slot (B, A): the slot (of the batch's window of
    epochs) each attestation covers; att_bits (B, A, slot_size) and
    sync_bits (B, sync size) bools; proposer (B,); msgs (B, S) indices into
    the G2 pool; sigma: B affine G2 points; valid (B,)."""

    att_slot: np.ndarray
    att_bits: np.ndarray
    sync_bits: np.ndarray
    proposer: np.ndarray
    msgs: np.ndarray
    sigma: list
    valid: np.ndarray


@dataclass
class Traffic:
    """The registry (keys_x, keys_y: affine coordinates as ints), the epochs'
    shuffled lists (epochs, n), the sync committee's validator indices, the
    G2 pool and the batches of one seed."""

    keys_x: list
    keys_y: list
    shuffling: np.ndarray
    sync: np.ndarray
    slots_per_epoch: int
    msgs: list
    batches: list

    @property
    def slot_size(self) -> int:
        return len(self.keys_x) // self.slots_per_epoch

    def members(self, slot: int) -> np.ndarray:
        """The validators of a slot of the window, in committee order."""
        e, s = divmod(int(slot), self.slots_per_epoch)
        return self.shuffling[e, s * self.slot_size:(s + 1) * self.slot_size]

    def sets_of(self, batch: int, block: int) -> list:
        """A block's signature sets as validator indices: its attestations',
        the sync aggregate's, the proposer's twice."""
        b = self.batches[batch]
        out = [self.members(s)[bits] for s, bits in zip(b.att_slot[block], b.att_bits[block])]
        prop = b.proposer[block:block + 1]
        return out + [self.sync[b.sync_bits[block]], prop, prop]


def _seed_rng(seed: int, *tags) -> random.Random:
    """A generator for one purpose of one seed (any int, of any size)."""
    return random.Random(repr((int(seed),) + tags))


def _np_rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(_seed_rng(seed, *tags).getrandbits(128))


def _affine(F, base, k: int):
    return curve.to_affine(F, [curve.mul(F, base, k)])[0]


def registry(n: int, k0: int, d: int) -> tuple[list, list]:
    """The affine keys (k0 + i d) G1, i < n (module docstring)."""
    c = max(math.isqrt(n), 1)
    step = _affine(Fp, curve.G1_GEN, d)
    ds = curve.to_affine(Fp, curve.chain(Fp, step, step, c - 1)) if c > 1 else []
    qs = curve.to_affine(Fp, curve.chain(Fp, _affine(Fp, curve.G1_GEN, k0),
                                         _affine(Fp, curve.G1_GEN, c * d), -(-n // c)))
    den = [dx - qx for qx, _ in qs for dx, _ in ds]
    if any(v % P == 0 for v in den):  # Q_j = +-D_i: probability about n / r
        raise ValueError("a key pair shares its x; draw another seed")
    prefix, acc = [], 1
    for v in den:
        prefix.append(acc)
        acc = acc * v % P
    inv = pow(acc, P - 2, P)
    invs = [0] * len(den)
    for k in range(len(den) - 1, -1, -1):
        invs[k] = inv * prefix[k] % P
        inv = inv * den[k] % P
    xs, ys, k = [], [], 0
    for qx, qy in qs:
        xs.append(qx)
        ys.append(qy)
        for dx, dy in ds:
            lam = (dy - qy) * invs[k] % P
            x3 = (lam * lam - qx - dx) % P
            xs.append(x3)
            ys.append((lam * (qx - x3) - qy) % P)
            k += 1
    return xs[:n], ys[:n]


def generate(seed: int, config: dict, batch: int, participation: float, invalid_one_in: int,
             distinct_batches: int) -> Traffic:
    """The seed's registry and its distinct_batches batches of `batch`
    blocks (module docstring)."""
    n, spe = int(config["validators"]), int(config["slots_per_epoch"])
    atts, sync_size = int(config["attestations_per_block"]), int(config["sync_committee_size"])
    if batch < 2 or batch % spe or n % spe or distinct_batches < 1:
        raise ValueError(f"a batch is whole epochs of {spe} slots; got {batch} blocks "
                         f"over {n} validators")
    rng = _seed_rng(seed, "registry")
    k0, d, h0, e = (rng.randrange(1, R) for _ in range(4))
    xs, ys = registry(n, k0, d)
    nrng = _np_rng(seed, "shuffling")
    epochs = batch // spe
    shuffling = np.stack([nrng.permutation(n) for _ in range(epochs)]).astype(np.int32)
    sync = nrng.choice(n, sync_size, replace=False).astype(np.int32)
    sets = atts + OTHER_SETS
    span = 64
    pool = curve.to_affine(Fq2, curve.chain(Fq2, _affine(Fq2, curve.G2_GEN, h0),
                                            _affine(Fq2, curve.G2_GEN, e), batch * sets + span))
    tr = Traffic(xs, ys, shuffling, sync, spe, pool, [])
    for i in range(distinct_batches):
        tr.batches.append(_batch(seed, i, tr, batch, atts, participation, invalid_one_in, span,
                                 (k0, d, h0, e)))
    return tr


def make(seed: int, cell) -> Traffic:
    """The traffic of one run of `cell` (harness/spec.py)."""
    t = cell.traffic
    return generate(seed, cell.config, t["batch"], float(t["participation"]),
                    t["invalid_one_in"], t["distinct_batches"])


def expected(traffic: Traffic, batch: int) -> np.ndarray:
    """(B,) the verdicts the batch's blocks were built to give."""
    return traffic.batches[batch].valid


def notable(traffic: Traffic, batch: int) -> np.ndarray:
    """The batch's blocks built invalid, which the judge samples first."""
    return np.flatnonzero(~traffic.batches[batch].valid)


def reference(traffic: Traffic, batch: int, block: int) -> bool:
    """The plain reference's verdict of one block: its sets' keys summed
    from the registry point by point and the product of its pairings,
    computed in Python integers (reference/aggregate.py)."""
    b = traffic.batches[batch]
    return ref_aggregate.block_verdict(
        traffic.keys_x, traffic.keys_y, traffic.sets_of(batch, block),
        len(b.att_slot[block]), [traffic.msgs[j] for j in b.msgs[block]], b.sigma[block])


def _batch(seed: int, i: int, tr: Traffic, batch: int, atts: int, participation: float,
           invalid_one_in: int, span: int, dlogs: tuple) -> Batch:
    k0, d, h0, e = dlogs
    rng, nrng = _seed_rng(seed, "batch", i), _np_rng(seed, "bits", i)
    window = tr.shuffling.shape[0] * tr.slots_per_epoch
    shift = rng.randrange(window)
    att_slot = (np.arange(batch)[:, None] - 1 - np.arange(atts)[None, :] + shift) % window
    att_bits = nrng.random((batch, atts, tr.slot_size)) < participation
    sync_bits = nrng.random((batch, len(tr.sync))) < participation
    proposer = nrng.integers(0, len(tr.keys_x), batch).astype(np.int32)
    sets = atts + OTHER_SETS
    msgs = np.arange(batch * sets).reshape(batch, sets) + rng.randrange(span)
    # each set's secret key from the registry's logs: |set| k0 + d sum(indices)
    members = tr.shuffling.reshape(-1)[(att_slot // tr.slots_per_epoch * len(tr.keys_x)
                                        + att_slot % tr.slots_per_epoch * tr.slot_size)
                                       [..., None] + np.arange(tr.slot_size)]
    att_n = att_bits.sum(axis=-1)
    att_sum = np.where(att_bits, members.astype(np.int64), 0).sum(axis=-1)
    sync_n = sync_bits.sum(axis=-1)
    sync_sum = np.where(sync_bits, tr.sync.astype(np.int64)[None, :], 0).sum(axis=-1)
    totals = []
    for b in range(batch):
        sk = [int(att_n[b, a]) * k0 + d * int(att_sum[b, a]) for a in range(atts)]
        sk += [int(sync_n[b]) * k0 + d * int(sync_sum[b])] + [k0 + d * int(proposer[b])] * 2
        totals.append(sum(s * (h0 + int(j) * e) for s, j in zip(sk, msgs[b])) % R)
    sigma = curve.to_affine(Fq2, [curve.mul(Fq2, curve.G2_GEN, t) for t in totals])
    valid = np.ones(batch, dtype=bool)
    for c in rng.sample(range(batch), math.ceil(batch / invalid_one_in)):
        if rng.randrange(2):
            a, pos = rng.randrange(atts), rng.randrange(tr.slot_size)
            att_bits[c, a, pos] = not att_bits[c, a, pos]
        else:
            sigma[c] = curve.to_affine(
                Fq2, [curve.add_affine(Fq2, (*sigma[c], Fq2.one), curve.G2_GEN)])[0]
        valid[c] = False
    return Batch(att_slot, att_bits, sync_bits, proposer, msgs, sigma, valid)
