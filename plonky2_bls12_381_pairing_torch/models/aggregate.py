"""Blocks' signature sets checked from the validator registry: the Electra
form of an Ethereum consensus block (consensus-specs electra/beacon-chain.md,
EIP-7549), whose every attestation covers all committees of one slot, each
verified as FastAggregateVerify does it, by the sum of its attesters' public
keys, here taken on the card from a registry the card holds.

A block has A attestations, a sync aggregate, a proposer signature and a
RANDAO reveal: S = A + 3 signature sets. Set s's key is the sum of the keys
its bits pick; an attestation's bits run over its slot's committees, which
phase0's compute_committee takes as consecutive slices of the epoch's
shuffled validator list, so its bit i picks position offset + i of that list,
the offset where the slot's first committee starts (Registry.slot_offset);
the sync aggregate's bits pick the sync committee's members in order; the
proposer's two sets are the proposer's own key. The S sets of a block are
checked in one product with the random scalars of blst's
verify_multiple_aggregate_signatures folded into the G2 side by the caller:

    prod_s e(apk_s, r_s H(m_s)) * e(-G1, sum_s r_s sigma_s) == 1

aggregate_check sums the keys of the B blocks' S sets (kernels.g1_aggregate,
span aggregate.keys), brings the sums to affine form with one batched
inverse (fp.inv's tree; span aggregate.to_affine) and runs pairing_check
with T = S + 1 terms. An attestation with no bit set makes its block's
verdict false, as is_valid_indexed_attestation rejects an empty index list,
and so does a bit set past a set's last validator (the padding of its last
word, which an SSZ bitlist or bitvector holds at zero), an attestation's
offset outside the registry's epochs or a proposer outside the registry;
an empty sync aggregate's key is the point at infinity, whose term is one
(eth_fast_aggregate_verify accepts no participants with the signature at
infinity, which then adds nothing to the sum of signatures).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import rns_constants as RC
from ..ops.rns import fp, g1, kernels
from ..ops.rns.lines import G1Affine, G2Affine, _filled
from ..utils import refmodel as rm
from ..utils import spans
from . import pairing_rns

LANES, SUB, PACK = RC.LANES, RC.SUB, RC.PACK
#: signature sets of a block besides its attestations: the sync aggregate,
#: the proposer's signature and the RANDAO reveal, in that order
OTHER_SETS = 3
#: bits of a set summed by one accumulator of g1_sum (a piece): on an H100
#: 128 and 256 give the same time, 512 and 1,024 7 % more (g1_combine's share
#: halves with each doubling: 0.99 ms a call at 256)
PIECE_BITS = 256


@dataclass
class Registry:
    """What the node holds for the check, on one device. keys: (n, 2, SUB)
    validator i's public key, its x and y slots (fp.encode_slots); index:
    (L,) int32, positions into keys: the shuffled validator lists of
    `epochs` epochs (epoch e's at e * n), the sync committee's members
    (at sync_base), and 0..n-1 (at ident_base), where a proposer's set
    reads its own key."""

    keys: torch.Tensor
    index: torch.Tensor
    validators: int
    epochs: int
    slots_per_epoch: int
    sync_size: int

    @staticmethod
    def encode(xs, ys, shuffling, sync_committee, slots_per_epoch: int = 32,
               device=None) -> "Registry":
        """The registry of the affine keys (xs[i], ys[i]) (Python ints), the
        epochs' shuffled lists shuffling (epochs, n) and the sync
        committee's validator indices, uploaded to `device`."""
        dev = fp.resolve_device(device)
        n = len(xs)
        shuffling = np.asarray(shuffling, dtype=np.int32).reshape(-1, n)
        if n % slots_per_epoch:
            raise ValueError(f"{n} validators do not split into {slots_per_epoch} equal slots")
        keys = np.stack([fp.encode_slots(xs), fp.encode_slots(ys)], axis=1)
        index = np.concatenate([shuffling.reshape(-1), np.asarray(sync_committee, np.int32),
                                np.arange(n, dtype=np.int32)])
        return Registry(torch.from_numpy(keys).to(dev), torch.from_numpy(index).to(dev), n,
                        shuffling.shape[0], slots_per_epoch, len(sync_committee))

    @property
    def slot_size(self) -> int:
        """Validators a slot: an attestation's bits."""
        return self.validators // self.slots_per_epoch

    @property
    def sync_base(self) -> int:
        return self.epochs * self.validators

    @property
    def ident_base(self) -> int:
        return self.sync_base + self.sync_size

    def slot_offset(self, epoch: int, slot: int) -> int:
        """Where slot `slot` of epoch `epoch`'s committees start in index."""
        return epoch * self.validators + slot * self.slot_size


@dataclass
class ElectraBlocks:
    """One call's B blocks (B even), A attestations each. att_offset (B, A)
    int32: each attestation's Registry.slot_offset; att_bits (B, A, W)
    int32: its aggregation bits over the slot's slot_size validators, 32 to
    a word (bit i of a word at 1 << i), W = ceil(slot_size / 32); sync_bits
    (B, Ws): the sync aggregate's bits over the sync committee, Ws =
    ceil(sync_size / 32); proposer (B,): the proposer's
    validator index; msgs: the S sets' G2 points r_s H(m_s), stacked
    (S, B / 2, 2, LANES), in the order attestations, sync aggregate,
    proposer, RANDAO; sigma: sum_s r_s sigma_s, (B / 2, 2, LANES)."""

    att_offset: torch.Tensor
    att_bits: torch.Tensor
    sync_bits: torch.Tensor
    proposer: torch.Tensor
    msgs: G2Affine
    sigma: G2Affine


_LAYOUTS: dict = {}


def layout(blocks: int, atts: int, att_words: int, att_len: int, sync_words: int,
           sync_len: int, piece_bits: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """kernels.g1_aggregate's pieces and sets for the flat bit words of
    _set_words, set j = s * blocks + b (block b's set s), made once per
    shape and device: each set's bits cut into runs of piece_bits."""
    key = (blocks, atts, att_words, att_len, sync_words, sync_len, piece_bits, device)
    if key not in _LAYOUTS:
        sync0 = atts * blocks * att_words
        own0 = sync0 + blocks * sync_words
        per_set = ([(s * blocks + b) * att_words, att_len] for s in range(atts)
                   for b in range(blocks))
        sync = ([sync0 + b * sync_words, sync_len] for b in range(blocks))
        own = ([own0 + k * blocks + b, 1] for k in range(2) for b in range(blocks))
        pieces, sets = [], []
        for j, (word, bits) in enumerate([*per_set, *sync, *own]):
            sets.append([len(pieces), max(-(-bits // piece_bits), 1)])
            pieces += [[j, word, b0, min(piece_bits, bits - b0)]
                       for b0 in range(0, max(bits, 1), piece_bits)]
        _LAYOUTS[key] = tuple(torch.tensor(np.array(t, dtype=np.int32), device=device)
                              for t in (pieces, sets))
    return _LAYOUTS[key]


def _word_masks(words: int, bits: int, device) -> torch.Tensor:
    """(words,) int32: the bits of a set's `words` words that lie among its
    `bits` bits (the last word's padding clear), made once per shape and
    device."""
    key = ("masks", words, bits, device)
    if key not in _LAYOUTS:
        masks = np.full(words, -1, dtype=np.int32)
        if bits % 32:
            masks[-1] = (1 << bits % 32) - 1
        _LAYOUTS[key] = torch.from_numpy(masks).to(device)
    return _LAYOUTS[key]


def _bits_valid(blocks: ElectraBlocks, registry: Registry) -> torch.Tensor:
    """(B,) bools: whether each of a block's attestations sets a bit among
    its slot's validators and none of its sets a padding bit."""
    dev = blocks.att_bits.device
    att = _word_masks(blocks.att_bits.shape[-1], registry.slot_size, dev)
    sync = _word_masks(blocks.sync_bits.shape[-1], registry.sync_size, dev)
    filled = ((blocks.att_bits & att) != 0).any(dim=-1).all(dim=-1)
    clean = (((blocks.att_bits & ~att) == 0).all(dim=-1).all(dim=-1)
             & ((blocks.sync_bits & ~sync) == 0).all(dim=-1))
    return filled & clean


def _in_range(blocks: ElectraBlocks, registry: Registry) -> torch.Tensor:
    """(B,) bools: whether a block's attestations' slots lie in the
    registry's epochs and its proposer in the registry."""
    last = registry.sync_base - registry.slot_size
    att = ((blocks.att_offset >= 0) & (blocks.att_offset <= last)).all(dim=-1)
    return att & (blocks.proposer >= 0) & (blocks.proposer < registry.validators)


def _set_words(blocks: ElectraBlocks, registry: Registry) -> tuple[torch.Tensor, torch.Tensor]:
    """Every set's first position in registry.index, (S * B,), and the sets'
    bit words in one flat array: the attestations' (set-major), the sync
    aggregates', then a word of one bit for each proposer set. An offset or
    proposer out of range (_in_range; its block fails) is clamped into it,
    so that no read leaves the index list or the keys."""
    b = blocks.proposer.shape[0]
    offsets = blocks.att_offset.clamp(0, registry.sync_base - registry.slot_size)
    own = blocks.proposer.clamp(0, registry.validators - 1) + registry.ident_base
    set_off = torch.cat([offsets.t().reshape(-1),
                         blocks.proposer.new_full((b,), registry.sync_base), own, own])
    words = torch.cat([blocks.att_bits.transpose(0, 1).reshape(-1),
                       blocks.sync_bits.reshape(-1), torch.ones_like(own).repeat(2)])
    return set_off, words


def aggregate_keys(blocks: ElectraBlocks, registry: Registry) -> g1.G1Projective:
    """The S sets' key sums of the B blocks, projective, (S, B / 2, LANES)
    each coordinate: set s of block b at [s], element b."""
    b, a, w = blocks.att_bits.shape
    if b % PACK or blocks.att_offset.shape != (b, a):
        raise ValueError(f"expected an even number of blocks and an offset per attestation, "
                         f"got bits {tuple(blocks.att_bits.shape)} and offsets "
                         f"{tuple(blocks.att_offset.shape)}")
    want = (-(-registry.slot_size // 32), -(-registry.sync_size // 32))
    if (w, blocks.sync_bits.shape[-1]) != want or blocks.sync_bits.shape[0] != b:
        raise ValueError(f"expected {want[0]} words of an attestation's bits and {want[1]} of "
                         f"a sync aggregate's for each of {b} blocks, got "
                         f"{tuple(blocks.att_bits.shape)} and {tuple(blocks.sync_bits.shape)}")
    pieces, sets = layout(b, a, w, registry.slot_size, blocks.sync_bits.shape[1],
                          registry.sync_size, PIECE_BITS, registry.keys.device)
    set_off, words = _set_words(blocks, registry)
    sums = kernels.g1_aggregate(registry.keys, registry.index, set_off, words, pieces, sets)
    return g1.G1Projective(*(c.reshape(a + OTHER_SETS, b // PACK, LANES) for c in sums))


def _neg_g1(rows: int, device) -> G1Affine:
    """-G1 at every element of `rows` packed rows."""
    g = rm.G1Affine.generator().neg()
    return G1Affine(_filled(("g1_gen_x",), fp.encode(g.x), (rows,), (LANES,), device),
                    _filled(("g1_neg_gen_y",), fp.encode(g.y), (rows,), (LANES,), device),
                    torch.zeros((rows, LANES), dtype=torch.int32, device=device))


def aggregate_check(blocks: ElectraBlocks, registry: Registry) -> torch.Tensor:
    """(B / 2, PACK) bools: each block's verdict (module docstring), block b
    at row b // 2, slot b % 2."""
    dev = registry.keys.device
    with spans.span("aggregate.keys", dev):
        sums = aggregate_keys(blocks, registry)
        filled = _bits_valid(blocks, registry) & _in_range(blocks, registry)
    with spans.span("aggregate.to_affine", dev):
        apk = g1.to_affine(sums)
    rows = apk.x.shape[1]
    ps = [G1Affine(apk.x[s], apk.y[s], apk.infinity[s]) for s in range(apk.x.shape[0])]
    qs = [G2Affine(blocks.msgs.x[s], blocks.msgs.y[s], blocks.msgs.infinity[s])
          for s in range(len(ps))]
    ok = pairing_rns.pairing_check(ps + [_neg_g1(rows, dev)], qs + [blocks.sigma])
    return ok & filled.reshape(rows, PACK)
