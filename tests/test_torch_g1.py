"""The RNS tier's G1 group law (ops/rns/g1.py) and the registry's encoding:
  * Algorithm 7 (g1.add) and Algorithm 8 (g1.madd) against the refmodel's
    affine addition on seeded points, with P + P, P + (-P) and the point at
    infinity on either side (Algorithm 8: on the projective side), by value
    after g1.to_affine;
  * their op counts (fp.count_fp_ops), which benchmark/work/aggregate.py
    freezes, and the bias rows the kernel adds (kernel_tables);
  * the plain aggregation (kernels.g1_aggregate_plain, through
    models/aggregate.py's layout) on a 256-key registry against the
    refmodel's sums: sets of no bit, one bit, every bit, and sets whose bits
    cross a 32-bit word and a piece;
  * fp.encode_slots bit for bit against fp.encode."""

import random

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch.models import aggregate as ag
from plonky2_bls12_381_pairing_torch.ops.rns import fp, g1, kernel_tables, kernels
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from torch_electra import key_sum, make_keys, words

torch.set_num_threads(2)


def decoded(p: G1Affine) -> list:
    """The refmodel points of packed affine rows."""
    inf = p.infinity.reshape(-1, 2, fp.RC.SUB)[:, :, 0].reshape(-1)
    return [rm.G1Affine.identity() if i else rm.G1Affine(int(x), int(y))
            for x, y, i in zip(fp.decode(p.x), fp.decode(p.y), inf.tolist())]


def pairs():
    """(P, Q) cases: random pairs, P + P, P + (-P), infinity on each side
    and on both."""
    r = random.Random(0x61)
    a, b, c = (rm.rand_g1(r) for _ in range(3))
    inf = rm.G1Affine.identity()
    return [(a, b), (b, c), (a, a), (b, b.neg()), (inf, c), (a, inf), (inf, inf), (c, a)]


def test_add_matches_the_refmodel():
    ps, qs = zip(*pairs())
    p = g1.G1Projective.from_affine(G1Affine.encode(list(ps), device="cpu"))
    q = g1.G1Projective.from_affine(G1Affine.encode(list(qs), device="cpu"))
    assert decoded(g1.to_affine(g1.add(p, q))) == [x.add(y) for x, y in zip(ps, qs)]


def test_madd_matches_the_refmodel():
    """The affine side is never at infinity; the projective side may be, and
    may equal it or its negative."""
    cases = [(p, q) for p, q in pairs() if not q.infinity]
    ps, qs = zip(*cases)
    p = g1.G1Projective.from_affine(G1Affine.encode(list(ps), device="cpu"))
    q = G1Affine.encode(list(qs), device="cpu")
    assert decoded(g1.to_affine(g1.madd(p, q.x, q.y))) == [x.add(y) for x, y in cases]


def test_add_of_unreduced_projective_points():
    """Algorithm 7 on points whose Z is not one (the outputs of Algorithm 8),
    chained: (((P1 + P2) + P3) + P3)."""
    r = random.Random(0x62)
    pts = [rm.rand_g1(r) for _ in range(6)]
    p = g1.G1Projective.from_affine(G1Affine.encode(pts[:2], device="cpu"))
    q = G1Affine.encode(pts[2:4], device="cpu")
    s = g1.madd(p, q.x, q.y)
    t = g1.add(g1.add(s, s), s)
    want = [a.add(b) for a, b in zip(pts[:2], pts[2:4])]
    assert decoded(g1.to_affine(t)) == [w.add(w).add(w) for w in want]


def test_op_counts():
    """Per element: Algorithm 8 is 11 products and 8 REDCs, Algorithm 7 12
    and 9 (benchmark/work/aggregate.py holds these)."""
    p = g1.G1Projective.identity((2,), "cpu")
    madd = fp.count_fp_ops(lambda a: g1.madd(a, a.x, a.y), p)
    add = fp.count_fp_ops(lambda a: g1.add(a, a), p)
    assert {k: v // 2 for k, v in madd.items()} == {"fp_mul": 11, "redc": 8}
    assert {k: v // 2 for k, v in add.items()} == {"fp_mul": 12, "redc": 9}


def test_g1_biases_are_the_plain_formulas():
    """The kernel's bias rows are those of the plain formulas' second-stage
    REDCs, and their first stages add none."""
    biases = kernel_tables.static_biases()
    seen = []
    stack = fp.redc_stack

    def record(rs, dim=-2):
        seen.append([fp.nonneg_multiple(x) for x in rs])
        return stack(rs, dim)

    p = g1.G1Projective.identity((2,), "cpu")
    fp.redc_stack = record
    try:
        g1.madd(p, p.x, p.y)
        g1.add(p, p)
    finally:
        fp.redc_stack = stack
    assert seen == [[0] * 5, biases["g1_madd"], [0] * 6, biases["g1_add"]]
    assert kernel_tables.tables()["RNS_G1_ADD_BIAS"].shape == (3, fp.RC.SUB)


@pytest.fixture(scope="module")
def keys():
    return make_keys(256, 2, 4, 40, seed=0x6100)


def sum_sets(keys, bit_rows, offsets, piece_bits):
    """The plain aggregation of sets given as bool rows, each over index
    positions offsets[j] onwards, through layout's pieces: one block of
    len(bit_rows) attestation sets (its sync and proposer sets empty or one
    key)."""
    reg = keys.registry
    n = len(bit_rows)
    bits = np.zeros((1, n, reg.slot_size), dtype=bool)
    for j, row in enumerate(bit_rows):
        bits[0, j, :len(row)] = row
    pieces, sets = ag.layout(1, n, bits.shape[-1] // 32 + (bits.shape[-1] % 32 > 0),
                             reg.slot_size, 2, reg.sync_size, piece_bits, "cpu")
    att = torch.from_numpy(words(bits))
    sync = torch.from_numpy(words(np.zeros((1, reg.sync_size), dtype=bool)))
    blocks = ag.ElectraBlocks(torch.tensor([offsets], dtype=torch.int32), att, sync,
                              torch.tensor([7], dtype=torch.int32), None, None)
    set_off, flat = ag._set_words(blocks, reg)
    out = kernels.g1_aggregate_plain(reg.keys, reg.index, set_off, flat, pieces, sets)
    return g1.G1Projective(*(c.reshape(-1, fp.LANES) for c in out))


@pytest.mark.parametrize("piece_bits", [32, 48, 256])
def test_plain_aggregation_matches_the_refmodels_sums(keys, piece_bits):
    """Sets of no bit, one bit (the last of the slot), every bit, and seeded
    bits (the slot's 64 bits cross a word and, below 64 bits a piece, a
    piece); the sync set empty and the proposer's two sets its one key."""
    reg = keys.registry
    size = reg.slot_size
    rng = np.random.default_rng(0x6101 + piece_bits)
    one = np.zeros(size, dtype=bool)
    one[-1] = True
    rows = [np.zeros(size, dtype=bool), one, np.ones(size, dtype=bool),
            rng.random(size) < 0.5, rng.random(size) < 0.97]
    slots = [0, 3, 4, 7, 5]
    offsets = [reg.slot_offset(s // reg.slots_per_epoch, s % reg.slots_per_epoch)
               for s in slots]
    got = decoded(g1.to_affine(sum_sets(keys, rows, offsets, piece_bits)))
    want = [key_sum(keys, keys.registry.index[o:o + size][torch.from_numpy(r)].tolist())
            for o, r in zip(offsets, rows)]
    want += [rm.G1Affine.identity()] + [keys.points[7]] * 2
    assert got == want


@pytest.mark.parametrize("n", [1, 2, 7, 600])
def test_encode_slots_matches_encode(n):
    """Element i's slot of fp.encode's packed rows, values of p and over
    among them."""
    r = random.Random(0x6102 + n)
    vals = [r.randrange(fp.P) for _ in range(n)]
    vals[:4] = [0, 1, fp.P - 1, 4 * fp.P + 5][:n]
    assert np.array_equal(fp.encode_slots(vals), fp.encode(vals).reshape(-1, fp.RC.SUB)[:n])
