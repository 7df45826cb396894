"""The frozen yardstick of FastAggregateVerify's key sums: what one key
addition costs in RNS Fp operations, and the least time of a call's
additions on the card.

The counts are the port's (ops/rns/g1.py through fp.count_fp_ops: Algorithm
8, the mixed addition that adds a registry key), copied here as numbers so
that no change to the program moves them; benchmark/tests/test_bench_electra.py
holds them equal to the port's. The operation model is work/model.py's (a
product one int32 operation on each of 63 channel lanes; a REDC row five lane
products and two base extensions on the tensor cores) and the peaks are
work/peak.py's, with the card's memory bandwidth beside them.

A call's additions are the bits its blocks set: each adds one key. Its
least bytes are its inputs read once (the roofline's rule: what is read
again is not counted): the registry's key rows, the index lists, the bit
words; the sums written back are few. On an H100 the int32 operations bound
it.
"""

from __future__ import annotations

from .model import TC_OPS_PER_EXT_MAC, work

#: (fp_mul, redc) per element of one mixed addition (g1.madd)
MADD = (11, 8)
#: (fp_mul, redc) per element of one projective addition (g1.add), which
#: combines a set's partial sums
ADD = (12, 9)
#: bytes of a registry row (x and y, 64 int32 lanes each) and of an index
KEY_BYTES = 2 * 64 * 4
INDEX_BYTES = 4
#: NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3
HBM_BYTES_PER_S = 3.35e12


def additions(cell) -> float:
    """The key additions of one call of the cell: per block, its
    attestations' bits over a slot's validators and the sync aggregate's
    over its committee at the traffic's participation, and the proposer's
    two sets of one key."""
    c, t = cell.config, cell.traffic
    slot = int(c["validators"]) // int(c["slots_per_epoch"])
    bits = int(c["attestations_per_block"]) * slot + int(c["sync_committee_size"])
    return t["batch"] * (float(t["participation"]) * bits + 2)


def input_bytes(cell) -> float:
    """The bytes a call reads once: the registry's rows, the epochs' index
    lists and the sync committee, and the blocks' bit words."""
    c, t = cell.config, cell.traffic
    n, spe = int(c["validators"]), int(c["slots_per_epoch"])
    epochs = t["batch"] // spe
    index = (epochs + 1) * n + int(c["sync_committee_size"])
    words = t["batch"] * (int(c["attestations_per_block"]) * -(-(n // spe) // 32)
                          + -(-int(c["sync_committee_size"]) // 32))
    return n * KEY_BYTES + INDEX_BYTES * (index + words)


def least_seconds(cell, peak) -> float:
    """The least time of a call's key additions on a card of `peak`
    (work/peak.py): its int32 operations at the int32 rate, its base
    extensions at the u8 tensor-core rate, or its input bytes at the memory
    bandwidth, whichever is longest."""
    n = additions(cell)
    w = work({"fp_mul": MADD[0], "redc": MADD[1]})
    return max(n * w.int_ops / peak.int32_ops_per_s,
               n * TC_OPS_PER_EXT_MAC * w.ext_macs / peak.u8_tc_ops_per_s,
               input_bytes(cell) / HBM_BYTES_PER_S)
