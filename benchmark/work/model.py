"""The frozen yardstick of a pairing check's work: how many RNS Fp operations
a check of T terms needs, and what they cost in the card's operations.

The counts are those of the port's exact op counts (models/pairing_rns.py
op_counts, ops/rns/fp.py count_fp_ops of the line steps and the sparse
product), copied here as numbers so that no change to the program moves them;
benchmark/tests/test_bench_work.py holds them equal to the port's. The
operation model is the port's utils/profiling.py one: an Fp product is one
int32 operation on each of 63 channel lanes; a REDC row is five such lane
products and two base extensions, whose multiply-adds run on the tensor cores
as three u8 plane products of two operations each (csrc/rns_redc_tc.cuh).
"""

from __future__ import annotations

from typing import NamedTuple

#: channel lanes an Fp element's operations run on
CHANNELS = 63
#: one REDC row: five lane products, and the base extensions' multiply-adds
#: (31 base-A sigmas onto 31 base-B lanes, the redundant lane and the alpha
#: column; 31 base-B sigmas onto 31 base-A lanes and the beta column)
REDC_LANE_PRODUCTS = 5
REDC_EXT_MACS = 31 * 33 + 31 * 32
#: the u8 tensor-core operations of one base-extension multiply-add
TC_OPS_PER_EXT_MAC = 6

#: One pairing's (fp_mul, redc) per element outside the batched Fp inverse's
#: product tree: the fused Miller loop (63 doubling and 5 addition steps with
#: the ell scaling, 68 sparse products, 62 squarings) and the final
#: exponentiation. op_counts(batch) = these + the tree's.
PAIRING = (22486, 7689)
#: The batched inverse: about 3 products and REDCs per element, and the
#: root's Fermat power (POW_STEPS dependent steps) over TREE_ROOT elements,
#: shared by the batch.
TREE_PER_ELEMENT = 3
POW_STEPS = 608
TREE_ROOT = 256
#: (fp_mul, redc) per element of one doubling step, one addition step (both
#: with the ell scaling) and one sparse product; a further term of a check
#: runs 63, 5 and 68 of them.
DOUBLING_STEP = (37, 24)
ADDITION_STEP = (57, 34)
SPARSE_PRODUCT = (39, 12)
STEPS = (63, 5, 68)


def pairing_counts(batch: int) -> dict:
    """(fp_mul, redc) of one pairing of a batch of `batch` elements, as the
    port's op_counts(batch) gives them."""
    tree = TREE_PER_ELEMENT + POW_STEPS * min(TREE_ROOT, batch) / batch
    return {"fp_mul": PAIRING[0] + tree, "redc": PAIRING[1] + tree}


def term_counts() -> dict:
    """(fp_mul, redc) of one further term of a check."""
    parts = (DOUBLING_STEP, ADDITION_STEP, SPARSE_PRODUCT)
    return {key: sum(n * part[i] for n, part in zip(STEPS, parts))
            for i, key in enumerate(("fp_mul", "redc"))}


def check_counts(batch: int, terms: int) -> dict:
    """(fp_mul, redc) of one check of `terms` pairings in a batch."""
    one, more = pairing_counts(batch), term_counts()
    return {k: one[k] + (terms - 1) * more[k] for k in one}


class Work(NamedTuple):
    int_ops: float
    ext_macs: float


def work(counts: dict) -> Work:
    """The int32 operations outside the base extensions, and the base
    extensions' multiply-adds."""
    redc = counts["redc"]
    return Work(CHANNELS * (counts["fp_mul"] + REDC_LANE_PRODUCTS * redc),
                REDC_EXT_MACS * redc)


def least_seconds(batch: int, terms: int, peak) -> float:
    """The least time of a call of `batch` checks of `terms` pairings on a
    card of `peak` (work/peak.py): the int32 operations at the int32 rate or
    the base extensions at the u8 tensor-core rate, whichever is longer. Only
    the points in and the verdicts out must move, so bytes do not bound it."""
    w = work(check_counts(batch, terms))
    per_check = max(w.int_ops / peak.int32_ops_per_s,
                    TC_OPS_PER_EXT_MAC * w.ext_macs / peak.u8_tc_ops_per_s)
    return batch * per_check
