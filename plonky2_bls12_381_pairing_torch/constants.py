"""Static BLS parameter tables of the Miller-loop and final-exponentiation
schedules (the subset of the JAX package's constants.py that the port's
schedule needs), derived from the exact integers of utils/refmodel.py."""

from __future__ import annotations

import numpy as np

from .utils import refmodel as rm

BLS_X = rm.BLS_X
BLS_X_IS_NEGATIVE = rm.BLS_X_IS_NEGATIVE
NUM_LINE_COEFFS = rm.NUM_LINE_COEFFS


def miller_schedule() -> np.ndarray:
    """Bits of BLS_X>>1 after the leading 1, MSB-first (62 iterations)."""
    x = BLS_X >> 1
    bits = [(x >> i) & 1 for i in range(x.bit_length() - 2, -1, -1)]
    arr = np.array(bits, dtype=np.int32)
    # 62 iterations; 5 add steps; 62 + 5 + 1 final doubling = 68 line triples.
    assert len(arr) == 62 and arr.sum() == 5
    return arr


MILLER_BITS = miller_schedule()
