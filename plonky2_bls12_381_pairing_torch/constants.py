"""Static tables of the port, derived at import time from the exact integers
of utils/refmodel.py (the port's own copy of the JAX package's constants.py):
the BLS parameter tables of the Miller-loop and final-exponentiation schedules,
and the numeric tables of the limb tier.

Limb tier representation (see ops/fp.py):
  - radix  B = 2^8, canonical Fp element = 48 int32 limbs in [0, 255]
  - Montgomery radix R = 2^(8*51) = 2^408 (NRED = 51: three guard limbs of
    headroom so lazy tower accumulations plus the kernel bias row stay < R*p)
  - values a are stored as a*R mod p ("Montgomery form")
"""

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

# ---------------------------------------------------------------------------
# Limb geometry
# ---------------------------------------------------------------------------

LIMB_BITS = 8
LIMB_BASE = 1 << LIMB_BITS  # 256
NLIMBS = 48  # canonical limbs per Fp element (384 bits >= 381)
#: Limbs of the Montgomery radix R = 2^(8*51) = 2^408. The 3 guard limbs of
#: headroom (R*p ~ 2^788.7) let the reduction kernels add a constant column-bias row
#: (a multiple of p with every digit >= 2^26, value ~2^786) that clears signed
#: columns *before* carry propagation — making every kernel digit provably
#: non-negative, which removes all data-dependent carry resolution (no scans,
#: no while loops) from the Montgomery reduction.
NRED = 51
R_BITS = LIMB_BITS * NRED  # 408

P = rm.P
R_MONT = 1 << R_BITS
R2 = R_MONT * R_MONT % P  # for to_mont: a*R = mont_mul(a, R^2)
PPRIME = (-pow(P, -1, R_MONT)) % R_MONT  # p' = -p^-1 mod R
ONE_MONT_INT = R_MONT % P


def int_to_limbs(x: int, n: int) -> np.ndarray:
    """Base-2^8 little-endian digits of x as int32; asserts x fits in n limbs."""
    assert 0 <= x < (1 << (LIMB_BITS * n)), "value does not fit in limbs"
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & (LIMB_BASE - 1)
        x >>= LIMB_BITS
    return out


def limbs_to_int(limbs) -> int:
    """Exact integer value of (possibly non-canonical, signed) limb columns."""
    acc = 0
    for i, v in enumerate(np.asarray(limbs).astype(object)):
        acc += int(v) << (LIMB_BITS * i)
    return acc


# ---------------------------------------------------------------------------
# Canonical limb tables
# ---------------------------------------------------------------------------

P_LIMBS = int_to_limbs(P, NLIMBS)
PPRIME_LIMBS = int_to_limbs(PPRIME, NRED)
R2_LIMBS = int_to_limbs(R2, NLIMBS)
ONE_MONT = int_to_limbs(ONE_MONT_INT, NLIMBS)
ZERO_LIMBS = np.zeros(NLIMBS, dtype=np.int32)

#: 2^392 - p, used by the conditional-subtract (res < 2p -> canonical) step.
CSUB_LIMBS = int_to_limbs(R_MONT - P, NRED)

# ---------------------------------------------------------------------------
# Relaxed negation constant: NEGC = 11*p written with 48 digits all in
# [255, 510], so that NEGC - a is limb-wise non-negative for any canonical a.
# neg_relaxed(a) = NEGC - a represents -a (mod p) with 9-bit limbs, no carries.
# ---------------------------------------------------------------------------


def _relaxed_digits(value: int, n: int) -> np.ndarray:
    base_floor = (1 << (LIMB_BITS * n)) - 1  # all-255 digits value
    w = value - base_floor
    assert 0 <= w <= base_floor + (1 << (LIMB_BITS * (n - 1)))  # representable
    digits = int_to_limbs(w, n) + 255
    assert limbs_to_int(digits) == value
    return digits.astype(np.int32)


#: Kernel outputs are weakly reduced: digits <= SEMI_DIG (not 255) and values
#: < SEMI_VAL (not p). All static bound tracking uses these.
SEMI_DIG = 258
#: Kernel outputs are < (BIAS/R ~ 0.64p) + (m*p/R < 1.01p) < 1.65p < 2p.
SEMI_VAL = 2 * P


def _dominating_multiple_of_p(floor_digit: int, n: int):
    """Smallest k with a length-n digit representation of k*p whose digits are
    all in [floor_digit, floor_digit + 255]."""
    base = floor_digit * (((1 << (LIMB_BITS * n)) - 1) // 255)
    k = -(-base // P)  # ceil
    while True:
        w = k * P - base
        if 0 <= w < (1 << (LIMB_BITS * n)):
            digits = int_to_limbs(w, n) + floor_digit
            if limbs_to_int(digits) == k * P:
                return k, digits.astype(np.int32)
        k += 1


NEG_K, NEGC_LIMBS = _dominating_multiple_of_p(SEMI_DIG + 1, NLIMBS)
assert NEGC_LIMBS.min() >= SEMI_DIG + 1 and NEGC_LIMBS.max() <= SEMI_DIG + 256

#: 2p digits, for the (total, not per-digit) complement in fp.neg.
TWOP_LIMBS = int_to_limbs(2 * P, NLIMBS)

# ---------------------------------------------------------------------------
# Kernel bias row: K_BIAS * p whose first NBIAS digits all lie in
# [BIAS_FLOOR, BIAS_FLOOR + 255]. Added to any signed-column Wide inside the
# reduction kernel, it makes every column non-negative while staying a
# multiple of p; value ~2^786 < R*p.
# ---------------------------------------------------------------------------

#: Floor 2^30 covers the deepest lazy tower combos (fused fq12 square:
#: cols > -3.14*2^28); 95 columns (= conv output width 2*NLIMBS-1) rather than
#: 96 keeps the bias VALUE tiny (~2^782 ~ 0.005*R*p; a 96th column would alone
#: add 2^(8*95)*floor ~ 2^790 and overflow the R*p ceiling).
BIAS_FLOOR = 1 << 30
NBIAS = 2 * NLIMBS - 1  # 95: all wides fed to reduction have <= 95 columns
K_BIAS, BIAS_DIGITS = _dominating_multiple_of_p(BIAS_FLOOR, NBIAS)
BIAS_VALUE = K_BIAS * P
assert BIAS_VALUE + 500 * P * P < (1 << R_BITS) * P, "bias exceeds R*p headroom"

#: Modulus for the exact low-part quotient test in the scan-free reduction:
#: the low NRED columns of t + m*p are congruent to 0 mod R and bounded in
#: (-eps, 1.01R), hence equal to 0 or R exactly; comparing their digit-weighted
#: sum mod M against R mod M distinguishes the two (M chosen odd so R mod M != 0).
QMOD = 65521
QMOD_WEIGHTS = np.array(
    [pow(2, LIMB_BITS * k, QMOD) if k < NRED else 0 for k in range(128)],
    dtype=np.int32,
)
R_MOD_QMOD = (1 << R_BITS) % QMOD
assert R_MOD_QMOD != 0

# ---------------------------------------------------------------------------
# Convolution matrices (exact small integers)
# ---------------------------------------------------------------------------


def onehot_conv_matrix(na: int, nb: int) -> np.ndarray:
    """S[(i*nb + j), k] = 1 iff i + j == k; conv(a,b) = outer(a,b).reshape @ S."""
    s = np.zeros((na * nb, na + nb - 1), dtype=np.float32)
    for i in range(na):
        for j in range(nb):
            s[i * nb + j, i + j] = 1.0
    return s


def toeplitz_conv_matrix(const_limbs: np.ndarray, n_in: int, n_out: int) -> np.ndarray:
    """T[i, k] = const[k - i]; x @ T = conv(x, const) truncated to n_out columns."""
    nc = len(const_limbs)
    t = np.zeros((n_in, n_out), dtype=np.float32)
    for i in range(n_in):
        for d in range(nc):
            if i + d < n_out:
                t[i, i + d] = float(const_limbs[d])
    return t


#: m = (T mod R) * p' mod R: (49 in) x (49 out) truncated Toeplitz.
TOEP_PPRIME_MODR = toeplitz_conv_matrix(PPRIME_LIMBS, NRED, NRED)
#: U = m * p: (49 in) x (96 out) full Toeplitz.
TOEP_P = toeplitz_conv_matrix(P_LIMBS, NRED, NRED + NLIMBS - 1)
#: x * (R mod p): embeds stored Montgomery limbs into the product-wide domain
#: (a conv-product of two stored values carries an extra R factor; multiplying
#: a lone stored value by R mod p matches that domain exactly).
TOEP_ONE_MONT = toeplitz_conv_matrix(ONE_MONT, NLIMBS, 2 * NLIMBS - 1)

# ---------------------------------------------------------------------------
# Frobenius coefficients in Montgomery limb form
#   gamma6_1 = xi^((p-1)/3), gamma6_2 = xi^((2p-2)/3), gamma12 = xi^((p-1)/6)
# Each is an Fq2 element -> shape (2, NLIMBS).
# ---------------------------------------------------------------------------


def fp_to_mont_limbs(x: int) -> np.ndarray:
    return int_to_limbs(x * R_MONT % P, NLIMBS)


def fq2_to_mont_limbs(x: rm.Fq2) -> np.ndarray:
    return np.stack([fp_to_mont_limbs(x.c0), fp_to_mont_limbs(x.c1)])


FROB_GAMMA6_1_MONT = fq2_to_mont_limbs(rm.FROB_GAMMA6_1[1])
FROB_GAMMA6_2_MONT = fq2_to_mont_limbs(rm.FROB_GAMMA6_2[1])
FROB_GAMMA12_MONT = fq2_to_mont_limbs(rm.FROB_GAMMA12[1])

#: Bits of BLS_X itself, MSB-first (for cyclotomic exponentiation by x;
#: reference miller_loop.rs:106-126).
BLS_X_BITS = np.array(
    [(BLS_X >> i) & 1 for i in range(BLS_X.bit_length() - 1, -1, -1)], dtype=np.int32
)
