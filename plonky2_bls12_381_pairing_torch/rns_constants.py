"""Generated tables for the RNS (residue number system) Fp tier.

The port's own copy of the JAX package's rns_constants.py: the same primes,
lane layout and tables, so both packages store bit-identical rows. Every lane
row is int32 (a torch op between an int32 and an int64 tensor promotes to
int64 and would stop wrapping like the reference's int32 arithmetic); the one
float row is the float32 Barrett reciprocal.

An Fp element is its residue vector modulo 63 independent 13-bit primes, one
residue per lane. It needs exactly SUB = 64 lanes (31 base-A + 31 base-B + 1
redundant + 1 alpha column), so every 128-lane row holds TWO batch elements
(PACK = 2). Every constant row is the 64-lane slot tiled twice; the extension
matrices are block-diagonal with two identical 64x64 blocks.

Math (RNS Montgomery reduction, Bajard et al. / Kawamura et al. style):

  Bases A = {a_1..a_31}, B = {b_1..b_31}, redundant channel m_r; all distinct
  13-bit primes. MA = prod(A) ~ 2^401 is the Montgomery radix: a stored field
  element x is represented by the residues of  v = x*MA mod p  (plus bounded
  multiples of p: v <= 4p), in ALL channels A+B+r.

  REDC(X) for 0 <= X < MA*p returns V = X/MA + k*p with V == X*MA^{-1}
  (mod p), V < 3p:
    1. sigma_i = X * (-p^{-1}) * (MA/a_i)^{-1} mod a_i          (base A)
    2. extend q = -X p^{-1} mod MA to B+r by a constant matrix product;
       alpha_hat = floor(sum_i sigma_i/a_i) rides an extra matrix column
       holding floor(2^ALPHA_T/a_i) (Kawamura fixed point, may undershoot
       by 1, which adds p to the result).
    3. r_j = (X_j + q_hat_j * p) * MA^{-1} mod m_j              (B+r)
    4. extend r back to A exactly via a second fixed-point column
       (beta_hat = floor(sum_j sigma'_j/b_j + 1/2), exact because r < 3p).

Exactness invariants (asserted below and at use sites):
  * channel products of canonical residues < 2^26 (int32-exact);
  * plane matmuls: 7/6-bit planes, <= 31 terms of <= 190*190 -> f32-exact;
  * Barrett: |x| < 2^31 - 2^27 -> one round-mult-sub lands in (-m, m);
  * Kawamura fixed point: NCH * 2^PRIME_BITS < 2^ALPHA_T.
"""

from __future__ import annotations

import numpy as np

from .utils import refmodel as rm

LANES = 128
SUB = 64          # lanes per packed element slot
PACK = 2          # elements per 128-lane row
NCH = 31          # channels per base
PRIME_BITS = 13   # channel residues fit 13 bits (plane-split geometry)
#: Primes are capped BELOW 2^13 at 7168 (~2^12.8): the extra headroom keeps
#: the deepest lazy Karatsuba combinations of the Fq6/Fq12 tower inside
#: int32 (with 8191-max primes the fq6 interpolation combine reaches
#: +-2.2e9 > 2^31; with 7167-max it stays under +-1.7e9).
PRIME_MAX = 7168
# slot-local lane layout
A_LO, A_HI = 0, 31       # base-A lanes
B_LO, B_HI = 31, 62      # base-B lanes
R_LANE = 62              # redundant channel lane
ALPHA_LANE = 63          # fixed-point alpha column (matmul output only)
ALPHA_T = 18             # Kawamura fixed-point fractional bits (step 2, +-1 ok)
BETA_T = 20              # step-4 fixed-point bits (exact: see docstring)
PLANE_BITS = 7           # extension-matmul plane split (lo 7 bits, hi 6)

P = rm.P


def _gen_primes(n: int, below: int) -> list[int]:
    """Largest n primes below `below`."""
    primes = []
    x = below - 1
    while len(primes) < n:
        is_p = x > 1 and all(x % d for d in range(2, int(x**0.5) + 1))
        if is_p:
            primes.append(x)
        x -= 1
    return primes

_ALL_PRIMES = _gen_primes(2 * NCH + 1, PRIME_MAX)
A_PRIMES = _ALL_PRIMES[0:NCH]
B_PRIMES = _ALL_PRIMES[NCH:2 * NCH]
M_R = _ALL_PRIMES[2 * NCH]

MA = 1
for _a in A_PRIMES:
    MA *= _a
MB = 1
for _b in B_PRIMES:
    MB *= _b

#: Stored elements are redundantly reduced: value <= STORED_BOUND. REDC
#: outputs are < 3p; stored negation (4p - x) can reach exactly 4p (x = 0).
STORED_BOUND = 4 * P
#: REDC input ceiling: X < MA*p ensures output < X/MA + 2p < 3p.
REDC_MAX = MA * P - 1

assert MA > 1000 * P, "base A too small for lazy tower accumulations"
assert MB > STORED_BOUND, "Shenoy-Kumaresan requires r < MB"
assert M_R > 2 * NCH, "redundant channel must exceed the max wrap count"
#: Barrett exactness (ops/rns/fp.py _BARRETT_DOM derivation) needs the f32
#: quotient error under 0.6, which requires every modulus >= 3557.
assert min(A_PRIMES + B_PRIMES + [M_R]) >= 3557
#: Kawamura undershoot: alpha_hat in {alpha-1, alpha} requires the total
#: fixed-point truncation (< NCH * max_sigma) below one unit, i.e. 2^ALPHA_T.
assert NCH * PRIME_MAX < (1 << ALPHA_T), "alpha fixed point too coarse"
#: Step-4 beta exactness: beta_hat = floor(beta + r/MB - err + 1/2) equals
#: beta iff err < 1/2 (fixed-point truncation, < NCH*PRIME_MAX/2^BETA_T) and
#: r/MB < 1/2 (wrap-boundary margin; r < 3p).
assert NCH * PRIME_MAX < (1 << (BETA_T - 1)), "beta fixed point too coarse"
assert 6 * P < MB, "beta wrap-boundary margin"

#: Slot-local moduli (padding lane ALPHA_LANE gets modulus 1: residues stay 0
#: under every op, including Barrett with 1/m = 1).
MODULI_SLOT = np.ones(SUB, dtype=np.int64)
MODULI_SLOT[A_LO:A_HI] = A_PRIMES
MODULI_SLOT[B_LO:B_HI] = B_PRIMES
MODULI_SLOT[R_LANE] = M_R
MODULI = np.tile(MODULI_SLOT, PACK).astype(np.int32)
M_I32 = MODULI
INV_M_F32 = (1.0 / MODULI_SLOT.astype(np.float64)).astype(np.float32)
INV_M_F32 = np.tile(INV_M_F32, PACK)

#: Boolean lane masks (full-row).
_IS_A_S = np.zeros(SUB, dtype=bool); _IS_A_S[A_LO:A_HI] = True
_IS_B_S = np.zeros(SUB, dtype=bool); _IS_B_S[B_LO:B_HI] = True
_IS_BR_S = _IS_B_S.copy(); _IS_BR_S[R_LANE] = True
IS_A = np.tile(_IS_A_S, PACK)
IS_B = np.tile(_IS_B_S, PACK)
IS_BR = np.tile(_IS_BR_S, PACK)
IS_CH = IS_A | IS_BR  # all real channels
#: First/second slot masks (for per-slot alpha/beta correction rows).
SLOT_MASKS = np.stack([
    np.arange(LANES) // SUB == k for k in range(PACK)
])


def residues_slot(v: int) -> np.ndarray:
    """(SUB,) residue slot of a non-negative integer (alpha lane 0)."""
    out = np.zeros(SUB, dtype=np.int32)
    for i in range(SUB):
        if MODULI_SLOT[i] > 1:
            out[i] = v % int(MODULI_SLOT[i])
    return out


def residues(v: int) -> np.ndarray:
    """Full 128-lane row: the residue slot tiled over both packed slots."""
    return np.tile(residues_slot(v), PACK)


def encode_int_slot(x: int) -> np.ndarray:
    """Field element x -> residue slot of its Montgomery form x*MA mod p."""
    return residues_slot(x % P * MA % P)


def encode_int(x: int) -> np.ndarray:
    """Full-row encoding: the same element in both packed slots (constants)."""
    return np.tile(encode_int_slot(x), PACK)


def decode_int_slot(slot_row) -> int:
    """Residue slot (canonical, value < MA) -> field element (CRT, base A)."""
    row = np.asarray(slot_row)
    v = 0
    for i in range(NCH):
        a = A_PRIMES[i]
        mi = MA // a
        v += int(row[A_LO + i]) * pow(mi, -1, a) % a * mi
    v %= MA
    return v * pow(MA, -1, P) % P


# ---------------------------------------------------------------------------
# Step-1/3 per-lane constant rows (slot-built, tiled)
# ---------------------------------------------------------------------------

def _lane_row(fn) -> np.ndarray:
    out = np.zeros(SUB, dtype=np.int32)
    for i in range(SUB):
        if MODULI_SLOT[i] > 1:
            out[i] = fn(i, int(MODULI_SLOT[i]))
    return np.tile(out, PACK)

#: sigma constant on A lanes: (-p^{-1} * (MA/a_i)^{-1}) mod a_i.
C_SIGMA = _lane_row(
    lambda i, m: (-pow(P, -1, m) * pow(MA // m, -1, m)) % m if _IS_A_S[i] else 0
)
#: MA^{-1} mod m on B+r lanes (step 3).
C_MAINV = _lane_row(lambda i, m: pow(MA % m, -1, m) if _IS_BR_S[i] else 0)
#: p * MA^{-1} mod m on B+r lanes (step 3, folded with q_hat).
C_PMAINV = _lane_row(lambda i, m: P * pow(MA % m, -1, m) % m if _IS_BR_S[i] else 0)
#: MA mod m on B+r lanes (alpha correction), masked per slot.
C_MAMOD = _lane_row(lambda i, m: MA % m if _IS_BR_S[i] else 0)
C_MAMOD_BY_SLOT = np.stack([C_MAMOD * SLOT_MASKS[k] for k in range(PACK)]).astype(np.int32)
#: Step-4 sigma' folded constants on B lanes: sigma'_j = r_j*(MB/b_j)^{-1}
#: = (X*MA^{-1} + q_hat*p*MA^{-1})*(MB/b_j)^{-1} mod b_j, computed directly
#: from (X, q_hat) so step 3's r needs no dedicated canonicalization.
C_MAINV_MBINV = _lane_row(
    lambda i, m: pow(MA % m, -1, m) * pow(MB // m, -1, m) % m
    if _IS_B_S[i] else 0)
C_PMAINV_MBINV = _lane_row(
    lambda i, m: P * pow(MA % m, -1, m) * pow(MB // m, -1, m) % m
    if _IS_B_S[i] else 0)
#: MB mod m on A lanes (beta correction), masked per slot.
C_MBMOD = _lane_row(lambda i, m: MB % m if _IS_A_S[i] else 0)
C_MBMOD_BY_SLOT = np.stack([C_MBMOD * SLOT_MASKS[k] for k in range(PACK)]).astype(np.int32)

# ---------------------------------------------------------------------------
# Base-extension matrices: 64x64 slot blocks, block-diagonal over both slots
# ---------------------------------------------------------------------------

def _block_diag(blk: np.ndarray) -> np.ndarray:
    out = np.zeros((LANES, LANES), dtype=np.int32)
    for k in range(PACK):
        out[k * SUB : (k + 1) * SUB, k * SUB : (k + 1) * SUB] = blk
    return out

#: T1[i, j] = (MA/a_i) mod m_j for i in A, j in B+r; column ALPHA_LANE holds
#: floor(2^T / a_i) (the Kawamura fixed-point weights).
_T1_BLK = np.zeros((SUB, SUB), dtype=np.int32)
for _i in range(NCH):
    _a = A_PRIMES[_i]
    _mai = MA // _a
    for _j in range(SUB):
        if _IS_BR_S[_j]:
            _T1_BLK[A_LO + _i, _j] = _mai % int(MODULI_SLOT[_j])
    _T1_BLK[A_LO + _i, ALPHA_LANE] = (1 << ALPHA_T) // _a
assert _T1_BLK.max() < (1 << PRIME_BITS)
T1 = _block_diag(_T1_BLK)

#: T2[j, i] = (MB/b_j) mod m_i for j in B, i in A; column ALPHA_LANE holds
#: floor(2^BETA_T / b_j) (the exact Kawamura beta weights, see docstring).
_T2_BLK = np.zeros((SUB, SUB), dtype=np.int32)
for _j in range(NCH):
    _b = B_PRIMES[_j]
    _mbj = MB // _b
    for _i in range(NCH):
        _T2_BLK[B_LO + _j, A_LO + _i] = _mbj % A_PRIMES[_i]
    _T2_BLK[B_LO + _j, ALPHA_LANE] = (1 << BETA_T) // _b
assert _T2_BLK.max() < (1 << PRIME_BITS)
T2 = _block_diag(_T2_BLK)

#: RNS -> positional bridge (ops/rns/fp.py to_limbs): per slot, digit column
#: j < CRT_DIGITS holds the j-th radix-256 digit of (MA/a_i), and column
#: ALPHA_LANE the Kawamura weight floor(2^BETA_T/a_i), so one extension-style
#: matmul gives the lazy positional digits of sum_i c_i*(MA/a_i) and its
#: exact wrap count over MA (exact for values < MA/2, as beta is).
#: 51 digits cover the intermediate before the wrap (< 31*MA < 2^408).
CRT_DIGITS = 51
_CRT_BLK = np.zeros((SUB, SUB), dtype=np.int32)
for _i in range(NCH):
    _a = A_PRIMES[_i]
    _mai = MA // _a
    for _j in range(CRT_DIGITS):
        _CRT_BLK[A_LO + _i, _j] = (_mai >> (8 * _j)) & 0xFF
    _CRT_BLK[A_LO + _i, ALPHA_LANE] = (1 << BETA_T) // _a
assert _CRT_BLK.max() <= 255 and (31 * MA) < (1 << (8 * CRT_DIGITS))
CRT = _block_diag(_CRT_BLK)
#: CRT coefficient constant: (MA/a_i)^{-1} mod a_i on A lanes.
C_CRT_CINV = _lane_row(lambda i, m: pow(MA // m, -1, m) if _IS_A_S[i] else 0)
#: Radix-256 digits of MA (the k*MA wrap subtraction).
MA_DIGITS = np.array([(MA >> (8 * _j)) & 0xFF for _j in range(CRT_DIGITS)],
                     dtype=np.int32)

_PLANE_MASK = (1 << PLANE_BITS) - 1


def plane_split(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """13-bit matrix -> (lo, hi) 7/6-bit planes (exact float32 matmul operands)."""
    return (mat & _PLANE_MASK).astype(np.int32), (mat >> PLANE_BITS).astype(np.int32)

T1_LO, T1_HI = plane_split(T1)
T2_LO, T2_HI = plane_split(T2)
CRT_LO, CRT_HI = plane_split(CRT)
# Karatsuba plane combine uses (lo + hi): entries <= 190.
T1_SUM = T1_LO + T1_HI
T2_SUM = T2_LO + T2_HI
CRT_SUM = CRT_LO + CRT_HI
# f32 accumulation bound: <= NCH terms of <= 190*190.
assert NCH * 190 * 190 < (1 << 24)

# ---------------------------------------------------------------------------
# Bias rows: residues of k*p, added to possibly-negative lazy accumulations
# before REDC so the represented value is provably >= 0 (the RNS analogue of
# constants.BIAS_DIGITS).
# ---------------------------------------------------------------------------

_PMULT_CACHE: dict[int, np.ndarray] = {}


def p_mult_row(k: int) -> np.ndarray:
    """Residue row of k*p (k >= 0)."""
    if k not in _PMULT_CACHE:
        _PMULT_CACHE[k] = residues(k * P)
    return _PMULT_CACHE[k]


# ---------------------------------------------------------------------------
# Field constants in RNS Montgomery form
# ---------------------------------------------------------------------------

ONE = encode_int(1)

#: Residues of (MA mod p): multiplying a stored element (value x*MA) by this
#: row lifts it into the conv-product domain (value ~ x*MA^2 mod-p-wise), so
#: it can be mixed with products of two stored elements before the one REDC —
#: the RNS analogue of the limb tier's TOEP_ONE_MONT (constants.py).
MA_MODP_INT = MA % P
MA_MODP_ROW = residues(MA_MODP_INT)

#: Residue rows of k*p, k = 0..4: a stored element (<= 4p) is zero mod p iff
#: its canonical residue slot equals one of these on every channel lane.
ZERO_TEST_ROWS = np.stack([residues(k * P) for k in range(5)])
#: Rows of k*p, k = 0..8: for is_equal's difference test (a - b + 4p in [0, 8p]).
EQ_TEST_ROWS = np.stack([residues(k * P) for k in range(9)])
