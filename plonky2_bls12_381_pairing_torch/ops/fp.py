"""Limb-vectorized Fp (BLS12-381 base field) arithmetic in PyTorch: the limb
tier of the port, the counterpart of the JAX package's ops/fp.py.

An Fp element is a vector of 48 radix-2^8 limbs (int32) in Montgomery form
(a*R mod p, R = 2^408), with a trailing limb axis so every operation batches
over arbitrary leading axes. Every function gives the rows the JAX function
of the same name gives on the CPU.

  * Multiplication is a 48 x 48 limb convolution into 95 signed int32
    "columns" (class Wide) that are added and subtracted lazily, with one
    Montgomery reduction per output element.
  * The reduction is scan-free wherever the tracked bounds allow it: a
    constant bias row (a multiple of p) makes every column non-negative, a
    static number of shift-add passes replaces carry resolution, and the
    quotient bit of the low half is decided mod 65521. Its output is weakly
    reduced (digits <= SEMI_DIG, value < SEMI_VAL). The exact path (canonical
    digits, conditional subtraction) serves the few inputs outside those
    bounds, and add / neg / canonicalize.
  * Stored elements are weakly reduced; equality, sign and export sites
    canonicalize first.

  * Independent products are formed together: a product's operand half
    (Products: its ConvPairs and the combine of their Wides) is gathered
    with others and formed by one conv_many, one kernel launch on the card
    for every group that no reduction separates (fq12.mul's 63 products).

Strategy (set_strategy), one switch for the tier:
  "auto" / "kernels"  on a CUDA tensor conv / conv_many (48 x 48),
                      mont_reduce (<= 95 columns), mont_mul and pow_static
                      (as one mont_pow) launch the CUDA kernels of
                      ops/kernels/mont.py; on a CPU tensor the same
                      functions run their plain versions here. The fused
                      mont_mul gives the rows of mont_reduce(conv(a, b)),
                      mont_pow those of pow_static's chain of mont_mul.
  "plain"             plain PyTorch on either device.
  "fused"             additionally fq12.mul / square / mul_by_014 /
                      cyclotomic_square run the tower kernels of
                      ops/kernels/tower.py (their plain versions on the CPU).
Dispatch is on the tensor's device; there is no fallback between the two.

Exactness invariants (asserted statically via tracked bounds):
  conv operands a, b satisfy  min(na, nb) * max(a) * max(b) < 2^31
  every Wide fed to mont_reduce satisfies  0 <= value + bias < R*p.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C
from .rns.fp import resolve_device

NLIMBS = C.NLIMBS  # 48
NRED = C.NRED  # 51
LIMB_BITS = C.LIMB_BITS
MASK = C.LIMB_BASE - 1  # 255

_I32_EXACT = 1 << 31
#: integers below 2^53 are exact in the float64 matmuls of the constant
#: (Toeplitz) products
_F64_EXACT = 1 << 53

STRATEGIES = ("auto", "kernels", "plain", "fused")
_STRATEGY = "auto"


def set_strategy(mode: str) -> None:
    global _STRATEGY
    if mode not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {mode!r}")
    _STRATEGY = mode


def get_strategy() -> str:
    return _STRATEGY


def _use_kernels(t: torch.Tensor) -> bool:
    """The conv / mont_reduce / mont_mul / mont_pow wrappers take every
    tensor that is not on the CPU (they launch on CUDA and refuse any other
    device)."""
    return _STRATEGY != "plain" and t.device.type != "cpu"


def use_fused() -> bool:
    return _STRATEGY == "fused"


# value-level bounds (exact Python ints, statically tracked)
_P = C.P
_RP = (1 << C.R_BITS) * _P  # Montgomery input ceiling

#: Stored elements are *weakly reduced*: digits <= SEMI_DIG, value < SEMI_VAL.
SEMI_DIG = C.SEMI_DIG  # 258
SEMI_VAL = C.SEMI_VAL  # 2p

# derived digit-widths of the Montgomery pipeline (for NRED = 51: 99 / 100)
_NT = -(-(C.R_BITS + 381) // LIMB_BITS)  # digits holding T < R*p
_NS = _NT + 1  # digits holding T + m*p < 2*R*p

_CONSTS: dict = {}


def const(name: str, device, dtype=torch.int32) -> torch.Tensor:
    """A constant table of this module (_TABLES) as a tensor on `device`."""
    key = (name, torch.device(device), dtype)
    if key not in _CONSTS:
        _CONSTS[key] = torch.from_numpy(np.ascontiguousarray(_TABLES[name])).to(
            device=device, dtype=dtype)
    return _CONSTS[key]


# ---------------------------------------------------------------------------
# Host-side encode/decode
# ---------------------------------------------------------------------------


def encode(values, mont: bool = True) -> np.ndarray:
    """Python ints (nested lists ok) -> limb array (..., NLIMBS), Montgomery form."""
    arr = np.asarray(values, dtype=object)
    out = np.zeros(arr.shape + (NLIMBS,), dtype=np.int32)
    for idx in np.ndindex(arr.shape):
        v = int(arr[idx]) % _P
        if mont:
            v = v * (1 << C.R_BITS) % _P
        out[idx] = C.int_to_limbs(v, NLIMBS)
    return out


def decode(limbs, mont: bool = True):
    """Limb tensor or array (..., NLIMBS) -> object ndarray of Python ints
    (standard form)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs)
    shape = arr.shape[:-1]
    out = np.empty(shape, dtype=object)
    rinv = pow(1 << C.R_BITS, -1, _P)
    for idx in np.ndindex(shape):
        v = C.limbs_to_int(arr[idx])
        if mont:
            v = v * rinv % _P
        out[idx] = v
    return out if shape else out[()]


def to_tensor(arr, device=None) -> torch.Tensor:
    """Encoded limbs (numpy) as an int32 tensor on the entry point's device:
    CUDA unless the caller names another."""
    a = np.array(arr, dtype=np.int32, order="C")
    return torch.from_numpy(a).to(resolve_device(device))


# ---------------------------------------------------------------------------
# Wide: lazy signed-column accumulator with static bounds
# ---------------------------------------------------------------------------


@dataclass
class Wide:
    """Unreduced value as signed int32 columns: value = sum cols[i] * 2^(8i).

    Static metadata (exact Python-int bounds) rides along so every operation
    can assert the int32 exactness invariants.
    """

    cols: torch.Tensor  # (..., K) int32
    col_lo: int  # per-column lower bound
    col_hi: int  # per-column upper bound
    val_lo: int  # value lower bound
    val_hi: int  # value upper bound

    @property
    def ncols(self) -> int:
        return self.cols.shape[-1]

    def __add__(self, o: "Wide") -> "Wide":
        a, b = _pad_match(self.cols, o.cols)
        return Wide(a + b, self.col_lo + o.col_lo, self.col_hi + o.col_hi,
                    self.val_lo + o.val_lo, self.val_hi + o.val_hi)

    def __sub__(self, o: "Wide") -> "Wide":
        a, b = _pad_match(self.cols, o.cols)
        return Wide(a - b, self.col_lo - o.col_hi, self.col_hi - o.col_lo,
                    self.val_lo - o.val_hi, self.val_hi - o.val_lo)

    def double(self) -> "Wide":
        return self.scale_small(2)

    def scale_small(self, k: int) -> "Wide":
        """Multiply by a small static non-negative integer (column scaling)."""
        assert k >= 0
        return Wide(self.cols * k, k * self.col_lo, k * self.col_hi,
                    k * self.val_lo, k * self.val_hi)

    def shift_bias(self, k_p2: int) -> "Wide":
        """Add the constant k_p2 * p^2 (a multiple of p) to make the value
        non-negative before Montgomery reduction."""
        v = k_p2 * _P * _P
        ncols = max(self.ncols, (v.bit_length() + LIMB_BITS - 1) // LIMB_BITS)
        return self + _wide_const(v, ncols, self.cols.device)


def _pad_match(a: torch.Tensor, b: torch.Tensor):
    k = max(a.shape[-1], b.shape[-1])
    return _pad_to(a, k), _pad_to(b, k)


def _pad_to(x: torch.Tensor, k: int) -> torch.Tensor:
    if x.shape[-1] == k:
        return x
    return F.pad(x, (0, k - x.shape[-1]))


def _wide_const(value: int, ncols: int, device) -> Wide:
    limbs = C.int_to_limbs(value, ncols)
    return Wide(torch.from_numpy(limbs).to(device), 0, int(limbs.max()), value, value)


# ---------------------------------------------------------------------------
# Convolution (limb products)
# ---------------------------------------------------------------------------


def conv_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[k] = sum_i a[i] * b[k - i] in int32: the plain contraction (a
    against the sliding windows of the zero-padded b). Exact while
    min(na, nb) * a_max * b_max < 2^31; batch axes broadcast."""
    na, nb = a.shape[-1], b.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(*batch, na)
    b = b.expand(*batch, nb)
    # windows[j, k] = b[k - (na - 1 - j)], zero outside b
    windows = F.pad(b, (na - 1, na - 1)).unfold(-1, na + nb - 1, 1)
    return (a.flip(-1).unsqueeze(-1) * windows).sum(-2, dtype=torch.int32)


class ConvPair(NamedTuple):
    """The operands of one product, non-negative int32 limbs a (..., na) and
    b (..., nb), with their digit and value bounds."""

    a: torch.Tensor
    b: torch.Tensor
    a_max: int = SEMI_DIG
    b_max: int = SEMI_DIG
    a_val: int = SEMI_VAL
    b_val: int = SEMI_VAL


def conv_many(pairs: Sequence[ConvPair]) -> list[Wide]:
    """Variable x variable limb convolutions of independent products, each
    accumulated exactly in int32 (asserted from its operands' digit bounds)
    and returned as a Wide with its own bounds. Under the kernels strategy
    the 48 x 48 pairs on the card go to one conv_many launch (per batch
    shape); the others, and every pair on the CPU, to conv_cols."""
    cols: list = [None] * len(pairs)
    col_hi, kernel = [], []
    for j, p in enumerate(pairs):
        na, nb = p.a.shape[-1], p.b.shape[-1]
        col_hi.append(min(na, nb) * p.a_max * p.b_max)
        assert col_hi[-1] < _I32_EXACT, (
            f"int32 exactness violated: {min(na, nb)}*{p.a_max}*{p.b_max} >= 2^31")
        if _use_kernels(p.a) and na == NLIMBS and nb == NLIMBS:
            kernel.append(j)
        else:
            cols[j] = conv_cols(p.a, p.b)
    if kernel:
        from .kernels import mont as _km

        for j, c in zip(kernel, _km.conv_many([pairs[j][:2] for j in kernel])):
            cols[j] = c
    return [Wide(c, 0, hi, 0, p.a_val * p.b_val) for c, hi, p in zip(cols, col_hi, pairs)]


def conv(a: torch.Tensor, b: torch.Tensor, a_max: int = SEMI_DIG, b_max: int = SEMI_DIG,
         a_val: int = SEMI_VAL, b_val: int = SEMI_VAL) -> Wide:
    """Variable x variable limb convolution: one ConvPair's Wide."""
    return conv_many([ConvPair(a, b, a_max, b_max, a_val, b_val)])[0]


class Products(NamedTuple):
    """Independent products not yet formed: their operand pairs, and the
    combine that turns their Wides (in the pairs' order) into a result."""

    pairs: tuple
    combine: Callable


def gather(parts: Sequence[Products], combine: Callable = list) -> Products:
    """Several parts' products as one group: `combine` receives the list of
    the parts' results."""
    def combine_parts(wides):
        results, i = [], 0
        for part in parts:
            results.append(part.combine(wides[i:i + len(part.pairs)]))
            i += len(part.pairs)
        return combine(results)

    return Products(tuple(x for part in parts for x in part.pairs), combine_parts)


def form(*parts: Products) -> list:
    """Form the products of every part in one conv_many call (one kernel
    launch on the card); the parts' results, in order."""
    group = gather(parts)
    return group.combine(conv_many(group.pairs))


def conv_const(x: torch.Tensor, name: str, x_max: int, n_const_terms: int) -> torch.Tensor:
    """x (..., n_in) times a constant, as a product with the constant's
    Toeplitz matrix _TABLES[name]. The float64 matmul is exact: every sum is
    an integer below 2^53 (asserted), whatever TF32 setting is in force."""
    nterms = min(x.shape[-1], n_const_terms)
    assert nterms * x_max * 255 < _F64_EXACT
    return (x.to(torch.float64) @ const(name, x.device, torch.float64)).to(torch.int32)


# ---------------------------------------------------------------------------
# Carry normalization
# ---------------------------------------------------------------------------


def _passes_needed(lo: int, hi: int) -> int:
    n = 0
    while lo < -1 or hi > 256:
        # after one pass: col in [min(0, lo>>8), 255 + max(0, hi>>8)]
        lo, hi = min(0, lo >> LIMB_BITS), 255 + max(0, hi >> LIMB_BITS)
        n += 1
        assert n < 8, "unbounded normalize"
    return n


def _carry_compose_table() -> np.ndarray:
    """A column with digit v in [-1, 256] maps its carry-in c in {-1, 0, 1}
    to the carry-out (v + c) >> 8: a monotone map of three states, coded as
    (f(-1) + 1) + 3 (f(0) + 1) + 9 (f(1) + 1). Entry [l * 27 + r] is the code
    of "l, then r"."""
    def fn(code):
        return [code % 3 - 1, code // 3 % 3 - 1, code // 9 - 1]

    t = np.zeros(27 * 27, dtype=np.int32)
    for l in range(27):
        for r in range(27):
            fl, fr = fn(l), fn(r)
            out = [fr[fl[x] + 1] for x in range(3)]
            t[l * 27 + r] = (out[0] + 1) + 3 * (out[1] + 1) + 9 * (out[2] + 1)
    return t


_CARRY_IDENT = 0 + 3 * 1 + 9 * 2  # the map c -> c


def _carry_scan(v: torch.Tensor):
    """Resolve residual carries for columns v in [-1, 256] by a carry
    lookahead over the three-state maps: a log-step prefix composition
    (each step composes every column's map with the one 2^k columns below).
    Returns (carry_in, carry_out_total). Integers are exact, so the digits
    are those of any other exact carry resolution."""
    code = (((v - 1) >> LIMB_BITS) + 1) + 3 * ((v >> LIMB_BITS) + 1) \
        + 9 * (((v + 1) >> LIMB_BITS) + 1)
    table = const("CARRY_COMPOSE", v.device)
    d = 1
    while d < v.shape[-1]:
        left = F.pad(code[..., :-d], (d, 0), value=_CARRY_IDENT)
        code = table[left * 27 + code]
        d *= 2
    g0 = torch.div(code, 3, rounding_mode="floor") % 3 - 1  # the prefix map at carry 0
    return F.pad(g0[..., :-1], (1, 0)), g0[..., -1]


def _shift_up(carry: torch.Tensor) -> torch.Tensor:
    """Move per-column carries one column up; the top carry is dropped (callers
    guarantee it is zero via guard columns, or want mod-2^(8K) semantics)."""
    return F.pad(carry[..., :-1], (1, 0))


def _normalize_cols(cols: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Shift-add passes + the carry lookahead. Exact modulo 2^(8K) where
    K = cols.shape[-1] (top carries are dropped). `>>` on int32 is arithmetic
    and `&` two's-complement, so negative columns borrow correctly."""
    for _ in range(_passes_needed(lo, hi)):
        cols = (cols & MASK) + _shift_up(cols >> LIMB_BITS)
        lo, hi = min(0, lo >> LIMB_BITS), 255 + max(0, hi >> LIMB_BITS)
    if lo < 0 or hi > 255:
        carry_in, _ = _carry_scan(cols)
        cols = (cols + carry_in) & MASK
    return cols


#: Guard columns appended inside normalize so intermediate carries compensated
#: by negative lower columns are never dropped (col_hi < 2^26 -> carries fit).
_GUARD = 3


def normalize(w: Wide, nout: int) -> torch.Tensor:
    """Exact canonical base-256 digits of w's value, as (..., nout) int32.

    Requires 0 <= value < 2^(8*nout) (asserted from static bounds).
    """
    assert w.val_lo >= 0, f"normalize of possibly-negative value (lo={w.val_lo})"
    assert w.val_hi < 1 << (LIMB_BITS * nout), "normalize output width too small"
    assert -(1 << 30) < w.col_lo and w.col_hi < 1 << 30, "column bounds exceed int32 safety"
    if w.ncols > nout:
        raise ValueError("normalize cannot truncate columns")
    cols = _pad_to(w.cols, nout + _GUARD)
    return _normalize_cols(cols, w.col_lo, w.col_hi)[..., :nout]


def normalize_mod_r(w: Wide, nout: int) -> torch.Tensor:
    """Canonical digits of (value mod 2^(8*nout)): carries beyond column
    nout-1 are discarded, which is exactly the modular truncation."""
    cols = _pad_to(w.cols, nout)[..., :nout]
    return _normalize_cols(cols, w.col_lo, w.col_hi)


# ---------------------------------------------------------------------------
# Montgomery reduction and multiplication
# ---------------------------------------------------------------------------


def semi_pass_count(lo: int, hi: int) -> int:
    """Static shift-add passes until digits lie in [0, 257] (non-negative
    inputs). The count is part of the result: a further pass on digits
    already in range can change the stored representative."""
    n = 0
    while lo < -1 or hi > 257:
        lo, hi = min(0, lo >> LIMB_BITS), 255 + max(0, hi >> LIMB_BITS)
        n += 1
        assert n < 9
    return n


def _semi_passes(cols: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Static shift-add passes; value-preserving mod 2^(8*K). No carry scan."""
    for _ in range(semi_pass_count(lo, hi)):
        cols = (cols & MASK) + _shift_up(cols >> LIMB_BITS)
    return cols


def _bias_cols() -> np.ndarray:
    """BIAS_DIGITS (K_BIAS * p, digits >= 2^30 on the first NBIAS columns)
    padded to the _NS-column working width of the scan-free reduction."""
    out = np.zeros(_NS, dtype=np.int32)
    out[: C.NBIAS] = C.BIAS_DIGITS
    return out


_TABLES = {
    "P": C.P_LIMBS,
    "CSUB": C.CSUB_LIMBS,
    "NEGC": C.NEGC_LIMBS,
    "TWOP": C.TWOP_LIMBS,
    "ONE_MONT": C.ONE_MONT,
    "R2": C.R2_LIMBS,
    "TOEP_PPRIME": C.TOEP_PPRIME_MODR,
    "TOEP_P": C.TOEP_P,
    "TOEP_ONE_MONT": C.TOEP_ONE_MONT,
    "BIAS": _bias_cols(),
    # digit weights 2^(8k) mod QMOD, k < NRED
    "QW": C.QMOD_WEIGHTS[:_NS].copy(),
    "CARRY_COMPOSE": _carry_compose_table(),
}


def scanfree_bounds_ok(ncols: int, col_lo: int, col_hi: int, val_lo: int,
                       val_hi: int) -> bool:
    """What the scan-free reduction (and its kernel) requires of its input."""
    return (
        ncols <= C.NBIAS
        and val_lo > -C.BIAS_VALUE
        and val_hi + C.BIAS_VALUE < _RP
        and -C.BIAS_FLOOR < col_lo
        and col_hi + C.BIAS_FLOOR + 255 < (1 << 31)  # cols+bias stay int32
    )


def _scanfree_ok(w: Wide) -> bool:
    return scanfree_bounds_ok(w.ncols, w.col_lo, w.col_hi, w.val_lo, w.val_hi)


def mont_reduce_scanfree(cols: torch.Tensor, col_lo: int, col_hi: int) -> torch.Tensor:
    """Scan-free Montgomery reduction of (..., K <= 95) signed columns, the
    plain version of the mont_reduce kernel (bit-identical): the constant
    bias row K_BIAS*p clears column- and value-level negativity, static
    shift-add passes replace the carry lookahead, the two constant products
    are exact matmuls, and the low-part quotient (provably 0 or R) is decided
    by a digit-weighted sum mod 65521. Output is weakly reduced: digits <=
    SEMI_DIG (258), value < SEMI_VAL."""
    dev = cols.device
    t = _semi_passes(_pad_to(cols, _NS) + const("BIAS", dev), min(col_lo, 0),
                     col_hi + C.BIAS_FLOOR + 255)
    m = conv_const(t[..., :NRED], "TOEP_PPRIME", 257, NRED)
    m = _semi_passes(m, 0, NRED * 257 * 255)  # top carries drop: mod R, exact
    u = conv_const(m, "TOEP_P", 257, NLIMBS)
    s = _semi_passes(t + _pad_to(u, _NS), 0, 257 + NRED * 257 * 255)
    qsum = (s * const("QW", dev)).sum(-1, dtype=torch.int32)
    q = ((qsum % C.QMOD) == C.R_MOD_QMOD).to(torch.int32)
    res = s[..., NRED: NRED + NLIMBS].clone()
    res[..., 0] += q
    return res


def _cond_subtract_p(res: torch.Tensor) -> torch.Tensor:
    """res (..., n) canonical limbs, value < 2p: return canonical value mod p."""
    n = res.shape[-1]
    csub = _pad_to(const("CSUB", res.device), max(NRED, n))
    d_w = Wide(_pad_to(res, max(NRED, n)) + csub, 0, 511,
               (1 << C.R_BITS) - _P, (1 << C.R_BITS) + 2 * _P)
    d = normalize(d_w, NRED + 1)
    ge = d[..., NRED:NRED + 1]  # 1 iff res >= p
    return torch.where(ge == 1, d[..., :NLIMBS], res[..., :NLIMBS])


def mont_reduce(w: Wide) -> torch.Tensor:
    """Montgomery reduction: value*R^-1 mod p as 48 limbs, weakly reduced
    from the scan-free reduction and its kernel, canonical from the exact
    path (SOS with constant-matrix products by p' and p)."""
    if _use_kernels(w.cols) and w.ncols <= C.NBIAS:
        # the kernel's constant bias row absorbs both column- and value-level
        # negativity; no caller-side p^2 bias needed
        assert w.val_lo > -C.BIAS_VALUE, "value negativity exceeds kernel bias"
        assert w.val_hi + C.BIAS_VALUE < _RP, "mont_reduce input exceeds R*p"
        assert -C.BIAS_FLOOR < w.col_lo
        assert w.col_hi + C.BIAS_FLOOR + 255 < (1 << 31)
        from .kernels import mont as _km

        return _km.mont_reduce(w.cols, w.col_lo, w.col_hi)
    if _scanfree_ok(w):
        return mont_reduce_scanfree(w.cols, w.col_lo, w.col_hi)
    if w.val_lo < 0:
        w = nonneg(w)
    assert w.val_hi < _RP, "mont_reduce input exceeds R*p"
    t = normalize(w, _NT)
    t_low = t[..., :NRED]
    m_cols = conv_const(t_low, "TOEP_PPRIME", 255, NRED)
    m_w = Wide(m_cols, 0, NRED * 255 * 255, 0, (1 << C.R_BITS) ** 2)
    m = normalize_mod_r(m_w, NRED)
    u_cols = conv_const(m, "TOEP_P", 255, NLIMBS)
    s = Wide(
        _pad_to(t, _NS) + _pad_to(u_cols, _NS),
        0,
        255 + NRED * 255 * 255,
        w.val_lo,
        w.val_hi + (1 << C.R_BITS) * _P,
    )
    sn = normalize(s, _NS)
    res = sn[..., NRED: NRED + NLIMBS]
    return _cond_subtract_p(res)


def as_wide(a: torch.Tensor, a_max: int = 255, a_val: int = _P - 1) -> Wide:
    """Embed limbs as a Wide with NO domain change.

    CAUTION: a Wide produced by conv(x, y) of two stored Montgomery values is
    in the *product domain* (mont_reduce divides by R, leaving one R factor).
    Mixing as_wide(stored) with product wides changes the meaning — use
    to_wide_mont for that; as_wide is for standard-form column juggling only.
    """
    return Wide(a, 0, a_max, 0, a_val)


def to_wide_mont(a: torch.Tensor, a_max: int = 255) -> Wide:
    """Embed stored Montgomery limbs into the conv-product domain:
    W = a * (R mod p), so mont_reduce(W + conv(x, y)) decodes consistently."""
    cols = conv_const(a, "TOEP_ONE_MONT", a_max, NLIMBS)
    a_val_max = a_max * (((1 << (LIMB_BITS * NLIMBS)) - 1) // MASK)  # limb bound -> value bound
    return Wide(cols, 0, NLIMBS * a_max * 255, 0, a_val_max * C.ONE_MONT_INT)


def nonneg(w: Wide) -> Wide:
    """Shift w by the smallest multiple of p making its value provably >= 0."""
    if w.val_lo >= 0:
        return w
    k = (-w.val_lo + _P - 1) // _P
    v = k * _P
    ncols = max(w.ncols, (v.bit_length() + LIMB_BITS - 1) // LIMB_BITS)
    return w + _wide_const(v, ncols, w.cols.device)


def mont_reduce_stack(wides: list[Wide], axis: int = -2) -> torch.Tensor:
    """Reduce k Wides in one batched Montgomery reduction with merged bounds.

    Returns (..., k, NLIMBS): the stacked results."""
    ncols = max(w.ncols for w in wides)
    cols = torch.stack([_pad_to(w.cols, ncols) for w in wides], dim=axis)
    merged = Wide(
        cols,
        min(w.col_lo for w in wides),
        max(w.col_hi for w in wides),
        min(w.val_lo for w in wides),
        max(w.val_hi for w in wides),
    )
    return mont_reduce(merged)


#: Witness-trace sink (models/witness.py): while it is a list, the recording
#: ops append (kind, (inputs..., output)) rows: mont_mul "mul", inv "inv",
#: sqrt_with_sgn "sqrt", connect "connect", and the Fq2/Fq6/Fq12 hints.
_witness_sink = None


def recording() -> bool:
    """Whether a witness trace is recording (a sink is installed)."""
    return _witness_sink is not None


def _record(op: str, *tensors) -> None:
    if _witness_sink is not None:
        _witness_sink.append((op, tensors))


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a*b*R^-1) mod p on stored Montgomery operands — the Fp product. On a
    CUDA tensor one fused kernel, whose rows are mont_reduce(conv(a, b))'s."""
    if _use_kernels(a):
        from .kernels import mont as _km

        out = _km.mont_mul(a, b)
    else:
        out = mont_reduce(conv(a, b))
    _record("mul", a, b, out)
    return out


def mont_square(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a)


# ---------------------------------------------------------------------------
# Canonical ring ops
# ---------------------------------------------------------------------------


def zeros(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, NLIMBS), dtype=torch.int32,
                       device=resolve_device(device))


def one_mont(batch_shape=(), device=None) -> torch.Tensor:
    return const("ONE_MONT", resolve_device(device)).expand(*batch_shape, NLIMBS)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, weakly reduced (inputs < SEMI_VAL each -> output < SEMI_VAL)."""
    s = Wide(a + b, 0, 2 * SEMI_DIG, 0, 2 * SEMI_VAL)
    return _cond_subtract_p(_cond_subtract_p(normalize(s, NRED)))


def neg(b: torch.Tensor) -> torch.Tensor:
    """2p - b mod-p-correct negation for weakly-reduced b (< 2p); branch-free.
    Output value <= p (the value-zero input maps to the representation p)."""
    twop = _pad_to(const("TWOP", b.device), NRED)
    cols = twop + (MASK - _pad_to(b, NRED))
    cols[..., 0] += 1  # cols is a new tensor: b is not written
    # value = R + (2p - b) with 2p - b in (0, 2p]; drop the R carry digit
    w = Wide(cols, 0, MASK + int(C.TWOP_LIMBS.max()) + 1,
             1 << C.R_BITS, (1 << C.R_BITS) + 2 * _P)
    n = normalize(w, NRED + 1)[..., :NLIMBS]
    return _cond_subtract_p(n)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return add(a, neg(b))


def neg_relaxed(b: torch.Tensor):
    """NEGC - b: represents -b (mod p) with digits <= SEMI_DIG + 256, no carries.

    Returns (limbs, limb_max, val_max) for use as a conv operand."""
    return const("NEGC", b.device) - b, SEMI_DIG + 256, C.NEG_K * _P


def canonicalize(a: torch.Tensor) -> torch.Tensor:
    """Exact canonical representative in [0, p) of a weakly-reduced element."""
    w = Wide(a, 0, SEMI_DIG, 0, 2 * _P - 1)
    return _cond_subtract_p(normalize(w, NRED))


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k mod p for small static k >= 0, by double-and-add on canonical limbs."""
    assert k >= 0
    if k == 0:
        return torch.zeros_like(a)
    result = None
    base = a
    while k:
        if k & 1:
            result = base if result is None else add(result, base)
        k >>= 1
        if k:
            base = add(base, base)
    return result


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask (...,) or (...,1) int/bool: a where true else b."""
    m = mask[..., None] if mask.dim() == a.dim() - 1 else mask
    return torch.where(m != 0, a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (canonicalize(a) == 0).all(-1)


def is_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (canonicalize(a) == canonicalize(b)).all(-1)


# ---------------------------------------------------------------------------
# Fixed-exponent powers
# ---------------------------------------------------------------------------


def pow_static(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent by MSB-first square-and-multiply over the static bits.
    Montgomery in, Montgomery out. On a CUDA tensor the whole chain of
    mont_mul products is one mont_pow kernel, with the same rows. While a
    witness sink is installed it is the chain of mont_mul calls in the JAX
    package's select form: the product with a is formed (and recorded) on
    every bit, set or not, and kept on set bits."""
    if exponent == 0:
        return one_mont(a.shape[:-1], a.device)
    if _use_kernels(a) and not recording():
        from .kernels import mont as _km

        return _km.mont_pow(a, exponent)
    acc = a  # the leading 1
    for i in range(exponent.bit_length() - 2, -1, -1):
        acc = mont_mul(acc, acc)
        if (exponent >> i) & 1:
            acc = mont_mul(acc, a)
        elif recording():
            mont_mul(acc, a)
    return acc


def get_naf(exponent: int) -> list[int]:
    """Non-adjacent form of exponent >= 0, LSB first, digits in {-1, 0, 1}:
    sum(d * 2^i) == exponent and no two adjacent digits are nonzero."""
    assert exponent >= 0
    naf = []
    e = exponent
    while e > 0:
        if e & 1:
            d = 2 - (e & 3)  # 1 if e % 4 == 1 else -1
            e -= d
        else:
            d = 0
        naf.append(d)
        e >>= 1
    return naf


def pow_naf(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent over the exponent's NAF digits, MSB first: one Fermat
    inverse for the -1 digits, then per digit a square and, on a nonzero
    digit, the product with a or a^-1."""
    if exponent == 0:
        return one_mont(a.shape[:-1], a.device)
    naf = get_naf(exponent)
    a_inv = inv(a)
    acc = a  # the leading digit is 1
    for d in naf[-2::-1]:
        acc = mont_mul(acc, acc)
        if d:
            acc = mont_mul(acc, a if d > 0 else a_inv)
    return acc


def pow_dynamic(a: torch.Tensor, e_bits: torch.Tensor) -> torch.Tensor:
    """a^e for an exponent given as data: e_bits (..., NBITS) little-endian
    0/1 int32, broadcastable against a's batch shape, so that elements may
    have different exponents. Per bit the product is kept where the bit is
    set, and the base squared."""
    bits = torch.movedim(e_bits.to(torch.int32), -1, 0)  # (NBITS, ...)
    batch = torch.broadcast_shapes(a.shape[:-1], bits.shape[1:])
    acc = one_mont(batch, a.device)
    base = a.expand(*batch, NLIMBS)
    for bit in bits:
        acc = select(bit, mont_mul(acc, base), acc)
        base = mont_square(base)
    return acc


def bits_of(exponents, nbits: int = 381) -> np.ndarray:
    """Ints -> (..., nbits) little-endian 0/1 int32 array, pow_dynamic's
    exponent layout."""
    arr = np.asarray(exponents, dtype=object)
    out = np.zeros(arr.shape + (nbits,), dtype=np.int32)
    for idx in np.ndindex(arr.shape):
        e = int(arr[idx])
        assert 0 <= e < (1 << nbits)
        for j in range(nbits):
            out[idx + (j,)] = (e >> j) & 1
    return out


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2); maps 0 -> 0."""
    out = pow_static(a, _P - 2)
    _record("inv", a, out)
    return out


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """Candidate square root a^((p+1)/4) (p = 3 mod 4); a root iff out^2 == a."""
    return pow_static(a, (_P + 1) // 4)


def legendre(a: torch.Tensor) -> torch.Tensor:
    """a^((p-1)/2) in Montgomery form: one_mont, neg(one_mont) or 0."""
    return pow_static(a, (_P - 1) // 2)


def is_square(a: torch.Tensor) -> torch.Tensor:
    """True for squares and zero."""
    return ~is_equal(legendre(a), neg(one_mont(a.shape[:-1], a.device)))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> standard form limbs (mont_mul by 1)."""
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return mont_mul(a, one)


def to_mont(a_std: torch.Tensor) -> torch.Tensor:
    """Standard-form limbs -> Montgomery form (mont_mul by R^2)."""
    return mont_mul(a_std, const("R2", a_std.device).expand_as(a_std))


def sgn0(a: torch.Tensor) -> torch.Tensor:
    """The RFC 9380 sign bit of the standard-form value."""
    return canonicalize(from_mont(a))[..., 0] & 1


def sqrt_with_sgn(a: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    """Of the roots +-s of a square a, the one whose sgn0 is sgn's low bit.
    Records a sqrt row."""
    s = sqrt(a)
    want = sgn0(s) == (sgn & 1)
    out = select(want.to(torch.int32), s, neg(s))
    _record("sqrt", a, sgn, out)
    return out


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b = a * b^-1 (b == 0 gives 0: inv maps 0 to 0)."""
    return mont_mul(a, inv(b))


def connect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The equality constraint: records a connect row, which
    models/witness.check_trace verifies, and returns a == b per element at
    any tower level (the component axes reduced)."""
    _record("connect", a, b)
    eq = canonicalize(a) == canonicalize(b)
    while eq.dim() > 1:
        eq = eq.all(-1)
    return eq
