"""RNS-channel Fp core in PyTorch (the JAX package's ops/rns/fp.py).

An Fp element is its residue vector modulo 63 independent ~13-bit primes
(rns_constants.py), one residue per lane; an element needs exactly 64 lanes,
so every 128-lane int32 row PACKS TWO batch elements.

  * multiply      = ONE int32 lane-multiply
  * add/sub/neg   = lane add/sub (+ a constant k*p residue row), carry-free
  * reduction     = RNS Montgomery REDC: lane-Barrett passes and two
                    base-extension products against constant block-diagonal
                    128x128 matrices (exact float32 products of 7/6-bit planes)

Stored elements are canonical per channel (residue < m) and redundantly
reduced at value level (<= 4p); lazy accumulations ride the `R` class, which
tracks exact channel- and value-level bounds statically, so every int32 and
float32 exactness invariant is asserted when the formula runs. The static
decisions those bounds make (bias multiples, canonicalization passes) are
the same as the JAX package's, which is what keeps the stored rows of the two
packages bit-identical.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, is_dataclass, replace

import numpy as np
import torch

from ... import rns_constants as RC

LANES = RC.LANES
P = RC.P
STORED = RC.STORED_BOUND  # value bound of stored elements (4p, inclusive)
_CH_MAX = RC.PRIME_MAX - 1  # canonical channel bound
_I32 = 1 << 31
#: One-pass Barrett stays exact for |x| up to ~2^31: the f32 quotient error is
#: <= 0.5 (round) + |x|*2^-25/m (x rounding) + 2*(x/m)*2^-24 (mult + 1/m
#: rounding) < 0.6 for m >= 3557, so r = x - round(x/m)*m lands in
#: (-0.6m, 0.6m) and one masked +m canonicalizes. The margin below 2^31 keeps
#: q*m inside int32.
_BARRETT_DOM = (1 << 31) - (1 << 27)


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        # the base-extension products are float32 matmuls that are exact only
        # with full float32 accumulation: TF32 would round them
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


# ---------------------------------------------------------------------------
# Host-side encode/decode (numpy, exact ints)
# ---------------------------------------------------------------------------


def encode(values) -> np.ndarray:
    """Python ints -> packed residue rows, Montgomery form x*MA mod p.

    Scalars (ndim 0) produce one (LANES,) row holding the value in BOTH
    packed slots. Arrays pack PAIRS of elements along axis 0: shape (B, ...)
    -> (ceil(B/2), ..., LANES), row r slot 0 = element 2r, slot 1 = element
    2r+1 (odd tails replicate the last element)."""
    arr = np.asarray(values, dtype=object)
    if arr.ndim == 0:
        return np.tile(RC.encode_int_slot(int(arr[()])), RC.PACK)
    b = arr.shape[0]
    rows = -(-b // RC.PACK)
    out = np.zeros((rows,) + arr.shape[1:] + (LANES,), dtype=np.int32)
    for idx in np.ndindex(arr.shape):
        r, slot = idx[0] // RC.PACK, idx[0] % RC.PACK
        out[(r,) + idx[1:] + (slice(slot * RC.SUB, (slot + 1) * RC.SUB),)] = (
            RC.encode_int_slot(int(arr[idx])))
    if b % RC.PACK:  # replicate the tail element into the empty slot
        tail = out[(rows - 1,) + (Ellipsis, slice(RC.SUB, LANES))]
        out[(rows - 1,) + (Ellipsis, slice(RC.SUB, LANES))] = np.where(
            tail.any(axis=-1, keepdims=True), tail,
            out[(rows - 1,) + (Ellipsis, slice(0, RC.SUB))])
    return out


#: CRT weights of base A: (MA/a_i)^{-1} mod a_i and MA/a_i.
_CRT_INV = [pow(RC.MA // a, -1, a) for a in RC.A_PRIMES]
_CRT_MI = [RC.MA // a for a in RC.A_PRIMES]
_MA_INV_P = pow(RC.MA, -1, P)


def _decode_slot(slot_row) -> int:
    v = 0
    for i in range(RC.NCH):
        v += int(slot_row[RC.A_LO + i]) * _CRT_INV[i] % RC.A_PRIMES[i] * _CRT_MI[i]
    return v % RC.MA * _MA_INV_P % P


def decode(rows) -> np.ndarray:
    """Packed rows (R, ..., LANES) -> object ndarray of field ints with the
    element axis unpacked: shape (R*PACK, ...). Callers slice [:B]."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    arr = np.asarray(rows)
    shape = arr.shape[:-1]
    if not shape:
        return _decode_slot(arr[: RC.SUB])
    out = np.empty((shape[0] * RC.PACK,) + shape[1:], dtype=object)
    for idx in np.ndindex(shape):
        for slot in range(RC.PACK):
            out[(idx[0] * RC.PACK + slot,) + idx[1:]] = _decode_slot(
                arr[idx + (slice(slot * RC.SUB, (slot + 1) * RC.SUB),)])
    return out


def pack_mask(mask) -> np.ndarray:
    """Per-element mask (B, ...) -> packed lane mask (ceil(B/2), ..., LANES)
    int32 (each element's mask broadcast over its 64-lane slot)."""
    arr = np.asarray(mask).astype(np.int32)
    b = arr.shape[0]
    rows = -(-b // RC.PACK)
    if b % RC.PACK:
        arr = np.concatenate([arr, arr[-1:]], axis=0)
    g = arr.reshape((rows, RC.PACK) + arr.shape[1:])
    g = np.moveaxis(g, 1, -1)  # (rows, ..., PACK)
    return np.repeat(g, RC.SUB, axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# Constant rows, cached per device
# ---------------------------------------------------------------------------


def _const_np(tag) -> np.ndarray:
    """Numpy value for an fp-internal constant tag."""
    kind = tag[0]
    if kind == "pmul":
        return RC.p_mult_row(tag[1])
    if kind == "c_mamod_slot":
        return RC.C_MAMOD_BY_SLOT[tag[1]]
    if kind == "c_mbmod_slot":
        return RC.C_MBMOD_BY_SLOT[tag[1]]
    table = {
        "m": RC.M_I32, "inv_m": RC.INV_M_F32,
        "c_sigma": RC.C_SIGMA, "c_mainv": RC.C_MAINV,
        "c_pmainv": RC.C_PMAINV,
        "c_mainv_mbinv": RC.C_MAINV_MBINV,
        "c_pmainv_mbinv": RC.C_PMAINV_MBINV,
        "ma_modp": RC.MA_MODP_ROW,
        "is_a": RC.IS_A.astype(np.int32),
        "is_ch": RC.IS_CH,
        "one": RC.ONE,
        "zero_rows": RC.ZERO_TEST_ROWS,
        "eq_rows": RC.EQ_TEST_ROWS,
        "t1lo": RC.T1_LO.astype(np.float32), "t1hi": RC.T1_HI.astype(np.float32),
        "t1sum": RC.T1_SUM.astype(np.float32),
        "t2lo": RC.T2_LO.astype(np.float32), "t2hi": RC.T2_HI.astype(np.float32),
        "t2sum": RC.T2_SUM.astype(np.float32),
        "crtlo": RC.CRT_LO.astype(np.float32), "crthi": RC.CRT_HI.astype(np.float32),
        "crtsum": RC.CRT_SUM.astype(np.float32),
        "c_crt_cinv": RC.C_CRT_CINV,
        "ma_digits": RC.MA_DIGITS,
    }
    if kind in table:
        return table[kind]
    raise KeyError(tag)


_CONSTS: dict = {}


def const_on(tag, device: torch.device, np_val=None) -> torch.Tensor:
    """Constant tensor for `tag` on `device`, built once per device."""
    key = (tag, device)
    out = _CONSTS.get(key)
    if out is None:
        val = _const_np(tag) if np_val is None else np_val
        out = torch.from_numpy(np.ascontiguousarray(val)).to(device)
        _CONSTS[key] = out
    return out


def cst(tag, like: torch.Tensor, np_val=None) -> torch.Tensor:
    """Constant tensor for `tag` on `like`'s device."""
    return const_on(tag, like.device, np_val)


# ---------------------------------------------------------------------------
# Channel Barrett reduction
# ---------------------------------------------------------------------------


def barrett_raw(x: torch.Tensor) -> torch.Tensor:
    """Per-lane signed representative of x mod m for |x| < _BARRETT_DOM: one
    round-mult-sub lands in (-0.6m, 0.6m). The float32 product is its own op
    (never fused into a multiply-add) and torch.round rounds half to even,
    as the reference's round does."""
    prod = x.to(torch.float32) * cst(("inv_m",), x)
    q = torch.round(prod).to(torch.int32)
    return x - q * cst(("m",), x)


def barrett(x: torch.Tensor) -> torch.Tensor:
    """Canonical x mod m: barrett_raw plus one masked add. Padding lanes
    (m = 1) map to 0."""
    r = barrett_raw(x)
    return torch.where(r < 0, r + cst(("m",), x), r)


# ---------------------------------------------------------------------------
# R: lazy channel accumulator with static bounds
# ---------------------------------------------------------------------------


@dataclass
class R:
    """Raw channel values (..., LANES) int32 plus exact static bounds.

    `lo`/`hi` bound every per-channel int; `vlo`/`vhi` bound the represented
    integer value (of the abstract computation over Z). Canonicalizing
    channels (Barrett) never changes the represented value, so `canon` is
    free at value level.
    """

    ch: torch.Tensor
    lo: int
    hi: int
    vlo: int
    vhi: int

    def _chk(self) -> "R":
        assert -_I32 < self.lo and self.hi < _I32, "int32 channel overflow"
        return self

    def __add__(self, o: "R") -> "R":
        return R(self.ch + o.ch, self.lo + o.lo, self.hi + o.hi,
                 self.vlo + o.vlo, self.vhi + o.vhi)._chk()

    def __sub__(self, o: "R") -> "R":
        return R(self.ch - o.ch, self.lo - o.hi, self.hi - o.lo,
                 self.vlo - o.vhi, self.vhi - o.vlo)._chk()

    def scale(self, k: int) -> "R":
        assert k >= 0
        return R(self.ch * k, self.lo * k, self.hi * k,
                 self.vlo * k, self.vhi * k)._chk()

    def canon(self) -> "R":
        """Barrett-canonicalize channels (value bounds unchanged)."""
        assert -_BARRETT_DOM < self.lo and self.hi < _BARRETT_DOM
        return R(barrett(self.ch), 0, _CH_MAX, self.vlo, self.vhi)

    def maybe_canon(self, budget: int = 1 << 14) -> "R":
        """Canonicalize only when channel growth threatens product exactness."""
        return self.canon() if (self.hi >= budget or self.lo <= -budget) else self

    def bias(self, k: int) -> "R":
        """Add the constant k*p (residue row): clears value-level negativity."""
        row = RC.p_mult_row(k)
        return R(self.ch + cst(("pmul", k), self.ch), self.lo,
                 self.hi + int(row.max()), self.vlo + k * P, self.vhi + k * P)


def wrap(a) -> R:
    """Stored canonical element -> R."""
    return R(a, 0, _CH_MAX, 0, STORED)


#: Fp-op counters (count_fp_ops): while set, mul_rr and redc add the packed
#: rows they process, in element units.
_op_counter: dict | None = None


def _count(kind: str, shape) -> None:
    rows = math.prod(shape[:-1]) if len(shape) > 1 else 1
    _op_counter[kind] = _op_counter.get(kind, 0) + rows * RC.PACK


def _on_cpu(x):
    """x with every tensor in it (in point dataclasses, lists and tuples)
    moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if is_dataclass(x) and not isinstance(x, type):
        return replace(x, **{f.name: _on_cpu(getattr(x, f.name)) for f in fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_on_cpu(v) for v in x)
    return x


def count_fp_ops(fn, *args) -> dict:
    """Exact Fp-op counts of fn's computation in element units (each packed
    element counted on its own): fp_mul (channel products) and redc
    (Montgomery reductions), as the JAX package's count_fp_ops gives them.

    Where the JAX package traces fn abstractly, the port runs it: on the CPU,
    with every tensor of args moved there, so that each dispatching op takes
    its plain formulas. The kernels never call mul_rr or redc, so a count on
    the card would miss their work. Run it at one packed row: the plain
    formulas cost what they count."""
    global _op_counter
    prev = _op_counter
    _op_counter = {}
    try:
        fn(*_on_cpu(args))
        return dict(_op_counter)
    finally:
        _op_counter = prev


def mul_rr(a: R, b: R) -> R:
    """Channel product; exact while |a_ch*b_ch| < 2^31 (asserted)."""
    am = max(abs(a.lo), abs(a.hi))
    bm = max(abs(b.lo), abs(b.hi))
    assert am * bm < _I32, f"int32 channel product overflow: {am}*{bm}"
    vals = [a.vlo * b.vlo, a.vlo * b.vhi, a.vhi * b.vlo, a.vhi * b.vhi]
    out = R(a.ch * b.ch, -am * bm, am * bm, min(vals), max(vals))
    if _op_counter is not None:
        _count("fp_mul", out.ch.shape)
    return out


def mul_ss(a, b) -> R:
    """Product of two stored elements."""
    return mul_rr(wrap(a), wrap(b))


def to_prod(a) -> R:
    """Lift a stored element into the product domain (x one extra MA factor,
    mod p) so it can be summed with products of two stored elements before a
    REDC. One lane-multiply by the constant residue row of (MA mod p)."""
    row = RC.MA_MODP_ROW
    c = R(cst(("ma_modp",), a), 0, int(row.max()), 0, RC.MA_MODP_INT)
    return mul_rr(wrap(a), c)


# ---------------------------------------------------------------------------
# RNS Montgomery reduction (rns_constants.py docstring, steps 1-4)
# ---------------------------------------------------------------------------

_PB = RC.PLANE_BITS


def _mm(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Exact product of a 7/6-bit plane with a plane matrix: every partial
    sum is an integer below 2^24, so float32 is exact in any order (with
    TF32 off, see resolve_device)."""
    return torch.matmul(x.to(torch.float32), mat).to(torch.int32)


def _ext_matmul(x: torch.Tensor, lo, hi, sm) -> torch.Tensor:
    """Exact x @ T for canonical 13-bit x and T, via 7/6-bit planes and a
    Karatsuba combine (3 float32 matmuls)."""
    xl = x & ((1 << _PB) - 1)
    xh = x >> _PB
    ll = _mm(xl, lo)
    hh = _mm(xh, hi)
    cross = _mm(xl + xh, sm) - ll - hh
    return ll + (cross << _PB) + (hh << (2 * _PB))


def _planes(name: str, like: torch.Tensor):
    return tuple(cst((name + part,), like) for part in ("lo", "hi", "sum"))


def nonneg_multiple(x: R) -> int:
    """The smallest k >= 0 with x.vlo + k*p >= 0 (a static decision)."""
    return 0 if x.vlo >= 0 else -(-(-x.vlo) // P)


def nonneg(x: R) -> R:
    """Bias by the smallest multiple of p making the value provably >= 0."""
    k = nonneg_multiple(x)
    return x.bias(k) if k else x


#: Channel bound under which redc skips its input canonicalization: both
#: product sites (sigma's x*C_SIGMA and step 3's x*C_MAINV + qhat*C_PMAINV,
#: the latter within the Barrett domain) stay exact in int32.
_SKIP_MAX = (_BARRETT_DOM - (1 << 26)) // (RC.PRIME_MAX - 1)


def redc_needs_canon(x: R) -> bool:
    """Static decision of redc: does its input get a canonical pass first?"""
    return not (-_SKIP_MAX < x.lo and x.hi < _SKIP_MAX)


def redc(x: R) -> torch.Tensor:
    """X (value in [0, MA*p)) -> stored element V = X*MA^{-1} + k*p (mod-p
    equal to X*MA^{-1}), canonical channels, value < 3p. Negative value
    bounds are cleared with a constant k*p residue row first."""
    x = nonneg(x)
    assert x.vhi <= RC.REDC_MAX, "redc input exceeds MA*p"
    if _op_counter is not None:
        _count("redc", x.ch.shape)
    xc = x.canon().ch if redc_needs_canon(x) else x.ch
    # step 1: sigma_i = X * (-p^-1) * (MA/a_i)^-1 mod a_i  (A lanes)
    sigma = barrett(xc * cst(("c_sigma",), xc))
    # step 2: extend q to B+r; each packed slot's alpha rides as an extra
    # matrix column of its block. qhat only ever enters products taken mod m,
    # so the signed barrett_raw representative suffices.
    s = _ext_matmul(sigma, *_planes("t1", xc))
    corr = 0
    for k in range(RC.PACK):
        lane = k * RC.SUB + RC.ALPHA_LANE
        alpha_k = s[..., lane : lane + 1] >> RC.ALPHA_T
        corr = corr + alpha_k * cst(("c_mamod_slot", k), xc)
    qhat = barrett_raw(s - corr)
    # steps 3+4 fused: sigma'_j = r_j * (MB/b_j)^-1 mod b_j directly from
    # (X, qhat) with folded constants
    sigma2 = barrett(xc * cst(("c_mainv_mbinv",), xc)
                     + qhat * cst(("c_pmainv_mbinv",), xc))
    s2 = _ext_matmul(sigma2, *_planes("t2", xc))
    # exact Kawamura beta: the +1/2 offset makes the fixed-point wrap count
    # exact because r < 3p << MB
    corr2 = 0
    for k in range(RC.PACK):
        lane = k * RC.SUB + RC.ALPHA_LANE
        beta_k = (s2[..., lane : lane + 1] + (1 << (RC.BETA_T - 1))) >> RC.BETA_T
        corr2 = corr2 + beta_k * cst(("c_mbmod_slot", k), xc)
    # one canonical Barrett over the where-merged halves: A lanes get the
    # back-extended value, B+r lanes get r = (X + qhat*p) * MA^-1.
    pre = torch.where(cst(("is_a",), xc) != 0, s2 - corr2,
                      xc * cst(("c_mainv",), xc) + qhat * cst(("c_pmainv",), xc))
    return barrett(pre)


def merged(rs: list[R], ch) -> R:
    """One R holding the channels `ch` of a stack of already-biased values,
    with the union of their bounds."""
    return R(ch, min(r.lo for r in rs), max(r.hi for r in rs),
             min(r.vlo for r in rs), max(r.vhi for r in rs))


def redc_stack(rs: list[R], dim: int = -2) -> torch.Tensor:
    """One stacked REDC for k lazy values -> (..., k, LANES) stored, with
    per-value nonneg biasing first."""
    rs = [nonneg(r) for r in rs]
    return redc(merged(rs, torch.stack([r.ch for r in rs], dim=dim)))


def row1(r: R) -> R:
    """A single-row R ((..., LANES)) -> 1-row stacked form ((..., 1, LANES));
    the redc_cat entry form. Keeping one entry per abstract value preserves
    redc_stack's PER-VALUE nonneg biasing (bit-identical rows)."""
    return R(r.ch[..., None, :], r.lo, r.hi, r.vlo, r.vhi)


def redc_cat(rs: list[R], dim: int = -2) -> torch.Tensor:
    """One stacked REDC over ALREADY multi-row R values ((..., k_i, LANES)),
    concatenated along `dim`, with per-entry nonneg biasing first (each
    entry's rows are bit-identical to a separate redc of that entry)."""
    rs = [nonneg(r) for r in rs]
    return redc(merged(rs, torch.cat([r.ch for r in rs], dim=dim)))


# ---------------------------------------------------------------------------
# Stored-element ring ops
# ---------------------------------------------------------------------------


def zeros(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, LANES), dtype=torch.int32,
                       device=resolve_device(device))


def one(batch_shape=(), device=None) -> torch.Tensor:
    return const_on(("one",), resolve_device(device)).expand(*batch_shape, LANES)


#: Witness-trace sink (models/witness.py): while it is a list, products and
#: inverses of stored elements append (kind, (inputs..., output)) rows. The
#: limb tier's ops/fp.py gets the same list, so the rows of both tiers land
#: in one sink in the order they are computed.
_witness_sink = None


def recording() -> bool:
    """Whether a witness trace is recording (a sink is installed)."""
    return _witness_sink is not None


def _record(op: str, *tensors) -> None:
    if _witness_sink is not None:
        _witness_sink.append((op, tensors))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of stored elements (the Fp multiply)."""
    out = redc(mul_ss(a, b))
    _record("rns_mul", a, b, out)
    return out


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def neg_r(b: R, k: int | None = None) -> R:
    """-b as k*p - b with the smallest adequate multiple of p."""
    if k is None:
        k = -(-b.vhi // P)
    row = RC.p_mult_row(k)
    return R(cst(("pmul", k), b.ch) - b.ch, -b.hi, int(row.max()) - b.lo,
             k * P - b.vhi, k * P - b.vlo)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = mask[..., None] if mask.ndim == a.ndim - 1 else mask
    return torch.where(m != 0, a, b)


def _rows_match(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Per-slot test: does each packed slot of x match any constant row?
    Returns (..., PACK) bools."""
    eq = (x[..., None, :] == rows) | ~cst(("is_ch",), x)
    eqs = eq.reshape(*eq.shape[:-1], RC.PACK, RC.SUB)
    return eqs.all(dim=-1).any(dim=-2)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Per packed element: stored value (<= 4p, canonical channels) == 0 mod
    p iff its residue slot equals that of k*p for some k in 0..4. Returns
    (..., PACK) bools (slot-major element order)."""
    return _rows_match(a, cst(("zero_rows",), a))


def slot_lanes(mask: torch.Tensor) -> torch.Tensor:
    """Per-element bools (..., PACK) -> bool lane mask (..., LANES), each
    element's value over its 64-lane slot."""
    return mask.repeat_interleave(RC.SUB, dim=-1)


def is_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per packed element: a == b (mod p) via the k*p rows of a - b + 4p.
    Returns (..., PACK) bools."""
    d = barrett(a - b + cst(("pmul", 4), a))
    return _rows_match(d, cst(("eq_rows",), a))


# ---------------------------------------------------------------------------
# Fixed-exponent powers and the batched inverse
# ---------------------------------------------------------------------------


def exponent_bits(exponent: int) -> list[int]:
    """MSB-first bits of exponent after its leading 1."""
    return [(exponent >> i) & 1 for i in range(exponent.bit_length() - 2, -1, -1)]


def pow_static(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent: MSB-first square-and-multiply over the static bit table,
    each step redc(mul_ss(.)). Montgomery in/out. The plain version of the
    pow_static_fused kernel (ops/rns/kernels.py). While a witness trace
    records, it takes the JAX package's select form (pow_static_steps) and
    records its products."""
    if exponent == 0:
        return one(a.shape[:-1], a.device)
    if recording():
        return _record_chain(a, exponent, *pow_static_steps(a, exponent))
    acc = a
    for bit in exponent_bits(exponent):
        acc = redc(mul_ss(acc, acc))
        if bit:
            acc = redc(mul_ss(acc, a))
    return acc


def pow_static_steps(a: torch.Tensor, exponent: int) -> tuple[torch.Tensor, torch.Tensor]:
    """a^exponent (exponent >= 1) in the select form, and its steps: per bit
    after the leading one the square and the product with a, which is
    formed on every bit and kept where the bit is set; steps[2i] and
    steps[2i + 1] (shape (2 * nbits, *a.shape)). The plain version of the
    pow kernel's recording build (ops/rns/kernels.py pow_static_steps)."""
    acc, steps = a, []
    for bit in exponent_bits(exponent):
        sq = redc(mul_ss(acc, acc))
        pr = redc(mul_ss(sq, a))
        steps += [sq, pr]
        acc = pr if bit else sq
    return acc, (torch.stack(steps) if steps else a.new_empty((0, *a.shape)))


def _record_chain(a: torch.Tensor, exponent: int, out: torch.Tensor,
                  steps: torch.Tensor) -> torch.Tensor:
    """Record a select-form chain's products from its steps as the JAX
    package's scan records them, two rns_mul rows per bit: (acc, acc,
    square) and (square, a, product); out."""
    acc = a
    for i, bit in enumerate(exponent_bits(exponent)):
        sq, pr = steps[2 * i], steps[2 * i + 1]
        _record("rns_mul", acc, acc, sq)
        _record("rns_mul", sq, a, pr)
        acc = pr if bit else sq
    return out


def _pow_api(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent through the pow kernel on the card (its plain version on
    the CPU). While a witness trace records, the kernel's recording build,
    whose steps give the chain's rows."""
    from . import kernels

    if recording():
        return _record_chain(a, exponent, *kernels.pow_static_steps(a, exponent))
    return kernels.pow_static_fused(a, exponent)


def _fermat_inv(a: torch.Tensor) -> torch.Tensor:
    """Per-element Fermat inverse a^(p-2) (0 -> 0 rides the pow)."""
    return _pow_api(a, P - 2)


#: Row count at which the inverse product tree hands over to the Fermat pow.
_TREE_FLOOR = 128


def inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse, 0 -> 0 (the inv0 convention).

    Montgomery's product-tree trick over the batch rows: a log-depth up-sweep
    of pairwise products down to a _TREE_FLOOR-row block, ONE Fermat pow on
    that block, and a log-depth down-sweep (inv(child) = inv(parent) *
    sibling). Zero elements are masked to 1 on the way up and restored to 0
    at the end."""
    rows = a.reshape(-1, LANES)
    n = rows.shape[0]
    zm = slot_lanes(is_zero(rows))  # (n, LANES) bools
    ones = one((n,), a.device)
    safe = torch.where(zm, ones, rows)
    size = 1
    while size < n:
        size *= 2
    if size != n:
        safe = torch.cat([safe, one((size - n,), a.device)], dim=0)
    stack = []
    cur = safe
    while cur.shape[0] > _TREE_FLOOR:
        stack.append(cur)
        h = cur.shape[0] // 2
        cur = mul(cur[:h], cur[h:])
    invc = _fermat_inv(cur)          # the one real (multi-row) inversion
    for level in reversed(stack):
        h = level.shape[0] // 2
        invc = torch.cat([mul(invc, level[h:]), mul(invc, level[:h])], dim=0)
    out = torch.where(zm, torch.zeros_like(invc[:n]), invc[:n]).reshape(a.shape)
    _record("rns_inv", a, out)
    return out


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b = a * b^-1 (b == 0 gives 0: inv maps 0 to 0)."""
    return mul(a, inv(b))


# ---------------------------------------------------------------------------
# RNS -> positional bridge and the non-arithmetic API
# ---------------------------------------------------------------------------


def to_limbs(a: torch.Tensor) -> torch.Tensor:
    """Stored (..., LANES) -> canonical standard-form (..., PACK, 48) int32
    radix-2^8 limbs (the limb tier's element layout, ops/fp.py).

    One REDC leaves Montgomery form (value v < 3p, v = x mod p), one Barrett
    gives the CRT coefficients c_i = v*(MA/a_i)^{-1} mod a_i, and one
    extension product against the digit matrix (rns_constants.CRT) gives the
    lazy positional digits of sum_i c_i*(MA/a_i) with their exact Kawamura
    wrap count k; v's digits are cols - k*MA_digits, finished by the limb
    tier's carry normalization and two conditional subtractions of p."""
    from .. import fp as limb_fp

    s = redc(wrap(a))
    c = barrett(s * cst(("c_crt_cinv",), s))
    d = _ext_matmul(c, *_planes("crt", s))
    mad = cst(("ma_digits",), s)
    per_slot = []
    for k in range(RC.PACK):
        lane = k * RC.SUB + RC.ALPHA_LANE
        kw = (d[..., lane : lane + 1] + (1 << (RC.BETA_T - 1))) >> RC.BETA_T
        per_slot.append(d[..., k * RC.SUB : k * RC.SUB + RC.CRT_DIGITS] - kw * mad)
    cols = torch.stack(per_slot, dim=-2)  # (..., PACK, CRT_DIGITS)
    hi = RC.NCH * (RC.PRIME_MAX - 1) * 255
    w = limb_fp.Wide(cols, -RC.NCH * 255, hi, 0, 3 * P - 1)
    v51 = limb_fp.normalize(w, RC.CRT_DIGITS)  # canonical digits, v < 3p
    return limb_fp._cond_subtract_p(limb_fp._cond_subtract_p(v51))


def neg(b: torch.Tensor) -> torch.Tensor:
    """Stored negation 4p - b (canonical channels, value <= 4p)."""
    return barrett(cst(("pmul", 4), b) - b)


def sgn0(a: torch.Tensor) -> torch.Tensor:
    """The RFC 9380 sign bit of each packed element's standard-form value:
    (..., PACK)."""
    return to_limbs(a)[..., 0] & 1


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """Candidate square root a^((p+1)/4) (p = 3 mod 4); a root iff out^2 == a."""
    return _pow_api(a, (P + 1) // 4)


def legendre(a: torch.Tensor) -> torch.Tensor:
    """a^((p-1)/2) in Montgomery form: one, neg(one) or 0."""
    return _pow_api(a, (P - 1) // 2)


def is_square(a: torch.Tensor) -> torch.Tensor:
    """True for squares and zero, per packed element (..., PACK)."""
    neg_one = neg(cst(("one",), a)).expand(a.shape)
    return ~is_equal(legendre(a), neg_one)


def sqrt_with_sgn(a: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    """Of the roots +-s of a square a, the one whose sgn0 is sgn's low bit;
    sgn: per packed element (..., PACK). Records an rns_sqrt row."""
    s = sqrt(a)
    want = sgn0(s) == (sgn & 1)
    out = torch.where(slot_lanes(want), s, neg(s))
    _record("rns_sqrt", a, sgn, out)
    return out


def connect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The equality constraint: records an rns_connect row, which
    models/witness.check_trace verifies, and returns a == b per packed
    element (..., PACK). Tower levels' component axes fold into the rows."""
    _record("rns_connect", a, b)
    return is_equal(a, b)


def pow_naf(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent over the signed NAF digits of the exponent: one inverse,
    then per digit a square and both products (by a and by a^-1), of which
    the digit keeps one or neither."""
    from .. import fp as limb_fp

    naf = limb_fp.get_naf(exponent)  # LSB first
    if not naf:
        return one(a.shape[:-1], a.device)
    a_inv = inv(a)
    acc = a  # the leading digit is +1
    for d in naf[-2::-1]:
        sq = mul(acc, acc)
        pos = mul(sq, a)
        neg_ = mul(sq, a_inv)
        acc = pos if d > 0 else (neg_ if d < 0 else sq)
    return acc


def pow_dynamic(a: torch.Tensor, e_bits: torch.Tensor) -> torch.Tensor:
    """a^e for an exponent given as data: e_bits, (nbits,) int32 MSB first.
    Every step squares and multiplies and keeps the product where the bit is
    set."""
    acc = one(a.shape[:-1], a.device)
    for bit in e_bits:
        sq = mul(acc, acc)
        acc = torch.where(bit != 0, mul(sq, a), sq)
    return acc
