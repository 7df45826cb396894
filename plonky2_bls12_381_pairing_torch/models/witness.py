"""The witness trace (the JAX package's models/witness.py): recorded
constraint rows, the hints, their checkers, and the rows' export.

The reference's plonky2 circuits take an inverse or a square root from an
off-circuit hint generator and verify it in-circuit. Here a hint is the
batched computation itself, and a trace records what the circuits would be
given: per operation its inputs and output, by kind,

  mul, inv              limb Fp products and Fermat inverses (ops/fp.py)
  sqrt                  limb Fp square root with a sign bit
  fq2_inv, fq2_sqrt     limb Fq2 inverse and square root (ops/fq2.py)
  fq6_inv, fq12_inv     limb Fq6 / Fq12 inverses
  connect               limb equality constraints (fp.connect, any level)
  rns_mul, rns_inv      RNS Fp products and batched inverses (ops/rns/fp.py)
  rns_sqrt, rns_connect RNS square root with a sign, equality
  rns_fq2_inv, rns_fq2_sqrt  RNS Fq2 inverse and square root (ops/rns/fq2.py)

and check_trace recomputes each kind's defining relation (x * x^-1 = 1 or
x = x^-1 = 0, s^2 = x with sgn0(s) = sgn, c = a b, a = b) over all its rows
and counts the rows that break it: all zeros is the gate.

trace() installs one list as the sink of both tiers' fp modules, so the rows
land in the order they are computed. While it runs, the recording ops are
the ones that compute: a limb strategy "fused" becomes "auto" (the fused
Fq12 kernels hold their inverses' products in-kernel), the Fermat chains
take the JAX package's select form (a product with the base on every bit,
recorded) -- on the RNS tier the pow kernel's recording build, which writes
each step's square and product for the rows, on the limb tier one mont_mul
per product in place of the one mont_pow -- and the RNS exponentiations by
|x| take the "karabina" form (models/pairing_rns.py set_exp_form), whose
decompressions' inversions record as the JAX package's unfused path does.
Every other kernel stays on: none of them computes a recorded row.

Rows export as the reference's 12 x u32 little-endian limbs per Fp element
(to_u32_limbs, rns_to_u32_limbs, export_rows_u32); sign flags pass through.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import fp, fq2, fq6, fq12
from ..ops.rns import fp as rfp
from ..ops.rns import fq2 as rfq2


@dataclass
class WitnessTrace:
    """Recorded rows by kind: rows[kind] is a list of tuples of tensors, in
    the batch shapes they were recorded with."""

    rows: dict = field(default_factory=dict)

    def add(self, op: str, tensors) -> None:
        self.rows.setdefault(op, []).append(tensors)

    def counts(self) -> dict:
        return {op: len(v) for op, v in self.rows.items()}


def _install(sink) -> None:
    fp._witness_sink = sink
    rfp._witness_sink = sink


class _Discard(list):
    """A sink that keeps nothing: the recording forms run, no row is kept."""

    def append(self, item) -> None:
        pass


@contextlib.contextmanager
def _recording(sink):
    _install(sink)
    try:
        yield
    finally:
        _install(_Discard())


def trace(fn, *args, jit: bool = False, strict: bool = True):
    """fn(*args) with its rows recorded: (output, WitnessTrace).

    jit=False runs fn eagerly; the rows are the tensors it computed.
    jit=True is the counterpart of the JAX package's traced compiled
    pipeline: fn is captured into a CUDA graph (utils/capture.py) with the
    recording forms on throughout, but the sink keeps rows only while the
    graph is captured, not during the warm-up call, so the recorded tensors
    are the graph's own; they are cloned after one replay. Like capture, it
    refuses CPU tensors.

    For its duration the recording forms are forced (module docstring) and
    the caller's settings restored afterwards. strict=True raises if nothing
    was recorded: a clean check of an empty trace would prove nothing."""
    from . import pairing_rns

    sink: list = []
    prev_strategy = fp.get_strategy()
    if prev_strategy == "fused":
        fp.set_strategy("auto")
    prev_form = pairing_rns.set_exp_form("karabina")
    try:
        if jit:
            from ..utils.capture import Captured

            _install(_Discard())
            step = Captured(fn, args, {}, during_capture=_recording(sink))
            out = step(*args)
            sink = [(op, tuple(t.clone() for t in ts)) for op, ts in sink]
        else:
            _install(sink)
            out = fn(*args)
    finally:
        _install(None)
        fp.set_strategy(prev_strategy)
        pairing_rns.set_exp_form(prev_form)
    tr = WitnessTrace()
    for op, tensors in sink:
        tr.add(op, tensors)
    if strict and not tr.rows:
        raise RuntimeError("witness trace recorded no rows: the traced function computes "
                           "no recorded product, inverse or root (pass strict=False if "
                           "that is expected)")
    return out, tr


# ---------------------------------------------------------------------------
# Hints (the reference's hint generators, computed batched)
# ---------------------------------------------------------------------------


def inverse_hint(x: torch.Tensor) -> torch.Tensor:
    """The Fp inverse hint (0 -> 0)."""
    return fp.inv(x)


def sqrt_hint(x: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    """The Fp square root with a prescribed sign."""
    return fp.sqrt_with_sgn(x, sgn)


def fq2_inverse_hint(x: torch.Tensor) -> torch.Tensor:
    return fq2.inv(x)


def fq2_sqrt_hint(x: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    return fq2.sqrt_with_sgn(x, sgn)


def fq6_inverse_hint(x: torch.Tensor) -> torch.Tensor:
    return fq6.inv(x)


def fq12_inverse_hint(x: torch.Tensor) -> torch.Tensor:
    return fq12.inv(x)


# ---------------------------------------------------------------------------
# Checkers: each recomputes its kind's relation over stacked rows and counts
# the rows that break it
# ---------------------------------------------------------------------------


def _canon_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb tower elements equal in value, reduced over every trailing axis
    to the rows' batch axis."""
    eq = fp.canonicalize(a) == fp.canonicalize(b.expand(a.shape))
    while eq.dim() > 1:
        eq = eq.all(-1)
    return eq


def _is_zero_elem(x: torch.Tensor) -> torch.Tensor:
    return _canon_eq(x, torch.zeros_like(x))


def _bad(ok: torch.Tensor) -> int:
    return int((~ok).sum())


def check_mul_rows(a, b, c) -> int:
    """c == a b."""
    return _bad(_canon_eq(fp.mont_mul(a, b), c))


def _check_inv(x, xinv, mul_fn, one_elem) -> int:
    """x xinv == 1, or x == 0 and xinv == 0 (the inv0 pattern)."""
    ok = torch.where(_is_zero_elem(x), _is_zero_elem(xinv),
                     _canon_eq(mul_fn(x, xinv), one_elem))
    return _bad(ok)


def check_inverse_rows(x, xinv) -> int:
    return _check_inv(x, xinv, fp.mont_mul, fp.one_mont(device=x.device))


def check_fq2_inverse_rows(x, xinv) -> int:
    return _check_inv(x, xinv, fq2.mul, fq2.one(device=x.device))


def check_fq6_inverse_rows(x, xinv) -> int:
    return _check_inv(x, xinv, fq6.mul, fq6.one(device=x.device))


def check_fq12_inverse_rows(x, xinv) -> int:
    return _check_inv(x, xinv, fq12.mul, fq12.one(device=x.device))


def check_sqrt_rows(x, sgn, s) -> int:
    """s^2 == x and sgn0(s) == sgn."""
    return _bad(_canon_eq(fp.mont_square(s), x) & (fp.sgn0(s) == (sgn & 1)))


def check_fq2_sqrt_rows(x, sgn, s) -> int:
    return _bad(_canon_eq(fq2.square(s), x) & (fq2.sgn0(s) == (sgn & 1)))


def check_connect_rows(a, b) -> int:
    return _bad(_canon_eq(a, b))


def check_rns_mul_rows(a, b, c) -> int:
    """c == a b per packed element."""
    return _bad(rfp.is_equal(rfp.mul(a, b), c))


def check_rns_inverse_rows(x, xinv) -> int:
    one = rfp.one(x.shape[:-1], x.device)
    ok = torch.where(rfp.is_zero(x), rfp.is_zero(xinv), rfp.is_equal(rfp.mul(x, xinv), one))
    return _bad(ok)


def check_rns_sqrt_rows(x, sgn, s) -> int:
    return _bad(rfp.is_equal(rfp.mul(s, s), x) & (rfp.sgn0(s) == (sgn & 1)))


def check_rns_connect_rows(a, b) -> int:
    return _bad(rfp.is_equal(a, b))


def check_rns_fq2_inverse_rows(x, xinv) -> int:
    one = rfq2.one(x.shape[:-2], x.device)
    ok = torch.where(rfq2.is_zero(x), rfq2.is_zero(xinv),
                     rfq2.is_equal(rfq2.mul(x, xinv), one))
    return _bad(ok)


def check_rns_fq2_sqrt_rows(x, sgn, s) -> int:
    return _bad(rfq2.is_equal(rfq2.square(s), x) & (rfq2.sgn0(s) == (sgn & 1)))


#: kind -> (checker, number of row slots)
_CHECKERS = {
    "mul": (check_mul_rows, 3),
    "inv": (check_inverse_rows, 2),
    "sqrt": (check_sqrt_rows, 3),
    "fq2_inv": (check_fq2_inverse_rows, 2),
    "fq2_sqrt": (check_fq2_sqrt_rows, 3),
    "fq6_inv": (check_fq6_inverse_rows, 2),
    "fq12_inv": (check_fq12_inverse_rows, 2),
    "rns_mul": (check_rns_mul_rows, 3),
    "rns_inv": (check_rns_inverse_rows, 2),
    "rns_sqrt": (check_rns_sqrt_rows, 3),
    "connect": (check_connect_rows, 2),
    "rns_connect": (check_rns_connect_rows, 2),
    "rns_fq2_inv": (check_rns_fq2_inverse_rows, 2),
    "rns_fq2_sqrt": (check_rns_fq2_sqrt_rows, 3),
}

#: The trailing element axes of each slot (0: a limb-tier sign per element;
#: an RNS sign is (rows..., PACK), one axis, beside its (rows..., LANES)
#: element).
_ROW_NDIM = {
    "mul": (1, 1, 1), "inv": (1, 1), "sqrt": (1, 0, 1),
    "fq2_inv": (2, 2), "fq2_sqrt": (2, 0, 2),
    "fq6_inv": (2, 2), "fq12_inv": (2, 2),
    "rns_mul": (1, 1, 1), "rns_inv": (1, 1), "rns_sqrt": (1, 1, 1),
    "connect": (1, 1), "rns_connect": (1, 1),
    "rns_fq2_inv": (2, 2), "rns_fq2_sqrt": (2, 1, 2),
}

#: The slots that hold a sign flag, not field elements: export passes them
#: through (the JAX package's export sends the RNS ones to its decoder,
#: which raises).
_FLAG_SLOTS = {"sqrt": (1,), "fq2_sqrt": (1,), "rns_sqrt": (1,), "rns_fq2_sqrt": (1,)}


def _stack_rows(rows, elem_ndim: int) -> torch.Tensor:
    """Each recorded tensor with its batch axes flattened, concatenated."""
    flat = []
    for r in rows:
        tail = tuple(r.shape[r.dim() - elem_ndim:]) if elem_ndim else ()
        flat.append(r.reshape(-1, *tail))
    return torch.cat(flat)


def check_trace(tr: WitnessTrace) -> dict:
    """{kind: rows that break its relation} over every recorded row; all
    zeros is the gate."""
    out = {}
    for op, rows in tr.rows.items():
        checker, arity = _CHECKERS[op]
        ndims = _ROW_NDIM[op]
        out[op] = checker(*(_stack_rows([r[i] for r in rows], ndims[i])
                            for i in range(arity)))
    return out


# ---------------------------------------------------------------------------
# Export: 12 x u32 little-endian limbs per Fp element, standard form
# ---------------------------------------------------------------------------

U32_LIMBS = 12


def _bytes_to_u32(std: torch.Tensor) -> np.ndarray:
    """Canonical standard-form (..., 48) byte limbs -> (..., 12) uint32,
    packed on the limbs' device."""
    groups = std.to(torch.int64).reshape(*std.shape[:-1], U32_LIMBS, 4)
    weights = torch.tensor([1, 1 << 8, 1 << 16, 1 << 24], dtype=torch.int64,
                           device=std.device)
    return (groups * weights).sum(-1).cpu().numpy().astype(np.uint32)


def to_u32_limbs(x: torch.Tensor) -> np.ndarray:
    """Montgomery (..., 48) limbs -> standard-form (..., 12) uint32 limbs,
    the layout the reference's FqTarget from_vec takes."""
    return _bytes_to_u32(fp.canonicalize(fp.from_mont(x)))


def from_u32_limbs(u, device=None) -> torch.Tensor:
    """(..., 12) uint32 limbs -> canonical Montgomery (..., 48) limbs."""
    u = np.asarray(u, dtype=np.uint32).astype(np.int64)
    b = (u[..., None] >> np.array([0, 8, 16, 24])) & 0xFF
    std = torch.from_numpy(b.reshape(*u.shape[:-1], U32_LIMBS * 4).astype(np.int32))
    return fp.to_mont(std.to(fp.resolve_device(device)))


def _unpack_rns(u: np.ndarray, shape: tuple) -> np.ndarray:
    """(N, PACK, 12) limbs of rows of batch shape `shape` (N = its size) ->
    (shape[0]*PACK, *shape[1:], 12): the elements unpacked along axis 0, as
    ops/rns/fp.py decode lays them out."""
    shape = shape or (1,)
    u = np.moveaxis(u.reshape(*shape, rfp.RC.PACK, U32_LIMBS), -2, 1)
    return u.reshape(shape[0] * rfp.RC.PACK, *shape[1:], U32_LIMBS)


def rns_to_u32_limbs(rows: torch.Tensor) -> np.ndarray:
    """Packed RNS rows (R, ..., LANES) -> (R*PACK, ..., 12) uint32 limbs of
    the standard-form values, the elements unpacked along axis 0 as
    ops/rns/fp.py decode gives them; through the CRT bridge fp.to_limbs on
    the rows' device."""
    return _unpack_rns(_bytes_to_u32(rfp.to_limbs(rows.reshape(-1, rfp.LANES))),
                       tuple(rows.shape[:-1]))


def _export_slot(tensors: list, rns: bool) -> list:
    """One slot of every row of a kind in the 12 x u32 layout, converted in
    one call over all of them."""
    width = rfp.LANES if rns else fp.NLIMBS
    flat = torch.cat([t.reshape(-1, width) for t in tensors])
    u = (_bytes_to_u32(rfp.to_limbs(flat)) if rns
         else _bytes_to_u32(fp.canonicalize(fp.from_mont(flat))))
    out, start = [], 0
    for t in tensors:
        shape = tuple(t.shape[:-1])
        n = int(np.prod(shape, dtype=np.int64))
        part = u[start:start + n]
        out.append(_unpack_rns(part, shape) if rns else part.reshape(*shape, U32_LIMBS))
        start += n
    return out


def export_rows_u32(tr: WitnessTrace) -> dict:
    """{kind: list of row tuples of uint32 limb arrays}, every Fp component
    in the 12 x u32 layout and sign flags passed through as numpy; RNS rows
    leave residue and Montgomery form first (each packed row exports PACK
    elements). Each slot of a kind converts in one call over its rows."""
    out = {}
    for op, rows in tr.rows.items():
        flags = _FLAG_SLOTS.get(op, ())
        slots = []
        for i in range(len(rows[0])):
            ts = [r[i] for r in rows]
            slots.append([t.cpu().numpy() for t in ts] if i in flags
                         else _export_slot(ts, op.startswith("rns_")))
        out[op] = list(zip(*slots))
    return out
