"""The limb tier's Montgomery kernels (the JAX package's ops/pallas/mont.py):
hand-written CUDA kernels, their plain PyTorch versions and their wrappers.

  conv_many(pairs), conv(a, b)     <- pallas/mont.py conv         (csrc/mont.cu)
  mont_reduce(cols, col_lo, col_hi) <- pallas/mont.py mont_reduce  (csrc/mont.cu)
  mont_mul(a, b)                   <- pallas/mont.py mont_mul     (csrc/mont.cu)
  mont_pow(a, exponent)            <- fp.py pow_static, a lax.scan of
                                      pallas/mont.py mont_mul      (csrc/mont.cu)

conv_many convolves up to K_MAX operand pairs in one launch (a tower op's
independent products); conv(a, b) is conv_many([(a, b)]).

Each wrapper runs its plain version for a tensor on the CPU and launches its
kernel for a tensor on a CUDA device; there is no fallback between the two.
`launches` counts kernel launches per wrapper. The plain versions are the
plain functions of ops/fp.py (conv_cols, mont_reduce_scanfree) and call no
dispatching function, so a plain run on a card launches none of these
kernels. mont_mul's rows are mont_reduce(conv(a, b))'s: the fused kernel
passes the reduction the bounds of a product of two stored operands.
mont_pow's rows are those of fp.pow_static's chain of mont_mul calls, which
its kernel runs in one launch for an exponent of up to 32 * POW_WORDS + 1
bits, and in one launch per piece of that many of its bits for a longer one.

The kernels are built and bound by ops/cuda_build.py.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ... import constants as C
from .. import cuda_build, fp
from ..cuda_build import INT, PTR, STRIDE

NLIMBS = C.NLIMBS
NCOLS = 2 * NLIMBS - 1  # 95 columns of a 48 x 48 convolution
#: most operand pairs of one conv launch: fq12.mul's group is 63 products
#: (three fq6.mul_wide of 9 Karatsuba and 12 schoolbook products)
K_MAX = 64
#: 32-bit words of the exponent's bits after its leading one that one
#: mont_pow launch takes (p - 2 has 380 such bits); a longer exponent is
#: one launch per piece
POW_WORDS = 16
#: warps an H100 holds at once (132 SMs x 64), and the most rows a conv
#: warp computes in turn
_CARD_WARPS = 132 * 64
CONV_ROWS_PER_WARP = 4


def conv_rows_per_warp(k: int, rows: int) -> int:
    """Rows per warp of a conv launch of k pairs: one while its k * rows
    warps fit on the card at once, up to CONV_ROWS_PER_WARP beyond, so that
    a warp loads its next row while it computes one."""
    return max(1, min(CONV_ROWS_PER_WARP, k * rows // _CARD_WARPS))


class _ConvPairs(ctypes.Structure):
    """csrc/mont.cu's ConvPairs: the pairs' row pointers and row strides,
    passed by value in the launch's parameters."""

    _fields_ = [("a", PTR * K_MAX), ("b", PTR * K_MAX),
                ("sa", STRIDE * K_MAX), ("sb", STRIDE * K_MAX)]


class _PowBits(ctypes.Structure):
    """csrc/mont.cu's PowBits: an exponent's bits after its leading one,
    MSB first (bit i is bit i % 32 of word i // 32), passed by value in the
    launch's parameters."""

    _fields_ = [("w", ctypes.c_uint32 * POW_WORDS), ("n", INT)]


#: every entry ends in the output pointer, the row count and the stream
#: (conv: and the rows per warp); an operand with a row stride is (PTR,
#: STRIDE); conv takes its pairs (a _ConvPairs) and their count;
#: mont_reduce also takes its column count and the count of its first
#: shift-add passes; mont_pow, after its base, the accumulator to start
#: from and a piece of its exponent's bits (a _PowBits)
_KERNELS = {
    "conv": ("mont.cu", "limb_conv_launch", [PTR, INT, PTR, INT, INT, PTR]),
    "mont_reduce": ("mont.cu", "limb_mont_reduce_launch",
                    [PTR, STRIDE, INT, INT, PTR, INT, PTR]),
    "mont_mul": ("mont.cu", "limb_mont_mul_launch",
                 [PTR, STRIDE] * 2 + [PTR, INT, PTR]),
    "mont_pow": ("mont.cu", "limb_mont_pow_launch",
                 [PTR, STRIDE, PTR, STRIDE, PTR, PTR, INT, PTR]),
}

#: Kernel launches per wrapper since the last reset_launches().
launches = {name: 0 for name in _KERNELS}
cuda_build.register(_KERNELS, launches)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


#: column bound of the product of two stored (weakly reduced) operands
MUL_COL_HI = NLIMBS * C.SEMI_DIG * C.SEMI_DIG


def first_pass_count(col_lo: int, col_hi: int) -> int:
    """Shift-add passes of the reduction's first stage, on columns + bias
    row. The bias makes every column non-negative, so the lower bound plays
    no part (asserted)."""
    hi = col_hi + C.BIAS_FLOOR + 255
    n = fp.semi_pass_count(0, hi)
    assert n == fp.semi_pass_count(min(col_lo, 0), hi)
    return n


#: the two fixed pass counts after it: on m = t * p' mod R, and on t + m * p
NPASS_M = fp.semi_pass_count(0, C.NRED * 257 * 255)
NPASS_S = fp.semi_pass_count(0, 257 + C.NRED * 257 * 255)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def conv_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 48) x (..., 48) -> (..., 95) int32 columns, out[k] = sum_i
    a[i] b[k - i]. Exact while 48 * a_max * b_max < 2^31 (callers assert)."""
    return fp.conv_cols(a, b)


def mont_reduce_plain(cols: torch.Tensor, col_lo: int = 0,
                      col_hi: int = NLIMBS * 255 * 255) -> torch.Tensor:
    """(..., K <= 95) signed int32 columns -> weakly reduced (..., 48), the
    scan-free reduction with the static bounds (col_lo, col_hi)."""
    return fp.mont_reduce_scanfree(cols, col_lo, col_hi)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stored (..., 48) x (..., 48) -> stored (..., 48): a * b / R mod p."""
    return fp.mont_reduce_scanfree(fp.conv_cols(a, b), 0, MUL_COL_HI)


def mont_pow_plain(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """Stored (..., 48) -> stored (..., 48): a^exponent (Montgomery in and
    out), fp.pow_static's MSB-first square-and-multiply on mont_mul_plain."""
    if exponent == 0:
        return fp.one_mont(a.shape[:-1], a.device)
    acc = a  # the leading 1
    for i in range(exponent.bit_length() - 2, -1, -1):
        acc = mont_mul_plain(acc, acc)
        if (exponent >> i) & 1:
            acc = mont_mul_plain(acc, a)
    return acc


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_reduce_bounds(ncols: int, col_lo: int, col_hi: int) -> None:
    if ncols > C.NBIAS:
        raise ValueError(f"at most {C.NBIAS} columns, got {ncols}")
    if not -C.BIAS_FLOOR < col_lo or not col_hi + C.BIAS_FLOOR + 255 < (1 << 31):
        raise ValueError("column bounds exceed the bias row")


def _rows48(t: torch.Tensor, batch: tuple) -> tuple[torch.Tensor, int]:
    """A (batch..., 48) operand as rows with one stride; a layout that does
    not merge (a partial broadcast) is copied (cuda_build.row_view)."""
    return cuda_build.rows(t, batch, (NLIMBS,))


def _mont_mul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    batch = _batch(a, b)
    av, sa = _rows48(a, batch)
    bv, sb = _rows48(b, batch)  # both alive until the launch is enqueued
    out = torch.empty((*batch, NLIMBS), dtype=torch.int32, device=a.device)
    cuda_build.call("mont_mul", a.device, av.data_ptr(), sa, bv.data_ptr(), sb,
                    out.data_ptr(), math.prod(batch))
    return out


def _pow_struct(bits: list) -> _PowBits:
    if len(bits) > 32 * POW_WORDS:
        raise ValueError(f"exponents of at most {32 * POW_WORDS + 1} bits a launch, "
                         f"got {len(bits) + 1}")
    out = _PowBits()
    out.n = len(bits)
    for j, bit in enumerate(bits):
        out.w[j // 32] |= bit << (j % 32)
    return out


def _bits_after_lead(exponent: int) -> list:
    n = exponent.bit_length() - 1
    return [(exponent >> (n - 1 - j)) & 1 for j in range(n)]


def pow_bits(exponent: int) -> _PowBits:
    """The exponent's bits after its leading one, as one launch takes them:
    an exponent of at most 32 * POW_WORDS + 1 bits."""
    return _pow_struct(_bits_after_lead(exponent))


def pow_pieces(exponent: int) -> list[_PowBits]:
    """The exponent's bits after its leading one in pieces of at most
    32 * POW_WORDS, MSB first, one per launch (one empty piece for 1)."""
    bits, step = _bits_after_lead(exponent), 32 * POW_WORDS
    return [_pow_struct(bits[i:i + step]) for i in range(0, max(len(bits), 1), step)]


def _mont_pow_kernel(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """Launch the mont_pow kernel (exponent >= 1), once per piece of the
    exponent (pow_pieces), each launch after the first starting from the
    output of the one before: fp.pow_static's products in its order. The
    base rows are read in place through one row stride where the batch axes
    merge, else copied."""
    batch = tuple(a.shape[:-1])
    av, sa = _rows48(a, batch)
    acc, s_acc = av, sa
    for bits in pow_pieces(exponent):
        out = torch.empty((*batch, NLIMBS), dtype=torch.int32, device=a.device)
        cuda_build.call("mont_pow", a.device, av.data_ptr(), sa, acc.data_ptr(), s_acc,
                        ctypes.addressof(bits), out.data_ptr(), math.prod(batch))
        acc, s_acc = out, NLIMBS
    return out


def _batch(a: torch.Tensor, b: torch.Tensor) -> tuple:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    return tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))


def _conv_many_kernel(pairs: list, rows_per_warp=None) -> list[torch.Tensor]:
    """Launch the conv kernel: the pairs of each batch shape, K_MAX at a
    time, in one launch into one (k, *batch, 95) tensor; pair j's columns
    are a view of it. Each operand is read in place through one row stride
    (0 for a broadcast row) where its batch axes merge, else copied. Rows
    per warp: conv_rows_per_warp's unless given."""
    out: list = [None] * len(pairs)
    groups: dict = {}
    for j, (a, b) in enumerate(pairs):
        groups.setdefault(_batch(a, b), []).append(j)
    device = pairs[0][0].device
    for batch, idx in groups.items():
        for first in range(0, len(idx), K_MAX):
            js = idx[first:first + K_MAX]
            arg, views = _ConvPairs(), []
            for i, j in enumerate(js):
                av, arg.sa[i] = _rows48(pairs[j][0], batch)
                bv, arg.sb[i] = _rows48(pairs[j][1], batch)
                arg.a[i], arg.b[i] = av.data_ptr(), bv.data_ptr()
                views += [av, bv]  # alive until the launch is enqueued
            res = torch.empty((len(js), *batch, NCOLS), dtype=torch.int32, device=device)
            rows = math.prod(batch)
            cuda_build.call("conv", device, ctypes.addressof(arg), len(js), res.data_ptr(),
                            rows, rows_per_warp or conv_rows_per_warp(len(js), rows))
            for i, j in enumerate(js):
                out[j] = res[i]
    return out


def conv_many(pairs: list) -> list[torch.Tensor]:
    """48 x 48 limb convolutions of the operand pairs [(a, b), ...], each
    (..., 48) x (..., 48) -> (..., 95) int32: on the card one launch per
    batch shape (and per K_MAX pairs)."""
    if not pairs:
        return []
    if pairs[0][0].device.type == "cpu":
        return [conv_plain(a, b) for a, b in pairs]
    return _conv_many_kernel(pairs)


def conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """48 x 48 limb convolution (..., 48) x (..., 48) -> (..., 95) int32."""
    return conv_many([(a, b)])[0]


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused Montgomery product of stored operands (digits <= SEMI_DIG)."""
    if a.device.type == "cpu":
        return mont_mul_plain(a, b)
    return _mont_mul_kernel(a, b)


def mont_pow(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent of stored rows (..., 48) for a static exponent >= 0: on the
    card one launch for the whole chain of an exponent of up to
    32 * POW_WORDS + 1 bits, one per piece of that many bits beyond
    (exponent 0 gives the one row, on the host)."""
    exponent = int(exponent)
    if exponent < 0:
        raise ValueError("the exponent must be >= 0")
    if a.device.type == "cpu" or exponent == 0:
        return mont_pow_plain(a, exponent)
    return _mont_pow_kernel(a, exponent)


def mont_reduce(cols: torch.Tensor, col_lo: int = 0,
                col_hi: int = NLIMBS * 255 * 255) -> torch.Tensor:
    """Scan-free Montgomery reduction of (..., K <= 95) signed columns with
    static bounds col_lo > -2^30, col_hi + 2^30 + 255 < 2^31."""
    if cols.device.type == "cpu":
        _check_reduce_bounds(cols.shape[-1], col_lo, col_hi)
        return mont_reduce_plain(cols, col_lo, col_hi)
    return _mont_reduce_kernel(cols, col_lo, col_hi)


def _mont_reduce_kernel(cols: torch.Tensor, col_lo: int, col_hi: int) -> torch.Tensor:
    """Launch the mont_reduce kernel: the rows read in place through one row
    stride where the batch axes merge, else copied."""
    ncols = cols.shape[-1]
    _check_reduce_bounds(ncols, col_lo, col_hi)
    batch = tuple(cols.shape[:-1])
    cv, stride = cuda_build.rows(cols, batch, (ncols,))
    out = torch.empty((*batch, NLIMBS), dtype=torch.int32, device=cols.device)
    cuda_build.call("mont_reduce", cols.device, cv.data_ptr(), stride, ncols,
                    first_pass_count(col_lo, col_hi), out.data_ptr(), math.prod(batch))
    return out
