"""The limb tier's Montgomery kernels (the JAX package's ops/pallas/mont.py):
hand-written CUDA kernels, their plain PyTorch versions and their wrappers.

  conv(a, b)                       <- pallas/mont.py conv         (csrc/mont.cu)
  mont_reduce(cols, col_lo, col_hi) <- pallas/mont.py mont_reduce  (csrc/mont.cu)
  mont_mul(a, b)                   <- pallas/mont.py mont_mul     (csrc/mont.cu)

Each wrapper runs its plain version for a tensor on the CPU and launches its
kernel for a tensor on a CUDA device; there is no fallback between the two.
`launches` counts kernel launches per wrapper. The plain versions are the
plain functions of ops/fp.py (conv_cols, mont_reduce_scanfree) and call no
dispatching function, so a plain run on a card launches none of these
kernels. mont_mul's rows are mont_reduce(conv(a, b))'s: the fused kernel
passes the reduction the bounds of a product of two stored operands.

The kernels are built and bound by ops/cuda_build.py.
"""

from __future__ import annotations

import math

import torch

from ... import constants as C
from .. import cuda_build, fp
from ..cuda_build import INT, PTR, STRIDE

NLIMBS = C.NLIMBS
NCOLS = 2 * NLIMBS - 1  # 95 columns of a 48 x 48 convolution

#: every entry ends in the output pointer, the row count and the stream;
#: an operand with a row stride is (PTR, STRIDE); mont_reduce also takes its
#: column count and the count of its first shift-add passes
_KERNELS = {
    "conv": ("mont.cu", "limb_conv_launch", [PTR, STRIDE] * 2 + [PTR, INT, PTR]),
    "mont_reduce": ("mont.cu", "limb_mont_reduce_launch",
                    [PTR, STRIDE, INT, INT, PTR, INT, PTR]),
    "mont_mul": ("mont.cu", "limb_mont_mul_launch",
                 [PTR, STRIDE] * 2 + [PTR, INT, PTR]),
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


def _pair(name: str, a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    batch = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    av, sa = _rows48(a, batch)
    bv, sb = _rows48(b, batch)  # both alive until the launch is enqueued
    out = torch.empty((*batch, width), dtype=torch.int32, device=a.device)
    cuda_build.call(name, a.device, av.data_ptr(), sa, bv.data_ptr(), sb,
                    out.data_ptr(), math.prod(batch))
    return out


def conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """48 x 48 limb convolution (..., 48) x (..., 48) -> (..., 95) int32."""
    if a.device.type == "cpu":
        return conv_plain(a, b)
    return _pair("conv", a, b, NCOLS)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused Montgomery product of stored operands (digits <= SEMI_DIG)."""
    if a.device.type == "cpu":
        return mont_mul_plain(a, b)
    return _pair("mont_mul", a, b, NLIMBS)


def mont_reduce(cols: torch.Tensor, col_lo: int = 0,
                col_hi: int = NLIMBS * 255 * 255) -> torch.Tensor:
    """Scan-free Montgomery reduction of (..., K <= 95) signed columns with
    static bounds col_lo > -2^30, col_hi + 2^30 + 255 < 2^31."""
    ncols = cols.shape[-1]
    _check_reduce_bounds(ncols, col_lo, col_hi)
    if cols.device.type == "cpu":
        return mont_reduce_plain(cols, col_lo, col_hi)
    batch = tuple(cols.shape[:-1])
    cv, stride = cuda_build.rows(cols, batch, (ncols,))
    out = torch.empty((*batch, NLIMBS), dtype=torch.int32, device=cols.device)
    cuda_build.call("mont_reduce", cols.device, cv.data_ptr(), stride, ncols,
                    first_pass_count(col_lo, col_hi), out.data_ptr(), math.prod(batch))
    return out
