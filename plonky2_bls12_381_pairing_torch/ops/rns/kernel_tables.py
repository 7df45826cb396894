"""The tables and static decisions of the CUDA kernels, as a C header.

The kernels in csrc/ compute each lane's residues exactly, so a stored row
depends only on the integer value each REDC reduces. Two things fix that
value besides the formula itself, and both come from here:
  * the lane tables of rns_constants.py (moduli, Barrett reciprocals, the
    REDC constant rows, the base-extension blocks);
  * the `nonneg` bias multiple k of every REDC input, which the bound
    tracking of the plain formulas decides statically (a different k gives
    a row equal mod p but not identical). They are read off by running the
    plain formulas once on a dummy element.
Every row is slot-local (64 lanes): both packed slots share it.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import rns_constants as RC
from . import fp, tower

_SLOT = slice(0, RC.SUB)


def static_biases() -> dict[str, list[int]]:
    """Bias multiple k of each of the 12 REDC inputs of one Granger-Scott
    squaring ("cyc") and one Fq12 product ("mul")."""
    z = torch.zeros((1, 12, RC.LANES), dtype=torch.int32)
    return {
        "cyc": [fp.nonneg_multiple(r) for r in tower._cyc_square_terms(z)],
        "mul": [fp.nonneg_multiple(r) for r in tower._mul_terms(z, z)],
    }


def tables() -> dict[str, np.ndarray]:
    """Every array the header defines, by its C name."""
    biases = static_biases()
    t = {
        "RNS_M": RC.M_I32[_SLOT],
        "RNS_INV_M": RC.INV_M_F32[_SLOT],
        "RNS_C_SIGMA": RC.C_SIGMA[_SLOT],
        "RNS_C_MAINV": RC.C_MAINV[_SLOT],
        "RNS_C_PMAINV": RC.C_PMAINV[_SLOT],
        "RNS_C_MAMOD": RC.C_MAMOD[_SLOT],
        "RNS_C_MAINV_MBINV": RC.C_MAINV_MBINV[_SLOT],
        "RNS_C_PMAINV_MBINV": RC.C_PMAINV_MBINV[_SLOT],
        "RNS_C_MBMOD": RC.C_MBMOD[_SLOT],
        "RNS_IS_A": RC.IS_A[_SLOT].astype(np.int32),
        "RNS_MA_MODP": RC.MA_MODP_ROW[_SLOT],
        # rows of the base-extension blocks that can be nonzero: T1 is read
        # from base-A rows, T2 from base-B rows
        "RNS_T1A": RC.T1[RC.A_LO:RC.A_HI, _SLOT],
        "RNS_T2B": RC.T2[RC.B_LO:RC.B_HI, _SLOT],
        "RNS_CYC_BIAS": np.stack([RC.p_mult_row(k)[_SLOT] for k in biases["cyc"]]),
        "RNS_MUL_BIAS": np.stack([RC.p_mult_row(k)[_SLOT] for k in biases["mul"]]),
    }
    return {name: np.ascontiguousarray(v) for name, v in t.items()}


def _c_values(arr: np.ndarray) -> str:
    flat = arr.reshape(-1)
    if arr.dtype == np.float32:
        # hex literals carry the float32 values exactly
        vals = [float(v).hex() + "f" for v in flat]
    else:
        vals = [str(int(v)) for v in flat]
    lines = [", ".join(vals[i:i + 16]) for i in range(0, len(vals), 16)]
    return "{\n    " + ",\n    ".join(lines) + "\n}"


def header_text() -> str:
    """rns_tables.h: constants of rns_constants.py plus the static biases."""
    out = [
        "// Generated by plonky2_bls12_381_pairing_torch/ops/rns/kernel_tables.py",
        "// from rns_constants.py and the plain formulas' static bounds.",
        "#pragma once",
        "",
        f"#define RNS_NCH {RC.NCH}",
        f"#define RNS_SUB {RC.SUB}",
        f"#define RNS_LANES {RC.LANES}",
        f"#define RNS_PACK {RC.PACK}",
        f"#define RNS_A_LO {RC.A_LO}",
        f"#define RNS_B_LO {RC.B_LO}",
        f"#define RNS_ALPHA_LANE {RC.ALPHA_LANE}",
        f"#define RNS_ALPHA_T {RC.ALPHA_T}",
        f"#define RNS_BETA_T {RC.BETA_T}",
        "// RNS_CYC_BIAS / RNS_MUL_BIAS: residues of k*p, k the nonneg bias",
        "// multiple of each REDC input of a squaring / product.",
        "",
    ]
    for name, arr in tables().items():
        ctype = "float" if arr.dtype == np.float32 else "int"
        dims = "".join(f"[{d}]" for d in arr.shape)
        out.append(f"__constant__ {ctype} {name}{dims} = {_c_values(arr)};")
        out.append("")
    return "\n".join(out)
