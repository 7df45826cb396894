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
from . import fp, lines, tower

_SLOT = slice(0, RC.SUB)


def static_biases() -> dict[str, list[int]]:
    """Bias multiple k of each REDC input of one Granger-Scott squaring
    ("cyc"), Fq12 product ("mul"), complex squaring ("sq") and sparse product
    mul_by_014 ("m014"), 12 each, and of the 4 rows of the Miller step's
    coefficient scaling ("ell": c0*P.y, c1*P.x)."""
    z = torch.zeros((1, 12, RC.LANES), dtype=torch.int32)
    d = z[:, :2]
    w = fp.wrap(z[:, :1])
    return {
        "cyc": [fp.nonneg_multiple(r) for r in tower._cyc_square_terms(z)],
        "mul": [fp.nonneg_multiple(r) for r in tower._mul_terms(z, z)],
        "sq": [fp.nonneg_multiple(r) for r in tower._square_terms(z)],
        "m014": [fp.nonneg_multiple(r) for r in tower._mul014_terms(z, d, d, d)],
        # each scaling term is a 2-row R with one bound for both rows
        "ell": [fp.nonneg_multiple(r) for r in lines.scale_terms(d, d, w, w)
                for _ in range(2)],
    }


#: C name of each bias table.
BIAS_TABLES = {"cyc": "RNS_CYC_BIAS", "mul": "RNS_MUL_BIAS", "sq": "RNS_SQ_BIAS",
               "m014": "RNS_M014_BIAS", "ell": "RNS_ELL_BIAS"}


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
    }
    for key, name in BIAS_TABLES.items():
        t[name] = np.stack([RC.p_mult_row(k)[_SLOT] for k in biases[key]])
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
        "// RNS_*_BIAS: residues of k*p, k the nonneg bias multiple of each REDC",
        "// input of the formula (kernel_tables.static_biases).",
        "// The tables are indexed by lane, a different entry for every thread",
        "// of a warp, so they lie in device memory, not in constant memory.",
        "",
    ]
    for name, arr in tables().items():
        ctype = "float" if arr.dtype == np.float32 else "int"
        dims = "".join(f"[{d}]" for d in arr.shape)
        out.append(f"__device__ const {ctype} {name}{dims} = {_c_values(arr)};")
        out.append("")
    return "\n".join(out)
