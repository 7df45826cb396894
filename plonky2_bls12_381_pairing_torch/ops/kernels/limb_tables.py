"""The tables and static decisions of the limb tier's CUDA kernels, as a C
header (limb_tables.h in the build directory).

The kernels in csrc/mont.cu and csrc/limb_tower.cu compute exact integers, so
a stored row depends only on the constants and on the static shift-add pass
counts of the reduction, which are part of the result (a further pass on
digits already in range can change the stored representative). Both come
from here, read off the port's plain formulas:
  * the rows of constants.py: p and p' digits, the bias row K_BIAS * p, the
    quotient-test weights, NEGC and R mod p;
  * the two fixed pass counts of the reduction and the first count of the
    fused product (ops/kernels/mont.py);
  * per tower formula (ops/kernels/tower.py `formula`): the operand terms,
    the output combinations (as lists of their nonzero terms),
    the product count and the first pass count of its merged reduction.
"""

from __future__ import annotations

import numpy as np

from ... import constants as C
from . import mont, tower

LANES = 128


def _row(values: np.ndarray, n: int = LANES) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    out[: len(values)] = values
    return out


def tables() -> dict[str, np.ndarray]:
    """Every array the header defines, by its C name. The per-formula tables
    are stacked in tower.FORMULAS order and zero-padded to the largest
    formula."""
    fs = [tower.formula(name) for name in tower.FORMULAS]
    shape = (len(fs), tower.MAX_PRODUCTS, 2, tower.MAX_TERMS)
    slots = np.zeros(shape, dtype=np.int32)
    coefs = np.zeros(shape, dtype=np.int32)
    # each output's combination as the list of its nonzero terms (product
    # index, coefficient, zero-padded) and its length
    out_p = np.zeros((len(fs), 12, max_out_terms()), dtype=np.int32)
    out_c = np.zeros_like(out_p)
    out_n = np.zeros((len(fs), 12), dtype=np.int32)
    for i, f in enumerate(fs):
        slots[i, : f.products] = f.slots
        coefs[i, : f.products] = f.coefs
        for j in range(12):
            nz = np.flatnonzero(f.outputs[j])
            out_p[i, j, : len(nz)] = nz
            out_c[i, j, : len(nz)] = f.outputs[j, nz]
            out_n[i, j] = len(nz)
    return {
        "LIMB_P": C.P_LIMBS.astype(np.int32),
        "LIMB_PPRIME": C.PPRIME_LIMBS.astype(np.int32),
        # lane rows: the bias row on the first NBIAS lanes, the quotient
        # weights on the first NRED lanes, zero elsewhere
        "LIMB_BIAS": _row(C.BIAS_DIGITS),
        "LIMB_QW": C.QMOD_WEIGHTS.astype(np.int32),
        "LIMB_NEGC": C.NEGC_LIMBS.astype(np.int32),
        "LIMB_ONE_MONT": C.ONE_MONT.astype(np.int32),
        "LIMB_TOWER_SLOT": slots,
        "LIMB_TOWER_COEF": coefs,
        "LIMB_TOWER_OUT_P": out_p,
        "LIMB_TOWER_OUT_C": out_c,
        "LIMB_TOWER_OUT_N": out_n,
    }


def max_out_terms() -> int:
    """The most nonzero terms of one output's combination, any formula."""
    return max(int(np.count_nonzero(tower.formula(name).outputs, axis=1).max())
               for name in tower.FORMULAS)


def defines() -> dict[str, int]:
    fs = [tower.formula(name) for name in tower.FORMULAS]
    d = {
        "LIMB_NLIMBS": C.NLIMBS,
        "LIMB_NRED": C.NRED,
        "LIMB_NCOLS": mont.NCOLS,
        "LIMB_LANES": LANES,
        "LIMB_QMOD": C.QMOD,
        "LIMB_R_MOD_QMOD": C.R_MOD_QMOD,
        "LIMB_NPASS_M": mont.NPASS_M,
        "LIMB_NPASS_S": mont.NPASS_S,
        "LIMB_NPASS_MUL": mont.first_pass_count(0, mont.MUL_COL_HI),
        "LIMB_TOWER_NSLOTS": tower.NSLOTS,
        "LIMB_TOWER_SLOT_B": tower.SLOT_B,
        "LIMB_TOWER_SLOT_NEGC": tower.SLOT_NEGC,
        "LIMB_TOWER_SLOT_ONE": tower.SLOT_ONE,
        "LIMB_TOWER_MAX_TERMS": tower.MAX_TERMS,
        "LIMB_TOWER_MAX_PRODUCTS": tower.MAX_PRODUCTS,
    }
    for i, f in enumerate(fs):
        tag = f.name.upper()
        d[f"LIMB_TOWER_{tag}"] = i
        d[f"LIMB_TOWER_{tag}_PRODUCTS"] = f.products
        d[f"LIMB_TOWER_{tag}_NPASS"] = f.first_passes
    return d


def header_text() -> str:
    out = [
        "// Generated by plonky2_bls12_381_pairing_torch/ops/kernels/limb_tables.py",
        "// from constants.py and the plain formulas' static bounds.",
        "#pragma once",
        "",
    ]
    out += [f"#define {name} {value}" for name, value in defines().items()]
    out += [
        "// The tables are indexed by lane or by thread, a different entry for",
        "// every thread of a warp, so they lie in device memory, not in",
        "// constant memory.",
        "",
    ]
    for name, arr in tables().items():
        dims = "".join(f"[{d}]" for d in arr.shape)
        vals = [str(int(v)) for v in arr.reshape(-1)]
        lines = [", ".join(vals[i:i + 16]) for i in range(0, len(vals), 16)]
        out.append(f"__device__ const int {name}{dims} = {{\n    "
                   + ",\n    ".join(lines) + "\n};")
        out.append("")
    return "\n".join(out)
