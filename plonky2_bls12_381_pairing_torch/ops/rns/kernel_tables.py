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
Every row is slot-local (64 lanes): both packed slots share it. The
tensor-core REDC (csrc/rns_redc_tc.cuh) takes the two base-extension blocks
as u8 planes in the layout of its matrix products (tc_planes).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import rns_constants as RC
from . import fp, lines, tower

_SLOT = slice(0, RC.SUB)


#: The stacked REDCs of the line steps in the order the plain formulas run
#: them (ops/rns/lines.py), by table key: doubling_step's stages 1-3 and
#: addition_step's stages A-E, a trailing "s" where the stage differs with
#: scale=(py, px).
LINE_STAGES = {(False, False): ("dbl1", "dbl2", "dbl3"),
               (False, True): ("dbl1", "dbl2", "dbl3s"),
               (True, False): ("add_a", "add_b", "add_c", "add_d", "add_e"),
               (True, True): ("add_a", "add_b", "add_c", "add_ds", "add_es")}


def line_biases() -> dict[str, list[int]]:
    """Bias multiple k of each REDC input row of doubling_step and
    addition_step in both scale modes, read off the plain formulas as they
    run on a dummy point: every fp.redc_stack / fp.redc_cat they call is
    recorded with its per-entry nonneg multiples (a multi-row entry of
    redc_cat, such as a scaling term, gives its k to each of its rows)."""
    z = torch.zeros((1, 2, RC.LANES), dtype=torch.int32)
    r = lines.G2Projective(z, z, z)
    q = lines.G2Affine(z, z, torch.zeros((1, RC.LANES), dtype=torch.int32))
    w = fp.wrap(z[:, :1])
    stack, cat = fp.redc_stack, fp.redc_cat
    out: dict[str, list[int]] = {}
    for (is_add, scaled), names in LINE_STAGES.items():
        rec: list[list[int]] = []

        def rec_stack(rs, dim=-2):
            rec.append([fp.nonneg_multiple(x) for x in rs])
            return stack(rs, dim)

        def rec_cat(rs, dim=-2):
            rec.append([fp.nonneg_multiple(x) for x in rs for _ in range(x.ch.shape[dim])])
            return cat(rs, dim)

        fp.redc_stack, fp.redc_cat = rec_stack, rec_cat
        try:
            scale = (w, w) if scaled else None
            if is_add:
                lines.addition_step(r, q, scale=scale)
            else:
                lines.doubling_step(r, scale=scale)
        finally:
            fp.redc_stack, fp.redc_cat = stack, cat
        assert len(rec) == len(names)
        for name, ks in zip(names, rec):
            assert out.setdefault(name, ks) == ks, name
    # scaled mode's stage D is the plain stage D and the coefficients c0, c1
    assert out["add_ds"][:8] == out["add_d"]
    return out


def static_biases() -> dict[str, list[int]]:
    """Bias multiple k of each REDC input of one Granger-Scott squaring
    ("cyc"), Fq12 product ("mul"), complex squaring ("sq") and sparse product
    mul_by_014 ("m014"), 12 each; of the 4 rows of the Miller step's
    coefficient scaling ("ell": c0*P.y, c1*P.x); of one Karabina squaring
    ("kara", 8); and of the stacked REDCs of the Karabina decompression: the
    numerator candidates ("knum", 4), the scaled conjugate of the denominator
    ("kdinv", 2), g1 ("kg1", 2) and g0 ("kg0", 2); and of the line steps'
    stacked REDCs (line_biases: "dbl1" 8, "dbl2" 10, "dbl3" 2 or "dbl3s" 6;
    "add_a" 6, "add_b" 4, "add_c" 6, "add_d" 8 or "add_ds" 12, "add_e" 6 or
    "add_es" 6)."""
    z = torch.zeros((1, 12, RC.LANES), dtype=torch.int32)
    d = z[:, :2]
    w = fp.wrap(z[:, :1])
    c8 = z[:, :8]
    s = fp.wrap(z[:, 0])
    # the decompression's single-row REDCs (the norm, the inverse over 4) and
    # the steps of the Fermat power reduce sums of products of stored values:
    # the kernels add no bias there
    assert fp.nonneg_multiple(fp.mul_rr(s, s) + fp.mul_rr(s, s)) == 0
    assert fp.nonneg_multiple(fp.mul_rr(s, tower.quarter(z))) == 0
    return {
        "kara": [fp.nonneg_multiple(r) for r in tower._kara_square_terms(c8)],
        "knum": [fp.nonneg_multiple(r) for r in tower._decompress_num_terms(c8)],
        "kdinv": [fp.nonneg_multiple(r) for r in tower._fq2_conj_scaled_terms(d, s)],
        "kg1": [fp.nonneg_multiple(r) for r in tower._decompress_g1_terms(d, d)],
        "kg0": [fp.nonneg_multiple(r) for r in tower._decompress_g0_terms(c8, d)],
        "cyc": [fp.nonneg_multiple(r) for r in tower._cyc_square_terms(z)],
        "mul": [fp.nonneg_multiple(r) for r in tower._mul_terms(z, z)],
        "sq": [fp.nonneg_multiple(r) for r in tower._square_terms(z)],
        "m014": [fp.nonneg_multiple(r) for r in tower._mul014_terms(z, d, d, d)],
        # each scaling term is a 2-row R with one bound for both rows
        "ell": [fp.nonneg_multiple(r) for r in lines.scale_terms(d, d, w, w)
                for _ in range(2)],
        **line_biases(),
    }


#: The tensor-core REDC's products run over K = 32: the 31 channels of one
#: base and a zero pad.
TC_K = 32
#: Step 2's columns: the slot lanes B_LO..ALPHA_LANE (base B, the redundant
#: lane, the alpha column), padded to whole 8-column tiles; step 4's: the
#: base-A lanes and the beta column (ALPHA_LANE).
TC_T1_LANES = tuple(range(RC.B_LO, RC.SUB))
TC_N1 = 40
TC_T2_LANES = tuple(range(RC.A_LO, RC.A_HI)) + (RC.ALPHA_LANE,)
TC_N2 = 32
#: Packed rows per block (a tile) of the kernels on the tensor-core REDC:
#: the sigma matrix has 24 rows per packed row, so an even count makes it
#: whole 16-row tiles.
TC_ROWS = 4


def tc_planes(block: np.ndarray, lanes, n_cols: int) -> np.ndarray:
    """(3, n_cols, TC_K) uint8: at [p, n, k] plane p (lo, hi, lo + hi of the
    7/6-bit split, as fp._ext_matmul) of block[k, lanes[n]], the extension
    block's row k (channel k of the base) and column lanes[n]; zero in the
    pad row k = 31 and the pad columns."""
    t = np.zeros((n_cols, TC_K), dtype=np.int64)
    t[:len(lanes), :RC.NCH] = block[:, list(lanes)].T
    lo, hi = t & ((1 << RC.PLANE_BITS) - 1), t >> RC.PLANE_BITS
    planes = np.stack([lo, hi, lo + hi])
    assert planes.max() < 256
    return planes.astype(np.uint8)


#: C name of each bias table.
BIAS_TABLES = {"cyc": "RNS_CYC_BIAS", "mul": "RNS_MUL_BIAS", "sq": "RNS_SQ_BIAS",
               "m014": "RNS_M014_BIAS", "ell": "RNS_ELL_BIAS",
               "kara": "RNS_KARA_BIAS", "knum": "RNS_KNUM_BIAS",
               "kdinv": "RNS_KDINV_BIAS", "kg1": "RNS_KG1_BIAS",
               "kg0": "RNS_KG0_BIAS",
               **{key: f"RNS_{key.upper()}_BIAS"
                  for key in ("dbl1", "dbl2", "dbl3", "dbl3s", "add_a", "add_b",
                              "add_c", "add_d", "add_ds", "add_e", "add_es")}}


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
        # the same blocks as the tensor-core REDC's u8 plane operands
        "RNS_T1_PLANES": tc_planes(RC.T1[RC.A_LO:RC.A_HI, _SLOT], TC_T1_LANES, TC_N1),
        "RNS_T2_PLANES": tc_planes(RC.T2[RC.B_LO:RC.B_HI, _SLOT], TC_T2_LANES, TC_N2),
        # the Karabina decompression: the rows of k*p a stored zero can
        # equal (every lane but ALPHA_LANE is a channel), the stored one and
        # 4^-1, and 4p for the negation 4p - x
        "RNS_ZERO_TEST": RC.ZERO_TEST_ROWS[:, _SLOT],
        "RNS_ONE": RC.ONE[_SLOT],
        "RNS_QUARTER": tower._QUARTER[_SLOT],
        "RNS_PMUL4": RC.p_mult_row(4)[_SLOT],
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
        f"#define RNS_PLANE_BITS {RC.PLANE_BITS}",
        f"#define RNS_TC_K {TC_K}",
        f"#define RNS_TC_N1 {TC_N1}",
        f"#define RNS_TC_N2 {TC_N2}",
        f"#define RNS_TC_ROWS {TC_ROWS}",
        "// flat Fq12 component of each compressed Karabina component",
        f"#define RNS_KARA_IDX {{{', '.join(map(str, tower._KARA_IDX))}}}",
        "// RNS_*_BIAS: residues of k*p, k the nonneg bias multiple of each REDC",
        "// input of the formula (kernel_tables.static_biases).",
        "// The tables are indexed by lane, a different entry for every thread",
        "// of a warp, so they lie in device memory, not in constant memory.",
        "",
    ]
    for name, arr in tables().items():
        ctype = {np.dtype(np.float32): "float",
                 np.dtype(np.uint8): "unsigned char"}.get(arr.dtype, "int")
        dims = "".join(f"[{d}]" for d in arr.shape)
        out.append(f"__device__ const {ctype} {name}{dims} = {_c_values(arr)};")
        out.append("")
    return "\n".join(out)
