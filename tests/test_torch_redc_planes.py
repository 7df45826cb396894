"""The tensor-core REDC's base extensions (csrc/rns_redc_tc.cuh) on the CPU.

The kernels run each base extension as three u8 matrix products of 7/6-bit
planes, combined in int32 the way fp._ext_matmul combines its float32
products. These tests take the u8 plane tables from the generated header
(rns_tables.h, ops/rns/kernel_tables.py), compute with numpy int64 what the
tensor cores compute, and hold it to the exact products with the extension
blocks and, through the kernel's lane steps, to fp.redc's rows."""

import re

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernel_tables as KT

_CTYPES = {"int": np.int64, "float": np.float32, "unsigned char": np.int64}


@pytest.fixture(scope="module")
def hdr() -> dict:
    """Every array of the generated header, by its C name."""
    text = KT.header_text()
    pat = re.compile(r"__device__ const (int|float|unsigned char) (\w+)((?:\[\d+\])+) = "
                     r"\{([^}]*)\};")
    out = {}
    for ctype, name, dims, body in pat.findall(text):
        shape = tuple(int(d) for d in re.findall(r"\d+", dims))
        vals = [v.strip() for v in body.replace("\n", " ").split(",") if v.strip()]
        conv = (lambda v: float.fromhex(v.rstrip("f"))) if ctype == "float" else int
        out[name] = np.array([conv(v) for v in vals], dtype=_CTYPES[ctype]).reshape(shape)
    return out


def planes(x: np.ndarray) -> tuple:
    lo, hi = x & ((1 << RC.PLANE_BITS) - 1), x >> RC.PLANE_BITS
    return lo, hi, lo + hi


def tc_extend(sig: np.ndarray, table: np.ndarray) -> np.ndarray:
    """What the kernel's extend computes: sig (M, 32) canonical residues,
    table (3, N, 32) the u8 planes at [plane, column, k] -> (M, N) sums.
    Every term is non-negative, so each partial sum of the tensor cores is at
    most the full sum checked here."""
    sp = planes(sig)
    assert all(0 <= p.min() and p.max() < 256 for p in sp)
    assert 0 <= table.min() and table.max() < 256
    ll, hh, ss = (sp[p] @ table[p].T for p in range(3))
    assert max(ll.max(), hh.max(), ss.max()) < 2**31
    cross = ss - ll - hh
    assert cross.min() >= 0
    out = ll + (cross << RC.PLANE_BITS) + (hh << (2 * RC.PLANE_BITS))
    assert out.max() < 2**31
    return out


def test_plane_tables_shape_and_pads(hdr):
    t1, t2 = hdr["RNS_T1_PLANES"], hdr["RNS_T2_PLANES"]
    assert t1.shape == (3, KT.TC_N1, KT.TC_K) and t2.shape == (3, KT.TC_N2, KT.TC_K)
    # the pad row (k = 31) and the pad columns are zero in every plane, so
    # whatever the pad column of the sigma matrix holds adds nothing
    assert not t1[:, :, RC.NCH:].any() and not t2[:, :, RC.NCH:].any()
    assert not t1[:, len(KT.TC_T1_LANES):].any()
    assert len(KT.TC_T2_LANES) == KT.TC_N2
    assert np.array_equal(t1[2], t1[0] + t1[1]) and np.array_equal(t2[2], t2[0] + t2[1])
    assert t1.max() <= 190 and t2.max() <= 190


@pytest.mark.parametrize("step", [2, 4])
@pytest.mark.parametrize("kind", ["random", "m-1"])
def test_extension_equals_exact_product(hdr, step, kind):
    """sigma @ T1A (step 2, base-A sigmas onto base B, r and alpha) and
    sigma' @ T2B (step 4, base-B sigmas onto base A and beta), exactly, over
    random canonical sigmas and the largest ones (m - 1 in every channel)."""
    if step == 2:
        primes, block, lanes = RC.A_PRIMES, hdr["RNS_T1A"], KT.TC_T1_LANES
        table = hdr["RNS_T1_PLANES"]
    else:
        primes, block, lanes = RC.B_PRIMES, hdr["RNS_T2B"], KT.TC_T2_LANES
        table = hdr["RNS_T2_PLANES"]
    m = np.array(primes, dtype=np.int64)
    rows = 24 * KT.TC_ROWS
    sig = np.zeros((rows, KT.TC_K), dtype=np.int64)
    if kind == "random":
        sig[:, :RC.NCH] = np.random.default_rng(step).integers(0, m, (rows, RC.NCH))
    else:
        sig[:, :RC.NCH] = m - 1
    got = tc_extend(sig, table)
    want = sig[:, :RC.NCH] @ block[:, list(lanes)]
    assert np.array_equal(got[:, :len(lanes)], want)
    assert not got[:, len(lanes):].any()


def _barrett(x: np.ndarray, m: np.ndarray, inv_m: np.ndarray) -> np.ndarray:
    """rns_common.cuh barrett: unfused float32 product, rounded half to even."""
    assert np.abs(x).max() < 2**31 - 2**27
    q = np.rint(x.astype(np.float32) * inv_m).astype(np.int64)
    r = x - q * m
    return np.where(r < 0, r + m, r)


def kernel_redc(hdr, x: np.ndarray) -> np.ndarray:
    """rns_redc_tc.cuh redc on canonical residues x (rows, K, LANES): steps
    1, 3 and 5 lane by lane, steps 2 and 4 as tc_extend over the tile's
    (row, component, slot) rows, alpha and beta from their columns."""
    c = {k: hdr[f"RNS_{k.upper()}"].astype(np.int64) for k in (
        "m", "c_sigma", "c_mainv", "c_pmainv", "c_mamod", "c_mainv_mbinv",
        "c_pmainv_mbinv", "c_mbmod")}
    inv_m = hdr["RNS_INV_M"].astype(np.float32)
    m = c["m"]
    shape = x.shape
    x = x.reshape(-1, RC.PACK, RC.SUB).astype(np.int64)  # one sigma row each
    bar = lambda v: _barrett(v, m, inv_m)
    # step 1; lane B_LO's sigma is 0 and fills the pad column
    sigma = bar(x * c["c_sigma"])[..., :KT.TC_K].reshape(-1, KT.TC_K)
    assert not sigma[:, RC.NCH].any()
    e1 = tc_extend(sigma, hdr["RNS_T1_PLANES"]).reshape(*x.shape[:2], KT.TC_N1)
    # step 3 on lanes B_LO..ALPHA_LANE
    out = np.zeros_like(x)
    sig2 = np.zeros((*x.shape[:2], KT.TC_K), dtype=np.int64)
    alpha = e1[..., RC.ALPHA_LANE - RC.B_LO:RC.ALPHA_LANE - RC.B_LO + 1] >> RC.ALPHA_T
    br = slice(RC.B_LO, RC.SUB)
    mb, ib = m[br], inv_m[br]
    qh = _barrett(e1[..., :RC.SUB - RC.B_LO] - alpha * c["c_mamod"][br], mb, ib)
    sp = _barrett(x[..., br] * c["c_mainv_mbinv"][br] + qh * c["c_pmainv_mbinv"][br], mb, ib)
    out[..., br] = _barrett(x[..., br] * c["c_mainv"][br] + qh * c["c_pmainv"][br], mb, ib)
    sig2[:] = sp[..., :KT.TC_K]
    assert not sig2[..., RC.NCH].any()  # the redundant lane's: the pad column
    e2 = tc_extend(sig2.reshape(-1, KT.TC_K), hdr["RNS_T2_PLANES"]).reshape(
        *x.shape[:2], KT.TC_N2)
    # step 5 on base A
    beta = (e2[..., KT.TC_N2 - 1:] + (1 << (RC.BETA_T - 1))) >> RC.BETA_T
    a = slice(RC.A_LO, RC.A_HI)
    out[..., a] = _barrett(e2[..., :RC.NCH] - beta * c["c_mbmod"][a], m[a], inv_m[a])
    return out.reshape(shape)


def test_kernel_redc_gives_fp_redc_rows(hdr):
    """The alpha and beta columns and the lane steps: the stored rows of
    fp.redc on a few packed rows of 12 stacked inputs X < MA p, the largest
    such X among them."""
    rng = np.random.default_rng(0x7C)
    n_rows, k = 3, 12
    xs = [int.from_bytes(rng.bytes(64), "little") % (RC.MA * RC.P)
          for _ in range(n_rows * k * RC.PACK)]
    xs[0], xs[1] = RC.MA * RC.P - 1, 0
    ch = np.stack([RC.residues_slot(v) for v in xs]).reshape(n_rows, k, RC.PACK * RC.SUB)
    x = fp.R(torch.from_numpy(ch.astype(np.int32)), 0, RC.PRIME_MAX - 1, 0, RC.REDC_MAX)
    assert not fp.redc_needs_canon(x)
    want = fp.redc(x).numpy()
    assert np.array_equal(kernel_redc(hdr, ch), want)
