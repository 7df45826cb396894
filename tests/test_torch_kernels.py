"""The port's kernel wrappers, the generated kernel header and the port's
import boundary.

On the CPU a wrapper runs its plain version and counts no launch; on a CUDA
device it launches its kernel or raises. The tests marked `gpu` hold each
kernel bit for bit to its plain version and skip where there is no card."""

import ast
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.models.schedule import (_DO_SQUARE, _FUSED_FLAGS,
                                                             _GS_SEGMENTS, _IS_ADD,
                                                             _KARA_SEGMENTS)
from plonky2_bls12_381_pairing_torch.ops.rns import (fp, kernel_tables, kernels, lines,
                                                     tower)
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "plonky2_bls12_381_pairing_torch"


def cyclotomic_rows(n: int, seed: int) -> np.ndarray:
    r = random.Random(seed)
    out = []
    for _ in range(n):
        f = rm.rand_fq12(r)
        t = f.frobenius_pow(6) * f.inv()
        out.append(t.frobenius_pow(2) * t)
    return tower.encode(out)


def fp_rows(n: int, seed: int) -> np.ndarray:
    r = random.Random(seed)
    xs = [r.randrange(rm.P) for _ in range(n)]
    xs[1] = 0
    return fp.encode(xs)


def fq12_rows(n: int, seed: int) -> np.ndarray:
    r = random.Random(seed)
    return tower.encode([rm.rand_fq12(r) for _ in range(n)])


def fq2_rows(n: int, seed: int) -> np.ndarray:
    r = random.Random(seed)
    return fp.encode(np.array([[r.randrange(rm.P), r.randrange(rm.P)]
                               for _ in range(n)], dtype=object))


def miller_inputs(n: int, seed: int, device):
    """n point pairs (the second G1 point and the third G2 point at infinity)
    as miller_run takes them: f0, step-major coefficients, py, px, skip."""
    r = random.Random(seed)
    ps = [rm.rand_g1(r) for _ in range(n)]
    qs = [rm.rand_g2(r) for _ in range(n)]
    ps[1] = rm.G1Affine(0, 0, True)
    qs[2 % n] = rm.G2Affine(rm.Fq2(0, 0), rm.Fq2(0, 0), True)
    p = G1Affine.encode(ps, device=device)
    q = G2Affine.encode(qs, device=device)
    skip = ((p.infinity != 0) | (q.infinity != 0)).to(torch.int32)
    f0 = tower.one(p.infinity.shape[:-1], device)
    return f0, mpr.prepare_g2_stepmajor(q), p.y, p.x, skip


def fused_inputs(n: int, seed: int, device):
    """The same point pairs as miller_inputs, as miller_fused takes them:
    f0, R, Q, py, px, skip and the step flags."""
    r = random.Random(seed)
    ps = [rm.rand_g1(r) for _ in range(n)]
    qs = [rm.rand_g2(r) for _ in range(n)]
    ps[1] = rm.G1Affine(0, 0, True)
    qs[2 % n] = rm.G2Affine(rm.Fq2(0, 0), rm.Fq2(0, 0), True)
    return mpr._fused_args(G1Affine.encode(ps, device=device),
                           G2Affine.encode(qs, device=device))


def test_cpu_wrappers_run_plain_versions():
    a = torch.from_numpy(cyclotomic_rows(2, 0xE1))
    segs = ((2, True), (1, True), (3, False))
    kernels.reset_launches()
    got = kernels.cyc_exp(a, segs)
    want = a
    for n, m in segs:
        for _ in range(n):
            want = tower.cyclotomic_square(want)
        if m:
            want = tower.mul(want, a)
    assert torch.equal(got, want)
    x = torch.from_numpy(fp_rows(4, 0xE2))
    assert torch.equal(kernels.pow_static_fused(x, 0xD201), fp.pow_static(x, 0xD201))
    f, g = (torch.from_numpy(fq12_rows(2, s)) for s in (0xE7, 0xE8))
    d0, d1, d4 = (torch.from_numpy(fq2_rows(2, s)) for s in (0xE9, 0xEA, 0xEB))
    skip = torch.zeros((1, RC.LANES), dtype=torch.int32)
    skip[0, RC.SUB:] = 1
    assert torch.equal(kernels.fq12_mul(f, g), tower.mul_plain(f, g))
    assert torch.equal(kernels.fq12_square(f), tower.square_plain(f))
    assert torch.equal(kernels.fq12_cyclotomic_square(a),
                       tower.cyclotomic_square_plain(a))
    assert torch.equal(kernels.fq12_mul_by_014(f, d0, d1, d4),
                       tower.mul_by_014_plain(f, d0, d1, d4))
    assert torch.equal(kernels.fq12_mul_by_014_square(f, d0, d1, d4, skip),
                       tower.mul_by_014_square_plain(f, d0, d1, d4, skip))
    # the dispatching tower ops are those wrappers
    assert torch.equal(tower.mul(f, g), tower.mul_plain(f, g))
    assert torch.equal(tower.square(f), tower.square_plain(f))
    args = miller_inputs(2, 0xEC, "cpu")
    assert torch.equal(kernels.miller_run(*args, _DO_SQUARE),
                       kernels.miller_run_plain(*args, _DO_SQUARE))
    fused = fused_inputs(2, 0xEC, "cpu")
    assert torch.equal(kernels.miller_fused(*fused), kernels.miller_fused_plain(*fused))
    assert torch.equal(kernels.prepare_g2_lines(*fused[1:6], _IS_ADD), args[1])
    # the forms of the exponentiation: runs of squarings, the one-loop form,
    # the Karabina chain and the whole Karabina exponentiation
    assert torch.equal(kernels.cyc_exp_cond(a, segs), got)
    assert torch.equal(kernels.cyc_square_run(a, 3), kernels.cyc_square_run_plain(a, 3))
    assert torch.equal(kernels.cyc_square_run(a, 0), a)
    c = tower.compress_cyclotomic(a)
    assert torch.equal(kernels.kara_square_run(c, 2), tower.compressed_square(
        tower.compressed_square_plain(c)))
    snaps = kernels.kara_exp(c, (2, 0, 1))
    assert snaps.shape == (3, *c.shape) and torch.equal(snaps[0], snaps[1])
    assert torch.equal(snaps, kernels.kara_exp_plain(c, (2, 0, 1)))
    small = (1, 0, 2, 1, 0, 1)
    assert torch.equal(kernels.kara_full(a, small), kernels.kara_full_plain(a, small))
    assert set(kernels.launches) == {
        "cyc_exp", "cyc_exp_cond", "cyc_square_run", "kara_square_run", "kara_exp",
        "kara_full", "pow_static", "miller_run", "miller_fused", "prepare_g2_lines",
        "fq12_mul", "fq12_square", "fq12_mul_by_014", "fq12_mul_by_014_square",
        "fq12_cyclotomic_square"}
    assert all(n == 0 for n in kernels.launches.values())
    with pytest.raises(ValueError):
        kernels.kara_full(a, (1, 2, 3))
    with pytest.raises(ValueError):
        kernels.miller_run(args[0], [], [], [], [], _DO_SQUARE)
    with pytest.raises(ValueError):
        kernels.kara_exp(c, ())
    with pytest.raises(ValueError):
        kernels.cyc_square_run(a, -1)
    with pytest.raises(ValueError):
        kernels.pow_static_fused(x, 0)


def test_row_views_of_kernel_operands():
    """What the tower kernels read in place (one row stride) and what is
    copied first."""
    tail = (12, RC.LANES)
    one = tower.one((6,), "cpu")                      # broadcast over the batch
    v, stride = kernels._row_view(one, (6,), tail)
    assert stride == 0 and v.data_ptr() == one.data_ptr()
    v, stride = kernels._row_view(one[0], (4, 6), tail)  # broadcast over two axes
    assert stride == 0 and v.shape == (24, *tail)
    wide = torch.arange(6 * 4 * RC.LANES, dtype=torch.int32).reshape(6, 4, RC.LANES)
    part = wide[..., 2:4, :]                          # a slice of a wider stack
    v, stride = kernels._row_view(part, (6,), (2, RC.LANES))
    assert stride == 4 * RC.LANES and v.data_ptr() == part.data_ptr()
    assert torch.equal(v, part)
    full = torch.arange(6 * 12 * RC.LANES, dtype=torch.int32).reshape(6, *tail)
    v, stride = kernels._row_view(full, (6,), tail)
    assert stride == 12 * RC.LANES and v.data_ptr() == full.data_ptr()
    v, stride = kernels._row_view(full, (4, 6), tail)  # partly broadcast: a copy
    assert stride == 12 * RC.LANES and v.data_ptr() != full.data_ptr()
    assert torch.equal(v.view(4, 6, *tail), full.expand(4, 6, *tail))
    v, stride = kernels._row_view(wide[..., ::2], (6,), (4, RC.SUB))  # tail not dense
    assert stride == 4 * RC.SUB and torch.equal(v, wide[..., ::2])


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on a CUDA device
    is refused, never computed by the plain version."""
    with pytest.raises(ValueError):
        kernels.cyc_exp(torch.empty((1, 12, RC.LANES), dtype=torch.int32,
                                    device="meta"), _GS_SEGMENTS)
    with pytest.raises(ValueError):
        kernels.pow_static_fused(torch.empty((1, RC.LANES), dtype=torch.int32,
                                             device="meta"), rm.P - 2)
    f = torch.empty((1, 12, RC.LANES), dtype=torch.int32, device="meta")
    c = torch.empty((1, 8, RC.LANES), dtype=torch.int32, device="meta")
    d = torch.empty((1, 2, RC.LANES), dtype=torch.int32, device="meta")
    row = torch.empty((1, RC.LANES), dtype=torch.int32, device="meta")
    for call in (lambda: kernels.fq12_mul(f, f), lambda: kernels.fq12_square(f),
                 lambda: kernels.cyc_exp_cond(f, _GS_SEGMENTS),
                 lambda: kernels.cyc_square_run(f, 2),
                 lambda: kernels.kara_square_run(c, 2),
                 lambda: tower.compressed_square(c),
                 lambda: kernels.kara_exp(c, _KARA_SEGMENTS),
                 lambda: kernels.kara_full(f, _KARA_SEGMENTS),
                 lambda: kernels.fq12_cyclotomic_square(f),
                 lambda: kernels.fq12_mul_by_014(f, d, d, d),
                 lambda: kernels.fq12_mul_by_014_square(f, d, d, d, row),
                 lambda: tower.mul(f, f),
                 lambda: kernels.miller_run(
                     f, torch.empty((68, 1, 3, 2, RC.LANES), dtype=torch.int32,
                                    device="meta"), row, row, row, _DO_SQUARE),
                 lambda: kernels.miller_fused(f, d, d, d, d, d, row, row, row,
                                              _FUSED_FLAGS),
                 lambda: kernels.prepare_g2_lines(d, d, d, d, d, _IS_ADD)):
        with pytest.raises(ValueError):
            call()


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rm.G1Affine.generator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G1Affine.encode([g, g])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tower.one((1,))
    assert G1Affine.encode([g, g], device="cpu").x.device.type == "cpu"


def _header_arrays(text: str) -> dict:
    out = {}
    pat = re.compile(r"__device__ const (int|float|unsigned char) (\w+)((?:\[\d+\])+) = "
                     r"\{([^}]*)\};")
    for ctype, name, dims, body in pat.findall(text):
        shape = tuple(int(d) for d in re.findall(r"\d+", dims))
        vals = [v.strip() for v in body.replace("\n", " ").split(",") if v.strip()]
        if ctype == "float":
            arr = np.array([float.fromhex(v.rstrip("f")) for v in vals], dtype=np.float32)
        else:
            arr = np.array([int(v) for v in vals], dtype=np.int64)
        out[name] = arr.reshape(shape)
    return out


def test_kernel_header_matches_tables():
    """The generated header carries the port's tables exactly (both packed
    slots share each 64-lane row) and the plain formulas' bias rows."""
    arrs = _header_arrays(kernel_tables.header_text())
    tile = lambda name: np.tile(arrs[name], RC.PACK)
    assert np.array_equal(tile("RNS_M"), RC.M_I32)
    assert np.array_equal(tile("RNS_INV_M").astype(np.float32), RC.INV_M_F32)
    for name, ref in (("RNS_C_SIGMA", RC.C_SIGMA), ("RNS_C_MAINV", RC.C_MAINV),
                      ("RNS_C_PMAINV", RC.C_PMAINV), ("RNS_C_MAMOD", RC.C_MAMOD),
                      ("RNS_C_MAINV_MBINV", RC.C_MAINV_MBINV),
                      ("RNS_C_PMAINV_MBINV", RC.C_PMAINV_MBINV),
                      ("RNS_C_MBMOD", RC.C_MBMOD), ("RNS_IS_A", RC.IS_A),
                      ("RNS_MA_MODP", RC.MA_MODP_ROW)):
        assert np.array_equal(tile(name), ref.astype(np.int64)), name
    # the two extension blocks: every row that can be nonzero, and nothing else
    assert np.array_equal(arrs["RNS_T1A"], RC.T1[RC.A_LO:RC.A_HI, :RC.SUB])
    assert np.array_equal(arrs["RNS_T2B"], RC.T2[RC.B_LO:RC.B_HI, :RC.SUB])
    blk = RC.T1[:RC.SUB, :RC.SUB].copy()
    blk[RC.A_LO:RC.A_HI] = 0
    assert not blk.any()
    blk = RC.T2[:RC.SUB, :RC.SUB].copy()
    blk[RC.B_LO:RC.B_HI] = 0
    assert not blk.any()
    assert np.array_equal(RC.T1[RC.SUB:, RC.SUB:], RC.T1[:RC.SUB, :RC.SUB])
    # the same blocks as the tensor-core REDC's u8 planes, [plane, column, k]:
    # step 2's columns are the lanes B_LO..ALPHA_LANE, step 4's the base-A
    # lanes and ALPHA_LANE; zero pads
    t1 = RC.T1[RC.A_LO:RC.A_HI, RC.B_LO:RC.SUB].T
    t2 = RC.T2[RC.B_LO:RC.B_HI, list(range(RC.A_LO, RC.A_HI)) + [RC.ALPHA_LANE]].T
    for name, blk, cols in (("RNS_T1_PLANES", t1, 40), ("RNS_T2_PLANES", t2, 32)):
        arr = arrs[name]
        assert arr.shape == (3, cols, 32), name
        lo, hi = arr[0, :len(blk), :RC.NCH], arr[1, :len(blk), :RC.NCH]
        assert lo.max() < 1 << RC.PLANE_BITS and hi.max() < 1 << (13 - RC.PLANE_BITS)
        assert np.array_equal(lo + (hi << RC.PLANE_BITS), blk), name
        assert np.array_equal(arr[2], arr[0] + arr[1]), name
        assert not arr[:, len(blk):].any() and not arr[:, :, RC.NCH:].any(), name
    biases = kernel_tables.static_biases()
    rows = {"cyc": 12, "mul": 12, "sq": 12, "m014": 12, "ell": 4, "kara": 8,
            "knum": 4, "kdinv": 2, "kg1": 2, "kg0": 2,
            "dbl1": 8, "dbl2": 10, "dbl3": 2, "dbl3s": 6, "add_a": 6, "add_b": 4,
            "add_c": 6, "add_d": 8, "add_ds": 12, "add_e": 6, "add_es": 6}
    assert sorted(kernel_tables.BIAS_TABLES) == sorted(rows)
    for key, name in kernel_tables.BIAS_TABLES.items():
        assert len(biases[key]) == rows[key]
        want = np.stack([RC.p_mult_row(k)[:RC.SUB] for k in biases[key]])
        assert np.array_equal(arrs[name], want), name
    # the decompression's zero test and constants: both slots share each row,
    # and every lane but ALPHA_LANE is a channel (the kernel's zero test
    # passes exactly that lane)
    assert np.array_equal(np.tile(arrs["RNS_ZERO_TEST"], (1, RC.PACK)), RC.ZERO_TEST_ROWS)
    assert np.flatnonzero(~RC.IS_CH[:RC.SUB]).tolist() == [RC.ALPHA_LANE]
    assert np.array_equal(tile("RNS_ONE"), RC.ONE)
    assert np.array_equal(tile("RNS_PMUL4"), RC.p_mult_row(4))
    assert np.array_equal(tile("RNS_QUARTER"), RC.encode_int(pow(4, -1, RC.P)))
    assert fp.decode(RC.encode_int(pow(4, -1, RC.P))) * 4 % RC.P == 1
    assert (f"#define RNS_KARA_IDX {{{', '.join(map(str, tower._KARA_IDX))}}}\n"
            in kernel_tables.header_text())
    assert f"#define RNS_ALPHA_LANE {RC.ALPHA_LANE}\n" in kernel_tables.header_text()
    for name, value in (("RNS_NCH", RC.NCH), ("RNS_ALPHA_T", RC.ALPHA_T),
                        ("RNS_BETA_T", RC.BETA_T), ("RNS_B_LO", RC.B_LO),
                        ("RNS_PLANE_BITS", RC.PLANE_BITS), ("RNS_TC_K", 32),
                        ("RNS_TC_N1", 40), ("RNS_TC_N2", 32),
                        ("RNS_TC_ROWS", kernel_tables.TC_ROWS)):
        assert f"#define {name} {value}\n" in kernel_tables.header_text()


def test_static_biases_match_redc_stack():
    """The header's bias multiples are the ones redc_stack applies: biasing
    by them by hand and reducing gives the squaring's and product's rows."""
    a = torch.from_numpy(cyclotomic_rows(2, 0xE3))
    b = torch.from_numpy(cyclotomic_rows(2, 0xE4))
    d0, d1, d4 = (torch.from_numpy(fq2_rows(2, s)) for s in (0xED, 0xEE, 0xEF))
    biases = kernel_tables.static_biases()
    c = tower.compress_cyclotomic(a)
    num, den = c[..., 4:6, :], c[..., 2:4, :]
    w = fp.wrap(d0[..., 0, :])
    # the scaling's two terms are 2-row values: one row each for the check
    ell = [fp.R(r.ch[..., i, :], r.lo, r.hi, r.vlo, r.vhi)
           for r in lines.scale_terms(d0, d1, fp.wrap(d4[..., :1, :]),
                                      fp.wrap(d4[..., 1:, :])) for i in range(2)]
    for terms, ks, want in (
            (tower._cyc_square_terms(a), biases["cyc"], tower.cyclotomic_square(a)),
            (tower._mul_terms(a, b), biases["mul"], tower.mul(a, b)),
            (tower._square_terms(a), biases["sq"], tower.square(a)),
            (tower._mul014_terms(a, d0, d1, d4), biases["m014"],
             tower.mul_by_014(a, d0, d1, d4)),
            (ell, biases["ell"], fp.redc_cat(lines.scale_terms(
                d0, d1, fp.wrap(d4[..., :1, :]), fp.wrap(d4[..., 1:, :])))),
            (tower._kara_square_terms(c), biases["kara"], tower.compressed_square(c)),
            (tower._decompress_num_terms(c), biases["knum"],
             fp.redc_stack(tower._decompress_num_terms(c))),
            (tower._fq2_conj_scaled_terms(den, w), biases["kdinv"],
             fp.redc_stack(tower._fq2_conj_scaled_terms(den, w))),
            (tower._decompress_g1_terms(num, den), biases["kg1"],
             fp.redc_stack(tower._decompress_g1_terms(num, den))),
            (tower._decompress_g0_terms(c, d0), biases["kg0"],
             fp.redc_stack(tower._decompress_g0_terms(c, d0)))):
        biased = [r.bias(k) if k else r for r, k in zip(terms, ks)]
        assert all(r.vlo >= 0 for r in biased)
        assert all(k == 0 or r.vlo + (k - 1) * fp.P < 0 for r, k in zip(terms, ks))
        assert torch.equal(fp.redc(fp.merged(biased, torch.stack(
            [r.ch for r in biased], dim=-2))), want)


_FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "plonky2_bls12_381_pairing_tpu")


def test_port_imports_nothing_of_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "scaling_report_torch.py",
                                          ROOT / "tests" / "torch_dist_worker.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in _FORBIDDEN, (path, name)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


#: Packed row counts of the tensor-core kernels' tests: one row, a partial
#: tile, a whole tile and one row more, and the paths' 1024 but for one.
TC_ROWS = (1, 3, kernel_tables.TC_ROWS + 1, 1023)


def device_rows(n: int, seed: int, device, cyclotomic: bool = False) -> torch.Tensor:
    """n packed Fq12 rows of random elements, mapped on the device through
    the final exponentiation's easy part where asked (cyclotomic), as the
    paths hand them to the kernels."""
    rng = np.random.default_rng(seed)
    ints = np.empty((2 * n, 12), dtype=object)
    for idx in np.ndindex(ints.shape):
        ints[idx] = int.from_bytes(rng.bytes(48), "little") % rm.P
    f = torch.from_numpy(fp.encode(ints)).to(device)
    if not cyclotomic:
        return f
    t = tower.mul(tower.conjugate(f), tower.inv(f))
    return tower.mul(tower.frobenius_pow(t, 2), t).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", TC_ROWS)
def test_cyc_exp_kernel_matches_plain(cuda, rows):
    """The tensor-core kernel at ragged tile counts (its last tile masked)."""
    a = (torch.from_numpy(cyclotomic_rows(2 * rows, 0xE5)).to(cuda) if rows < 8
         else device_rows(rows, 0xE5, cuda, cyclotomic=True))
    assert a.shape == (rows, 12, RC.LANES)
    kernels.reset_launches()
    got = kernels.cyc_exp(a, _GS_SEGMENTS)
    assert kernels.launches["cyc_exp"] == 1
    assert torch.equal(got, kernels.cyc_exp_plain(a, _GS_SEGMENTS))


def karabina_rows(seed: int, device) -> torch.Tensor:
    """Cyclotomic rows for the Karabina kernels: random elements, then one
    (its compressed form is all zero: the g2 == 0 branch with a zero norm)
    sharing a packed row with a random element, and a whole row of ones."""
    r = random.Random(seed)
    f = rm.rand_fq12(r)
    t = f.frobenius_pow(6) * f.inv()
    cyc = t.frobenius_pow(2) * t
    one = rm.Fq12.one()
    extra = tower.encode([cyc, one, one, one])
    return torch.from_numpy(np.concatenate([cyclotomic_rows(6, seed), extra])).to(device)


@pytest.mark.gpu
def test_cyc_exp_cond_kernel_matches_plain(cuda):
    a = torch.from_numpy(cyclotomic_rows(6, 0xF6)).to(cuda)
    kernels.reset_launches()
    got = kernels.cyc_exp_cond(a, _GS_SEGMENTS)
    assert kernels.launches["cyc_exp_cond"] == 1
    assert sum(kernels.launches.values()) == 1
    assert torch.equal(got, kernels.cyc_exp_cond_plain(a, _GS_SEGMENTS))
    assert torch.equal(got, kernels.cyc_exp(a, _GS_SEGMENTS))


def ragged_stack(rows: int, seed: int, device) -> torch.Tensor:
    """rows + 1 packed cyclotomic rows: the kernels read the last `rows` of
    them as a row view (contiguous, one row into the stack)."""
    if rows < 8:
        return torch.from_numpy(cyclotomic_rows(2 * rows + 2, seed)).to(device)
    return device_rows(rows + 1, seed, device, cyclotomic=True)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", TC_ROWS)
def test_cyc_exp_cond_kernel_at_ragged_rows(cuda, rows):
    """The tile kernel's last tile masked, on a row view."""
    a = ragged_stack(rows, 0xE8, cuda)[1:]
    assert a.shape == (rows, 12, RC.LANES) and a.is_contiguous()
    kernels.reset_launches()
    got = kernels.cyc_exp_cond(a, _GS_SEGMENTS)
    assert kernels.launches["cyc_exp_cond"] == 1 and sum(kernels.launches.values()) == 1
    assert torch.equal(got, kernels.cyc_exp_cond_plain(a, _GS_SEGMENTS))
    assert torch.equal(got, kernels.cyc_exp(a, _GS_SEGMENTS))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", TC_ROWS)
def test_kara_full_kernel_at_ragged_rows(cuda, rows):
    """The tile kernel's last tile masked, on a row view whose first row
    holds the identity in one slot and (from 3 rows) whose second row is
    the identity: the g2 == 0 branch with a zero norm."""
    stack = ragged_stack(rows, 0xE9, cuda)
    one = tower.one((), cuda)
    stack[1, :, RC.SUB:] = one[:, RC.SUB:]
    if rows > 1:
        stack[2] = one
    a = stack[1:]
    kernels.reset_launches()
    got = kernels.kara_full(a, _KARA_SEGMENTS)
    assert kernels.launches["kara_full"] == 1 and sum(kernels.launches.values()) == 1
    assert torch.equal(got, kernels.kara_full_plain(a, _KARA_SEGMENTS))
    assert tower.is_equal(got, kernels.cyc_exp(a, _GS_SEGMENTS)).all()
    assert tower.is_one(got)[0, 1].all()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 5])
def test_square_run_kernels_match_plain(cuda, n):
    a = karabina_rows(0xF7, cuda)
    c = tower.compress_cyclotomic(a)
    kernels.reset_launches()
    got12, got8 = kernels.cyc_square_run(a, n), kernels.kara_square_run(c, n)
    assert kernels.launches["cyc_square_run"] == 1
    assert kernels.launches["kara_square_run"] == 1
    assert sum(kernels.launches.values()) == 2
    assert torch.equal(got12, kernels.cyc_square_run_plain(a, n))
    assert torch.equal(got8, kernels.kara_square_run_plain(c, n))


@pytest.mark.gpu
def test_kara_exp_kernel_matches_plain(cuda):
    c = tower.compress_cyclotomic(karabina_rows(0xF8, cuda))[1:].view(2, 2, 8, RC.LANES)
    kernels.reset_launches()
    got = kernels.kara_exp(c, (2, 0, 1, 3))
    assert kernels.launches["kara_exp"] == 1 and sum(kernels.launches.values()) == 1
    assert got.shape == (4, 2, 2, 8, RC.LANES)
    assert torch.equal(got, kernels.kara_exp_plain(c, (2, 0, 1, 3)))


@pytest.mark.gpu
@pytest.mark.parametrize("segments", [_KARA_SEGMENTS, (0, 1, 2, 0, 1, 3)])
def test_kara_full_kernel_matches_plain(cuda, segments):
    """The whole Karabina exponentiation against its plain version, rows
    with the identity (all-zero compressed state, zero norms) included, and
    against the Granger-Scott kernel by value."""
    a = karabina_rows(0xF9, cuda)
    kernels.reset_launches()
    got = kernels.kara_full(a, segments)
    assert kernels.launches["kara_full"] == 1 and sum(kernels.launches.values()) == 1
    assert torch.equal(got, kernels.kara_full_plain(a, segments))
    if segments == _KARA_SEGMENTS:
        assert tower.is_equal(got, kernels.cyc_exp(a, _GS_SEGMENTS)).all()
        assert tower.is_one(got)[-1].all() and tower.is_one(got)[-2, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", (1, 3, 5, 20, 127))
def test_pow_kernel_matches_plain(cuda, rows):
    """One warp per element: odd row counts end the grid on a partial block;
    every value of fp_rows is a zero at index 1."""
    a = torch.from_numpy(fp_rows(2 * rows, 0xE6 + rows)).to(cuda)
    kernels.reset_launches()
    got = kernels.pow_static_fused(a, rm.P - 2)
    assert kernels.launches["pow_static"] == 1
    assert torch.equal(got, fp.pow_static(a, rm.P - 2))
    assert fp.decode(got)[1] == 0
    assert torch.equal(kernels.pow_static_fused(a, 0xD201), fp.pow_static(a, 0xD201))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", (1, 5, 128))
def test_pow_kernel_recording_build_matches_plain(cuda, rows):
    """The recording build (a witness trace's chains) at p - 2: the select
    form's steps and power, the 128-row root of the traced pairing's
    inverses among the shapes."""
    a = torch.from_numpy(fp_rows(2 * rows, 0xE7 + rows)).to(cuda)
    kernels.reset_launches()
    out, steps = kernels.pow_static_steps(a, rm.P - 2)
    assert kernels.launches["pow_static"] == 1
    want_out, want_steps = fp.pow_static_steps(a, rm.P - 2)
    assert torch.equal(steps, want_steps) and torch.equal(out, want_out)
    assert torch.equal(out, kernels.pow_static_fused(a, rm.P - 2))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["fq12_mul", "fq12_square", "fq12_cyclotomic_square",
                                "fq12_mul_by_014", "fq12_mul_by_014_square"])
def test_tower_kernel_matches_plain(cuda, op):
    """Each per-op kernel against its plain formula, with operands the paths
    hand it: a broadcast one, slices of a wider stack, two batch axes; and
    at ragged tile counts, with an operand broadcast over the rows (row
    stride 0) and, for the product, a stack of more tiles than the card
    holds blocks at once."""
    f = torch.from_numpy(fq12_rows(12, 0xF0)).to(cuda).view(2, 3, 12, RC.LANES)
    g = torch.from_numpy(cyclotomic_rows(12, 0xF1)).to(cuda).view(2, 3, 12, RC.LANES)
    d = torch.from_numpy(np.concatenate(
        [fq2_rows(12, s) for s in (0xF2, 0xF3, 0xF4)], axis=-2)).to(cuda)
    d = d.view(2, 3, 6, RC.LANES)
    d0, d1, d4 = d[..., 0:2, :], d[..., 2:4, :], d[..., 4:6, :]
    skip = torch.zeros((2, 3, RC.LANES), dtype=torch.int32, device=cuda)
    skip[0, 1, RC.SUB:] = 1
    skip[1, 2, :RC.SUB] = 1
    plain = {"fq12_mul": tower.mul_plain, "fq12_square": tower.square_plain,
             "fq12_cyclotomic_square": tower.cyclotomic_square_plain,
             "fq12_mul_by_014": tower.mul_by_014_plain,
             "fq12_mul_by_014_square": tower.mul_by_014_square_plain}[op]
    cases = {
        "fq12_mul": [(f, g), (f, tower.one((2, 3), cuda)), (f[0, 1], g)],
        "fq12_square": [(f,)],
        "fq12_cyclotomic_square": [(g,)],
        "fq12_mul_by_014": [(f, d0, d1, d4)],
        "fq12_mul_by_014_square": [(f, d0, d1, d4), (f, d0, d1, d4, skip)],
    }[op]
    big_f = device_rows(max(TC_ROWS), 0xFA, cuda)
    big_g = device_rows(max(TC_ROWS), 0xFB, cuda, cyclotomic=True)
    big_d = device_rows(max(TC_ROWS), 0xFC, cuda)[:, :6]
    for n in TC_ROWS:
        a, b, dn = big_f[:n], big_g[:n], big_d[:n]
        e0, e1, e4 = dn[:, 0:2], dn[:, 2:4], dn[:, 4:6]
        # one element's row broadcast over the n rows: row stride 0
        a0 = big_f[n - 1:n].expand(n, 12, RC.LANES)
        e0b = dn[:1, 0:2].expand(n, 2, RC.LANES)
        sk = torch.zeros((n, RC.LANES), dtype=torch.int32, device=cuda)
        sk[n // 2, :RC.SUB] = 1
        sk[n - 1, RC.SUB:] = 1
        cases += {
            "fq12_mul": [(a, b), (a, tower.one((n,), cuda)), (a0, b)],
            "fq12_square": [(a,), (a0,)],
            "fq12_cyclotomic_square": [(b,), (b[:1].expand(n, 12, RC.LANES),)],
            "fq12_mul_by_014": [(a, e0, e1, e4), (a, e0b, e1, e4)],
            "fq12_mul_by_014_square": [(a, e0, e1, e4, sk), (a0, e0b, e1, e4, sk)],
        }[op]
    if op == "fq12_mul":
        # the final exponentiation's stacked tail product against a
        # broadcast one: 3 x 1023 rows, more tiles than one wave of blocks
        st = torch.stack([big_f, big_g, big_f.flip(0)])
        cases += [(st, tower.one((3, max(TC_ROWS)), cuda)), (st, big_g)]
    kernels.reset_launches()
    for args in cases:
        got = getattr(kernels, op)(*args)
        want = plain(*args)
        assert got.shape == want.shape and torch.equal(got, want)
    assert kernels.launches[op] == len(cases)
    assert sum(kernels.launches.values()) == len(cases)


@pytest.mark.gpu
def test_miller_run_kernel_matches_plain(cuda):
    args = miller_inputs(10, 0xF5, cuda)
    kernels.reset_launches()
    got = kernels.miller_run(*args, _DO_SQUARE)
    assert kernels.launches["miller_run"] == 1
    assert sum(kernels.launches.values()) == 1
    assert torch.equal(got, kernels.miller_run_plain(*args, _DO_SQUARE))


def line_operands(n: int, seed: int, device) -> tuple:
    """The Miller kernels' operands on n packed rows, from random field
    elements (the formulas need no curve point): R and Q as slices of one
    wider stack (row stride 12 * LANES), P.y, P.x and the skip mask. Row
    n // 2's first element has R = (0, 0, 0), as a G2 input at infinity would
    give it, and is masked; with more than one row the last row's second
    element is masked too (a G1 input at infinity)."""
    d = device_rows(n, seed, device)
    rx, ry, rz, qx, qy = (d[:, 2 * i:2 * i + 2] for i in range(5))
    for t in (rx, ry, rz):
        t[n // 2, :, :RC.SUB] = 0
    skip = torch.zeros((n, RC.LANES), dtype=torch.int32, device=device)
    skip[n // 2, :RC.SUB] = 1
    if n > 1:
        skip[n - 1, RC.SUB:] = 1
    return rx, ry, rz, qx, qy, d[:, 10].contiguous(), d[:, 11].contiguous(), skip


@pytest.mark.gpu
@pytest.mark.parametrize("rows", TC_ROWS)
def test_miller_kernels_match_plain(cuda, rows):
    """prepare_g2_lines, miller_fused and miller_run (one and two terms) at
    ragged tile counts, with inputs at infinity, from the paths' f0 = one
    (row stride 0) and from random rows."""
    ops = [line_operands(rows, seed + rows, cuda) for seed in (0x1F0, 0x1F1)]
    starts = (tower.one((rows,), cuda), device_rows(rows, 0x1F2, cuda))
    kernels.reset_launches()
    coeffs = []
    for o in ops:
        got = kernels.prepare_g2_lines(*o[:5], _IS_ADD)
        assert got.shape == (68, rows, 3, 2, RC.LANES)
        assert torch.equal(got, kernels.prepare_g2_lines_plain(*o[:5], _IS_ADD))
        coeffs.append(got)
    for f0 in starts:
        got = kernels.miller_fused(f0, *ops[0], _FUSED_FLAGS)
        assert torch.equal(got, kernels.miller_fused_plain(f0, *ops[0], _FUSED_FLAGS))
        for t in (1, 2):
            call = (coeffs[:t], *([o[k] for o in ops[:t]] for k in (5, 6, 7)), _DO_SQUARE)
            got = kernels.miller_run(f0, *call)
            assert torch.equal(got, kernels.miller_run_plain(f0, *call))
    assert {k: v for k, v in kernels.launches.items() if v} == {
        "prepare_g2_lines": 2, "miller_fused": 2, "miller_run": 4}


@pytest.mark.gpu
def test_miller_run_kernel_takes_any_number_of_terms(cuda):
    """Seventeen terms, each its own points, in one launch."""
    ops = [line_operands(3, 0x200 + t, cuda) for t in range(17)]
    coeffs = [kernels.prepare_g2_lines(*o[:5], _IS_ADD) for o in ops]
    call = (coeffs, *([o[k] for o in ops] for k in (5, 6, 7)), _DO_SQUARE)
    f0 = tower.one((3,), cuda)
    kernels.reset_launches()
    got = kernels.miller_run(f0, *call)
    assert {k: v for k, v in kernels.launches.items() if v} == {"miller_run": 1}
    assert torch.equal(got, kernels.miller_run_plain(f0, *call))


@pytest.mark.gpu
def test_kernel_wrappers_check_their_inputs(cuda):
    a = torch.zeros((4, 12, RC.LANES), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kernels.cyc_exp(a.to(torch.int64), _GS_SEGMENTS)
    with pytest.raises(ValueError):
        kernels.cyc_exp(a[..., :64], _GS_SEGMENTS)
    with pytest.raises(ValueError):
        kernels.cyc_exp(a[::2], _GS_SEGMENTS)
    with pytest.raises(ValueError):
        kernels.pow_static_fused(a[:, :, :100], rm.P - 2)
    with pytest.raises(TypeError):
        kernels.fq12_mul(a, a.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.fq12_mul_by_014(a, a[:, :3], a[:, :2], a[:, :2])
    with pytest.raises(ValueError):
        kernels.fq12_square(a.cpu().to(cuda)[..., :64])
    c = a[:, :8].contiguous()
    for call in (lambda: kernels.cyc_exp_cond(a[::2], _GS_SEGMENTS),
                 lambda: kernels.cyc_square_run(a[:, :8], 2),
                 lambda: kernels.kara_square_run(a, 2),
                 lambda: kernels.kara_square_run(a[:, :8], 2),
                 lambda: kernels.kara_exp(c[::2], _KARA_SEGMENTS),
                 lambda: kernels.kara_full(c, _KARA_SEGMENTS),
                 lambda: kernels.kara_full(a, _KARA_SEGMENTS[:5])):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(TypeError):
        kernels.kara_exp(c.to(torch.int64), _KARA_SEGMENTS)
    # the Miller kernels: no term, a term's tensor missing, a step flag
    # missing, P rows of another batch
    f0, coeffs, py, px, skip = miller_inputs(4, 0xFD, cuda)
    for call in (lambda: kernels.miller_run(f0, [], [], [], [], _DO_SQUARE),
                 lambda: kernels.miller_run(f0, [coeffs] * 2, [py], [px], [skip], _DO_SQUARE),
                 lambda: kernels.miller_run(f0, coeffs, py, px, skip, _DO_SQUARE[:-1]),
                 lambda: kernels.miller_run(f0, coeffs, py[:1], px, skip, _DO_SQUARE),
                 lambda: kernels.miller_fused(f0, *line_operands(2, 0xFE, cuda)[:5], py[:1],
                                              px[:1], skip[:1], _FUSED_FLAGS)):
        with pytest.raises(ValueError):
            call()
