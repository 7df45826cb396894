"""The limb tier's kernel wrappers of the PyTorch port, their plain versions
and the generated header.

  * conv_plain / mont_reduce_plain / mont_mul_plain row for row against the
    Pallas kernels of ops/pallas/mont.py in interpret mode, with adversarial
    columns and semi-reduced feedback; the four fq12_*_plain row for row
    against ops/pallas/tower.py in interpret mode, and equal in decoded value
    to the composition path and the oracle;
  * limb_tables.h against constants.py and the bounds the plain versions
    track; the static pass counts;
  * on the CPU a wrapper runs its plain version and counts no launch; on
    another device than CPU or CUDA it raises;
  * the `gpu` tests hold each CUDA kernel bit for bit to its plain version
    and skip where there is no card.
Zero tolerance everywhere: integer rows, np.array_equal / torch.equal."""

import ast
import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plonky2_bls12_381_pairing_tpu.ops.pallas.mont as pm
import plonky2_bls12_381_pairing_tpu.ops.pallas.tower as tw
from plonky2_bls12_381_pairing_torch import constants as C
from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.ops import cuda_build, fp, fq12
from plonky2_bls12_381_pairing_torch.ops.kernels import limb_tables, mont, tower
from plonky2_bls12_381_pairing_torch.ops.rns import kernels as rns_kernels
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu.ops import fp as jfp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "plonky2_bls12_381_pairing_torch"
B = 4
BLOCK = 8


def t(arr, device="cpu") -> torch.Tensor:
    return interop.limbs_from_numpy(np.asarray(arr), device=device)


def fp_rows(n: int, seed: int) -> np.ndarray:
    r = random.Random(seed)
    return fp.encode([r.randrange(rm.P) for _ in range(n)])


def fq12_values(n: int, seed: int) -> list:
    r = random.Random(seed)
    return [rm.Fq12.from_coeffs([r.randrange(rm.P) for _ in range(12)]) for _ in range(n)]


def cyclotomic_values(n: int, seed: int) -> list:
    r = random.Random(seed)
    out = []
    for _ in range(n):
        f = rm.rand_fq12(r)
        e = f.frobenius_pow(6) * f.inv()
        out.append(e.frobenius_pow(2) * e)
    return out


def adversarial_columns() -> tuple[np.ndarray, int, int]:
    """All-0xFF carry-ripple columns and max-negative columns."""
    rows = np.zeros((4, 95), dtype=np.int32)
    rows[0, :] = 255 * 255 * 48  # max uniform conv columns
    rows[1, :48] = 255
    rows[2, 0] = -(1 << 25)  # deep negative low column
    rows[2, 1] = 1 << 25
    rows[3, 94] = 255 * 255 * 48
    return rows, -(1 << 25), 255 * 255 * 48


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def test_conv_plain_matches_pallas():
    a, b = fp_rows(8, 0xA1), fp_rows(8, 0xA2)
    want = np.asarray(pm.conv(jnp.asarray(a), jnp.asarray(b), block=8, interpret=True))
    assert np.array_equal(mont.conv_plain(t(a), t(b)).numpy(), want)
    # operands of a tower formula's deepest sums: int32-exact, beyond float32
    r = np.random.default_rng(0xA3)
    x = r.integers(0, 4 * (3 * 258 + 256) + 1, (4, 48)).astype(np.int32)
    y = r.integers(0, 8 * 258 + 1, (4, 48)).astype(np.int32)
    want = np.asarray(pm.conv(jnp.asarray(x), jnp.asarray(y), block=4, interpret=True))
    assert want.max() > (1 << 24)
    assert np.array_equal(mont.conv_plain(t(x), t(y)).numpy(), want)


def test_mont_mul_plain_matches_pallas_with_semi_feedback():
    edge = [0, 1, rm.P - 1, rm.P - 1, 0, 1, 2, 3]
    a, b = fp.encode(edge), fp.encode(list(reversed(edge)))
    o1 = np.asarray(pm.mont_mul(jnp.asarray(a), jnp.asarray(b), block=8, interpret=True))
    g1 = mont.mont_mul_plain(t(a), t(b))
    assert np.array_equal(g1.numpy(), o1)
    # semi outputs (digits may exceed 255) are valid inputs
    o2 = np.asarray(pm.mont_mul(jnp.asarray(o1), jnp.asarray(o1), block=8, interpret=True))
    g2 = mont.mont_mul_plain(g1, g1)
    assert np.array_equal(g2.numpy(), o2)
    want = [x * y % rm.P for x, y in zip(edge, reversed(edge))]
    assert list(fp.decode(g2)) == [v * v % rm.P for v in want]
    assert int(g2.max()) <= C.SEMI_DIG
    # the fused product is the reduction of the convolution, row for row
    wide = fp.conv(g1, g1)
    assert wide.col_hi == mont.MUL_COL_HI
    assert torch.equal(g2, mont.mont_reduce_plain(wide.cols, wide.col_lo, wide.col_hi))


def test_mont_reduce_plain_matches_pallas():
    a, b, c, d = (fp_rows(8, s) for s in (0xB1, 0xB2, 0xB3, 0xB4))
    w = jfp.conv(jnp.asarray(a), jnp.asarray(b)) - jfp.conv(jnp.asarray(c), jnp.asarray(d))
    want = np.asarray(pm.mont_reduce(w.cols, w.col_lo, w.col_hi, block=8, interpret=True))
    got = mont.mont_reduce_plain(t(np.asarray(w.cols)), w.col_lo, w.col_hi)
    assert np.array_equal(got.numpy(), want)
    rows, lo, hi = adversarial_columns()
    want = np.asarray(pm.mont_reduce(jnp.asarray(rows), lo, hi, block=4, interpret=True))
    got = mont.mont_reduce_plain(t(rows), lo, hi)
    assert np.array_equal(got.numpy(), want)
    rinv = pow(1 << C.R_BITS, -1, rm.P)
    assert [C.limbs_to_int(r) % rm.P for r in got.numpy()] == [
        C.limbs_to_int(r) * rinv % rm.P for r in rows]
    # fewer than 95 columns: a stack of lifted components
    narrow = rows[:, :60].copy()
    want = np.asarray(pm.mont_reduce(jnp.asarray(narrow), lo, hi, block=4, interpret=True))
    assert np.array_equal(mont.mont_reduce_plain(t(narrow), lo, hi).numpy(), want)


def _d_rows(seed: int) -> np.ndarray:
    r = random.Random(seed)
    return fp.encode(np.array([[r.randrange(rm.P) for _ in range(6)] for _ in range(B)],
                              dtype=object))


@pytest.mark.parametrize("name", tower.FORMULAS)
def test_tower_plain_matches_pallas_and_oracle(name):
    av, bv = fq12_values(B, 0xF12), fq12_values(B, 0xF13)
    if name == "cyclotomic_square":
        av = cyclotomic_values(B, 0xF14)
    a, b, d = fq12.encode(av), fq12.encode(bv), _d_rows(0xF15)
    ja, jb, jd = jnp.asarray(a), jnp.asarray(b), jnp.asarray(d)
    ta, tb, td = t(a), t(b), t(d)
    d0, d1, d4 = td[:, 0:2], td[:, 2:4], td[:, 4:6]
    dv = fp.decode(d, mont=True)
    fq2s = [[rm.Fq2(int(row[2 * i]), int(row[2 * i + 1])) for i in range(3)] for row in dv]
    want, got, values, composed = {
        "mul": lambda: (tw.fq12_mul(ja, jb, block=BLOCK, interpret=True),
                        tower.fq12_mul_plain(ta, tb),
                        [x * y for x, y in zip(av, bv)], fq12.mul(ta, tb)),
        "square": lambda: (tw.fq12_square(ja, block=BLOCK, interpret=True),
                           tower.fq12_square_plain(ta),
                           [x * x for x in av], fq12.square(ta)),
        "mul_by_014": lambda: (tw.fq12_mul_by_014(ja, jd, block=BLOCK, interpret=True),
                               tower.fq12_mul_by_014_plain(ta, td),
                               [x.mul_by_014(*f) for x, f in zip(av, fq2s)],
                               fq12.mul_by_014(ta, d0, d1, d4)),
        "cyclotomic_square": lambda: (
            tw.fq12_cyclotomic_square(ja, block=BLOCK, interpret=True),
            tower.fq12_cyclotomic_square_plain(ta),
            [x * x for x in av], fq12.cyclotomic_square(ta)),
    }[name]()
    assert np.array_equal(got.numpy(), np.asarray(want))  # row for row
    assert list(fq12.decode(got)) == values  # the oracle
    assert fp.get_strategy() == "auto"
    assert list(fq12.decode(composed)) == values  # the composition path
    assert int(got.max()) <= C.SEMI_DIG and int(got.min()) >= 0


def test_fused_strategy_runs_the_plain_tower_versions_on_cpu():
    av, bv = fq12_values(2, 0xF16), cyclotomic_values(2, 0xF17)
    ta, tb, td = t(fq12.encode(av)), t(fq12.encode(bv)), t(_d_rows(0xF18)[:2])
    d0, d1, d4 = td[:, 0:2], td[:, 2:4], td[:, 4:6]
    tower.reset_launches()
    fp.set_strategy("fused")
    try:
        assert torch.equal(fq12.mul(ta, tb), tower.fq12_mul_plain(ta, tb))
        assert torch.equal(fq12.square(ta), tower.fq12_square_plain(ta))
        assert torch.equal(fq12.cyclotomic_square(tb),
                           tower.fq12_cyclotomic_square_plain(tb))
        assert torch.equal(fq12.mul_by_014(ta, d0, d1, d4),
                           tower.fq12_mul_by_014_plain(ta, td))
        # one triple broadcast over the batch, as the Miller loop's identity
        assert torch.equal(fq12.mul_by_014(ta, d0[:1], d1[:1], d4[:1]),
                           tower.fq12_mul_by_014_plain(ta, td[:1]))
    finally:
        fp.set_strategy("auto")
    assert all(n == 0 for n in tower.launches.values())
    with pytest.raises(ValueError):
        fp.set_strategy("pallas")


# ---------------------------------------------------------------------------
# The wrappers on the CPU, and the devices they refuse
# ---------------------------------------------------------------------------


def test_cpu_wrappers_run_plain_versions():
    a, b = t(fp_rows(4, 0xC1)), t(fp_rows(4, 0xC2))
    mont.reset_launches()
    assert torch.equal(mont.conv(a, b), mont.conv_plain(a, b))
    assert torch.equal(mont.mont_mul(a, b), mont.mont_mul_plain(a, b))
    w = fp.conv(a, b) - fp.conv(b, b)
    assert torch.equal(mont.mont_reduce(w.cols, w.col_lo, w.col_hi),
                       mont.mont_reduce_plain(w.cols, w.col_lo, w.col_hi))
    assert torch.equal(fp.mont_reduce(w), mont.mont_reduce_plain(w.cols, w.col_lo, w.col_hi))
    assert torch.equal(fp.mont_mul(a, b), mont.mont_mul_plain(a, b))
    assert torch.equal(mont.mont_pow(a, 0xD201), mont.mont_pow_plain(a, 0xD201))
    assert torch.equal(fp.pow_static(a, 0xD201), mont.mont_pow_plain(a, 0xD201))
    assert set(mont.launches) == {"conv", "mont_reduce", "mont_mul", "mont_pow"}
    assert set(tower.launches) == {"limb_fq12_mul", "limb_fq12_square",
                                   "limb_fq12_mul_by_014", "limb_fq12_cyclotomic_square"}
    assert all(n == 0 for n in mont.launches.values())
    # both tiers' counters are reported together
    total = cuda_build.all_launches()
    assert set(total) == {*mont.launches, *tower.launches, *rns_kernels.launches}
    assert len(total) == 23  # 15 RNS kernels, 8 limb kernels
    with pytest.raises(ValueError):
        mont.mont_reduce(torch.zeros((1, 96), dtype=torch.int32))
    with pytest.raises(ValueError):
        mont.mont_reduce(torch.zeros((1, 95), dtype=torch.int32), -(1 << 30), 0)


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on a CUDA device
    is refused, never computed by the plain version."""
    row = torch.empty((2, 48), dtype=torch.int32, device="meta")
    cols = torch.empty((2, 95), dtype=torch.int32, device="meta")
    f = torch.empty((2, 12, 48), dtype=torch.int32, device="meta")
    d = torch.empty((2, 6, 48), dtype=torch.int32, device="meta")
    for call in (lambda: mont.conv(row, row), lambda: mont.mont_mul(row, row),
                 lambda: mont.mont_pow(row, 3), lambda: fp.pow_static(row, 3),
                 lambda: mont.mont_reduce(cols), lambda: fp.mont_mul(row, row),
                 lambda: fp.conv(row, row), lambda: tower.fq12_mul(f, f),
                 lambda: tower.fq12_square(f), lambda: tower.fq12_mul_by_014(f, d),
                 lambda: tower.fq12_cyclotomic_square(f)):
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# The generated header
# ---------------------------------------------------------------------------


def _header_arrays(text: str) -> dict:
    out = {}
    pat = re.compile(r"__device__ const int (\w+)((?:\[\d+\])+) = \{([^}]*)\};")
    for name, dims, body in pat.findall(text):
        shape = tuple(int(d) for d in re.findall(r"\d+", dims))
        out[name] = np.array([int(v) for v in body.replace("\n", " ").split(",")],
                             dtype=np.int64).reshape(shape)
    return out


def _defines(text: str) -> dict:
    return {ln.split()[1]: int(ln.split()[2]) for ln in text.splitlines()
            if ln.startswith("#define")}


def test_limb_header_matches_constants_and_bounds():
    text = limb_tables.header_text()
    arrs, defs = _header_arrays(text), _defines(text)
    assert np.array_equal(arrs["LIMB_P"], C.P_LIMBS)
    assert np.array_equal(arrs["LIMB_PPRIME"], C.PPRIME_LIMBS)
    assert np.array_equal(arrs["LIMB_NEGC"], C.NEGC_LIMBS)
    assert np.array_equal(arrs["LIMB_ONE_MONT"], C.ONE_MONT)
    assert arrs["LIMB_BIAS"].shape == (128,) and arrs["LIMB_QW"].shape == (128,)
    assert np.array_equal(arrs["LIMB_BIAS"][:95], C.BIAS_DIGITS)
    assert not arrs["LIMB_BIAS"][95:].any() and not arrs["LIMB_QW"][C.NRED:].any()
    assert np.array_equal(arrs["LIMB_QW"], C.QMOD_WEIGHTS)
    assert C.limbs_to_int(arrs["LIMB_BIAS"]) == C.K_BIAS * rm.P
    assert C.limbs_to_int(arrs["LIMB_P"]) == rm.P
    assert (C.limbs_to_int(arrs["LIMB_P"]) * C.limbs_to_int(arrs["LIMB_PPRIME"]) + 1) % (
        1 << C.R_BITS) == 0
    assert defs["LIMB_NLIMBS"] == 48 and defs["LIMB_NRED"] == 51 and defs["LIMB_NCOLS"] == 95
    assert defs["LIMB_QMOD"] == C.QMOD and defs["LIMB_R_MOD_QMOD"] == C.R_MOD_QMOD
    # the pass counts are the JAX package's static counts
    assert defs["LIMB_NPASS_M"] == pm._static_pass_count(0, C.NRED * 257 * 255)
    assert defs["LIMB_NPASS_S"] == pm._static_pass_count(0, 257 + C.NRED * 257 * 255)
    assert defs["LIMB_NPASS_MUL"] == pm._static_pass_count(
        0, 48 * C.SEMI_DIG * C.SEMI_DIG + C.BIAS_FLOOR + 255)
    assert [defs[f"LIMB_TOWER_{n.upper()}"] for n in tower.FORMULAS] == [0, 1, 2, 3]
    products = {"mul": 54, "square": 36, "mul_by_014": 39, "cyclotomic_square": 27 + 12}
    for i, name in enumerate(tower.FORMULAS):
        f = tower.formula(name)
        assert f.products == products[name] == defs[f"LIMB_TOWER_{name.upper()}_PRODUCTS"]
        assert defs[f"LIMB_TOWER_{name.upper()}_NPASS"] == pm._static_pass_count(
            0, f.col_hi + C.BIAS_FLOOR + 255)
        assert np.array_equal(arrs["LIMB_TOWER_SLOT"][i, :f.products], f.slots)
        assert np.array_equal(arrs["LIMB_TOWER_COEF"][i, :f.products], f.coefs)
        # the outputs' combinations, as the lists of their nonzero terms
        n = arrs["LIMB_TOWER_OUT_N"][i]
        outputs = np.zeros((12, f.products), dtype=np.int64)
        for j in range(12):
            terms = arrs["LIMB_TOWER_OUT_P"][i, j, :n[j]]
            outputs[j, terms] = arrs["LIMB_TOWER_OUT_C"][i, j, :n[j]]
            assert n[j] == np.count_nonzero(f.outputs[j])
            assert not arrs["LIMB_TOWER_OUT_C"][i, j, n[j]:].any()
        assert np.array_equal(outputs, f.outputs)
        assert not arrs["LIMB_TOWER_COEF"][i, f.products:].any()
        # every operand stays within int32 per product, every output within
        # the bias row
        assert -C.BIAS_FLOOR < f.col_lo and f.col_hi + C.BIAS_FLOOR + 255 < (1 << 31)
        assert f.slots.max() < tower.NSLOTS and f.slots.min() >= 0


def test_pass_counts_ignore_the_lower_bound():
    """The bias row makes every column non-negative: the plain version's
    count (from min(col_lo, 0)) is the kernel's (from 0) for every bound the
    wrappers admit."""
    for hi in (0, 255, 48 * 255 * 255, mont.MUL_COL_HI, (1 << 30) - 512):
        for lo in (0, -1, -(1 << 25), -(1 << 30) + 1):
            n = mont.first_pass_count(lo, hi)
            assert n == pm._static_pass_count(0, hi + C.BIAS_FLOOR + 255)
    assert fp.semi_pass_count(-1, 257) == 0 and fp.semi_pass_count(0, 255 * 255 * 48) >= 2


_FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "plonky2_bls12_381_pairing_tpu")


def test_limb_modules_import_nothing_of_jax():
    files = [PORT / "constants.py", PORT / "interop.py", PORT / "models" / "pairing.py",
             *sorted((PORT / "ops").glob("*.py")), *sorted((PORT / "ops" / "kernels").glob("*.py"))]
    assert len(files) >= 14
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


@pytest.mark.gpu
def test_conv_kernel_matches_plain(cuda):
    a, b = t(fp_rows(37, 0xD1), cuda), t(fp_rows(37, 0xD2), cuda)
    mont.reset_launches()
    assert torch.equal(mont.conv(a, b), mont.conv_plain(a, b))
    # a stride-0 operand and a slice of a wider stack
    wide = torch.stack([a, b], dim=1)
    assert torch.equal(mont.conv(wide[:, 1], b[:1]), mont.conv_plain(b, b[:1].expand_as(b)))
    big = torch.full((5, 48), 4 * (3 * 258 + 256), dtype=torch.int32, device=cuda)
    assert torch.equal(mont.conv(big, 2 * a[:5]), mont.conv_plain(big, 2 * a[:5]))
    assert mont.launches["conv"] == 3


@pytest.mark.gpu
def test_mont_reduce_kernel_matches_plain(cuda):
    a, b = t(fp_rows(37, 0xD3), cuda), t(fp_rows(37, 0xD4), cuda)
    w = fp.conv(a, b) - fp.conv(b, b)
    mont.reset_launches()
    got = mont.mont_reduce(w.cols, w.col_lo, w.col_hi)
    assert torch.equal(got, mont.mont_reduce_plain(w.cols, w.col_lo, w.col_hi))
    rows, lo, hi = adversarial_columns()
    rows = t(rows, cuda)
    assert torch.equal(mont.mont_reduce(rows, lo, hi), mont.mont_reduce_plain(rows, lo, hi))
    narrow = rows[:, :60]  # not contiguous: read through its row stride
    assert torch.equal(mont.mont_reduce(narrow, lo, hi),
                       mont.mont_reduce_plain(narrow, lo, hi))
    stack = torch.stack([w.cols, w.cols + 1], dim=-2)  # (37, 2, 95)
    assert torch.equal(mont.mont_reduce(stack, w.col_lo, w.col_hi + 1),
                       mont.mont_reduce_plain(stack, w.col_lo, w.col_hi + 1))
    assert mont.launches["mont_reduce"] == 4
    assert torch.equal(fp.mont_reduce(w), got) and mont.launches["mont_reduce"] == 5


@pytest.mark.gpu
def test_mont_mul_kernel_matches_plain(cuda):
    edge = [0, 1, rm.P - 1, rm.P - 1, 0, 1, 2, 3]
    a = torch.cat([t(fp.encode(edge), cuda), t(fp_rows(33, 0xD5), cuda)])
    b = torch.cat([t(fp.encode(edge[::-1]), cuda), t(fp_rows(33, 0xD6), cuda)])
    mont.reset_launches()
    o1 = mont.mont_mul(a, b)
    assert torch.equal(o1, mont.mont_mul_plain(a, b))
    o2 = mont.mont_mul(o1, o1)  # semi-reduced feedback
    assert torch.equal(o2, mont.mont_mul_plain(o1, o1))
    w = fp.conv(o1, o1)
    assert torch.equal(o2, mont.mont_reduce(w.cols, w.col_lo, w.col_hi))
    assert mont.launches == {"conv": 1, "mont_reduce": 1, "mont_mul": 2, "mont_pow": 0}
    assert torch.equal(fp.inv(a[8:12]), fp.pow_static(a[8:12].cpu(), rm.P - 2).to(cuda))
    fp.set_strategy("plain")
    try:
        mont.reset_launches()
        assert torch.equal(fp.mont_mul(a, b), o1)
        assert sum(mont.launches.values()) == 0  # plain on the card: no kernel
    finally:
        fp.set_strategy("auto")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", (1, 3, 5, 127))
@pytest.mark.parametrize("name", tower.FORMULAS)
def test_tower_kernel_matches_plain(cuda, name, rows):
    """At odd row counts, fed back, with the second operand broadcast (row
    stride 0), and with both operands read in place from slices of a wider
    stack (a row stride that is not the dense one)."""
    values = (cyclotomic_values(rows, 0xD7) if name == "cyclotomic_square"
              else fq12_values(rows, 0xD7))
    a = t(fq12.encode(values), cuda)
    b = t(fq12.encode(fq12_values(rows, 0xD8)), cuda)
    d = t(np.concatenate([_d_rows(0xD9 + i) for i in range(-(-rows // 4))])[:rows], cuda)
    wrapper = getattr(tower, f"fq12_{name}")
    plain = getattr(tower, f"fq12_{name}_plain")
    args = {"mul": (a, b), "mul_by_014": (a, d)}.get(name, (a,))
    tower.reset_launches()
    got = wrapper(*args)
    assert torch.equal(got, plain(*args))
    assert torch.equal(wrapper(got, *args[1:]), plain(got, *args[1:]))  # fed back
    if len(args) == 2:  # the second operand broadcast over the batch
        one = args[1][:1]
        assert torch.equal(wrapper(a, one), plain(a, one.expand(rows, *one.shape[1:])))
    wide = torch.cat([got, *args], dim=-2)  # (rows, 12 + 12 + ..., 48)
    views = (wide[:, 12:24], *(wide[:, 24:][:, :x.shape[-2]] for x in args[1:]))
    assert views[0].stride(0) == wide.shape[1] * 48
    assert torch.equal(wrapper(*views), plain(*views))
    n = len(args) + 2
    assert tower.launches[f"limb_fq12_{name}"] == n
    assert sum(tower.launches.values()) == n
