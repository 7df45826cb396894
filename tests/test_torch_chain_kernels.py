"""The limb tier's mont_mul and mont_pow kernels (csrc/mont.cu, one warp per
row), cyc_square_run on the tensor-core REDC tile (csrc/cyc_exp.cu) and the
two Karabina walks on it (csrc/kara_exp.cu), every comparison bit for bit
(tolerance 0):
  * the sources built for the host by torch_cuda_emu.py (one thread per
    CUDA thread, a barrier per warp, the tensor-core products as the same
    integer sums) and bound to the wrappers' launch helpers:
    mont_mul's kernel path against mont_mul_plain at 1, 3, 5 and 127 rows,
    on dense rows, row views (a slice of a wider stack; an odd row stride
    from an address that is not 16-byte aligned) and a row broadcast (row
    stride 0), with digits up to SEMI_DIG and fed back on its own output;
    mont_pow's kernel path against mont_pow_plain, the loop of
    mont_mul_plain, for the exponents 0, 1, 2, 3 and one with runs of set
    and clear bits at 1, 3 and 5 rows (zero rows among them map to zero),
    and for p - 2 on one row and on a batch broadcast from one row; a
    600-bit exponent in two launches, the second starting from the first's
    output;
    cyc_square_run's kernel path against cyc_square_run_plain at 1, 3 and
    5 packed rows for n = 0, 1, 3; kara_square_run's and kara_exp's (one
    kernel body walking one run or the chain with snapshots) against
    kara_square_run_plain and kara_exp_plain likewise, kara_exp on chain
    segments with a zero-length one;
  * fp.inv through the emulated mont_pow kernel against the JAX package's
    ops/fp.py inv on the CPU;
  * the sources: mont_mul and mont_pow take no block barrier after their
    constants are staged; cyc_square_run is cyc_exp's kernel body on the
    tile, and the Karabina runs are kara_exp's;
  * the `gpu` twins hold the same cases and the paths' shapes (2048 rows,
    1024 packed rows at the runs and chain of |x|) on the card through the
    public wrappers, and skip where there is no card."""

import re

import jax
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import constants as C
from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.models.schedule import _GS_SEGMENTS, _KARA_SEGMENTS
from plonky2_bls12_381_pairing_torch.ops import fp
from plonky2_bls12_381_pairing_torch.ops.kernels import mont
from plonky2_bls12_381_pairing_torch.ops.rns import kernels, tower
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu.ops import fp as jfp
from test_torch_exp_kernels import cyclotomic_rows
from torch_cuda_emu import CSRC, ORDERS, bind, bind_limb, build, compiler, set_order

torch.set_num_threads(1)

ROWS = (1, 3, 5, 127)
#: exponents of the short chains: the empty chain (0, the host's one row),
#: no step (1), one squaring (2), a squaring and a product (3), and runs of
#: set and clear bits
EXPONENTS = (0, 1, 2, 3, 0b1110011000111)
#: an exponent longer than one mont_pow launch takes (513 bits): 600 bits,
#: runs of set and clear bits across the two pieces' seam
LONG_EXPONENT = (1 << 599) | int.from_bytes(
    np.random.default_rng(600).bytes(75), "little") % (1 << 599)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the kernels for the CPU")
    out = tmp_path_factory.mktemp("emu")
    return {src: build(src, out) for src in ("mont.cu", "cyc_exp.cu", "kara_exp.cu")}


@pytest.fixture
def emu(libs, monkeypatch):
    """mont.cu bound to the limb wrappers' launch helpers; its launches."""
    bind_limb(monkeypatch, libs["mont.cu"])
    mont.reset_launches()
    yield mont.launches
    mont.reset_launches()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def fp_rows(rows: int, seed: int, device="cpu") -> torch.Tensor:
    """(rows, 48) stored rows: digits up to SEMI_DIG, the top one below p's,
    as the paths' weakly reduced products are."""
    rng = np.random.default_rng([0x4C, rows, seed])
    out = rng.integers(0, C.SEMI_DIG + 1, (rows, C.NLIMBS), dtype=np.int32)
    out[:, -1] %= int(C.P_LIMBS[-1])
    return torch.from_numpy(out).to(device)


def mul_operands(rows: int, device="cpu") -> list:
    """mont_mul's operand pairs in the layouts the paths hand over: dense
    rows; a slice of a wider stack (row stride 3 * 48) against one row
    broadcast (stride 0); rows at an odd stride (147) from an address 4
    bytes past an aligned one against dense rows."""
    a, b = fp_rows(3 * rows, 1, device), fp_rows(3 * rows, 2, device)
    wide = torch.cat([a, b[:, :1]], dim=-1).reshape(rows, 147)  # (rows, 3 x 49)
    return [(a[:rows], b[:rows]),
            (a.reshape(rows, 3, 48)[:, 1], b[:1].expand(rows, 48)),
            (wide[:, 1:49], b.reshape(rows, 3, 48)[:, 2].contiguous())]


def pow_rows(rows: int, device="cpu") -> torch.Tensor:
    """(rows, 48) stored rows with a zero row first (from 3 rows)."""
    a = fp_rows(rows, 3, device)
    if rows >= 3:
        a[0] = 0
    return a


# ---------------------------------------------------------------------------
# Through the emulated kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", ROWS)
def test_mont_mul_warp_kernel_matches_plain(emu, rows):
    pairs = mul_operands(rows)
    for a, b in pairs:
        got = mont._mont_mul_kernel(a, b)
        assert got.shape == (rows, 48) and torch.equal(got, mont.mont_mul_plain(a, b))
        # its own output fed back, as fp.pow_static's chain does
        assert torch.equal(mont._mont_mul_kernel(got, got), mont.mont_mul_plain(got, got))
        assert int(got.max()) <= C.SEMI_DIG and int(got.min()) >= 0
    assert emu["mont_mul"] == 2 * len(pairs) and sum(emu.values()) == 2 * len(pairs)


@pytest.mark.parametrize("exponent", EXPONENTS)
def test_mont_pow_kernel_matches_the_mont_mul_loop(emu, exponent):
    for rows in (1, 3, 5):
        a = pow_rows(rows)
        want = mont.mont_pow_plain(a, exponent)
        if exponent == 0:  # on the host: the one row, no launch
            got = mont.mont_pow(a, exponent)
        else:
            got = mont._mont_pow_kernel(a, exponent)
        assert got.shape == a.shape and torch.equal(got, want)
        assert torch.equal(want, fp.pow_static(a, exponent))  # the loop it replaces
        if rows >= 3 and exponent:
            assert bool(fp.is_zero(got[0]))  # zero maps to zero (mod p)
    assert emu["mont_pow"] == (0 if exponent == 0 else 3)
    assert emu["mont_mul"] == 0


def test_mont_pow_kernel_runs_the_fermat_chain(emu):
    """p - 2, 608 dependent products: on one row, and on a row broadcast
    over three (row stride 0)."""
    e = rm.P - 2
    a = pow_rows(5)[3:4]
    got = mont._mont_pow_kernel(a, e)
    assert torch.equal(got, mont.mont_pow_plain(a, e))
    assert fp.decode(got)[0] * fp.decode(a)[0] % rm.P == 1
    bcast = a.expand(3, 48)
    assert torch.equal(mont._mont_pow_kernel(bcast, e), got.expand(3, 48))
    assert emu["mont_pow"] == 2
    with pytest.raises(ValueError):
        mont.pow_bits(1 << (32 * mont.POW_WORDS + 1))  # longer than a launch takes


def test_mont_pow_splits_a_long_exponent_into_launches():
    """Up to 32 * POW_WORDS bits after the leading one are one launch, and
    the pieces hold the bits in order."""
    step = 32 * mont.POW_WORDS
    for e, lengths in ((1, [0]), (2, [1]), (rm.P - 2, [380]), ((1 << step) | 5, [step]),
                       ((1 << (step + 1)) | 5, [step, 1]), (LONG_EXPONENT, [step, 87])):
        pieces = mont.pow_pieces(e)
        assert [p.n for p in pieces] == lengths
        bits = [(p.w[j // 32] >> (j % 32)) & 1 for p in pieces for j in range(p.n)]
        assert int("1" + "".join(map(str, bits)), 2) == e
    assert mont.pow_bits(rm.P - 2).n == 380


def test_mont_pow_kernel_takes_a_long_exponent_in_pieces(emu):
    """A 600-bit exponent: two launches, the second from the first's
    output, the products and rows of mont_pow_plain."""
    a = pow_rows(3)
    got = mont._mont_pow_kernel(a, LONG_EXPONENT)
    assert torch.equal(got, mont.mont_pow_plain(a, LONG_EXPONENT))
    assert bool(fp.is_zero(got[0]))
    assert emu["mont_pow"] == 2 and sum(emu.values()) == 2


@pytest.mark.parametrize("rows", (1, 3, 5))
@pytest.mark.parametrize("n", (0, 1, 3))
def test_cyc_square_run_on_the_tile_matches_plain(libs, monkeypatch, rows, n):
    bind(monkeypatch, kernels, libs["cyc_exp.cu"])
    kernels.reset_launches()
    a = cyclotomic_rows(rows, 0xE0 + rows)
    out = kernels._square_run_kernel("cyc_square_run", a, n, 12)
    assert kernels.launches["cyc_square_run"] == 1 and sum(kernels.launches.values()) == 1
    assert torch.equal(out, kernels.cyc_square_run_plain(a, n))
    if n == 0:
        assert torch.equal(out, a)
    kernels.reset_launches()


def karabina_rows(rows: int, seed: int) -> torch.Tensor:
    """(rows, 8, LANES): compressed cyclotomic elements, the identity (all
    zero) in one slot of the first row."""
    a = cyclotomic_rows(rows, seed)
    a[0, :, kernels.LANES // 2:] = tower.one((), torch.device("cpu"))[:, kernels.LANES // 2:]
    return tower.compress_cyclotomic(a)


@pytest.mark.parametrize("rows", (1, 3, 5))
@pytest.mark.parametrize("n", (0, 1, 3))
def test_kara_square_run_on_the_tile_matches_plain(libs, monkeypatch, rows, n):
    bind(monkeypatch, kernels, libs["kara_exp.cu"])
    kernels.reset_launches()
    c = karabina_rows(rows, 0xE4 + rows)
    out = kernels._square_run_kernel("kara_square_run", c, n, 8)
    assert kernels.launches["kara_square_run"] == 1 and sum(kernels.launches.values()) == 1
    assert torch.equal(out, kernels.kara_square_run_plain(c, n))
    if n == 0:
        assert torch.equal(out, c)
    kernels.reset_launches()


@pytest.mark.parametrize("rows", (1, 3, 5))
def test_kara_exp_on_the_tile_matches_plain(libs, monkeypatch, rows):
    bind(monkeypatch, kernels, libs["kara_exp.cu"])
    kernels.reset_launches()
    c = karabina_rows(rows, 0xE8 + rows)
    segments = (1, 0, 2)
    out = kernels._kara_exp_kernel(c, segments)
    assert kernels.launches["kara_exp"] == 1 and sum(kernels.launches.values()) == 1
    assert out.shape == (3, rows, 8, kernels.LANES)
    assert torch.equal(out, kernels.kara_exp_plain(c, segments))
    assert torch.equal(out[0], out[1])
    kernels.reset_launches()


@pytest.mark.parametrize("order", ORDERS)
def test_chain_kernels_under_each_fiber_order(libs, emu, monkeypatch, order):
    """mont_mul, mont_pow, cyc_square_run and kara_exp with each block's
    fibers resumed by thread index, in reverse and shuffled, so that a
    missing barrier shows whichever thread reads first."""
    for lib in libs.values():
        set_order(lib, order)
    try:
        a, b = mul_operands(3)[0]
        assert torch.equal(mont._mont_mul_kernel(a, b), mont.mont_mul_plain(a, b))
        x = pow_rows(3)
        assert torch.equal(mont._mont_pow_kernel(x, EXPONENTS[-1]),
                           mont.mont_pow_plain(x, EXPONENTS[-1]))
        bind(monkeypatch, kernels, libs["cyc_exp.cu"])
        f = cyclotomic_rows(3, 0xEC)
        assert torch.equal(kernels._square_run_kernel("cyc_square_run", f, 3, 12),
                           kernels.cyc_square_run_plain(f, 3))
        bind(monkeypatch, kernels, libs["kara_exp.cu"])
        c = karabina_rows(3, 0xED)
        assert torch.equal(kernels._kara_exp_kernel(c, (1, 0, 2)),
                           kernels.kara_exp_plain(c, (1, 0, 2)))
    finally:
        for lib in libs.values():
            set_order(lib, "forward")
        kernels.reset_launches()


def test_fp_inv_through_the_chain_kernel_matches_jax(emu, monkeypatch):
    """fp.inv on the kernel path (its one mont_pow launch emulated) against
    the JAX package's inv, a lax.scan of its mont_mul, on the CPU."""
    vals = [0, 1, rm.P - 1, 2, 0xD201, 3 ** 100 % rm.P]
    ja = jfp.encode(vals)
    monkeypatch.setattr(fp, "_use_kernels", lambda t: fp.get_strategy() != "plain")
    monkeypatch.setattr(mont, "mont_pow", mont._mont_pow_kernel)
    got = fp.inv(interop.limbs_from_numpy(np.asarray(ja), device="cpu"))
    assert emu["mont_pow"] == 1 and emu["mont_mul"] == 0
    assert np.array_equal(np.asarray(jax.jit(jfp.inv)(ja)), interop.to_numpy(got))
    dec = fp.decode(got)
    assert dec[0] == 0 and all(dec[i] * v % rm.P == 1 for i, v in enumerate(vals) if v)


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------


def _code(source: str) -> str:
    return re.sub(r"//[^\n]*", "", (CSRC / source).read_text())


def _body(text: str, start: str) -> str:
    i = text.index("{", text.index(start))
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise ValueError(start)


@pytest.mark.parametrize("kernel", ["mont_mul_kernel(", "mont_pow_kernel("])
def test_chain_kernels_have_no_block_barrier_after_the_constants(kernel):
    src = _code("mont.cu")
    body = _body(src, kernel)
    assert body.count("__syncthreads") == 1
    assert body.index("load_consts(") < body.index("__syncthreads") < body.index("mul_warp(")
    mul = _body(src, "void mul_warp(")
    assert "__syncthreads" not in mul and "mont_reduce_warp(" in mul and "conv_quads(" in mul
    assert "mont_reduce_lanes" not in src + _code("limb_common.cuh")
    if kernel == "mont_pow_kernel(":
        assert "__grid_constant__ PowBits" in src and "LIMB_POW_WORDS" in src


def test_cyc_square_run_is_the_tiled_exponentiation_body():
    assert kernels._KERNELS["cyc_square_run"][0] == "cyc_exp.cu"
    src = _code("cyc_exp.cu")
    assert re.search(r"launch<RUN, RUN_TILE>", src) and "TcSmem<T>" in src
    # the Karabina runs are kara_exp's kernel body walking one run
    assert kernels._KERNELS["kara_square_run"][0] == "kara_exp.cu"
    assert not (CSRC / "square_run.cu").exists()
    runs = _code("kara_exp.cu")
    assert "kara_square_run_launch" in runs and "cyc_square_run" not in runs
    assert "cyc_square" not in runs and "RNS_CYC_BIAS" not in runs
    assert re.search(r"launch<RUN, TILE>", runs) and re.search(r"launch<SNAPSHOTS, TILE>", runs)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows", (2048, *ROWS))
def test_mont_mul_warp_kernel_matches_plain_on_card(cuda, rows):
    mont.reset_launches()
    pairs = mul_operands(rows, cuda)
    for a, b in pairs:
        got = mont.mont_mul(a, b)
        assert torch.equal(got, mont.mont_mul_plain(a, b))
        assert torch.equal(mont.mont_mul(got, got), mont.mont_mul_plain(got, got))
    assert mont.launches["mont_mul"] == 2 * len(pairs)


@pytest.mark.gpu
@pytest.mark.parametrize("exponent", (*EXPONENTS, rm.P - 2))
def test_mont_pow_kernel_matches_the_mont_mul_loop_on_card(cuda, exponent):
    mont.reset_launches()
    for rows in (1, 3, 5, 2048) if exponent == rm.P - 2 else (1, 3, 5, 127):
        a = pow_rows(rows, cuda)
        got = mont.mont_pow(a, exponent)
        assert torch.equal(got, mont.mont_pow_plain(a, exponent))
    # through fp.pow_static: one launch for the whole chain
    a = pow_rows(5, cuda)
    assert torch.equal(fp.pow_static(a, exponent), mont.mont_pow_plain(a, exponent))
    assert mont.launches["mont_pow"] == (0 if exponent == 0 else 5)
    assert mont.launches["mont_mul"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("rows", (1, 3, 5, 1023, 1024))
def test_cyc_square_run_on_the_tile_matches_plain_on_card(cuda, rows):
    # eight packed rows of cyclotomic elements in turn (a row's result
    # depends on it alone)
    a = cyclotomic_rows(8, 0xE8).repeat(128, 1, 1)[:rows].to(cuda)
    kernels.reset_launches()
    lengths = sorted({0, 1, 3, *(n for n, _ in _GS_SEGMENTS)}) if rows >= 1023 else (0, 1, 3)
    for n in lengths:
        assert torch.equal(kernels.cyc_square_run(a, n), kernels.cyc_square_run_plain(a, n))
    assert kernels.launches["cyc_square_run"] == len(lengths)


@pytest.mark.gpu
def test_mont_pow_kernel_takes_a_long_exponent_in_pieces_on_card(cuda):
    mont.reset_launches()
    for rows in (1, 3, 5, 2048):
        a = pow_rows(rows, cuda)
        assert torch.equal(mont.mont_pow(a, LONG_EXPONENT),
                           mont.mont_pow_plain(a, LONG_EXPONENT))
    assert mont.launches["mont_pow"] == 2 * 4


@pytest.mark.gpu
@pytest.mark.parametrize("rows", (1, 3, 5, 1023, 1024))
def test_karabina_walks_on_the_tile_match_plain_on_card(cuda, rows):
    # eight packed rows in turn, the first with the identity in one slot
    c = karabina_rows(8, 0xEC).repeat(128, 1, 1)[:rows].to(cuda)
    kernels.reset_launches()
    lengths = sorted({0, 1, 3, *_KARA_SEGMENTS}) if rows >= 1023 else (0, 1, 3)
    for n in lengths:
        assert torch.equal(kernels.kara_square_run(c, n), kernels.kara_square_run_plain(c, n))
    chains = ((1, 0, 2), _KARA_SEGMENTS) if rows >= 1023 else ((1, 0, 2),)
    for segments in chains:
        assert torch.equal(kernels.kara_exp(c, segments), kernels.kara_exp_plain(c, segments))
    assert kernels.launches["kara_square_run"] == len(lengths)
    assert kernels.launches["kara_exp"] == len(chains)
