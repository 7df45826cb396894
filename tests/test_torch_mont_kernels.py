"""The limb tier's conv and mont_reduce kernels (csrc/mont.cu) and the
grouping of the products that the composition path hands them.

  * csrc/mont.cu built for the host by torch_cuda_emu.py (one thread per
    CUDA thread, a barrier per warp) and bound with bind_limb: conv_many's
    kernel path bit for bit (tolerance 0) against conv_plain for 1, 3, 30 and
    K_MAX pairs at 1, 3, 5 and 127 rows (127 only for k of 1 and 3), with
    operands read in place through a row stride that is not the dense one,
    from an address that is not 16-byte aligned, broadcast (row stride 0),
    mixed in one launch, and pairs of two batch shapes (one launch each);
    with each warp computing 2 to 4 rows in turn;
    mont_reduce's kernel path against mont_reduce_plain for 51, 72 and 95
    columns at the bounds of three of the paths' wides (whose first pass
    count the bias row sets: 4), on the same row counts (127 only for 95
    columns) and on row views;
  * the sources: neither warp kernel has a block barrier after the
    constants are staged;
  * each tower op, doubling and addition step, Frobenius map and inverse
    forms its products in the stated groups (fp.conv_many calls and their
    pair counts), and through the emulated kernels launches one conv per
    group and gives the rows of the plain composition;
  * the `gpu` twins hold the same cases on the card through the public
    wrappers, and skip where there is no card.
The plain versions are held to the JAX package in test_torch_limb_kernels.py,
the composition path in test_torch_limb_*.py."""

import re

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import constants as C
from plonky2_bls12_381_pairing_torch.models import pairing as lmp
from plonky2_bls12_381_pairing_torch.ops import curve, fp, fq2, fq6, fq12, lines
from plonky2_bls12_381_pairing_torch.ops.kernels import mont
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from torch_cuda_emu import CSRC, ORDERS, bind_limb, build, compiler, set_order

torch.set_num_threads(1)

#: (pairs, rows) of the conv cases: every k at small row counts, the two
#: smaller k also at 127 rows (the emulator runs a thread per CUDA thread)
CONV_CASES = [(k, rows) for k in (1, 3, 30, mont.K_MAX) for rows in (1, 3, 5, 127)
              if rows < 127 or k <= 3]
REDUCE_CASES = [(ncols, rows) for ncols in (51, 72, 95) for rows in (1, 3, 5, 127)
                if rows < 127 or ncols == 95]
#: digit bounds of the operands the paths convolve: stored elements, the
#: sums of two (Karatsuba, interpolation) and a relaxed difference against a
#: stored element
DIGITS = ((C.SEMI_DIG, C.SEMI_DIG), (2 * C.SEMI_DIG, 2 * C.SEMI_DIG),
          (2 * C.SEMI_DIG + 256, C.SEMI_DIG))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the kernels for the CPU")
    return build("mont.cu", tmp_path_factory.mktemp("emu"))


@pytest.fixture
def emu(lib, monkeypatch):
    bind_limb(monkeypatch, lib)
    mont.reset_launches()
    yield mont.launches
    mont.reset_launches()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def conv_pairs(k: int, rows: int, device="cpu") -> list:
    """k pairs of (rows, 48) operands in the layouts the paths hand over, in
    turn: dense rows; a slice of a wider stack (row stride 3 * 48) against
    one row broadcast (stride 0); rows at an odd stride from an address that
    is not 16-byte aligned against a slice; a broadcast row against dense
    rows. The digit bounds cycle through DIGITS."""
    rng = np.random.default_rng([0x3C, k, rows])
    out = []
    for j in range(k):
        a_max, b_max = DIGITS[j % len(DIGITS)]
        a = rng.integers(0, a_max + 1, (rows, 3, 49), dtype=np.int32)
        b = rng.integers(0, b_max + 1, (rows, 3, 49), dtype=np.int32)
        a, b = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
        layout = j % 4
        if layout == 0:
            pair = (a[:, 0, :48].contiguous(), b[:, 0, :48].contiguous())
        elif layout == 1:
            wide = a[:, :, :48].contiguous()
            pair = (wide[:, 1], b[:1, 0, :48].expand(rows, 48))
        elif layout == 2:  # row stride 147, 4 bytes past an aligned address
            pair = (a.reshape(rows, 147)[:, 1:49], b[:, :, :48].contiguous()[:, 2])
        else:
            pair = (a[:1, 0, :48].expand(rows, 48), b[:, 0, :48].contiguous())
        out.append(pair)
    return out


def assert_conv_matches(got: list, pairs: list) -> None:
    assert len(got) == len(pairs)
    for g, (a, b) in zip(got, pairs):
        want = mont.conv_plain(a, b)
        assert g.shape == want.shape and torch.equal(g.cpu(), want.cpu())


# ---------------------------------------------------------------------------
# conv_many through the emulated kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,rows", CONV_CASES)
def test_conv_many_kernel_matches_plain(emu, k, rows):
    if k == 1:  # each layout in a launch of its own
        for pair in conv_pairs(4, rows):
            assert_conv_matches(mont._conv_many_kernel([pair]), [pair])
        assert emu["conv"] == 4
    else:
        pairs = conv_pairs(k, rows)
        assert_conv_matches(mont._conv_many_kernel(pairs), pairs)
        assert emu["conv"] == 1


@pytest.mark.parametrize("per_warp", range(2, mont.CONV_ROWS_PER_WARP + 1))
def test_conv_many_kernel_rows_per_warp(emu, per_warp):
    """A warp's rows in turn, the next one's operands loading while it
    computes one: 37 rows end the last tile of 8 warps x per_warp rows
    early, in some warps before their first row."""
    pairs = conv_pairs(4, 37)
    assert_conv_matches(mont._conv_many_kernel(pairs, per_warp), pairs)
    assert emu["conv"] == 1
    assert mont.conv_rows_per_warp(63, 2048) == mont.CONV_ROWS_PER_WARP
    assert mont.conv_rows_per_warp(30, 2048) == 4 and mont.conv_rows_per_warp(3, 127) == 1
    assert mont.conv_rows_per_warp(2, 2048) == 1


def test_conv_many_kernel_splits_batch_shapes(emu):
    """Pairs of two batch shapes (and a pair broadcast to the larger):
    one launch per shape, every result in its pair's shape."""
    pairs = conv_pairs(5, 3)
    stack = [(a.reshape(3, 1, 48).expand(3, 2, 48), b[:, None].expand(3, 2, 48))
             for a, b in conv_pairs(3, 3)]
    mixed = [pairs[0], stack[0], pairs[1], (stack[1][0], stack[1][1][:1, :1]),
             pairs[2], stack[2], pairs[3], pairs[4]]
    got = mont._conv_many_kernel(mixed)
    assert emu["conv"] == 2
    assert [tuple(g.shape) for g in got] == [(3, 95), (3, 2, 95)] * 3 + [(3, 95)] * 2
    assert_conv_matches(got, mixed)


def test_conv_many_kernel_refuses_and_cpu_runs_plain(emu):
    pairs = conv_pairs(3, 2)
    assert_conv_matches(mont.conv_many(pairs), pairs)
    assert mont.conv_many([]) == [] and emu["conv"] == 0  # on the CPU: no launch
    for k, per_warp in ((mont.K_MAX + 1, 1), (1, 0)):  # more pairs than a launch takes,
        with pytest.raises(RuntimeError):                # and no row per warp
            mont.cuda_build.call("conv", torch.device("cpu"), 0, k, 0, 1, per_warp)
    assert emu["conv"] == 0


# ---------------------------------------------------------------------------
# mont_reduce through the emulated kernel
# ---------------------------------------------------------------------------


def path_bounds() -> dict:
    """The column bounds of wides the paths reduce: one product of stored
    elements, an Fq2 product's stack, and fq12.mul's merged 12-output
    stack (built on one row: the bounds are static)."""
    x = torch.from_numpy(fp.encode([[3, 5], [7, 11]]))
    w = fq2.mul_wide(x[0], x[1])
    a0, a1 = (torch.from_numpy(fp.encode([[i + j for i in range(6)]])) for j in (1, 7))
    t0, t1 = fq6.mul_wide(a0, a0), fq6.mul_wide(a1, a1)
    t01 = fq6.mul_wide(fp.add(a0, a1), fp.add(a0, a1))
    out0 = fq6.add_wide(t0, fq6.mul_by_nonresidue_wide(t1))
    out1 = fq6.sub_wide(fq6.sub_wide(t01, t0), t1)
    wides = [w for tri in (out0, out1) for pair in tri for w in pair]
    return {"conv": (0, mont.MUL_COL_HI), "fq2_mul": (min(w[0].col_lo, w[1].col_lo),
                                                      max(w[0].col_hi, w[1].col_hi)),
            "fq12_mul": (min(v.col_lo for v in wides), max(v.col_hi for v in wides))}


def reduce_columns(rows: int, ncols: int, lo: int, hi: int) -> torch.Tensor:
    """(rows, 12, 95) signed columns within [lo, hi] whose value stays within
    the reduction's bounds on the first ncols columns: the top columns of
    each row small, as a product's are."""
    rng = np.random.default_rng([0x3D, rows, ncols])
    cols = rng.integers(lo, hi + 1, (rows, 12, 95), dtype=np.int64)
    cols[..., ncols - 3:] = rng.integers(max(lo, -9), min(hi, 9) + 1, (rows, 12, 98 - ncols))
    return torch.from_numpy(cols.astype(np.int32))


@pytest.mark.parametrize("ncols,rows", REDUCE_CASES)
def test_mont_reduce_kernel_matches_plain(emu, ncols, rows):
    bounds = path_bounds()
    # the bias row (digits >= 2^30) sets the count for every bound the
    # wrappers admit: 4 passes
    assert {mont.first_pass_count(*b) for b in bounds.values()} == {4}
    for name, (lo, hi) in bounds.items():
        cols = reduce_columns(rows, ncols, lo, hi)
        dense = cols[:, 0, :ncols].contiguous()
        view = cols[:, 3:5, :ncols]  # row stride 95, two elements a row
        for case in (dense, view):
            got = mont._mont_reduce_kernel(case, lo, hi)
            want = mont.mont_reduce_plain(case, lo, hi)
            assert got.shape == want.shape and torch.equal(got, want), name
            assert int(got.max()) <= C.SEMI_DIG and int(got.min()) >= 0
    assert emu["mont_reduce"] == 2 * len(bounds)


@pytest.mark.parametrize("order", ORDERS)
def test_mont_kernels_under_each_fiber_order(lib, emu, order):
    """conv_many and mont_reduce with each block's fibers resumed by thread
    index, in reverse and shuffled."""
    set_order(lib, order)
    try:
        pairs = conv_pairs(30, 3)
        assert_conv_matches(mont._conv_many_kernel(pairs), pairs)
        (lo, hi), = list(path_bounds().values())[:1]
        cols = reduce_columns(3, 95, lo, hi)[:, 0, :95].contiguous()
        assert torch.equal(mont._mont_reduce_kernel(cols, lo, hi),
                           mont.mont_reduce_plain(cols, lo, hi))
    finally:
        set_order(lib, "forward")


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


def test_warp_kernels_have_no_block_barrier_after_the_constants():
    src = _code("mont.cu")
    conv = _body(src, "conv_kernel(")
    assert "__syncthreads" not in conv and "__syncwarp" in conv
    assert "__grid_constant__ ConvPairs" in src
    reduce = _body(src, "mont_reduce_kernel(")
    assert reduce.count("__syncthreads") == 1
    staged = reduce.index("load_consts(")
    assert staged < reduce.index("__syncthreads") < reduce.index("mont_reduce_warp(")
    assert "mont_reduce_lanes" not in reduce


# ---------------------------------------------------------------------------
# Groups of products
# ---------------------------------------------------------------------------


def _fq12(n: int, seed: int) -> torch.Tensor:
    r = np.random.default_rng(seed)
    return torch.from_numpy(fp.encode(
        [[int.from_bytes(r.bytes(48), "little") % rm.P for _ in range(12)] for _ in range(n)]))


def _tensors(out) -> list:
    """An op's result as its tensors (a doubling step's point and line)."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, curve.G2Projective):
        return [out.x, out.y, out.z]
    return [t for part in out for t in _tensors(part)]


def _g2_step_inputs():
    g = rm.G2Affine.generator()
    q = curve.G2Affine.encode([g, g.add(g)], device="cpu")
    r = curve.G2Projective.from_affine(q)
    return r, q


GROUPS = {
    # op: its conv_many calls' pair counts, in order
    "mul": [63], "square": [42], "mul_by_014": [43], "cyclotomic_square": [30],
    "doubling_step": [13, 20, 4], "addition_step": [9, 6, 6, 12, 12],
    "frobenius_map": [12, 9], "inv": [42, 18, 9, 2, 2, 9, 42], "scale_coeffs": [4],
}


def _op_runs() -> dict:
    a, b = _fq12(2, 0x3E), _fq12(2, 0x3F)
    d = torch.from_numpy(fp.encode([[5 + i for i in range(6)]] * 2))
    r, q = _g2_step_inputs()
    p = curve.G1Affine.encode([rm.G1Affine.generator()] * 2, device="cpu")
    coeffs = lmp.prepare_g2(q)
    return {
        "mul": lambda: fq12.mul(a, b), "square": lambda: fq12.square(a),
        "mul_by_014": lambda: fq12.mul_by_014(a, d[:, 0:2], d[:, 2:4], d[:, 4:6]),
        "cyclotomic_square": lambda: fq12.cyclotomic_square(a),
        "doubling_step": lambda: lines.doubling_step(r),
        "addition_step": lambda: lines.addition_step(r, q),
        "frobenius_map": lambda: fq12.frobenius_map(a), "inv": lambda: fq12.inv(a),
        "scale_coeffs": lambda: lmp._scale_coeffs(p, q.infinity, coeffs),
    }


def test_ops_form_their_products_in_groups(monkeypatch):
    """Every group of independent products is one fp.conv_many call: the
    counts of each op's calls and of their pairs."""
    calls = []
    conv_many = fp.conv_many

    def counted(pairs):
        calls.append(len(pairs))
        return conv_many(pairs)

    monkeypatch.setattr(fp, "conv_many", counted)
    # the inverse's Fermat chain of Fp products is the fused mont_mul kernel
    # on the card, no conv group
    monkeypatch.setattr(fp, "mont_mul", mont.mont_mul_plain)
    for name, run in _op_runs().items():
        calls.clear()
        run()
        assert calls == GROUPS[name], name
    assert max(n for g in GROUPS.values() for n in g) <= mont.K_MAX


@pytest.mark.parametrize("name", ["mul", "square", "mul_by_014", "cyclotomic_square",
                                  "doubling_step"])
def test_ops_through_the_kernels_launch_once_per_group(emu, monkeypatch, name):
    """Under "auto" with the emulated kernels in the wrappers' place: one
    conv launch per group, and the rows of the plain composition."""
    run = _op_runs()[name]
    want = run()
    monkeypatch.setattr(fp, "_use_kernels", lambda t: fp.get_strategy() != "plain")
    monkeypatch.setattr(mont, "conv_many", mont._conv_many_kernel)
    monkeypatch.setattr(mont, "mont_reduce", mont._mont_reduce_kernel)
    got = run()
    assert emu["conv"] == len(GROUPS[name])
    assert emu["mont_reduce"] == (3 if name == "doubling_step" else 1)
    got, want = _tensors(got), _tensors(want)
    assert len(got) == len(want) == (6 if name == "doubling_step" else 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("k,rows", CONV_CASES)
def test_conv_many_kernel_matches_plain_on_card(cuda, k, rows):
    mont.reset_launches()
    if k == 1:
        for pair in conv_pairs(4, rows, cuda):
            assert_conv_matches(mont.conv_many([pair]), [pair])
        assert mont.launches["conv"] == 4
    else:
        pairs = conv_pairs(k, rows, cuda)
        assert_conv_matches(mont.conv_many(pairs), pairs)
        assert mont.launches["conv"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("ncols,rows", REDUCE_CASES)
def test_mont_reduce_kernel_matches_plain_on_card(cuda, ncols, rows):
    mont.reset_launches()
    bounds = path_bounds()
    for name, (lo, hi) in bounds.items():
        cols = reduce_columns(rows, ncols, lo, hi).to(cuda)
        for case in (cols[:, 0, :ncols].contiguous(), cols[:, 3:5, :ncols]):
            got = mont.mont_reduce(case, lo, hi)
            assert torch.equal(got.cpu(), mont.mont_reduce_plain(case.cpu(), lo, hi)), name
    assert mont.launches["mont_reduce"] == 2 * len(bounds)
