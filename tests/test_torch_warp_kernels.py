"""The two warp kernels' own code on the CPU (csrc/pow_static.cu and
csrc/limb_tower.cu, built for the host by torch_cuda_emu.py: one thread per
CUDA thread, a barrier per warp for __syncwarp and the shuffles), every
comparison bit for bit (tolerance 0):
  * pow_static through its wrapper's kernel path against fp.pow_static on
    three packed rows with zeros among the elements, for p - 2, and on one
    and three rows for the short exponent 0xD201 and exponents of one and
    two bits;
  * the four limb tower entries through their wrappers' kernel path
    against fq12_*_plain on one and on three rows, with the operands read in
    place from a wider stack (a row stride that is not the dense one) and
    the second operand broadcast (row stride 0);
  * pow_static's recording build (the chains of a witness trace) against
    fp.pow_static_steps, the select form, on one and three rows, its steps
    and power; an RNS inverse traced through it has the rows of the plain
    chain's trace (whose rows test_torch_witness.py holds to the JAX
    package's), with one launch;
  * both kernels, and the traced inverse, with each block's fibers resumed
    in reverse and in a shuffled order as well (torch_cuda_emu.set_order),
    so that a missing barrier shows whichever thread reads first;
  * no block-wide barrier in pow_static.cu or in the warp reduction.
The plain versions are held to the JAX package in test_torch_fp.py and
test_torch_limb_kernels.py."""

import random
import re

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import constants as C
from plonky2_bls12_381_pairing_torch.ops.kernels import tower as ltower
from plonky2_bls12_381_pairing_torch.models import witness
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernels
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from torch_cuda_emu import CSRC, ORDERS, bind, bind_limb, build, compiler, set_order

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the kernels for the CPU")
    out = tmp_path_factory.mktemp("emu")
    return {src: build(src, out) for src in ("pow_static.cu", "limb_tower.cu")}


@pytest.fixture
def pow_kernel(libs, monkeypatch):
    bind(monkeypatch, kernels, libs["pow_static.cu"])
    kernels.reset_launches()
    yield kernels.launches
    kernels.reset_launches()


@pytest.fixture
def tower_kernel(libs, monkeypatch):
    bind_limb(monkeypatch, libs["limb_tower.cu"])
    ltower.reset_launches()
    yield ltower.launches
    ltower.reset_launches()


def pow_rows(seed: int) -> torch.Tensor:
    """Three packed rows (six elements), zeros at elements 1 and 4."""
    r = random.Random(seed)
    xs = [r.randrange(rm.P) for _ in range(6)]
    xs[1] = xs[4] = 0
    return torch.from_numpy(fp.encode(xs))


def test_pow_kernel_p_minus_2_matches_plain(pow_kernel):
    a = pow_rows(0x9A)
    got = kernels._pow_static_kernel(a, rm.P - 2)
    assert pow_kernel["pow_static"] == 1
    assert torch.equal(got, fp.pow_static(a, rm.P - 2))
    dec = fp.decode(got)
    assert dec[1] == dec[4] == 0
    assert all(x == 0 or x * y % rm.P == 1 for x, y in zip(fp.decode(a), dec))


@pytest.mark.parametrize("rows", [1, 3])
def test_pow_kernel_short_exponent_matches_plain(pow_kernel, rows):
    a = pow_rows(0x9B + rows)[:rows]
    got = kernels._pow_static_kernel(a, 0xD201)
    assert torch.equal(got, fp.pow_static(a, 0xD201))
    # exponents of one bit: no step at all, and a single squaring
    assert torch.equal(kernels._pow_static_kernel(a, 1), a)
    assert torch.equal(kernels._pow_static_kernel(a, 2), fp.pow_static(a, 2))


@pytest.mark.parametrize("rows", [1, 3])
def test_pow_kernel_recording_build_matches_select_form(pow_kernel, rows):
    a = pow_rows(0x9C + rows)[:rows]
    out, steps = kernels._pow_static_kernel(a, 0xD201, record=True)
    want_out, want_steps = fp.pow_static_steps(a, 0xD201)
    assert steps.shape == (2 * (0xD201).bit_length() - 2, rows, fp.LANES)
    assert torch.equal(steps, want_steps) and torch.equal(out, want_out)
    assert torch.equal(out, fp.pow_static(a, 0xD201))
    assert pow_kernel["pow_static"] == 1


@pytest.fixture(params=ORDERS)
def order(request, libs):
    for lib in libs.values():
        set_order(lib, request.param)
    yield request.param
    for lib in libs.values():
        set_order(lib, "forward")


def test_traced_inverse_through_the_recording_build(pow_kernel, monkeypatch, order):
    """fp.inv of three packed rows (zeros among them) under a trace, its
    Fermat chain on the emulated recording build: the plain chain's rows."""
    a = pow_rows(0x9D)
    want_out, want = witness.trace(fp.inv, a)
    monkeypatch.setattr(kernels, "pow_static_steps",
                        lambda x, e: kernels._pow_static_kernel(x, e, record=True))
    out, got = witness.trace(fp.inv, a)
    assert pow_kernel["pow_static"] == 1 and torch.equal(out, want_out)
    assert got.counts() == want.counts() == {"rns_mul": 2 * ((rm.P - 2).bit_length() - 1),
                                             "rns_inv": 1}
    for op, rows in want.rows.items():
        for w, g in zip(rows, got.rows[op]):
            assert all(torch.equal(x, y) for x, y in zip(w, g)), op


def limb_rows(rng: np.random.Generator, *shape: int) -> torch.Tensor:
    """Weakly reduced rows, as the paths hand them over: digits to 258, the
    top one below p's."""
    rows = rng.integers(0, C.SEMI_DIG + 1, (*shape, C.NLIMBS), dtype=np.int32)
    rows[..., -1] = rng.integers(0, int(C.P_LIMBS[-1]), shape, dtype=np.int32)
    return torch.from_numpy(rows)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("name", ltower.FORMULAS)
def test_tower_kernel_matches_plain(tower_kernel, name, rows):
    rng = np.random.default_rng([0x7A, rows, ltower.FORMULAS.index(name)])
    n_second = {"mul": 12, "mul_by_014": 6}.get(name, 0)
    a = limb_rows(rng, rows, 12)
    second = limb_rows(rng, rows, n_second) if n_second else None
    args = (a,) if second is None else (a, second)
    plain = getattr(ltower, f"fq12_{name}_plain")
    launch = lambda *x: ltower._launch(f"limb_fq12_{name}", x[0], x[1] if n_second else None,
                                       n_second)
    assert torch.equal(launch(*args), plain(*args))
    # in place from a wider stack: row stride (12 + n_second + 5) * 48
    wide = torch.cat([a, *args[1:], limb_rows(rng, rows, 5)], dim=-2)
    views = (wide[:, :12], *(wide[:, 12:12 + n_second] for _ in args[1:]))
    assert views[0].stride(0) == wide.shape[1] * C.NLIMBS
    assert torch.equal(launch(*views), plain(*views))
    if n_second:  # the second operand's first row over the batch (stride 0)
        one = second[:1].expand(rows, n_second, C.NLIMBS)
        assert rows == 1 or one.stride(0) == 0
        assert torch.equal(launch(a, one), plain(a, one))
    assert tower_kernel[f"limb_fq12_{name}"] == (3 if n_second else 2)


def test_warp_kernels_under_each_fiber_order(pow_kernel, tower_kernel, order):
    a = pow_rows(0x9E)
    assert torch.equal(kernels._pow_static_kernel(a, 0xD201), fp.pow_static(a, 0xD201))
    rng = np.random.default_rng(0x7B)
    x, y = limb_rows(rng, 3, 12), limb_rows(rng, 3, 12)
    assert torch.equal(ltower._launch("limb_fq12_mul", x, y, 12), ltower.fq12_mul_plain(x, y))


def _body(text: str, start: str) -> str:
    """The brace-delimited body that follows `start` in a source."""
    i = text.index("{", text.index(start))
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise ValueError(start)


def _code(source: str) -> str:
    """A CUDA source without its // comments."""
    return re.sub(r"//[^\n]*", "", (CSRC / source).read_text())


def test_warp_kernels_take_no_block_barrier_in_their_loops():
    pow_src = _code("pow_static.cu")
    assert "__syncthreads" not in pow_src and "__syncwarp" in _body(pow_src, "void run(")
    common = _code("limb_common.cuh")
    for fn in ("void warp_passes(", "void mont_reduce_warp("):
        body = _body(common, fn)
        assert "__syncthreads" not in body and "__syncwarp" in common
    tower_src = _code("limb_tower.cu")
    # stage 4, the outputs' reductions, comes after the kernel's last block
    # barrier
    last = tower_src.rindex("__syncthreads();") + len("__syncthreads();")
    stage4 = _body("{" + tower_src[last:], "{")
    assert re.search(r"mont_reduce_warp\(", stage4) and "mont_reduce_lanes" not in tower_src
    # the block-wide reduction is gone: mont.cu's kernels are warp kernels
    assert "mont_reduce_lanes" not in _code("mont.cu") + common

