"""miller_run with any number of terms, and multi_pairing's single
preparation of its T terms, on the CPU (every comparison bit for bit,
tolerance 0, unless a value is named):
  * the miller_run kernel (csrc/miller.cu built for the host by
    torch_cuda_emu.py) through its wrapper's launch half at T = 65 and 130
    terms in one launch, on a short schedule at three packed rows, against
    miller_run_plain, in both operand layouts: each operand's terms views of
    one buffer (read in place: the launch gets the buffer's pointer and
    strides) and separate tensors (stacked by the wrapper);
  * prepare_g2_stepmajor of three G2 points stacked along a new leading axis
    against three separate calls and against the JAX package's
    prepare_g2_stepmajor of the same stack, and the prepare_g2_lines kernel
    on that stack against the plain rows;
  * the port's multi_pairing with 65 terms at one packed row, against the
    native oracle's product of each element's 65 pairings by value, with one
    preparation for all terms and the Miller loop reading views of its
    output."""

import random

import jax
import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop, native
from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.models.schedule import _IS_ADD
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernels, tower
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu.models import pairing_rns as jmpr
from plonky2_bls12_381_pairing_tpu.ops.rns.lines import G2Affine as JG2Affine
from torch_cuda_emu import bind, build, compiler

torch.set_num_threads(1)

#: the short schedule of the emulated launches: square, no square, square
FLAGS = (1, 0, 1)
ROWS = 3


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the kernels for the CPU")
    return build("miller.cu", tmp_path_factory.mktemp("emu"))


@pytest.fixture
def launched(lib, monkeypatch):
    """The kernel paths of ops/rns/kernels.py launching the CPU build; the
    arguments of each launch, by kernel."""
    bind(monkeypatch, kernels, lib)
    emu_call, calls = kernels._call, []

    def call(name, device, *args):
        calls.append((name, args))
        emu_call(name, device, *args)

    monkeypatch.setattr(kernels, "_call", call)
    return calls


def stored_rows(rng: np.random.Generator, *shape: int) -> torch.Tensor:
    """(*shape, LANES) stored Fp rows, drawn from a pool of encoded random
    field elements (the formulas need no curve point)."""
    pool = fp.encode([int.from_bytes(rng.bytes(48), "little") % rm.P for _ in range(64)])
    return torch.from_numpy(pool[rng.integers(0, len(pool), shape)])


def term_operands(n_terms: int, seed: int) -> tuple:
    """n_terms terms at ROWS packed rows as single buffers: step-major
    coefficients (steps, T, rows, 3, 2, LANES), P.y, P.x and the skip mask
    (T, rows, LANES); about one element in five is skipped."""
    rng = np.random.default_rng(seed)
    coeffs = stored_rows(rng, len(FLAGS), n_terms, ROWS, 3, 2)
    py, px = stored_rows(rng, n_terms, ROWS), stored_rows(rng, n_terms, ROWS)
    skip = torch.from_numpy(
        np.repeat(rng.random((n_terms, ROWS, RC.PACK)) < 0.2, RC.SUB, axis=-1).astype(np.int32))
    return coeffs, py, px, skip


@pytest.mark.parametrize("layout", ["views", "separate"])
@pytest.mark.parametrize("n_terms", [65, 130])
def test_miller_run_kernel_takes_many_terms(launched, n_terms, layout):
    """One launch for 65 and 130 terms. Views of one buffer reach the kernel
    as its pointer and strides, with nothing copied; separate tensors are
    stacked first."""
    coeffs, py, px, skip = term_operands(n_terms, 0x400 + n_terms)
    call = [list(coeffs.unbind(1)), *(list(t.unbind(0)) for t in (py, px, skip))]
    if layout == "separate":
        call = [[t.clone() for t in ts] for ts in call]
    f0 = tower.one((ROWS,), "cpu")
    got = kernels._miller_run_kernel(f0, call, FLAGS)
    assert [name for name, _ in launched] == ["miller_run"]
    _, args = launched[0]
    # f0 and its row stride, then coeffs with its step and term strides, P.y,
    # P.x and skip each with its term stride, then the number of terms
    ptrs = args[2], args[5], args[7], args[9]
    assert args[3:5] == ((n_terms * ROWS * 6 * RC.LANES, ROWS * 6 * RC.LANES)
                         if layout == "views" else (ROWS * 6 * RC.LANES,
                                                    len(FLAGS) * ROWS * 6 * RC.LANES))
    assert args[6] == args[8] == args[10] == ROWS * RC.LANES and args[11] == n_terms
    sources = [coeffs, py, px, skip] if layout == "views" else [ts[0] for ts in call]
    same = [p == t.data_ptr() for p, t in zip(ptrs, sources)]
    assert same == [layout == "views"] * 4
    assert torch.equal(got, kernels.miller_run_plain(f0, *call, FLAGS))


def random_g2(r: random.Random, n: int) -> list:
    """n G2 points k*G2 (native batch scalar multiplication), the second at
    infinity."""
    qs = native.g2_mul_batch([r.randrange(1, rm.R) for _ in range(n)])
    qs[1] = rm.G2Affine.identity()
    return qs


def test_prepare_g2_stepmajor_of_stacked_points_keeps_each_terms_rows(lib, monkeypatch):
    """Three terms of two elements (one packed row) each, stacked to (3, 1):
    one call gives each term the rows of its own call and of the JAX
    package's preparation of the same stack; the kernel on the stack gives
    the plain rows."""
    r = random.Random(0x401)
    pts = [random_g2(r, 2) for _ in range(3)]
    qs = [G2Affine.encode(q, device="cpu") for q in pts]
    stacked = mpr._stack_g2(qs)
    got = mpr.prepare_g2_stepmajor(stacked)
    assert got.shape == (68, 3, 1, 3, 2, RC.LANES)
    for t, q in enumerate(qs):
        assert torch.equal(got[:, t], mpr.prepare_g2_stepmajor(q))
    jq = JG2Affine.encode(pts[0])
    jstack = type(jq)(*(np.stack([np.asarray(getattr(JG2Affine.encode(p), k)) for p in pts])
                        for k in ("x", "y", "infinity")))
    want = np.asarray(jax.jit(jmpr.prepare_g2_stepmajor)(jstack))
    assert np.array_equal(interop.to_numpy(got), want)
    # the prepare_g2_lines kernel over the stack's 3 x 1 rows
    bind(monkeypatch, kernels, lib)
    qs_, r_ = mpr._g2_start(stacked)
    emu = kernels._prepare_g2_lines_kernel(r_.x, r_.y, r_.z, qs_.x, qs_.y,
                                           tuple(map(int, _IS_ADD)))
    assert torch.equal(emu, got)


def test_multi_pairing_65_terms_matches_native_oracle(monkeypatch):
    """65 terms of two elements each (one packed row): one prepare call for
    all terms, a Miller loop over views of its output, and per element the
    native oracle's product of its 65 pairings, by value. A G1 and a G2
    point at infinity are among them."""
    n_terms, r = 65, random.Random(0x402)
    ps = [native.g1_mul_batch([r.randrange(1, rm.R) for _ in range(2)])
          for _ in range(n_terms)]
    qs = [native.g2_mul_batch([r.randrange(1, rm.R) for _ in range(2)])
          for _ in range(n_terms)]
    ps[3][0] = rm.G1Affine.identity()
    qs[7][1] = rm.G2Affine.identity()
    prepares, millers = [], []
    prepare, miller = kernels.prepare_g2_lines, kernels.miller_run

    def spy_prepare(*args):
        prepares.append(args[0].shape)
        return prepare(*args)

    def spy_miller(f0, coeffs, *rest):
        millers.append({c.untyped_storage().data_ptr() for c in coeffs})
        return miller(f0, coeffs, *rest)

    monkeypatch.setattr(kernels, "prepare_g2_lines", spy_prepare)
    monkeypatch.setattr(kernels, "miller_run", spy_miller)
    got = mpr.multi_pairing([G1Affine.encode(p, device="cpu") for p in ps],
                            [G2Affine.encode(q, device="cpu") for q in qs])
    assert prepares == [(n_terms, 1, 2, RC.LANES)]
    assert len(millers) == 1 and len(millers[0]) == 1
    assert got.shape == (1, 12, RC.LANES)
    dec = [e.coeffs() for e in tower.decode(got)]
    want = [native.multi_pairing_product([p[i] for p in ps], [q[i] for q in qs]).coeffs()
            for i in range(2)]
    assert dec == want
