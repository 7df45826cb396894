"""The RNS Miller kernels' own code on the CPU (csrc/miller.cu with
csrc/rns_lines.cuh, built for the host by torch_cuda_emu.py: one thread per
CUDA thread, the tensor-core products as the same integer sums), every
comparison bit for bit (tolerance 0):
  * each stacked REDC of the line steps, doubling_step and addition_step of
    ops/rns/lines.py, in both scale modes, on points with and without an
    input at infinity (R.z = 0): the kernel's REDC inputs, lane by lane on
    canonical residues with the header's bias multiples, equal the plain
    formula's biased integers modulo each lane's modulus, and its outputs
    equal the plain rows;
  * prepare_g2_lines, miller_fused and miller_run (one, two and seventeen
    terms) through their wrappers' kernel paths against their plain
    versions on one packed row;
  * miller_run_plain with two terms against miller_steps_raw.
The JAX package's rows are held to the plain versions in
test_torch_miller.py and test_torch_pairing.py."""

import random

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.models.schedule import _DO_SQUARE, _FUSED_FLAGS, _IS_ADD
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernel_tables, kernels, lines, tower
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from torch_cuda_emu import ORDERS, bind, build, compiler, redc_log, set_order

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the kernels for the CPU")
    return build("miller.cu", tmp_path_factory.mktemp("emu"))


@pytest.fixture
def emulated(lib, monkeypatch):
    """The kernel paths of ops/rns/kernels.py's wrappers launching the CPU
    build; the launches they count."""
    bind(monkeypatch, kernels, lib)
    kernels.reset_launches()
    yield kernels.launches
    kernels.reset_launches()


def fq2s(r: random.Random, n: int) -> torch.Tensor:
    """(n/2 packed rows, 2, LANES): n random Fq2 elements."""
    return torch.from_numpy(fp.encode(np.array(
        [[r.randrange(rm.P), r.randrange(rm.P)] for _ in range(n)], dtype=object)))


def line_inputs(seed: int, infinity: bool):
    """A projective R and an affine Q, two elements on one packed row, with
    random coordinates (the formulas need no curve point); with infinity,
    the second element's R has z = 0, as from_affine of a point at infinity
    gives it. And P's coordinates."""
    r = random.Random(seed)
    rx, ry, rz, qx, qy = (fq2s(r, 2) for _ in range(5))
    if infinity:
        rz[..., RC.SUB:] = 0
    p = fp.encode([r.randrange(rm.P) for _ in range(4)])
    return (rx, ry, rz, qx, qy), torch.from_numpy(p[:1]), torch.from_numpy(p[1:])


def plain_redcs(monkeypatch) -> list:
    """Record every stacked REDC the plain formulas run: its biased input
    channels reduced modulo each lane's modulus, and its output rows, both
    (K, rows, LANES)."""
    stack, cat = fp.redc_stack, fp.redc_cat
    m = torch.from_numpy(RC.M_I32.astype(np.int64))
    out = []

    def record(rs, dim, fn, join):
        biased = [fp.nonneg(x) for x in rs]
        ch = join([x.ch for x in biased], dim=dim).to(torch.int64) % m
        got = fn(rs, dim)
        out.append((ch.movedim(-2, 0).numpy(), got.movedim(-2, 0).numpy()))
        return got

    monkeypatch.setattr(fp, "redc_stack",
                        lambda rs, dim=-2: record(rs, dim, stack, torch.stack))
    monkeypatch.setattr(fp, "redc_cat", lambda rs, dim=-2: record(rs, dim, cat, torch.cat))
    return out


@pytest.mark.parametrize("infinity", [False, True], ids=["finite", "infinity"])
@pytest.mark.parametrize("scaled", [False, True], ids=["raw", "scaled"])
@pytest.mark.parametrize("step", ["doubling", "addition"])
def test_line_step_redcs_match_plain(lib, emulated, monkeypatch, step, scaled, infinity):
    (rx, ry, rz, qx, qy), py, px = line_inputs(0x11E + scaled + 2 * infinity, infinity)
    add = step == "addition"
    if scaled:
        # the fused kernel, one step: the line step, then the ell's REDC
        f0 = torch.from_numpy(tower.encode([rm.rand_fq12(random.Random(7))] * 2))
        skip = torch.zeros_like(py)
        kernels._miller_fused_kernel(f0, rx, ry, rz, qx, qy, py, px, skip, (2 * add,))
    else:
        kernels._prepare_g2_lines_kernel(rx, ry, rz, qx, qy, (int(add),))
    got = redc_log(lib)
    want = plain_redcs(monkeypatch)
    r, q = lines.G2Projective(rx, ry, rz), G2Affine(qx, qy, None)
    scale = (fp.wrap(py[..., None, :]), fp.wrap(px[..., None, :])) if scaled else None
    if add:
        lines.addition_step(r, q, scale=scale)
    else:
        lines.doubling_step(r, scale=scale)
    stages = kernel_tables.LINE_STAGES[(add, scaled)]
    assert len(want) == len(stages) and len(got) == len(stages) + scaled
    biases = kernel_tables.static_biases()
    for name, (gin, gout), (win, wout) in zip(stages, got, want):
        assert gin.shape[0] == len(biases[name]), name
        assert np.array_equal(gin[:, :1], win), name
        assert np.array_equal(gout[:, :1], wout), name


def points(seed: int, g1_at_infinity: int | None, g2_at_infinity: int | None):
    """Two point pairs on one packed row, the named G1 or G2 point at
    infinity."""
    r = random.Random(seed)
    ps = [rm.rand_g1(r) for _ in range(2)]
    qs = [rm.rand_g2(r) for _ in range(2)]
    if g1_at_infinity is not None:
        ps[g1_at_infinity] = rm.G1Affine(0, 0, True)
    if g2_at_infinity is not None:
        qs[g2_at_infinity] = rm.G2Affine(rm.Fq2(0, 0), rm.Fq2(0, 0), True)
    return G1Affine.encode(ps, device="cpu"), G2Affine.encode(qs, device="cpu")


@pytest.fixture(scope="module")
def two_terms():
    """Two terms on one packed row, the first with its second G1 point at
    infinity, the second with its first G2 point at infinity: points,
    fused-loop operands and the plain step-major coefficients of each."""
    out = []
    for seed, inf in ((0x11F, (1, None)), (0x120, (None, 0))):
        p, q = points(seed, *inf)
        args = mpr._fused_args(p, q)
        out.append((p, q, args, kernels.prepare_g2_lines_plain(*args[1:6], _IS_ADD)))
    return out


def test_prepare_g2_lines_kernel_matches_plain(emulated, two_terms):
    _, _, args, want = two_terms[0]
    got = kernels._prepare_g2_lines_kernel(*args[1:6], tuple(map(int, _IS_ADD)))
    assert {k: n for k, n in emulated.items() if n} == {"prepare_g2_lines": 1}
    assert got.shape == (68, 1, 3, 2, RC.LANES) and torch.equal(got, want)


@pytest.mark.parametrize("term", [0, 1])
def test_miller_fused_kernel_matches_plain(emulated, two_terms, term):
    _, _, args, _ = two_terms[term]
    got = kernels._miller_fused_kernel(*args)
    assert {k: n for k, n in emulated.items() if n} == {"miller_fused": 1}
    want = kernels.miller_fused_plain(*args)
    assert torch.equal(got, want)
    # one element runs the loop, the other keeps f = 1
    one = tower.is_one(want)[0].tolist()
    assert one == ([False, True] if term == 0 else [True, False])


@pytest.mark.parametrize("n_terms", [1, 2, 17])
def test_miller_run_kernel_matches_plain(emulated, two_terms, n_terms):
    """One launch for any number of terms (seventeen: the two terms in
    turn)."""
    terms = [two_terms[t % 2] for t in range(n_terms)]
    skips = [((p.infinity != 0) | (q.infinity != 0)).to(torch.int32) for p, q, _, _ in terms]
    call = ([c for *_, c in terms], [p.y for p, *_ in terms], [p.x for p, *_ in terms],
            skips)
    f0 = tower.one((1,), "cpu")
    got = kernels._miller_run_kernel(f0, list(call), tuple(map(int, _DO_SQUARE)))
    assert {k: n for k, n in emulated.items() if n} == {"miller_run": 1}
    assert torch.equal(got, kernels.miller_run_plain(f0, *call, _DO_SQUARE))


@pytest.mark.parametrize("order", ORDERS)
def test_line_kernels_under_each_fiber_order(lib, emulated, two_terms, order):
    """prepare_g2_lines and a one-term miller_run with each block's fibers
    resumed by thread index, in reverse and shuffled."""
    set_order(lib, order)
    try:
        p, q, args, want = two_terms[1]
        assert torch.equal(kernels._prepare_g2_lines_kernel(*args[1:6],
                                                            tuple(map(int, _IS_ADD))), want)
        skip = ((p.infinity != 0) | (q.infinity != 0)).to(torch.int32)
        call = ([want], [p.y], [p.x], [skip])
        f0 = tower.one((1,), "cpu")
        assert torch.equal(kernels._miller_run_kernel(f0, list(call),
                                                      tuple(map(int, _DO_SQUARE))),
                           kernels.miller_run_plain(f0, *call, _DO_SQUARE))
    finally:
        set_order(lib, "forward")


def test_miller_run_plain_two_terms_matches_steps_raw(two_terms):
    ps = [p for p, *_ in two_terms]
    skips = [((p.infinity != 0) | (q.infinity != 0)).to(torch.int32) for p, q, _, _ in two_terms]
    coeffs = [c for *_, c in two_terms]
    f0 = tower.one((1,), "cpu")
    got = kernels.miller_run_plain(f0, coeffs, [p.y for p in ps], [p.x for p in ps], skips,
                                   _DO_SQUARE)
    want = mpr.miller_steps_raw(f0, coeffs, [fp.wrap(p.y[..., None, :]) for p in ps],
                                [fp.wrap(p.x[..., None, :]) for p in ps], skips)
    assert torch.equal(got, want)
    # and the fused schedule's flags are the split loop's square flags and
    # its addition steps
    assert [f & 1 for f in _FUSED_FLAGS] == list(_DO_SQUARE)
    assert [f >> 1 for f in _FUSED_FLAGS] == list(_IS_ADD)
