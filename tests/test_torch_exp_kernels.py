"""The tensor-core exponentiation kernels' own code on the CPU
(csrc/cyc_exp.cu and csrc/kara_full.cu, built for the host by
torch_cuda_emu.py: one thread per CUDA thread, the tensor-core products as
the same integer sums), every comparison bit for bit (tolerance 0):
  * cyc_exp_cond through its wrapper's kernel path against
    cyc_exp_cond_plain, and cyc_exp (the same kernel body walking
    segments) against cyc_exp_plain, for |BLS_X| on 1, 3 and TC_ROWS + 1
    packed rows (a partial last tile);
  * kara_full through its wrapper's kernel path against kara_full_plain on
    1, 3 and TC_ROWS + 1 packed rows, with the identity in one slot of the
    first row and (from 3 rows) in the whole second row: its compressed
    form is zero, the g2 == 0 branch with a zero norm; on short chain
    segments (a zero-length one among them) and on |BLS_X|'s; the Fermat
    chains are p - 2's whole 608 REDCs;
  * both kernels, and kara_exp.cu's Karabina walks, on the tensor-core
    tile; no source keeps the one-row blocks' shared-memory REDC.
The plain versions are held to the JAX package in test_torch_karabina.py
and test_torch_pairing.py."""

import random
import re

import pytest
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models.schedule import _GS_SEGMENTS, _KARA_SEGMENTS
from plonky2_bls12_381_pairing_torch.ops.rns import kernel_tables, kernels, tower
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from torch_cuda_emu import CSRC, ORDERS, bind, build, compiler, set_order

torch.set_num_threads(1)

#: packed rows: one, a partial tile, a whole tile and one row more (of
#: cyc_exp's tiles; kara_full's tiles are of 2 rows)
ROWS = (1, 3, kernel_tables.TC_ROWS + 1)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the kernels for the CPU")
    out = tmp_path_factory.mktemp("emu")
    return {src: build(src, out) for src in ("cyc_exp.cu", "kara_full.cu")}


@pytest.fixture
def emulated(libs, monkeypatch):
    """Bind a source's library to ops/rns/kernels.py's launch helpers; the
    launches they count."""
    def use(source):
        bind(monkeypatch, kernels, libs[source])
        kernels.reset_launches()
        return kernels.launches

    yield use
    kernels.reset_launches()


def cyclotomic_rows(rows: int, seed: int) -> torch.Tensor:
    """(rows, 12, LANES): 2 * rows random elements of the cyclotomic
    subgroup, as the final exponentiation's easy part leaves them."""
    r = random.Random(seed)
    out = []
    for _ in range(2 * rows):
        f = rm.rand_fq12(r)
        t = f.frobenius_pow(6) * f.inv()
        out.append(t.frobenius_pow(2) * t)
    return torch.from_numpy(tower.encode(out))


@pytest.mark.parametrize("rows", ROWS)
def test_cyc_exp_cond_kernel_matches_plain(emulated, rows):
    a = cyclotomic_rows(rows, 0xC0 + rows)
    launches = emulated("cyc_exp.cu")
    got = kernels._cyc_exp_cond_kernel(a, _GS_SEGMENTS)
    assert launches["cyc_exp_cond"] == 1 and sum(launches.values()) == 1
    assert torch.equal(got, kernels.cyc_exp_cond_plain(a, _GS_SEGMENTS))
    # the same body walking the segments gives the same rows
    assert torch.equal(kernels._cyc_exp_kernel(a, _GS_SEGMENTS), got)
    assert torch.equal(got, kernels.cyc_exp_plain(a, _GS_SEGMENTS))


@pytest.mark.parametrize("rows, segments", [(1, (0, 1, 2, 0, 1, 3)), (3, (2, 0, 1, 0, 0, 1)),
                                            (ROWS[-1], _KARA_SEGMENTS)])
def test_kara_full_kernel_matches_plain(emulated, rows, segments):
    a = cyclotomic_rows(rows, 0xD0 + rows)
    one = tower.one((), torch.device("cpu"))
    a[0, :, RC.SUB:] = one[:, RC.SUB:]
    if rows > 1:
        a[1] = one
    launches = emulated("kara_full.cu")
    got = kernels._kara_full_kernel(a, segments)
    assert launches["kara_full"] == 1 and sum(launches.values()) == 1
    assert torch.equal(got, kernels.kara_full_plain(a, segments))
    assert bool(tower.is_one(got)[0, 1].all())
    if rows > 1:
        assert bool(tower.is_one(got)[1].all())


@pytest.mark.parametrize("order", ORDERS)
def test_exp_kernels_under_each_fiber_order(libs, emulated, order):
    """cyc_exp_cond and kara_full with each block's fibers resumed by
    thread index, in reverse and shuffled."""
    for lib in libs.values():
        set_order(lib, order)
    try:
        a = cyclotomic_rows(1, 0xC8)
        emulated("cyc_exp.cu")
        assert torch.equal(kernels._cyc_exp_cond_kernel(a, _GS_SEGMENTS),
                           kernels.cyc_exp_cond_plain(a, _GS_SEGMENTS))
        emulated("kara_full.cu")
        segments = (0, 1, 2, 0, 1, 3)
        assert torch.equal(kernels._kara_full_kernel(a, segments),
                           kernels.kara_full_plain(a, segments))
    finally:
        for lib in libs.values():
            set_order(lib, "forward")


def _code(source: str) -> str:
    """A CUDA source without its // comments."""
    return re.sub(r"//[^\n]*", "", (CSRC / source).read_text())


@pytest.mark.parametrize("source", ["cyc_exp.cu", "kara_full.cu", "kara_exp.cu"])
def test_exp_kernels_run_on_the_tensor_core_tile(source):
    """One block per tile of packed rows on rns_redc_tc.cuh's redc (cyc_exp.cu
    and kara_exp.cu: a tile of T rows, the template's, for their walks);
    none of the one-row blocks' REDC (Smem) is left."""
    code = _code(source)
    assert re.search(r"TcSmem<T(ILE)?>", code) and re.search(r"constexpr int TILE = \w+;", code)
    assert not re.search(r"\bSmem<", code) and "load_tables(" not in code


def test_no_source_keeps_the_one_row_block_redc():
    """Every RNS Fq12 kernel runs on the tensor-core tile (TcSmem); the
    one-row blocks' shared memory and table copy are gone from csrc/."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert len(sources) > 10
    for src in sources:
        text = src.read_text()
        assert not re.search(r"\bSmem<", text) and "load_tables(" not in text, src.name
