"""csrc/tower_ops.cu's per-op kernels built for the host by
torch_cuda_emu.py and laid out by their wrapper's kernel path
(kernels._tower_op) as on a card, every comparison bit for bit (tolerance
0) against the plain tower formulas:
  * fq12_frobenius against tower.frobenius_map_plain at 1 and 3 packed rows
    and at one row more than a tile, on every other element of a stack (the
    final exponentiation's tail hands it such a view) and on one row
    broadcast over the rows (row stride 0), under each order of a block's
    fibers;
  * fq12_mul against tower.mul_plain on the same operands;
  * the final exponentiation's hard part with its products and Frobenius
    maps on the emulated kernels against the hard part on the plain formulas.
The `gpu` twin is tests/test_torch_kernels.py's test_tower_kernel_matches_plain."""

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernel_tables, kernels, tower
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from torch_cuda_emu import ORDERS, bind, build, compiler, set_order

torch.set_num_threads(1)

#: packed rows: one, a part of a tile, one more than a tile
ROWS = (1, 3, kernel_tables.TC_ROWS + 1)
_FQ12 = (12, RC.LANES)


def fq12_rows(rows: int, seed: int) -> torch.Tensor:
    """(rows, 12, LANES): 2 * rows random Fq12 elements."""
    rng = np.random.default_rng(seed)
    ints = np.empty((2 * rows, 12), dtype=object)
    for idx in np.ndindex(ints.shape):
        ints[idx] = int.from_bytes(rng.bytes(48), "little") % rm.P
    return torch.from_numpy(fp.encode(ints))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the kernels for the CPU")
    return build("tower_ops.cu", tmp_path_factory.mktemp("emu"))


@pytest.fixture
def emulated(lib, monkeypatch):
    """tower_ops.cu bound to ops/rns/kernels.py's launch helpers; the
    launches they count."""
    bind(monkeypatch, kernels, lib)
    kernels.reset_launches()
    yield kernels.launches
    kernels.reset_launches()


def frobenius(a: torch.Tensor) -> torch.Tensor:
    return kernels._tower_op("fq12_frobenius", a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return kernels._tower_op("fq12_mul", a, [(b, _FQ12)])


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("rows", ROWS)
def test_frobenius_kernel_matches_plain(lib, emulated, rows, order):
    set_order(lib, order)
    a = fq12_rows(rows, 0xA0 + rows)
    b = fq12_rows(rows, 0xB0 + rows)
    stack = torch.stack([a, b, a.flip(0)])
    cases = [(a,), (stack[0::2],), (b[-1:].expand(rows, *_FQ12),)]
    for (x,) in cases:
        got = frobenius(x)
        assert got.shape == x.shape and torch.equal(got, tower.frobenius_map_plain(x))
    # a Frobenius power is the p-th power: six of them give the conjugate
    # f^(p^6), compared as values
    want = [e.frobenius_pow(6) for e in tower.decode(a)[:2]]
    x = a
    for _ in range(6):
        x = frobenius(x)
    assert [e.coeffs() for e in tower.decode(x)[:2]] == [e.coeffs() for e in want]
    got = mul(a, b)
    assert torch.equal(got, tower.mul_plain(a, b))
    assert {k: v for k, v in emulated.items() if v} == {"fq12_frobenius": 9, "fq12_mul": 1}


def test_hard_part_on_the_kernels_matches_plain(emulated, monkeypatch):
    """The hard part with tower.mul and tower.frobenius_map on the emulated
    kernels (its exponentiations on their plain versions) against the hard
    part on the plain formulas."""
    f = fq12_rows(2, 0xC0)
    t2 = kernels.easy_part_plain(f)
    want = mpr._hard_part(t2, "segments")
    assert sum(emulated.values()) == 0  # the CPU takes the plain formulas
    monkeypatch.setattr(kernels, "fq12_frobenius", frobenius)
    monkeypatch.setattr(kernels, "fq12_mul", mul)
    got = mpr._hard_part(t2, "segments")
    assert torch.equal(got, want)
    assert {k: v for k, v in emulated.items() if v} == {"fq12_frobenius": 3, "fq12_mul": 15}
