"""The final exponentiation's easy part as csrc/easy_part.cu's kernels
(easy_down, one tree_mul per level of fp.inv's product tree, easy_up),
built for the host by torch_cuda_emu.py and laid out by their wrapper's
kernel path (kernels._easy_part_kernel) as on a card, every comparison bit
for bit (tolerance 0) against the plain easy part (kernels.easy_part_plain):
  * at 1 and 3 packed rows (under the tree's 128-row floor), 128 (the floor),
    129 (padded to 256: one level) and 300 (padded to 512: two levels);
  * with a zero element in one slot, in both slots of a row, and filling
    every row (the inv0 convention: the tree takes one in their place and
    the inverse is zero there) or every row the padding pairs with;
  * the tree alone against fp.inv, and the chain with a zero slot, under
    each order of a block's fibers;
  * at 300 rows against the JAX package's easy part;
  * the dispatch: the CPU and a recording witness trace run the plain path.
The Fermat root between the levels is pow_static_fused, which on the CPU is
its plain version fp.pow_static (the emulated pow_static.cu is held to it in
test_torch_warp_kernels.py). The `gpu` tests run the kernels on the card at
the cells' 512 and 1,024 packed rows."""

import contextlib
import random

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernel_tables, kernels, tower
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_torch.utils import spans
from plonky2_bls12_381_pairing_torch.utils.capture import Captured
from torch_cuda_emu import ORDERS, bind, build, compiler, set_order

torch.set_num_threads(1)

#: packed rows: under the floor, the floor, one level (padded), two levels
#: (padded)
ROWS = (1, 3, fp._TREE_FLOOR, fp._TREE_FLOOR + 1, 300)


def tree_levels(rows: int) -> int:
    """Levels of fp.inv's product tree above its floor for `rows` rows."""
    size = 1 << max(rows - 1, 0).bit_length()
    return max(size.bit_length() - fp._TREE_FLOOR.bit_length(), 0)


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
    return build("easy_part.cu", tmp_path_factory.mktemp("emu"))


@pytest.fixture
def emulated(lib, monkeypatch):
    """easy_part.cu bound to ops/rns/kernels.py's launch helpers; the
    launches they count."""
    bind(monkeypatch, kernels, lib)
    kernels.reset_launches()
    yield kernels.launches
    kernels.reset_launches()


def check_chain(f: torch.Tensor, launches: dict) -> torch.Tensor:
    """The emulated chain against the plain easy part, with its launches."""
    got = kernels._easy_part_kernel(f)
    assert torch.equal(got, kernels.easy_part_plain(f))
    rows = f.shape[0]
    assert {k: v for k, v in launches.items() if v} == {
        "easy_down": 1, "easy_up": 1, **({"tree_mul": 2 * tree_levels(rows)}
                                         if rows > fp._TREE_FLOOR else {})}
    return got


@pytest.mark.parametrize("rows", ROWS)
def test_easy_part_kernel_matches_plain(emulated, rows):
    f = fq12_rows(rows, 0xEA00 + rows)
    got = check_chain(f, emulated)
    # the value: f^((p^6 - 1)(p^2 + 1)) of the first row's two elements
    for slot, x in enumerate(tower.decode(f[:1])):
        e = x.conjugate() * x.inv()
        assert tower.decode(got[:1])[slot].coeffs() == (e.frobenius_pow(2) * e).coeffs()


def zero_cases():
    """(name, rows, rows made zero, slots made zero)."""
    every = slice(None)
    return [("one slot", 3, [0], slice(RC.SUB, None)),
            ("both slots", 3, [1], every),
            ("every row", fp._TREE_FLOOR + 1, every, every),
            # rows 256..299 pair with the padding on the first level
            ("the padding's partners", 300, slice(256, None), every)]


@pytest.mark.parametrize("name, rows, which, lanes", zero_cases(),
                         ids=[c[0] for c in zero_cases()])
def test_easy_part_kernel_with_zeros(emulated, name, rows, which, lanes):
    f = fq12_rows(rows, 0xEA10 + rows)
    f[which, :, lanes] = 0
    got = check_chain(f, emulated)
    # zero maps to zero, and only zero
    zero = tower.is_equal(f, torch.zeros_like(f))
    assert bool(zero.any()) and torch.equal(tower.is_equal(got, torch.zeros_like(got)), zero)


@pytest.mark.parametrize("order", ORDERS)
def test_easy_part_kernels_under_each_fiber_order(lib, emulated, order):
    """The tree's levels at 300 rows against fp.inv, and the chain with a
    zero slot (easy_down's zero mask meets across warps in shared memory),
    with each block's fibers resumed by thread index, in reverse and
    shuffled."""
    set_order(lib, order)
    try:
        r = random.Random(0xEA20)
        n = torch.from_numpy(fp.encode([r.randrange(1, rm.P) for _ in range(600)]))
        assert torch.equal(kernels._tree_inv(n), fp.inv(n))
        assert emulated["tree_mul"] == 2 * tree_levels(300)
        kernels.reset_launches()
        f = fq12_rows(5, 0xEA21)
        f[2, :, :RC.SUB] = 0
        check_chain(f, emulated)
    finally:
        set_order(lib, "forward")


def test_easy_part_kernel_matches_the_jax_package(emulated):
    """Two levels of the tree, padded: the JAX package's easy part, the
    composition of its final_exponentiation."""
    import jax  # the JAX package runs on the CPU only: not imported on the card

    from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw

    f = fq12_rows(300, 0xEA30)

    def easy(a):
        t = jtw.mul(jtw.conjugate(a), jtw.inv(a))
        return jtw.mul(jtw.frobenius_pow(t, 2), t)

    want = np.asarray(jax.jit(easy)(f.numpy()))
    assert np.array_equal(kernels._easy_part_kernel(f).numpy(), want)


def test_easy_part_biases_are_the_plain_formulas():
    """The bias rows the kernels add are those of the plain easy part's
    stacked REDCs, stage by stage (EASY_STAGES), each k of its rows."""
    biases = kernel_tables.static_biases()
    seen = []
    stack = fp.redc_stack

    def record(rs, dim=-2):
        seen.append([fp.nonneg_multiple(x) for x in rs])
        return stack(rs, dim)

    fp.redc_stack = record
    try:
        kernels.easy_part_plain(fq12_rows(1, 0xEA40))
    finally:
        fp.redc_stack = stack
    assert seen == [biases[k] for k in kernel_tables.EASY_STAGES]
    assert len(kernel_tables.tables()["RNS_FROB"]) == 2 * len(tower.FROB_NAMES)


def test_easy_part_dispatch(monkeypatch):
    """_easy_part: the CPU runs the plain path; a recording witness trace
    runs it too, whatever the device, and records fp.inv's rows; else the
    kernels' wrapper."""
    f = fq12_rows(2, 0xEA50)
    want = kernels.easy_part_plain(f)
    calls = []
    kernel = kernels._easy_part_kernel
    monkeypatch.setattr(kernels, "_easy_part_kernel", lambda a: calls.append(a) or kernel(a))
    assert torch.equal(mpr._easy_part(f), want) and not calls
    wrapper = []
    monkeypatch.setattr(kernels, "easy_part", lambda a: wrapper.append(a) or want)
    assert mpr._easy_part(f) is want and len(wrapper) == 1
    monkeypatch.setattr(fp, "_witness_sink", [])
    assert torch.equal(mpr._easy_part(f), want) and len(wrapper) == 1
    kinds = [op for op, _ in fp._witness_sink]
    assert kinds.count("rns_inv") == 1 and "rns_mul" in kinds


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", (512, 1024))
def test_easy_part_kernels_on_the_card(cuda, rows):
    """The cells' packed rows, with a zero slot: the kernels against the
    plain path on the card and on the CPU (whose rows the tests above hold
    to the JAX package); captured, the graph holds the kernels' launches and
    no other node."""
    f = fq12_rows(rows, 0xEA60 + rows)
    f[3, :, RC.SUB:] = 0
    fd = f.to(cuda)
    kernels.reset_launches()
    got = kernels.easy_part(fd)
    levels = tree_levels(rows)
    want_launches = {"easy_down": 1, "tree_mul": 2 * levels, "pow_static": 1, "easy_up": 1}
    assert {k: v for k, v in kernels.launches.items() if v} == want_launches
    assert torch.equal(got, kernels.easy_part_plain(fd))
    assert torch.equal(got.cpu(), kernels.easy_part_plain(f))
    counted = {}

    @contextlib.contextmanager
    def count_nodes():
        yield
        counted["nodes"] = spans.capture_nodes(cuda)

    step = Captured(kernels.easy_part, (fd,), {}, during_capture=count_nodes())
    assert torch.equal(step(fd), got)
    assert counted["nodes"] == (sum(want_launches.values()), 0)
