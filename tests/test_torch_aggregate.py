"""FastAggregateVerify's key sums on the card (csrc/g1_aggregate.cu) and the
entry point that checks Electra blocks from the registry
(models/aggregate.py aggregate_check):
  * the kernels built for the host by torch_cuda_emu.py and launched by their
    wrapper (kernels._g1_aggregate_kernel), bit for bit (tolerance 0) against
    the plain path (kernels.g1_aggregate_plain) on the same pieces: pieces
    of several lengths, tiles that stride, a set of no bit, and under each
    order of a block's fibers;
  * aggregate_check's verdicts at 4 blocks against the refmodel (each set's
    keys summed point by point, the product of the block's pairings), with
    a valid block, an empty attestation, a bit flipped after signing and a
    sum of signatures off by G2;
  * an offset or proposer out of range fails its block and reads nothing
    outside the registry;
  * its second call makes no tensor from host data (a CUDA graph capture
    would refuse one).
The `gpu` tests run the kernels on the card at the electra-agg-64x12 cell's
shapes (64 blocks of 8 attestations over 31,250 validators each, a
1,000,000-key registry) against the plain path there, and the captured entry
point's verdicts."""

import contextlib
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from plonky2_bls12_381_pairing_torch.models import aggregate as ag
from plonky2_bls12_381_pairing_torch.ops import cuda_build
from plonky2_bls12_381_pairing_torch.ops.kernels import mont, tower  # noqa: F401 (register)
from plonky2_bls12_381_pairing_torch.ops.rns import kernels
from plonky2_bls12_381_pairing_torch.utils import spans
from plonky2_bls12_381_pairing_torch.utils.capture import capture
from torch_cuda_emu import ORDERS, bind, build, compiler, set_order
from torch_electra import make_blocks, make_keys, reference_verdict

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def keys():
    return make_keys(256, 2, 4, 40, seed=0x6200)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the kernels for the CPU")
    return build("g1_aggregate.cu", tmp_path_factory.mktemp("emu"))


@pytest.fixture
def emulated(lib, monkeypatch):
    """g1_aggregate.cu bound to ops/rns/kernels.py's launch helpers; the
    launches they count."""
    bind(monkeypatch, kernels, lib)
    kernels.reset_launches()
    yield kernels.launches
    kernels.reset_launches()


def kernel_inputs(keys, n_blocks: int, piece_bits: int, seed: int):
    """The arguments of g1_aggregate for n_blocks blocks of 2 attestations,
    the first block's first attestation empty."""
    data = make_blocks(keys, n_blocks, 2, seed, participation=0.7, empty=(0,))
    reg, b = keys.registry, data.blocks
    pieces, sets = ag.layout(n_blocks, 2, b.att_bits.shape[-1], reg.slot_size,
                             b.sync_bits.shape[-1], reg.sync_size, piece_bits, "cpu")
    set_off, words = ag._set_words(b, reg)
    return reg.keys, reg.index, set_off, words, pieces, sets


@pytest.mark.parametrize("n_blocks, piece_bits", [(2, 64), (4, 24), (6, 40)])
def test_g1_aggregate_kernel_matches_plain(keys, emulated, n_blocks, piece_bits):
    """Pieces of 64 bits (one a set), 24 (three, the last shorter, across
    words) and 40; 6 blocks make 33 sets and, with 40-bit pieces, 63 pieces,
    each over several tiles of both kernels."""
    args = kernel_inputs(keys, n_blocks, piece_bits, 0x6201 + n_blocks)
    got = kernels._g1_aggregate_kernel(*args)
    assert torch.equal(got, kernels.g1_aggregate_plain(*args))
    assert {k: v for k, v in emulated.items() if v} == {"g1_sum": 1, "g1_combine": 1}


@pytest.mark.parametrize("order", ORDERS)
def test_g1_aggregate_kernel_under_each_fiber_order(keys, lib, emulated, order):
    """With each block's fibers resumed by thread index, in reverse and
    shuffled: the REDCs' shared words and the tile's step count."""
    set_order(lib, order)
    try:
        args = kernel_inputs(keys, 4, 24, 0x6210)
        assert torch.equal(kernels._g1_aggregate_kernel(*args),
                           kernels.g1_aggregate_plain(*args))
    finally:
        set_order(lib, "forward")


def test_every_kernels_argument_types_match_its_entry_point():
    """Each registered kernel's ctypes argument types, the stream last,
    count its C entry point's parameters: one short, the stream would go
    as a C int (the emulator, which passes it as None, would not see it)."""
    text = "".join(p.read_text() for p in cuda_build._CSRC.glob("*.cu"))
    for name, (src, entry, argtypes, _) in cuda_build._KERNELS.items():
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
        assert m, entry
        assert len(m.group(1).split(",")) == len(argtypes), name


def test_aggregate_check_verdicts(keys):
    """4 blocks: valid, an empty attestation, a bit flipped after signing,
    and the sum of signatures off by G2; the verdicts are the refmodel's."""
    data = make_blocks(keys, 4, 2, 0x6220, empty=(1,), flipped=(2,), sigma_off=(3,))
    got = ag.aggregate_check(data.blocks, keys.registry).reshape(-1)
    assert got.tolist() == data.valid.tolist() == [True, False, False, False]
    assert [reference_verdict(keys, data, b) for b in range(4)] == got.tolist()


def test_out_of_range_inputs_fail_their_blocks(keys):
    """An attestation offset past the registry's epochs, a negative one and a
    proposer outside the registry fail their blocks, and the sets read only
    inside the index list and the keys (torch's indexing of the plain path
    would raise)."""
    data = make_blocks(keys, 4, 2, 0x6225)
    b = data.blocks
    b.att_offset[0, 1] = keys.registry.sync_base
    b.att_offset[1, 0] = -5
    b.proposer[2] = keys.registry.validators + 3
    got = ag.aggregate_check(b, keys.registry).reshape(-1)
    assert got.tolist() == [False, False, False, True]


@pytest.fixture(scope="module")
def padded_keys():
    """200 keys in 4 slots an epoch: 50 bits an attestation, 14 of its second
    word padding; a sync committee of 40, 24 bits of padding."""
    return make_keys(200, 2, 4, 40, seed=0x6260)


def test_padding_bits_fail_their_blocks(padded_keys):
    """A bit set in a word's padding fails its block: an attestation whose
    only bit is padding (the kernels read none of it, so its key would be
    the point at infinity and its term one), an attestation with its bits
    and a padding bit, and a sync aggregate's padding bit."""
    data = make_blocks(padded_keys, 4, 2, 0x6261, empty=(0,))
    b = data.blocks
    b.att_bits[0, 0, 1] |= 1 << 20
    b.att_bits[1, 1, 1] |= 1 << 31
    b.sync_bits[2, 1] |= 1 << 9
    got = ag.aggregate_check(b, padded_keys.registry).reshape(-1)
    assert got.tolist() == [False, False, False, True]


@pytest.mark.parametrize("short", ["att", "sync"])
def test_bit_words_of_another_length_are_refused(padded_keys, short):
    """Words fewer than ceil(bits / 32) for an attestation or the sync
    aggregate: the kernels would read other sets' words, so the entry point
    refuses them."""
    b = make_blocks(padded_keys, 2, 2, 0x6262).blocks
    if short == "att":
        b.att_bits = b.att_bits[..., :-1].contiguous()
    else:
        b.sync_bits = b.sync_bits[..., :-1].contiguous()
    with pytest.raises(ValueError, match="words"):
        ag.aggregate_check(b, padded_keys.registry)


class _HostTensors(TorchDispatchMode):
    """Counts the tensors made from host data inside the mode (a Python list
    or number made a tensor reaches the dispatcher as aten.lift_fresh)."""

    def __init__(self):
        super().__init__()
        self.made = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.made += 1
        return func(*args, **(kwargs or {}))


def test_second_call_makes_no_host_tensor(keys, monkeypatch):
    """After a first call has made the layout and the constants, a call makes
    no tensor from host data (torch.from_numpy, torch.tensor, an index
    list): on the card each would be a copy from host memory, which a CUDA
    graph capture refuses."""
    data = make_blocks(keys, 2, 2, 0x6230)
    ag.aggregate_check(data.blocks, keys.registry)
    calls = []
    from_numpy = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda *a: calls.append(a) or from_numpy(*a))
    with _HostTensors() as mode:
        ag.aggregate_check(data.blocks, keys.registry)
    assert calls == [] and mode.made == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cell_keys():
    """The cell's registry shape: 1,000,000 keys (a pool of 4,096 repeated),
    two epochs of 32 slots, a sync committee of 512."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return make_keys(1_000_000, 2, 32, 512, seed=0x6240, device="cuda", pool=4096)


@pytest.mark.gpu
def test_g1_aggregate_on_the_card(cell_keys):
    """64 blocks of 8 attestations at 0.97 participation: the kernels'
    sums bit for bit the plain path's on the card, and the captured call's
    graph holds their two launches and no other node."""
    data = make_blocks(cell_keys, 64, 8, 0x6241, device="cuda")
    reg, b = cell_keys.registry, data.blocks
    pieces, sets = ag.layout(64, 8, b.att_bits.shape[-1], reg.slot_size,
                             b.sync_bits.shape[-1], reg.sync_size, ag.PIECE_BITS, reg.keys.device)
    set_off, words = ag._set_words(b, reg)
    args = (reg.keys, reg.index, set_off, words, pieces, sets)
    kernels.reset_launches()
    got = kernels.g1_aggregate(*args)
    assert {k: v for k, v in kernels.launches.items() if v} == {"g1_sum": 1, "g1_combine": 1}
    assert torch.equal(got, kernels.g1_aggregate_plain(*args))
    counted = {}

    @contextlib.contextmanager
    def count_nodes():
        yield
        counted["nodes"] = spans.capture_nodes(reg.keys.device)

    from plonky2_bls12_381_pairing_torch.utils.capture import Captured

    step = Captured(kernels.g1_aggregate, args, {}, during_capture=count_nodes())
    assert torch.equal(step(*args), got)
    assert counted["nodes"] == (2, 0)


@pytest.mark.gpu
def test_aggregate_check_on_the_card(cell_keys):
    """The entry point captured at the cell's shapes (the registry a fixed
    argument, not copied), its verdicts those the blocks were built to give,
    with an empty attestation, a flipped bit and a sum of signatures off."""
    data = make_blocks(cell_keys, 64, 8, 0x6250, empty=(5,), flipped=(17,), sigma_off=(40,),
                       device="cuda")
    step = capture(ag.aggregate_check, data.blocks, registry=cell_keys.registry)
    got = step(data.blocks).reshape(-1).cpu().numpy()
    assert np.array_equal(got, data.valid) and (~got).sum() == 3
    eager = ag.aggregate_check(data.blocks, cell_keys.registry).reshape(-1).cpu().numpy()
    assert np.array_equal(eager, got)
