"""The port's witness trace (models/witness.py) against the JAX package's, on
the CPU: the same inputs, made from numpy seeds, traced by both packages.
  * the hint workload of tests/test_witness_aux.py at 3 elements (every limb
    kind) and an RNS workload at 2 packed rows (products, inverses with a
    zero, both square roots, the Fq2 inverse): the same kinds, counts and
    rows, bit for bit (tolerance 0);
  * check_trace: all zeros on the port's rows and, through
    interop.trace_from_numpy, on the JAX package's; one corrupted row of
    each kind rejected;
  * export: 12 x u32 limbs, a round trip, equal to the JAX package's export
    on the kinds without sign slots; the port's export also takes the RNS
    kinds with sign slots (rns_sqrt, rns_fq2_sqrt), on which the JAX
    package's export raises (its fault a);
  * strict traces, the restored "fused" strategy, the select-form Fermat
    chains (two recorded products per exponent bit after the leading one),
    and profiling.static_op_report against the JAX package's.
The traced RNS pairing is in test_torch_witness_pairing.py; kill and resume
in test_torch_checkpoint.py."""

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.models import witness as twt
from plonky2_bls12_381_pairing_torch.ops import fp as tfp
from plonky2_bls12_381_pairing_torch.ops import fq2 as tfq2
from plonky2_bls12_381_pairing_torch.ops import fq12 as tfq12
from plonky2_bls12_381_pairing_torch.ops.rns import fp as trfp
from plonky2_bls12_381_pairing_torch.ops.rns import fq2 as trfq2
from plonky2_bls12_381_pairing_torch.utils import profiling as tprof
from plonky2_bls12_381_pairing_tpu.models import witness as jwt
from plonky2_bls12_381_pairing_tpu.ops import fp as jfp
from plonky2_bls12_381_pairing_tpu.ops import fq2 as jfq2
from plonky2_bls12_381_pairing_tpu.ops import fq6 as jfq6
from plonky2_bls12_381_pairing_tpu.ops import fq12 as jfq12
from plonky2_bls12_381_pairing_tpu.ops.rns import fp as jrfp
from plonky2_bls12_381_pairing_tpu.utils import profiling as jprof
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm
from torch_jax_witness import jax_trace

torch.set_num_threads(1)

P = rm.P
B = 3
LIMB_KINDS = ("mul", "inv", "sqrt", "fq2_inv", "fq2_sqrt", "fq6_inv", "fq12_inv")
RNS_KINDS = ("rns_mul", "rns_inv", "rns_sqrt", "rns_fq2_inv", "rns_fq2_sqrt")


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int32))


def ints(rng: np.random.Generator, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def limb_workload(m):
    """tests/test_witness_aux.py's hint workload over module set m: every
    limb kind once (the roots of squares)."""
    fp, fq2, wt = m

    def run(x, x2, x6, x12, sgn):
        return (wt.inverse_hint(x), wt.sqrt_hint(fp.mont_square(x), sgn),
                wt.fq2_inverse_hint(x2), wt.fq2_sqrt_hint(fq2.square(x2), sgn),
                wt.fq6_inverse_hint(x6), wt.fq12_inverse_hint(x12))
    return run


def rns_workload(m):
    """Products, a batched inverse (with a zero), both square roots and the
    Fq2 inverse on the RNS tier."""
    fp, fq2 = m

    def run(a, b, s, s2, sgn):
        return (fp.mul(a, b), fp.inv(a), fp.sqrt_with_sgn(s, sgn), fq2.inv(s2),
                fq2.sqrt_with_sgn(fq2.square(s2), sgn))
    return run


@pytest.fixture(scope="module")
def limb_inputs():
    rng = np.random.default_rng(0xA11)
    x = jfp.encode(ints(rng, B))
    x2 = jfq2.encode([rm.Fq2(*ints(rng, 2)) for _ in range(B)])
    x6 = jfq6.encode([rm.Fq6(*(rm.Fq2(*ints(rng, 2)) for _ in range(3))) for _ in range(B)])
    x12 = jfq12.encode([rm.Fq12.from_coeffs(ints(rng, 12)) for _ in range(B)])
    sgn = np.array([0, 1, 1], dtype=np.int32)
    return [np.asarray(v) for v in (x, x2, x6, x12, sgn)]


@pytest.fixture(scope="module")
def rns_inputs():
    rng = np.random.default_rng(0xD1CE)
    xs = ints(rng, 3) + [0]
    s2 = np.empty((4, 2), dtype=object)
    s2[:] = np.array(ints(rng, 8), dtype=object).reshape(4, 2)
    return [np.asarray(v) for v in (
        jrfp.encode(xs), jrfp.encode(ints(rng, 4)),
        jrfp.encode([x * x % P for x in ints(rng, 4)]), jrfp.encode(s2),
        np.array([[0, 1], [1, 1]], dtype=np.int32))], xs


@pytest.fixture(scope="module")
def limb_traces(limb_inputs):
    jout, jtr = jax_trace(limb_workload((jfp, jfq2, jwt)), *limb_inputs)
    tout, ttr = twt.trace(limb_workload((tfp, tfq2, twt)), *map(t, limb_inputs))
    return jout, jtr, tout, ttr


@pytest.fixture(scope="module")
def rns_traces(rns_inputs):
    from plonky2_bls12_381_pairing_tpu.ops.rns import fq2 as jrfq2

    args, _ = rns_inputs
    jout, jtr = jax_trace(rns_workload((jrfp, jrfq2)), *args)
    tout, ttr = twt.trace(rns_workload((trfp, trfq2)), *map(t, args))
    return jout, jtr, tout, ttr


def same_rows(jtr, ttr) -> None:
    assert list(ttr.rows) == list(jtr.rows)
    assert ttr.counts() == jtr.counts()
    for op, rows in jtr.rows.items():
        for i, (jr, tr_) in enumerate(zip(rows, ttr.rows[op])):
            assert len(jr) == len(tr_)
            for j, (a, b) in enumerate(zip(jr, tr_)):
                assert np.array_equal(np.broadcast_to(np.asarray(a), b.shape),
                                      b.numpy()), (op, i, j)


def test_limb_trace_matches_jax(limb_traces):
    jout, jtr, tout, ttr = limb_traces
    assert set(ttr.counts()) == set(LIMB_KINDS)
    same_rows(jtr, ttr)
    for a, b in zip(jout, tout):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_rns_trace_matches_jax(rns_traces, rns_inputs):
    jout, jtr, tout, ttr = rns_traces
    assert set(ttr.counts()) == set(RNS_KINDS)
    assert ttr.counts()["rns_inv"] == 2  # fp.inv and the Fq2 inverse's norm
    same_rows(jtr, ttr)
    for a, b in zip(jout, tout):
        assert np.array_equal(np.asarray(a), b.numpy())
    _, xs = rns_inputs
    assert list(trfp.decode(tout[1]))[:4] == [rm.fp_inv(x) if x else 0 for x in xs]


@pytest.mark.parametrize("which", ["limb", "rns"])
def test_untampered_traces_check_clean(limb_traces, rns_traces, which):
    _, jtr, _, ttr = limb_traces if which == "limb" else rns_traces
    result = twt.check_trace(ttr)
    assert result and all(v == 0 for v in result.values()), result
    jrows = {op: [tuple(np.asarray(x) for x in r) for r in rows]
             for op, rows in jtr.rows.items()}
    assert twt.check_trace(interop.trace_from_numpy(jrows, device="cpu")) == result


def _corrupt(tr, kind: str):
    """A trace of kind's first row with one residue or limb of its last slot
    + 1."""
    row = list(tr.rows[kind][0])
    bad = row[-1].clone()
    bad.view(-1)[0] += 1
    row[-1] = bad
    out = twt.WitnessTrace()
    out.add(kind, tuple(row))
    return out


@pytest.mark.parametrize("kind", LIMB_KINDS + RNS_KINDS)
def test_corrupted_row_rejected(limb_traces, rns_traces, kind):
    _, _, _, ttr = rns_traces if kind.startswith("rns_") else limb_traces
    assert twt.check_trace(_corrupt(ttr, kind))[kind] > 0


@pytest.mark.parametrize("tier", ["limb", "rns"])
def test_corrupted_connect_rejected(tier):
    rng = np.random.default_rng(0xC0)
    if tier == "limb":
        x = t(jfp.encode(ints(rng, 2)))
        fn, kind = tfp.connect, "connect"
    else:
        x = t(jrfp.encode(ints(rng, 2)))
        fn, kind = trfp.connect, "rns_connect"
    _, tr = twt.trace(fn, x, x.clone())
    assert twt.check_trace(tr) == {kind: 0}
    assert twt.check_trace(_corrupt(tr, kind))[kind] > 0


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def test_u32_export_roundtrip():
    rng = np.random.default_rng(0xB32)
    vals = ints(rng, 4) + [0, P - 1]
    x = t(jfp.encode(vals))
    u = twt.to_u32_limbs(x)
    assert u.shape == (6, twt.U32_LIMBS) and u.dtype == np.uint32
    assert [sum(int(u[i, j]) << (32 * j) for j in range(twt.U32_LIMBS))
            for i in range(6)] == vals
    back = twt.from_u32_limbs(u, device="cpu")
    assert list(tfp.decode(back)) == vals


def _first_rows(tr, kinds, n=2):
    return {op: tr.rows[op][:n] for op in kinds}


@pytest.mark.parametrize("which", ["limb", "rns"])
def test_export_matches_jax_without_sign_slots(limb_traces, rns_traces, which):
    """On the kinds whose slots are all field elements the two exports are
    equal; the limb sqrt kinds' sign slots pass through in both."""
    _, jtr, _, ttr = limb_traces if which == "limb" else rns_traces
    kinds = [k for k in ttr.rows if k not in ("rns_sqrt", "rns_fq2_sqrt")]
    jsub, tsub = jwt.WitnessTrace(_first_rows(jtr, kinds)), twt.WitnessTrace(
        _first_rows(ttr, kinds))
    jex, tex = jwt.export_rows_u32(jsub), twt.export_rows_u32(tsub)
    assert list(jex) == list(tex) == kinds
    for op in kinds:
        for jr, tr_ in zip(jex[op], tex[op]):
            for a, b in zip(jr, tr_):
                assert b.dtype == np.asarray(a).dtype
                assert np.array_equal(np.asarray(a), b), op


@pytest.mark.parametrize("tier", ["limb", "rns"])
def test_export_of_connect_rows_matches_jax(tier):
    """The equality kinds export as the JAX package's: with the kinds above,
    all fourteen."""
    rng = np.random.default_rng(0xC1)
    if tier == "limb":
        x, y = jfp.encode(ints(rng, 2)), jfp.encode(ints(rng, 2))
        tfn, jfn = tfp.connect, jfp.connect
    else:
        x, y = jrfp.encode(ints(rng, 4)), jrfp.encode(ints(rng, 4))
        tfn, jfn = trfp.connect, jrfp.connect
    _, ttr = twt.trace(tfn, t(x), t(y))
    _, jtr = jax_trace(jfn, x, y)
    (kind,) = ttr.rows
    jex, tex = jwt.export_rows_u32(jtr)[kind], twt.export_rows_u32(ttr)[kind]
    for a, b in zip(jex[0], tex[0]):
        assert b.dtype == np.uint32 and np.array_equal(np.asarray(a), b), kind


def test_export_takes_rns_sign_slots(rns_traces):
    """The reference's fault a: the JAX package's export sends the RNS sign
    slots to its RNS decoder. The port passes them through and exports the
    roots' elements."""
    _, _, _, ttr = rns_traces
    sub = twt.WitnessTrace(_first_rows(ttr, ("rns_sqrt", "rns_fq2_sqrt"), 1))
    ex = twt.export_rows_u32(sub)
    for op in ("rns_sqrt", "rns_fq2_sqrt"):
        x, sgn, s = sub.rows[op][0]
        ux, usgn, us = ex[op][0]
        assert np.array_equal(usgn, sgn.numpy())
        assert ux.dtype == us.dtype == np.uint32 and us.shape[-1] == twt.U32_LIMBS
        vals = [int(v) for v in trfp.decode(s).reshape(-1)]
        got = [sum(int(v) << (32 * j) for j, v in enumerate(row))
               for row in us.reshape(-1, twt.U32_LIMBS)]
        assert got == vals
        if op == "rns_sqrt":
            assert [v & 1 for v in vals] == sgn.reshape(-1).tolist()


# ---------------------------------------------------------------------------
# Trace mechanics
# ---------------------------------------------------------------------------


def test_trace_strict_raises_on_empty():
    with pytest.raises(RuntimeError, match="no rows"):
        twt.trace(lambda x: x + 1, torch.ones(2, 2))
    _, tr = twt.trace(lambda x: x + 1, torch.ones(2, 2), strict=False)
    assert tr.counts() == {}


def test_trace_restores_a_fused_strategy(limb_inputs):
    x12 = t(limb_inputs[3])
    tfp.set_strategy("fused")
    try:
        out, tr = twt.trace(tfq12.inv, x12)
        assert tfp.get_strategy() == "fused"
    finally:
        tfp.set_strategy("auto")
    assert tr.counts()["fq12_inv"] == 1 and tr.counts()["mul"] > 100
    assert not tfp.recording() and not trfp.recording()
    assert np.array_equal(out.numpy(), tfq12.inv(x12).numpy())


@pytest.mark.parametrize("tier", ["limb", "rns"])
def test_fermat_chain_records_every_bit(tier):
    """In witness mode the chain takes the select form: a square and a
    product with the base on every bit after the leading one, both
    recorded, as the JAX package's scan records them."""
    rng = np.random.default_rng(0xFE)
    e = P - 2
    if tier == "limb":
        x = jfp.encode(ints(rng, 2))
        _, ttr = twt.trace(tfp.inv, t(x))
        _, jtr = jax_trace(jfp.inv, x)
        kind = "mul"
    else:
        x = jrfp.encode(ints(rng, 2))
        _, ttr = twt.trace(trfp.inv, t(x))
        _, jtr = jax_trace(jrfp.inv, x)
        kind = "rns_mul"
    assert ttr.counts()[kind] == 2 * (e.bit_length() - 1) == jtr.counts()[kind]
    same_rows(jtr, ttr)


def test_static_op_report_matches_jax(limb_inputs):
    x, x2 = limb_inputs[0], limb_inputs[1]
    fn = lambda m: (lambda a, b: (m[0].inv(a), m[1].inv(b)))  # noqa: E731
    assert tprof.static_op_report(fn((tfp, tfq2)), t(x), t(x2)) == \
        jprof.static_op_report(fn((jfp, jfq2)), x, x2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and CUDA graphs run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_limb_trace_on_card_matches_cpu(cuda, limb_inputs):
    """On the card mont_mul launches its kernel per recorded product and the
    rows are the CPU trace's."""
    work = limb_workload((tfp, tfq2, twt))
    _, ttr = twt.trace(work, *map(t, limb_inputs))
    _, ctr = twt.trace(work, *(t(v).to(cuda) for v in limb_inputs))
    assert ctr.counts() == ttr.counts()
    for op, rows in ttr.rows.items():
        for a, b in zip(rows, ctr.rows[op]):
            assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b)), op
    assert all(v == 0 for v in twt.check_trace(ctr).values())


@pytest.mark.gpu
def test_rns_trace_on_card_eager_and_captured(cuda, rns_inputs):
    """The RNS chains on the pow kernel's recording build (one launch per
    inverse and root: fp.inv, the root, the Fq2 inverse's norm; twice
    captured, warm-up and capture), the rows the CPU trace's."""
    from plonky2_bls12_381_pairing_torch.ops.rns import kernels

    work = rns_workload((trfp, trfq2))
    _, ttr = twt.trace(work, *map(t, rns_inputs[0]))
    args = [t(v).to(cuda) for v in rns_inputs[0]]
    for jit in (False, True):
        kernels.reset_launches()
        _, ctr = twt.trace(work, *args, jit=jit)
        assert kernels.launches["pow_static"] == (6 if jit else 3), jit
        assert ctr.counts() == ttr.counts(), jit
        for op, rows in ttr.rows.items():
            for a, b in zip(rows, ctr.rows[op]):
                assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b)), (op, jit)
        assert all(v == 0 for v in twt.check_trace(ctr).values())
