"""The port's non-arithmetic API against the JAX package's, on the CPU: the
same inputs, made from numpy seeds, through both packages, rows held bit for
bit (tolerance 0); the cases of tests/test_parity_api.py's RNS section and
its limb twins.
  * ops/rns/fp.py: to_limbs (the CRT bridge), sgn0, neg, square, sqrt,
    legendre, is_square, sqrt_with_sgn, div, connect, pow_naf, pow_dynamic,
    at 2 packed rows (4 elements, zeros and non-squares among them);
  * ops/rns/fq2.py, all of it, at 2 packed rows;
  * ops/rns/tower.py connect;
  * the limb tier's fp / fq2 / fq12 sqrt, sgn0, div, connect, pow_static and
    the Fq6 / Fq12 conditional_mul, at 3 elements;
and each result also against the oracle (utils/refmodel.py)."""

import numpy as np
import pytest
import torch

from plonky2_bls12_381_pairing_torch.models import witness as twt
from plonky2_bls12_381_pairing_torch.ops import fp as tlfp
from plonky2_bls12_381_pairing_torch.ops import fq2 as tlfq2
from plonky2_bls12_381_pairing_torch.ops import fq6 as tlfq6
from plonky2_bls12_381_pairing_torch.ops import fq12 as tlfq12
from plonky2_bls12_381_pairing_torch.ops.rns import fp as tfp
from plonky2_bls12_381_pairing_torch.ops.rns import fq2 as tfq2
from plonky2_bls12_381_pairing_torch.ops.rns import tower as ttw
from plonky2_bls12_381_pairing_tpu.models import witness as jwt
from plonky2_bls12_381_pairing_tpu.ops import fp as jlfp
from plonky2_bls12_381_pairing_tpu.ops import fq2 as jlfq2
from plonky2_bls12_381_pairing_tpu.ops import fq6 as jlfq6
from plonky2_bls12_381_pairing_tpu.ops import fq12 as jlfq12
from plonky2_bls12_381_pairing_tpu.ops.rns import fp as jfp
from plonky2_bls12_381_pairing_tpu.ops.rns import fq2 as jfq2
from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm
from torch_jax_witness import jax_trace

torch.set_num_threads(1)

P = rm.P
B = 4  # elements: 2 packed rows


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int32))


def same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out), torch_out.numpy())


def ints(rng: np.random.Generator, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def fq2s(rng: np.random.Generator, n: int) -> list:
    return [rm.Fq2(*ints(rng, 2)) for _ in range(n)]


def enc2(zs) -> np.ndarray:
    arr = np.empty((len(zs), 2), dtype=object)
    for i, z in enumerate(zs):
        arr[i, 0], arr[i, 1] = z.c0, z.c1
    return np.asarray(tfp.encode(arr))


def dec2(rows: torch.Tensor, n: int) -> list:
    v = tfp.decode(rows)
    return [rm.Fq2(int(v[i, 0]), int(v[i, 1])) for i in range(n)]


def pair(zs) -> list:
    """Fq2 values as (c0, c1): the two packages' refmodel classes differ."""
    return [(z.c0, z.c1) for z in zs]


# ---------------------------------------------------------------------------
# RNS Fp
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rfp_in():
    rng = np.random.default_rng(0x5A1)
    xs = ints(rng, B - 1) + [0]
    ys = [0] + ints(rng, B - 1)
    sq = [x * x % P for x in xs]
    return {"xs": xs, "ys": ys, "sq": sq,
            "x": tfp.encode(xs), "y": tfp.encode(ys), "s": tfp.encode(sq),
            "sgn": np.array([[1, 0], [0, 1]], dtype=np.int32)}


RFP_CASES = {
    "to_limbs": lambda m, d: m.to_limbs(d["x"]),
    "sgn0": lambda m, d: m.sgn0(d["x"]),
    "neg": lambda m, d: m.neg(d["x"]),
    "square": lambda m, d: m.square(d["x"]),
    "div": lambda m, d: m.div(d["x"], d["y"]),
    "connect": lambda m, d: m.connect(d["x"], d["y"]),
    "legendre": lambda m, d: m.legendre(d["x"]),
    "is_square": lambda m, d: m.is_square(d["x"]),
    "sqrt": lambda m, d: m.sqrt(d["s"]),
    "sqrt_with_sgn": lambda m, d: m.sqrt_with_sgn(d["s"], d["sgn"]),
    "pow_naf": lambda m, d: m.pow_naf(d["x"], 0xD201000000010001),
    "pow_dynamic": lambda m, d: m.pow_dynamic(d["x"], d["bits"]),
}


def _rfp_oracle(name: str, d: dict, out: torch.Tensor) -> None:
    xs, ys, sq = d["xs"], d["ys"], d["sq"]
    if name == "to_limbs":
        got = [sum(int(v) << (8 * j) for j, v in enumerate(row))
               for row in out.reshape(-1, 48).tolist()]
        assert got == xs
    elif name == "sgn0":
        assert out.reshape(-1).tolist() == [x & 1 for x in xs]
    elif name in ("neg", "square", "div", "pow_naf", "pow_dynamic"):
        want = {"neg": [(-x) % P for x in xs], "square": sq,
                "div": [x * rm.fp_inv(y) % P for x, y in zip(xs, ys)],
                "pow_naf": [pow(x, 0xD201000000010001, P) for x in xs],
                "pow_dynamic": [pow(x, 0x1D3, P) for x in xs]}[name]
        assert list(tfp.decode(out))[:B] == want
    elif name == "connect":
        assert out.reshape(-1).tolist() == [x == y for x, y in zip(xs, ys)]
    elif name == "legendre":
        leg = [int(v) for v in tfp.decode(out)][:B]
        assert leg == [pow(x, (P - 1) // 2, P) for x in xs]
    elif name == "is_square":
        assert out.reshape(-1).tolist() == [pow(x, (P - 1) // 2, P) != P - 1 for x in xs]
    elif name == "sqrt":
        assert [r * r % P for r in tfp.decode(out)[:B]] == sq
    elif name == "sqrt_with_sgn":
        roots = [int(v) for v in tfp.decode(out)][:B]
        assert [r * r % P for r in roots] == sq
        # a zero root has sign 0 whatever was asked
        assert [r & 1 for r in roots] == [g if r else 0 for r, g in
                                          zip(roots, d["sgn"].reshape(-1).tolist())]


@pytest.mark.parametrize("name", list(RFP_CASES))
def test_rns_fp_api_matches_jax(rfp_in, name):
    d = dict(rfp_in, bits=np.array([int(b) for b in bin(0x1D3)[2:]], dtype=np.int32))
    jd = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    td = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    jout = RFP_CASES[name](jfp, jd)
    tout = RFP_CASES[name](tfp, td)
    assert same(jout, tout), name
    _rfp_oracle(name, d, tout)


# ---------------------------------------------------------------------------
# RNS Fq2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rfq2_in():
    rng = np.random.default_rng(0x5A2)
    a = fq2s(rng, B)
    b = [rm.Fq2.zero()] + fq2s(rng, B - 1)
    specials = [rm.Fq2(0, 3), rm.Fq2(0, 4), rm.Fq2(2, 1), rm.Fq2(5, 0)]
    sq = [z.square() for z in a]
    return {"a": a, "b": b, "sq": sq, "specials": specials,
            "A": enc2(a), "B": enc2(b), "S": enc2(sq), "SP": enc2(specials),
            "N": enc2([z * rm.XI for z in sq]),  # xi is not a square in Fq2
            "sgn": np.array([[0, 1], [1, 0]], dtype=np.int32),
            "mask": tfp.pack_mask(np.array([1, 0, 0, 1]))}


RFQ2_CASES = {
    "zero": lambda m, d: m.zero((2,), **d["dev"]),
    "one": lambda m, d: m.one((2,), **d["dev"]),
    "add": lambda m, d: m.add(d["A"], d["B"]),
    "sub": lambda m, d: m.sub(d["A"], d["B"]),
    "neg": lambda m, d: m.neg(d["A"]),
    "conjugate": lambda m, d: m.conjugate(d["A"]),
    "neg_conjugate": lambda m, d: m.neg_conjugate(d["A"]),
    "mul_by_nonresidue": lambda m, d: m.mul_by_nonresidue(d["A"]),
    "mul": lambda m, d: m.mul(d["A"], d["B"]),
    "square": lambda m, d: m.square(d["A"]),
    "inv": lambda m, d: m.inv(d["B"]),
    "div": lambda m, d: m.div(d["A"], d["B"]),
    "connect": lambda m, d: m.connect(d["A"], d["A"]),
    "select": lambda m, d: m.select(d["mask"], d["A"], d["B"]),
    "is_zero": lambda m, d: m.is_zero(d["B"]),
    "is_equal": lambda m, d: m.is_equal(d["A"], d["A"]),
    "sgn0": lambda m, d: m.sgn0(d["SP"]),
    "is_square": lambda m, d: m.is_square(d["S"]),
    "is_square_not": lambda m, d: m.is_square(d["N"]),
    "pow_static": lambda m, d: m.pow_static(d["A"], 0x1D3),
    "sqrt": lambda m, d: m.sqrt(d["S"]),
    "sqrt_with_sgn": lambda m, d: m.sqrt_with_sgn(d["S"], d["sgn"]),
}


def _rfq2_oracle(name: str, d: dict, out: torch.Tensor) -> None:
    a, b, sq = d["a"], d["b"], d["sq"]
    vals = {"add": [x + y for x, y in zip(a, b)], "sub": [x - y for x, y in zip(a, b)],
            "neg": [-x for x in a],
            "conjugate": [rm.Fq2(x.c0, (-x.c1) % P) for x in a],
            "neg_conjugate": [rm.Fq2((-x.c0) % P, x.c1) for x in a],
            "mul_by_nonresidue": [x.mul_by_nonresidue() for x in a],
            "mul": [x * y for x, y in zip(a, b)], "square": [x.square() for x in a],
            "inv": [y.inv() for y in b], "div": [x * y.inv() for x, y in zip(a, b)],
            "select": [a[0], b[1], b[2], a[3]],
            "pow_static": [x.pow(0x1D3) for x in a]}
    if name in vals:
        assert dec2(out, B) == vals[name]
    elif name in ("connect", "is_equal", "is_square"):
        assert out.all()
    elif name == "is_square_not":
        assert not out.any()
    elif name == "is_zero":
        assert out.reshape(-1).tolist() == [True, False, False, False]
    elif name == "sgn0":
        assert out.reshape(-1).tolist() == [rm.sgn0_fq2(z) for z in d["specials"]]
    elif name in ("sqrt", "sqrt_with_sgn"):
        roots = dec2(out, B)
        assert [r.square() for r in roots] == sq
        if name == "sqrt_with_sgn":
            assert [rm.sgn0_fq2(r) for r in roots] == d["sgn"].reshape(-1).tolist()


@pytest.mark.parametrize("name", list(RFQ2_CASES))
def test_rns_fq2_matches_jax(rfq2_in, name):
    jd = dict(rfq2_in, dev={})
    td = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in rfq2_in.items()}
    td["dev"] = {"device": "cpu"}
    jout = RFQ2_CASES[name](jfq2, jd)
    tout = RFQ2_CASES[name](tfq2, td)
    assert same(jout, tout), name
    _rfq2_oracle(name, rfq2_in, tout)


def test_rns_fq2_inv_and_sqrt_record_their_kinds(rfq2_in):
    """inv and sqrt_with_sgn record rns_fq2_inv / rns_fq2_sqrt rows (with the
    Fp inverse's own rows), as the JAX package's do, and they check clean."""
    A, S, sgn = (t(rfq2_in[k]) for k in ("A", "S", "sgn"))
    _, tr = twt.trace(lambda x, s, g: (tfq2.inv(x), tfq2.sqrt_with_sgn(s, g)), A, S, sgn)
    counts = tr.counts()
    assert counts["rns_fq2_inv"] == 1 and counts["rns_fq2_sqrt"] == 1
    assert counts["rns_inv"] == 1
    assert twt.check_trace(tr) == {k: 0 for k in counts}


def test_rns_tower_connect_matches_jax():
    rng = np.random.default_rng(0x5A3)
    xs = [rm.Fq12.from_coeffs(ints(rng, 12)) for _ in range(3)]
    a = ttw.encode(xs[:2])
    b = ttw.encode([xs[0], xs[2]])
    jout = jtw.connect(a, b)
    tout, tr = twt.trace(ttw.connect, t(a), t(b))
    assert same(jout, tout) and tout.reshape(-1).tolist() == [True, False]
    assert tr.counts() == {"rns_connect": 1}
    assert twt.check_trace(tr) == {"rns_connect": 12}  # the 12 components of element 1


# ---------------------------------------------------------------------------
# The limb tier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def limb_in():
    rng = np.random.default_rng(0x5A4)
    n = 3
    xs = ints(rng, n - 1) + [0]
    x2 = fq2s(rng, n)
    x12 = [rm.Fq12.from_coeffs(ints(rng, 12)) for _ in range(n)]
    y12 = [rm.Fq12.from_coeffs(ints(rng, 12)) for _ in range(n)]
    return {"xs": xs, "x2": x2, "x12": x12, "y12": y12,
            "X": tlfp.encode(xs), "Y": tlfp.encode(list(reversed(xs))),
            "S": tlfp.encode([x * x % P for x in xs]),
            "X2": tlfq2.encode(x2), "S2": tlfq2.encode([z.square() for z in x2]),
            "X12": tlfq12.encode(x12), "Y12": tlfq12.encode(y12),
            "sgn": np.array([1, 0, 1], dtype=np.int32),
            "flag": np.array([1, 0, 1], dtype=np.int32)}


LIMB_CASES = {
    "fp_sqrt": lambda m, d: m["fp"].sqrt(d["S"]),
    "fp_sgn0": lambda m, d: m["fp"].sgn0(d["X"]),
    "fp_div": lambda m, d: m["fp"].div(d["X"], d["Y"]),
    "fp_connect": lambda m, d: m["fp"].connect(d["X"], d["Y"]),
    "fp_pow_static": lambda m, d: m["fp"].pow_static(d["X"], 0x1D3),
    "fp_legendre": lambda m, d: m["fp"].legendre(d["X"]),
    "fp_is_square": lambda m, d: m["fp"].is_square(d["X"]),
    "fp_sqrt_with_sgn": lambda m, d: m["fp"].sqrt_with_sgn(d["S"], d["sgn"]),
    "fp_pow_naf": lambda m, d: m["fp"].pow_naf(d["X"], 0xD201000000010001),
    "fp_pow_dynamic": lambda m, d: m["fp"].pow_dynamic(d["X"], d["ebits"]),
    "fq2_sqrt": lambda m, d: m["fq2"].sqrt(d["S2"]),
    "fq2_sgn0": lambda m, d: m["fq2"].sgn0(d["X2"]),
    "fq2_div": lambda m, d: m["fq2"].div(d["X2"], d["S2"]),
    "fq2_connect": lambda m, d: m["fq2"].connect(d["X2"], d["X2"]),
    "fq2_pow_static": lambda m, d: m["fq2"].pow_static(d["X2"], 0x1D3),
    "fq2_is_square": lambda m, d: m["fq2"].is_square(d["S2"]),
    "fq2_sqrt_with_sgn": lambda m, d: m["fq2"].sqrt_with_sgn(d["S2"], d["sgn"]),
    "fq12_div": lambda m, d: m["fq12"].div(d["X12"], d["Y12"]),
    "fq12_connect": lambda m, d: m["fq12"].connect(d["X12"], d["Y12"]),
    "fq12_pow_static": lambda m, d: m["fq12"].pow_static(d["X12"], 0x1D3),
    "fq12_conditional_mul": lambda m, d: m["fq12"].conditional_mul(d["X12"], d["Y12"],
                                                                   d["flag"]),
    "fq6_conditional_mul": lambda m, d: m["fq6"].conditional_mul(
        d["X12"][..., :6, :], d["Y12"][..., 6:, :], d["flag"]),
}


def _limb_oracle(name: str, d: dict, out: torch.Tensor) -> None:
    xs, x2, x12, y12 = d["xs"], d["x2"], d["x12"], d["y12"]
    if name in ("fp_sqrt", "fp_sqrt_with_sgn"):
        roots = list(tlfp.decode(out))
        assert [r * r % P for r in roots] == [x * x % P for x in xs]
        if name == "fp_sqrt_with_sgn":
            assert [r & 1 for r in roots] == [g if r else 0 for r, g in
                                              zip(roots, d["sgn"].tolist())]
    elif name == "fp_sgn0":
        assert out.tolist() == [x & 1 for x in xs]
    elif name == "fp_div":
        assert list(tlfp.decode(out)) == [x * rm.fp_inv(y) % P
                                          for x, y in zip(xs, reversed(xs))]
    elif name == "fp_connect":
        assert out.tolist() == [False, True, False]
    elif name == "fq12_connect":
        assert not out.any()
    elif name == "fp_pow_static":
        assert list(tlfp.decode(out)) == [pow(x, 0x1D3, P) for x in xs]
    elif name == "fp_pow_naf":
        assert list(tlfp.decode(out)) == [pow(x, 0xD201000000010001, P) for x in xs]
    elif name == "fp_pow_dynamic":
        assert list(tlfp.decode(out)) == [pow(x, e, P) for x, e in zip(xs, (5, 0x1D3, 7))]
    elif name == "fp_legendre":
        assert list(tlfp.decode(out)) == [pow(x, (P - 1) // 2, P) for x in xs]
    elif name == "fp_is_square":
        assert out.tolist() == [pow(x, (P - 1) // 2, P) != P - 1 for x in xs]
    elif name in ("fq2_sqrt", "fq2_sqrt_with_sgn"):
        roots = [rm.Fq2(z.c0, z.c1) for z in tlfq2.decode(out)]
        assert pair(r.square() for r in roots) == pair(z.square() for z in x2)
        if name == "fq2_sqrt_with_sgn":
            assert [rm.sgn0_fq2(r) for r in roots] == d["sgn"].tolist()
    elif name == "fq2_sgn0":
        assert out.tolist() == [rm.sgn0_fq2(z) for z in x2]
    elif name == "fq2_div":
        assert pair(tlfq2.decode(out)) == pair(z * z.square().inv() for z in x2)
    elif name in ("fq2_connect", "fq2_is_square"):
        assert out.all()
    elif name == "fq2_pow_static":
        assert pair(tlfq2.decode(out)) == pair(z.pow(0x1D3) for z in x2)
    elif name == "fq12_div":
        assert [v.coeffs() for v in tlfq12.decode(out)] == [
            (x * y.inv()).coeffs() for x, y in zip(x12, y12)]
    elif name == "fq12_pow_static":
        assert [v.coeffs() for v in tlfq12.decode(out)] == [
            x.pow(0x1D3).coeffs() for x in x12]
    elif name == "fq12_conditional_mul":
        assert [v.coeffs() for v in tlfq12.decode(out)] == [
            (x12[0] * y12[0]).coeffs(), x12[1].coeffs(), (x12[2] * y12[2]).coeffs()]


@pytest.mark.parametrize("name", list(LIMB_CASES))
def test_limb_api_matches_jax(limb_in, name):
    d = dict(limb_in, ebits=tlfp.bits_of([5, 0x1D3, 7], nbits=9))
    jm = {"fp": jlfp, "fq2": jlfq2, "fq6": jlfq6, "fq12": jlfq12}
    tm = {"fp": tlfp, "fq2": tlfq2, "fq6": tlfq6, "fq12": tlfq12}
    jd = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    td = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    jout = LIMB_CASES[name](jm, jd)
    tout = LIMB_CASES[name](tm, td)
    assert same(jout, tout), name
    _limb_oracle(name, d, tout)


def test_limb_connect_rows_check(limb_in):
    """connect records one row per call at any tower level, and the checker
    counts the unequal elements, as the JAX package's does."""
    X, Y, X2 = (t(limb_in[k]) for k in ("X", "Y", "X2"))
    _, tr = twt.trace(lambda a, b, c: (tlfp.connect(a, b), tlfq2.connect(c, c)), X, Y, X2)
    assert tr.counts() == {"connect": 2}
    _, jtr = jax_trace(lambda a, b, c: (jlfp.connect(a, b), jlfq2.connect(c, c)),
                       *(limb_in[k] for k in ("X", "Y", "X2")))
    assert twt.check_trace(tr) == jwt.check_trace(jtr) == {"connect": 2}
