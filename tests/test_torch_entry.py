"""The port's entry path against the JAX package's, on the CPU at one or two
packed rows, the inputs made from numpy seeds and handed to both packages:
  * PairingConfig: the same fields, defaults and environment variables as
    the JAX package's; apply() refuses the same configurations (the JAX
    package asserts, the port raises ValueError) and sets the limb tier's
    strategy;
  * entry(device="cpu"): the JAX entry's example points, row for row, and
    its pairing: under impl="karabina" row for row with the JAX entry's
    jitted pairing (whose CPU path runs the Karabina exponentiation), under
    the default form equal in value;
  * count_fp_ops of tower ops equal to the JAX package's; op_counts() equal
    to the JAX package's less exactly one cyclotomic square per pairing (the
    JAX package counts t1pre's square twice);
  * the RNS point and tower extras (generator, identity, is_point_equal_to,
    conditional_select; G2Projective.identity and generator; tower.zero,
    div, conditional_mul) as tests/test_parity_api.py holds the JAX
    package's, and row for row against them.
Every comparison is exact (tolerance 0)."""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from plonky2_bls12_381_pairing_torch import config as tconfig
from plonky2_bls12_381_pairing_torch import interop
from plonky2_bls12_381_pairing_torch.entry import entry
from plonky2_bls12_381_pairing_torch.models import pairing_rns as tmpr
from plonky2_bls12_381_pairing_torch.ops import fp as tlfp
from plonky2_bls12_381_pairing_torch.ops.rns import fp as tfp
from plonky2_bls12_381_pairing_torch.ops.rns import lines as tl
from plonky2_bls12_381_pairing_torch.ops.rns import tower as ttw
from plonky2_bls12_381_pairing_tpu import config as jconfig
from plonky2_bls12_381_pairing_tpu.models import pairing_rns as jmpr
from plonky2_bls12_381_pairing_tpu.ops.rns import fp as jfp
from plonky2_bls12_381_pairing_tpu.ops.rns import lines as jl
from plonky2_bls12_381_pairing_tpu.ops.rns import tower as jtw
from plonky2_bls12_381_pairing_tpu.utils import refmodel as rm

torch.set_num_threads(1)

a = np.asarray
P = rm.P


def t(x) -> torch.Tensor:
    """A JAX array's rows as a CPU tensor."""
    return torch.from_numpy(np.array(x, dtype=np.int32))


def rand_fq12(rng: np.random.Generator) -> rm.Fq12:
    return rm.Fq12.from_coeffs([int.from_bytes(rng.bytes(48), "little") % P
                                for _ in range(12)])


def coeffs(xs):
    return [x.coeffs() for x in xs]


# ---------------------------------------------------------------------------
# PairingConfig
# ---------------------------------------------------------------------------


def test_config_fields_and_defaults_match_jax():
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.PairingConfig)]
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.PairingConfig)]
    assert tf == jf
    assert dataclasses.asdict(tconfig.DEFAULT) == dataclasses.asdict(jconfig.DEFAULT)


def test_config_from_env_matches_jax(monkeypatch):
    env = {"BENCH_BATCH": "512", "PAIRING_STRATEGY": "fused", "PAIRING_DP": "4",
           "BENCH_REPS": "7", "PAIRING_CKPT_EVERY": "17"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(tconfig.PairingConfig.from_env())
    assert got == dataclasses.asdict(jconfig.PairingConfig.from_env())
    assert got["batch_per_chip"] == 512 and got["checkpoint_every_steps"] == 17


@pytest.mark.parametrize("bad", [{"limb_bits": 7}, {"nlimbs": 47}, {"mont_limbs": 50},
                                 {"batch_per_chip": 0}, {"dp": 0}, {"bench_reps": 0}])
def test_config_apply_refuses_what_jax_refuses(bad):
    with pytest.raises(AssertionError):
        jconfig.PairingConfig(**bad).apply()
    with pytest.raises(ValueError):
        tconfig.PairingConfig(**bad).apply()


@pytest.mark.parametrize("strategy,limb", [("rns", "auto"), ("fused", "fused"),
                                           ("auto", "auto")])
def test_config_apply_sets_the_limb_strategy(strategy, limb):
    try:
        cfg = tconfig.PairingConfig(strategy=strategy)
        assert cfg.apply() is cfg
        assert tlfp.get_strategy() == limb
    finally:
        tlfp.set_strategy("auto")
    with pytest.raises(ValueError):
        tconfig.PairingConfig(strategy="pallas").apply()  # the JAX package's own
    assert tlfp.get_strategy() == "auto"


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry's function, points and jitted pairing rows (its
    compilation-cache set-up skipped: the test session keeps its own)."""
    setup, jentry._setup_cache = jentry._setup_cache, lambda: None
    try:
        fn, (p, q) = jentry.entry()
    finally:
        jentry._setup_cache = setup
    return fn, (p, q), np.asarray(jax.jit(fn)(p, q))


def test_entry_points_match_jax(jax_entry):
    fn, (p, q) = entry(device="cpu")
    _, (jp, jq), _ = jax_entry
    assert fn is tmpr.pairing
    for got, want in ((p.x, jp.x), (p.y, jp.y), (p.infinity, jp.infinity),
                      (q.x, jq.x), (q.y, jq.y), (q.infinity, jq.infinity)):
        assert got.device.type == "cpu" and got.is_contiguous()
        assert np.array_equal(interop.to_numpy(got), a(want))


def test_entry_pairing_matches_jax(jax_entry):
    fn, (p, q) = entry(device="cpu")
    want = jax_entry[2]
    assert np.array_equal(interop.to_numpy(fn(p, q, impl="karabina")), want)
    got = ttw.decode(fn(p, q))
    assert coeffs(got) == coeffs(jtw.decode(want))
    g = rm.pairing(rm.G1Affine.generator(), rm.G2Affine.generator()).coeffs()
    assert coeffs(got) == [g] * 4


def test_entry_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


# ---------------------------------------------------------------------------
# Op counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["mul", "square", "cyclotomic_square", "frobenius_map"])
def test_count_fp_ops_matches_jax(op):
    rng = np.random.default_rng(12)
    x = tfp.encode(np.array([int.from_bytes(rng.bytes(48), "little") % P
                             for _ in range(24)], dtype=object).reshape(2, 12))
    args = (x, x) if op == "mul" else (x,)
    got = tfp.count_fp_ops(getattr(ttw, op), *map(torch.from_numpy, args))
    want = jfp.count_fp_ops(getattr(jtw, op), *args)
    assert got == want and got["redc"] > 0


def test_count_fp_ops_runs_the_plain_formulas_on_the_cpu():
    """A counted call runs the dispatching op's plain formulas, on the CPU;
    the counter is off after it."""
    f = ttw.one((1,), "cpu")
    calls = []
    orig = ttw.mul_plain
    try:
        ttw.mul_plain = lambda x, y: calls.append(x.device.type) or orig(x, y)
        assert tfp.count_fp_ops(ttw.mul, f, f) == {"fp_mul": 108, "redc": 24}
    finally:
        ttw.mul_plain = orig
    assert calls == ["cpu"] and tfp._op_counter is None
    ttw.mul(f, f)
    assert tfp._op_counter is None


def test_op_counts_one_cyclotomic_square_less_than_jax():
    got, want = tmpr.op_counts(), jmpr.op_counts()
    f = jtw.one((1,))
    cycsq = {k: v / 2 for k, v in jfp.count_fp_ops(jtw.cyclotomic_square, f).items()}
    assert set(got) == set(want) == {"fp_mul", "redc"}
    assert {k: want[k] - cycsq[k] for k in want} == got
    assert tmpr.op_counts(batch=128) != got  # the batch spreads the root power


# ---------------------------------------------------------------------------
# Point and tower extras
# ---------------------------------------------------------------------------


def test_tower_div_and_conditional_mul_match_jax():
    rng = np.random.default_rng(21)
    x, y = rand_fq12(rng), rand_fq12(rng)
    A, Bv = jtw.encode([x, y]), jtw.encode([y, x])
    got = ttw.div(t(A), t(Bv))
    want = np.asarray(jax.jit(jtw.div)(A, Bv))
    assert np.array_equal(interop.to_numpy(got), want)
    assert coeffs(ttw.decode(got))[:2] == coeffs([x * y.inv(), y * x.inv()])
    mask = jfp.pack_mask(np.array([0, 1]))
    got = ttw.conditional_mul(t(A), t(Bv), t(mask))
    want = np.asarray(jax.jit(jtw.conditional_mul)(A, Bv, mask))
    assert np.array_equal(interop.to_numpy(got), want)
    assert coeffs(ttw.decode(got))[:2] == coeffs([x, y * x])
    # b = 0 divides to 0 (the inverse's inv0 convention)
    zero = ttw.zero((1,), "cpu")
    assert np.array_equal(interop.to_numpy(zero), np.asarray(jtw.zero((1,))))
    got = ttw.div(t(A), zero)
    assert np.array_equal(interop.to_numpy(got), np.asarray(jax.jit(jtw.div)(A, jtw.zero((1,)))))
    assert coeffs(ttw.decode(got))[:2] == [[0] * 12] * 2


def test_point_constructors_match_jax():
    for shape in ((), (4,), (3,), (2, 3)):
        pairs = [(tl.G1Affine.generator(shape, "cpu"), jl.G1Affine.generator(shape)),
                 (tl.G2Affine.generator(shape, "cpu"), jl.G2Affine.generator(shape)),
                 (tl.G1Affine.identity(shape, "cpu"), jl.G1Affine.identity(shape)),
                 (tl.G2Affine.identity(shape, "cpu"), jl.G2Affine.identity(shape)),
                 (tl.G2Projective.identity(shape, "cpu"), jl.G2Projective.identity(shape)),
                 (tl.G2Projective.generator(shape, "cpu"), jl.G2Projective.generator(shape))]
        for got, want in pairs:
            for f in dataclasses.fields(got):
                g, w = getattr(got, f.name), getattr(want, f.name)
                assert g.is_contiguous() and np.array_equal(interop.to_numpy(g), a(w)), (
                    shape, type(got).__name__, f.name)


def test_rns_curve_identity_equality():
    """tests/test_parity_api.py's test_rns_curve_identity_equality on the
    port's points, and its predicates against the JAX package's."""
    ks = [1, 2, 3, 2]
    g1s = [rm.G1Affine.generator().mul(k) for k in ks]
    g2s = [rm.G2Affine.generator().mul(k) for k in ks]
    P1 = tl.G1Affine.encode(g1s, device="cpu")
    P2 = tl.G1Affine.encode([g1s[0], g1s[1], g1s[3], g1s[3]], device="cpu")
    eq = P1.is_point_equal_to(P2)
    assert eq.reshape(-1)[:4].tolist() == [True, True, False, True]
    jP1 = jl.G1Affine.encode(g1s)
    jP2 = jl.G1Affine.encode([g1s[0], g1s[1], g1s[3], g1s[3]])
    assert np.array_equal(eq.numpy(), a(jP1.is_point_equal_to(jP2)))
    Q1 = tl.G2Affine.encode(g2s, device="cpu")
    Q2 = tl.G2Affine.encode([g2s[0], g2s[1], g2s[3], g2s[3]], device="cpu")
    eq = Q1.is_point_equal_to(Q2)
    assert eq.reshape(-1)[:4].tolist() == [True, True, False, True]
    jQ1 = jl.G2Affine.encode(g2s)
    jQ2 = jl.G2Affine.encode([g2s[0], g2s[1], g2s[3], g2s[3]])
    assert np.array_equal(eq.numpy(), a(jQ1.is_point_equal_to(jQ2)))
    # identity: infinity mask everywhere, equal to itself, not to a point
    i1 = tl.G1Affine.identity((4,), "cpu")
    assert bool(i1.is_point_equal_to(tl.G1Affine.identity((4,), "cpu")).all())
    assert not bool(i1.is_point_equal_to(P1).any())
    i2 = tl.G2Affine.identity((4,), "cpu")
    assert bool(i2.is_point_equal_to(tl.G2Affine.identity((4,), "cpu")).all())
    assert not bool(i2.is_point_equal_to(Q1).any())
    # conditional_select on G1
    msel = torch.from_numpy(tfp.pack_mask(np.array([1, 0, 1, 0])))
    sel = P1.conditional_select(msel, tl.G1Affine.identity((4,), "cpu"))
    assert sel.is_point_equal_to(P1).reshape(-1)[:4].tolist() == [True, False, True, False]
    jsel = jP1.conditional_select(a(msel), jl.G1Affine.identity((4,)))
    for f in ("x", "y", "infinity"):
        assert np.array_equal(getattr(sel, f).numpy(), a(getattr(jsel, f)))


def test_generator_pairs_to_the_oracle():
    """G1Affine.generator and G2Affine.generator through the port's pairing
    at an odd batch (the padded slot duplicates the last element)."""
    p, q = tl.G1Affine.generator((3,), "cpu"), tl.G2Affine.generator((3,), "cpu")
    got = coeffs(ttw.decode(tmpr.pairing(p, q)))[:3]
    g = rm.pairing(rm.G1Affine.generator(), rm.G2Affine.generator()).coeffs()
    assert got == [g] * 3


def test_new_modules_are_walked_and_import_no_jax():
    """The entry path's modules are in the package tree that
    test_torch_kernels.py's import walk covers, and import no JAX."""
    port = Path(tconfig.__file__).resolve().parent
    for rel in ("config.py", "entry.py", "utils/capture.py", "utils/profiling.py"):
        path = port / rel
        assert path in set(port.rglob("*.py")), rel
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] not in ("jax", "plonky2_bls12_381_pairing_tpu")
            elif isinstance(node, ast.Import):
                assert all(n.name.split(".")[0] != "jax" for n in node.names)
