"""The port's C++ host oracle (plonky2_bls12_381_pairing_torch/native/) on
the CPU: against the port's refmodel (the cases of tests/test_native.py),
integer for integer against the JAX package's native tier on the same
seeded inputs through each of the six C entry points, against the frozen
vectors, and its build: the constants text, the build directory, two
processes building at once.

The JAX package's native tier is held here through its own source, constants
generator and ctypes binding, built by this file into a temporary directory
(its own build() writes into its package, where tests/test_native.py and
tests/test_kat.py build it at the same time in other workers). The two
packages' refmodel classes differ: values are compared as integer tuples.
"""

import json
import random
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from plonky2_bls12_381_pairing_torch import native
from plonky2_bls12_381_pairing_torch.native import gen_constants
from plonky2_bls12_381_pairing_torch.parallel import multihost
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_tpu import native as jnative
from plonky2_bls12_381_pairing_tpu.native import gen_constants as jgen_constants
from plonky2_bls12_381_pairing_tpu.utils import refmodel as jrm

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "plonky2_bls12_381_pairing_torch"
KAT = json.loads((ROOT / "tests" / "vectors" / "pairing_kat.json").read_text())["vectors"]
N = 4


@pytest.fixture(scope="module", autouse=True)
def jax_build(tmp_path_factory):
    """g++ building the JAX package's source and constants in a temporary
    directory, started before the file's first test, so that it runs while
    the port's library builds."""
    d = tmp_path_factory.mktemp("jax_native")
    shutil.copy(Path(jnative.__file__).with_name("bls12_381.cpp"), d)
    (d / "constants.inc").write_text(jgen_constants.main())
    proc = subprocess.Popen(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                             "-o", str(d / "libbls.so"), str(d / "bls12_381.cpp")],
                            stderr=subprocess.PIPE, text=True)
    yield d / "libbls.so", proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_native(jax_build):
    """The JAX package's native binding on that library."""
    so, proc = jax_build
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", jnative.ctypes.CDLL(str(so)))
        yield jnative


@pytest.fixture(scope="module")
def rng0():
    return random.Random(0xC0FFEE)


def g1_ints(ps) -> list:
    return [(p.x, p.y, p.infinity) for p in ps]


def g2_ints(qs) -> list:
    return [(q.x.c0, q.x.c1, q.y.c0, q.y.c1, q.infinity) for q in qs]


def kat_points(v):
    p = rm.G1Affine(int(v["p_x"], 16), int(v["p_y"], 16))
    q = rm.G2Affine(rm.Fq2(int(v["q_x"][0], 16), int(v["q_x"][1], 16)),
                    rm.Fq2(int(v["q_y"][0], 16), int(v["q_y"][1], 16)))
    return p, q


def to_jax(ps, qs):
    """The port's refmodel points as the JAX package's refmodel points."""
    return ([jrm.G1Affine(p.x, p.y, p.infinity) for p in ps],
            [jrm.G2Affine(jrm.Fq2(q.x.c0, q.x.c1), jrm.Fq2(q.y.c0, q.y.c1), q.infinity)
             for q in qs])


# ---------------------------------------------------------------------------
# The cases of tests/test_native.py, against the port's refmodel
# ---------------------------------------------------------------------------


def test_fp_batches(rng0):
    xs = [rng0.randrange(rm.P) for _ in range(16)] + [0, 1, rm.P - 1]
    ys = [rng0.randrange(rm.P) for _ in range(16)] + [rm.P - 1, 0, 1]
    assert native.fp_mul_batch(xs, ys) == [x * y % rm.P for x, y in zip(xs, ys)]
    # Fermat inverse; 0 -> 0
    assert native.fp_inv_batch(xs) == [pow(x, rm.P - 2, rm.P) for x in xs]


def test_scalar_mul_batches(rng0):
    ks = [rng0.randrange(1, rm.R) for _ in range(N)] + [0, 1, rm.R]
    g1s = native.g1_mul_batch(ks)
    g2s = native.g2_mul_batch(ks)
    for k, p, q in zip(ks, g1s, g2s):
        assert p == rm.G1Affine.generator().mul(k)
        assert q == rm.G2Affine.generator().mul(k)
    assert g1s[-1].infinity and g2s[-1].infinity  # r*G = O


def test_pairing_batch_matches_oracle(rng0):
    ks = [rng0.randrange(1, rm.R) for _ in range(N)]
    js = [rng0.randrange(1, rm.R) for _ in range(N)]
    g1s = native.g1_mul_batch(ks)
    g2s = native.g2_mul_batch(js)
    assert native.pairing_batch(g1s, g2s) == [rm.pairing(p, q) for p, q in zip(g1s, g2s)]


def test_pairing_batch_infinity():
    g1, g2 = rm.G1Affine.generator(), rm.G2Affine.generator()
    es = native.pairing_batch([rm.G1Affine.identity(), g1], [g2, rm.G2Affine.identity()])
    assert es == [rm.Fq12.one(), rm.Fq12.one()]


def test_multi_pairing_product(rng0):
    ks = [rng0.randrange(1, rm.R) for _ in range(3)]
    g1s = native.g1_mul_batch(ks)
    g2s = native.g2_mul_batch(ks[::-1])
    acc = rm.Fq12.one()
    for p, q in zip(g1s, g2s):
        acc = acc * rm.pairing(p, q)
    assert native.multi_pairing_product(g1s, g2s) == acc


def test_bilinearity_via_native(rng0):
    """e(aP, bQ) == e(P, Q)^(ab), computed through the native tier alone."""
    a = rng0.randrange(2, 1 << 64)
    b = rng0.randrange(2, 1 << 64)
    (pa,) = native.g1_mul_batch([a])
    (qb,) = native.g2_mul_batch([b])
    (g1,) = native.g1_mul_batch([1])
    (g2,) = native.g2_mul_batch([1])
    lhs, base = native.pairing_batch([pa, g1], [qb, g2])
    assert lhs == base.pow(a * b % rm.R)


# ---------------------------------------------------------------------------
# Integer for integer the JAX package's native tier
# ---------------------------------------------------------------------------


def test_fp_entry_points_equal_jax(jax_native):
    r = random.Random(11)
    xs = [r.randrange(rm.P) for _ in range(13)] + [0, 1, rm.P - 1]
    ys = [r.randrange(rm.P) for _ in range(13)] + [rm.P - 1, 0, 1]
    assert native.fp_mul_batch(xs, ys) == jax_native.fp_mul_batch(xs, ys)
    assert native.fp_inv_batch(xs) == jax_native.fp_inv_batch(xs)


def test_scalar_mul_entry_points_equal_jax(jax_native):
    r = random.Random(12)
    ks = [r.randrange(1 << 256) for _ in range(6)] + [0, 1, rm.R, rm.R + 1]
    assert g1_ints(native.g1_mul_batch(ks)) == g1_ints(jax_native.g1_mul_batch(ks))
    assert g2_ints(native.g2_mul_batch(ks)) == g2_ints(jax_native.g2_mul_batch(ks))
    # and from another base than the generator
    p, q = rm.G1Affine.generator().mul(7), rm.G2Affine.generator().mul(9)
    (jp,), (jq,) = to_jax([p], [q])
    assert (g1_ints(native.g1_mul_batch(ks[:3], p))
            == g1_ints(jax_native.g1_mul_batch(ks[:3], jp)))
    assert (g2_ints(native.g2_mul_batch(ks[:3], q))
            == g2_ints(jax_native.g2_mul_batch(ks[:3], jq)))


def test_pairing_entry_points_equal_jax(jax_native):
    """pairing_batch over 8 pairs, P_2 and Q_5 at infinity, and
    multi_pairing_product of the 8 and of two of them."""
    r = random.Random(13)
    ps = native.g1_mul_batch([r.randrange(1, rm.R) for _ in range(8)])
    qs = native.g2_mul_batch([r.randrange(1, rm.R) for _ in range(8)])
    ps[2], qs[5] = rm.G1Affine.identity(), rm.G2Affine.identity()
    jps, jqs = to_jax(ps, qs)
    got = native.pairing_batch(ps, qs)
    assert [e.coeffs() for e in got] == [e.coeffs() for e in jax_native.pairing_batch(jps, jqs)]
    assert got[2] == got[5] == rm.Fq12.one()
    for sl in (slice(None), slice(3, 5)):
        assert (native.multi_pairing_product(ps[sl], qs[sl]).coeffs()
                == jax_native.multi_pairing_product(jps[sl], jqs[sl]).coeffs())


def test_kat_e_chain():
    """The frozen vectors' e_chain, 9/9."""
    ps, qs = zip(*[kat_points(v) for v in KAT])
    got = native.pairing_batch(list(ps), list(qs))
    assert len(got) == 9
    assert [e.coeffs() for e in got] == [[int(h, 16) for h in v["e_chain"]] for v in KAT]


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def test_gen_constants_is_the_jax_generators_text():
    port, jax_text = gen_constants.main().splitlines(), jgen_constants.main().splitlines()
    assert port[0] != jax_text[0] and port[0].startswith("// GENERATED")
    assert port[1:] == jax_text[1:]
    assert len(port) == 13


def test_build_lands_under_build_native():
    so = native.build()
    assert so.name == "libbls.so" and so.parent.parent == ROOT / "build" / "native"
    assert (so.parent / "constants.inc").read_text() == gen_constants.main()


def package_files() -> set:
    return {p for p in PORT.rglob("*") if "__pycache__" not in p.parts}


_BUILD_INTO = """
import sys
from pathlib import Path
from plonky2_bls12_381_pairing_torch import native
native._BUILD_ROOT = Path(sys.argv[1])
native._FLAGS = ["-O0", *native._FLAGS[1:]]  # the race is in the files, not the compiler
so = native.lib()._name
print(so)
"""


def test_two_processes_build_one_loadable_library(tmp_path):
    """Two processes building into one fresh directory at once each load a
    whole library, the same file, and leave no other file beside it; the
    package directory gains no file. (Built at -O0, which takes a second
    where -O3 takes ten: what races is the writing of the files.)"""
    before = package_files()
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_INTO, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT) for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    (out_dir,) = tmp_path.iterdir()
    assert sorted(p.name for p in out_dir.iterdir()) == ["constants.inc", "libbls.so"]
    assert Path(paths.pop()) == out_dir / "libbls.so"
    assert package_files() == before
    # and the library works in a third process
    check = subprocess.run([sys.executable, "-c", _BUILD_INTO + """
assert native.fp_mul_batch([3], [5]) == [15]
""", str(tmp_path)], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert check.returncode == 0, check.stderr


def test_build_without_gxx_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.lib()
    assert not native.available()
    assert list(tmp_path.iterdir()) == []


def test_packing_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        native.g1_mul_batch([1 << 256])
    with pytest.raises(ValueError, match="does not fit"):
        native.g1_mul_batch([-1])
    with pytest.raises(ValueError, match="G1 points against"):
        native.pairing_batch([rm.G1Affine.generator()], [])


# ---------------------------------------------------------------------------
# multihost.run's points
# ---------------------------------------------------------------------------


def test_multihost_points_are_the_refmodels():
    assert native.available()
    ps, qs = multihost.local_points(1, 3)
    g1, g2 = rm.G1Affine.generator(), rm.G2Affine.generator()
    assert ps == [g1.mul(k) for k in (4, 5, 6)]
    assert qs == [g2.mul(k) for k in (4, 5, 6)]


def test_multihost_points_without_the_oracle(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "g1_mul_batch", None)
    ps, qs = multihost.local_points(0, 2)
    assert ps == [rm.G1Affine.generator().mul(k) for k in (1, 2)]
    assert qs == [rm.G2Affine.generator().mul(k) for k in (1, 2)]
