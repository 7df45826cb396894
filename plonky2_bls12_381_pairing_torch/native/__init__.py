"""ctypes binding of the port's C++ host oracle (bls12_381.cpp).

The library is built with g++ at first use into build/native/<hash>/ at the
repository root, beside the constants.inc that gen_constants.py generates for
it; nothing is written into the package. The hash covers the C++ source, the
generated constants and the compiler flags. Each file is written under a name
of its own process and then moved into place, so that processes building at
the same moment (test workers, spawned ranks) each load a whole library.

`lib()` builds and loads it, and raises where it cannot (no g++, a failed
build): a caller that must have the oracle calls `lib()`. `available()` says
whether a caller may use it; a caller that can do without it (its points
are the refmodel's either way) asks that first.

All array interfaces take standard-form little-endian 6 x u64 limbs per Fp;
the functions below take and return the port's refmodel values.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..utils import refmodel as rm
from . import gen_constants

_SOURCE = Path(__file__).resolve().parent / "bls12_381.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_PTR, _LONG = ctypes.c_void_p, ctypes.c_long
#: C entry point -> argument types (every one returns int, 0 on success)
_SIGNATURES = {
    "pairing_batch": [_PTR] * 5 + [_LONG],
    "multi_pairing_product": [_PTR] * 5 + [_LONG],
    "g1_mul_batch": [_PTR] * 4 + [_LONG],
    "g2_mul_batch": [_PTR] * 4 + [_LONG],
    "fp_mul_batch": [_PTR] * 3 + [_LONG],
    "fp_inv_batch": [_PTR] * 2 + [_LONG],
}
_LIB = None


def _write(path: Path, data: bytes) -> None:
    """Write `data` to `path` through a name of this process's own."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def build() -> Path:
    """Build the library unless its build directory already holds it; its
    path."""
    constants = gen_constants.main().encode()
    h = hashlib.sha256()
    for part in (_SOURCE.read_bytes(), constants, " ".join(_FLAGS).encode()):
        h.update(hashlib.sha256(part).digest())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libbls.so"
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host oracle (native/bls12_381.cpp) "
                           "is built with g++")
    out_dir.mkdir(parents=True, exist_ok=True)
    inc = out_dir / "constants.inc"
    if not inc.exists() or inc.read_bytes() != constants:
        _write(inc, constants)
    tmp = out_dir / f"libbls.so.{os.getpid()}"
    proc = subprocess.run([gxx, *_FLAGS, "-I", str(out_dir), "-o", str(tmp), str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {_SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises where it cannot be."""
    global _LIB
    if _LIB is None:
        loaded = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = loaded
    return _LIB


def available() -> bool:
    """Whether the library can be built and loaded here."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


# ---------------------------------------------------------------------------
# Packing (standard form, little-endian u64 x 6 per Fp, u64 x 4 per scalar)
# ---------------------------------------------------------------------------


def _ints_to_u64(rows: list, words: int = 6) -> np.ndarray:
    """(len(rows), len(rows[0]), words) u64 limbs of the ints in `rows`."""
    nbytes = 8 * words
    for row in rows:
        for x in row:
            if not 0 <= x < 1 << (8 * nbytes):
                raise ValueError(f"{x:#x} does not fit {words} u64 limbs")
    data = b"".join(x.to_bytes(nbytes, "little") for row in rows for x in row)
    width = len(rows[0]) if rows else 0
    return np.frombuffer(data, dtype="<u8").reshape(len(rows), width, words).copy()


def _u64_to_ints(arr: np.ndarray) -> list[int]:
    data = np.ascontiguousarray(arr, dtype="<u8").tobytes()
    return [int.from_bytes(data[i:i + 48], "little") for i in range(0, len(data), 48)]


def _g1_u64(ps: list) -> tuple[np.ndarray, np.ndarray]:
    return (_ints_to_u64([[p.x, p.y] for p in ps]),
            np.array([p.infinity for p in ps], dtype=np.uint8))


def _g2_u64(qs: list) -> tuple[np.ndarray, np.ndarray]:
    return (_ints_to_u64([[q.x.c0, q.x.c1, q.y.c0, q.y.c1] for q in qs]),
            np.array([q.infinity for q in qs], dtype=np.uint8))


def _call(name: str, *arrays: np.ndarray, n: int) -> None:
    rc = getattr(lib(), name)(*(a.ctypes.data for a in arrays), n)
    if rc != 0:
        raise RuntimeError(f"native {name} returned {rc}")


# ---------------------------------------------------------------------------
# The API (mirrors utils/refmodel.py, returning its types)
# ---------------------------------------------------------------------------


def pairing_batch(ps: list, qs: list) -> list:
    """[e(P_i, Q_i)] as refmodel.Fq12 values (one where an input is at
    infinity)."""
    if len(ps) != len(qs):
        raise ValueError(f"{len(ps)} G1 points against {len(qs)} G2 points")
    n = len(ps)
    (g1, g1i), (g2, g2i) = _g1_u64(ps), _g2_u64(qs)
    out = np.zeros((n, 12, 6), dtype=np.uint64)
    _call("pairing_batch", g1, g1i, g2, g2i, out, n=n)
    ints = _u64_to_ints(out)
    return [rm.Fq12.from_coeffs(ints[12 * i:12 * (i + 1)]) for i in range(n)]


def multi_pairing_product(ps: list, qs: list) -> rm.Fq12:
    """prod_i e(P_i, Q_i): one fused Miller loop and one final
    exponentiation."""
    if len(ps) != len(qs):
        raise ValueError(f"{len(ps)} G1 points against {len(qs)} G2 points")
    (g1, g1i), (g2, g2i) = _g1_u64(ps), _g2_u64(qs)
    out = np.zeros((12, 6), dtype=np.uint64)
    _call("multi_pairing_product", g1, g1i, g2, g2i, out, n=len(ps))
    return rm.Fq12.from_coeffs(_u64_to_ints(out))


def _scalars_to_u64(ks) -> np.ndarray:
    return _ints_to_u64([[k] for k in ks], words=4).reshape(-1, 4)


def g1_mul_batch(ks, base: rm.G1Affine | None = None) -> list:
    """[k_i * base] as refmodel.G1Affine (base: the generator), 0 <= k_i <
    2^256."""
    base = rm.G1Affine.generator() if base is None else base
    s = _scalars_to_u64(ks)
    n = len(s)
    out = np.zeros((n, 2, 6), dtype=np.uint64)
    inf = np.zeros(n, dtype=np.uint8)
    _call("g1_mul_batch", _g1_u64([base])[0], s, out, inf, n=n)
    ints = _u64_to_ints(out)
    return [rm.G1Affine.identity() if inf[i] else rm.G1Affine(ints[2 * i], ints[2 * i + 1])
            for i in range(n)]


def g2_mul_batch(ks, base: rm.G2Affine | None = None) -> list:
    """[k_i * base] as refmodel.G2Affine (base: the generator), 0 <= k_i <
    2^256."""
    base = rm.G2Affine.generator() if base is None else base
    s = _scalars_to_u64(ks)
    n = len(s)
    out = np.zeros((n, 4, 6), dtype=np.uint64)
    inf = np.zeros(n, dtype=np.uint8)
    _call("g2_mul_batch", _g2_u64([base])[0], s, out, inf, n=n)
    ints = _u64_to_ints(out)
    return [rm.G2Affine.identity() if inf[i] else
            rm.G2Affine(rm.Fq2(ints[4 * i], ints[4 * i + 1]),
                        rm.Fq2(ints[4 * i + 2], ints[4 * i + 3]))
            for i in range(n)]


def fp_inv_batch(xs: list) -> list[int]:
    """[x_i^(p-2) mod p]: the Fermat inverse, 0 for 0."""
    a = _ints_to_u64([[x] for x in xs])
    out = np.zeros((len(xs), 6), dtype=np.uint64)
    _call("fp_inv_batch", a, out, n=len(xs))
    return _u64_to_ints(out)


def fp_mul_batch(xs: list, ys: list) -> list[int]:
    """[x_i * y_i mod p]."""
    if len(xs) != len(ys):
        raise ValueError(f"{len(xs)} factors against {len(ys)}")
    a, b = _ints_to_u64([[x] for x in xs]), _ints_to_u64([[y] for y in ys])
    out = np.zeros((len(xs), 6), dtype=np.uint64)
    _call("fp_mul_batch", a, b, out, n=len(xs))
    return _u64_to_ints(out)
