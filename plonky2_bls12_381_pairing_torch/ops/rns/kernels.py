"""The RNS tier's hand-written CUDA kernels (the JAX package's
ops/rns/pallas.py on the pairing's path), their plain PyTorch versions, the
nvcc build and the ctypes binding.

  cyc_exp(a, segments)            <- pallas.cyc_exp_run   (csrc/cyc_exp.cu)
  pow_static_fused(a, exponent)   <- pallas.pow_static_fused (csrc/pow_static.cu)

Each wrapper runs its plain version for a tensor on the CPU and launches its
kernel for a tensor on a CUDA device; there is no fallback between the two.
`launches` counts kernel launches per wrapper.

The kernels are built at first use with nvcc into shared libraries with a
plain C interface, in build/torch_kernels/<hash>/ at the repository root,
keyed by a hash of the CUDA sources and the generated table header.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import fp, kernel_tables, tower

LANES = fp.LANES

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: kernel name -> (source, C entry point)
_KERNELS = {
    "cyc_exp": ("cyc_exp.cu", "cyc_exp_launch"),
    "pow_static": ("pow_static.cu", "pow_static_launch"),
}

#: Kernel launches per wrapper since the last reset_launches().
launches = {name: 0 for name in _KERNELS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def cyc_exp_plain(a: torch.Tensor, segments) -> torch.Tensor:
    """a^X for cyclotomic Fq12 a (..., 12, LANES), X given as MSB-first
    (n_squares, multiply_after) segments after its leading bit: Granger-Scott
    squarings and full products with the base."""
    acc = a
    for n_sq, mul_after in segments:
        for _ in range(n_sq):
            acc = tower.cyclotomic_square(acc)
        if mul_after:
            acc = tower.mul(acc, a)
    return acc


# The plain version of pow_static_fused is fp.pow_static.


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

_LIBS: dict[str, ctypes.CDLL] = {}
#: nvcc's report (ptxas register and shared-memory use) of the last build.
build_log: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc")
    return path


def build() -> Path:
    """Build both kernels (in parallel, one nvcc each) unless the build
    directory for the current sources already holds them; load them."""
    header = kernel_tables.header_text()
    h = hashlib.sha256(header.encode())
    for src in sorted(_CSRC.iterdir()):
        h.update(src.name.encode() + src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    hdr = out_dir / "rns_tables.h"
    if not hdr.exists() or hdr.read_text() != header:
        tmp = out_dir / f"rns_tables.h.{os.getpid()}"
        tmp.write_text(header)
        os.replace(tmp, hdr)
    procs = {}
    for name, (src, _) in _KERNELS.items():
        lib = out_dir / f"lib{name}.so"
        if name in _LIBS or lib.exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-I", str(out_dir), "-I", str(_CSRC),
               "-o", str(tmp), str(_CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, lib)
    for name, (_, entry) in _KERNELS.items():
        if name not in _LIBS:
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _LIBS[name] = fn
    return out_dir


def _entry(name: str):
    if name not in _LIBS:
        build()
    return _LIBS[name]


def _check(a: torch.Tensor, tail: tuple) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {a.device}")
    if a.dtype != torch.int32:
        raise TypeError(f"expected int32 rows, got {a.dtype}")
    if tuple(a.shape[a.dim() - len(tail):]) != tail:
        raise ValueError(f"expected shape (..., {', '.join(map(str, tail))}), "
                         f"got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("expected a contiguous tensor")


_ARGS: dict = {}


def _int_arg(key, values, device: torch.device) -> torch.Tensor:
    """A small int32 argument array on the device, made once per key."""
    k = (key, device)
    if k not in _ARGS:
        _ARGS[k] = torch.tensor(values, dtype=torch.int32, device=device)
    return _ARGS[k]


def _launch(name: str, a: torch.Tensor, rows: int, arg: torch.Tensor,
            n_arg: int) -> torch.Tensor:
    fn = _entry(name)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), out.data_ptr(), rows, arg.data_ptr(), n_arg, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def cyc_exp(a: torch.Tensor, segments) -> torch.Tensor:
    """a^X for cyclotomic Fq12 rows a (..., 12, LANES) int32, X given as
    MSB-first (n_squares, multiply_after) segments after its leading bit."""
    segments = tuple((int(n), int(bool(m))) for n, m in segments)
    if a.device.type == "cpu":
        return cyc_exp_plain(a, segments)
    _check(a, (12, LANES))
    segs = _int_arg(("segs", segments), [v for s in segments for v in s], a.device)
    rows = a.numel() // (12 * LANES)
    return _launch("cyc_exp", a, rows, segs, len(segments))


def pow_static_fused(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent (exponent >= 1) for stored Fp rows a (..., LANES) int32,
    Montgomery in and out; 0 maps to 0."""
    if exponent < 1:
        raise ValueError("exponent must be >= 1")
    if a.device.type == "cpu":
        return fp.pow_static(a, exponent)
    _check(a, (LANES,))
    bits = fp.exponent_bits(exponent)
    arg = _int_arg(("bits", exponent), bits or [0], a.device)
    rows = a.numel() // LANES
    return _launch("pow_static", a, rows, arg, len(bits))
