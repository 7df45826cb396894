"""The nvcc build and the ctypes binding of the port's CUDA kernels, shared by
the RNS tier (ops/rns/kernels.py) and the limb tier (ops/kernels/).

Every source of csrc/ is built at first use into a shared library with a plain
C interface, one per source and one nvcc process each, all started together,
in build/torch_kernels/<hash>/ at the repository root. The hash covers the
CUDA sources, the generated table headers of both tiers and the compiler
flags. A tier registers its kernels (name -> source, C entry point, argument
types) and its launch counters; `call` launches a kernel on the current
stream, raises if the launch is refused, and counts it.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
PTR, INT, STRIDE = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: kernel name -> (source, C entry point, argument types, the tier's counters)
_KERNELS: dict = {}
#: source -> its loaded library; kernel name -> its bound C entry point
_LOADED: dict = {}
_LIBS: dict = {}
#: nvcc's report (ptxas register and shared-memory use) of the build that made
#: each source's library, by source; kept beside the library, so that a build
#: directory reused by a later process still has it.
build_log: dict[str, str] = {}


def register(kernels: dict, launches: dict) -> None:
    """Add a tier's kernels: name -> (source, entry point, argument types);
    `launches` is the dict in which the tier counts their launches."""
    for name, (src, entry, argtypes) in kernels.items():
        _KERNELS[name] = (src, entry, argtypes, launches)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc")
    return path


def nvcc_command(src: Path, lib: Path, include: Path) -> list[str]:
    """The nvcc command that builds `src` into the shared library `lib`, with
    the generated headers in `include` and csrc/ on the include path."""
    return [_nvcc(), *_NVCC_FLAGS, "-I", str(include), "-I", str(_CSRC), "-o", str(lib),
            str(src)]


def headers() -> dict[str, str]:
    """The generated table headers, by file name."""
    from .kernels import limb_tables
    from .rns import kernel_tables

    return {"rns_tables.h": kernel_tables.header_text(),
            "limb_tables.h": limb_tables.header_text()}


def build() -> Path:
    """Build every source (in parallel, one nvcc each) unless the build
    directory for the current sources already holds its library; load them."""
    hdrs = headers()
    h = hashlib.sha256()
    for name, text in sorted(hdrs.items()):
        h.update(name.encode() + text.encode())
    for src in sorted(_CSRC.iterdir()):
        h.update(src.name.encode() + src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, text in hdrs.items():
        hdr = out_dir / name
        if not hdr.exists() or hdr.read_text() != text:
            tmp = out_dir / f"{name}.{os.getpid()}"
            tmp.write_text(text)
            os.replace(tmp, hdr)
    sources = sorted(p.name for p in _CSRC.glob("*.cu"))
    procs = {}
    for src in sources:
        lib = out_dir / f"lib{Path(src).stem}.so"
        if lib.exists():
            report = lib.with_suffix(".log")
            build_log[src] = report.read_text() if report.exists() else ""
            continue
        tmp = out_dir / f"{lib.name}.{os.getpid()}"
        procs[src] = (subprocess.Popen(nvcc_command(_CSRC / src, tmp, out_dir),
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = None
    for src, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()  # every process is waited for
        build_log[src] = log
        if proc.returncode != 0:
            failed = failed or f"nvcc failed for {src}:\n{log}"
        else:
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError(failed)
    for src in sources:
        _LOADED[src] = ctypes.CDLL(str(out_dir / f"lib{Path(src).stem}.so"))
    _LIBS.clear()
    return out_dir


def entry(name: str):
    """The bound C entry point of kernel `name`, building at first use."""
    if name not in _LIBS:
        if not _LOADED:
            build()
        src, symbol, argtypes, _ = _KERNELS[name]
        fn = getattr(_LOADED[src], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return _LIBS[name]


def call(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream (the entry's last
    argument) and count it."""
    fn = entry(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _KERNELS[name][3][name] += 1


def all_launches() -> dict[str, int]:
    """The launch counts of every registered kernel, both tiers together."""
    return {name: k[3][name] for name, k in _KERNELS.items()}


def reset_all_launches() -> None:
    for name, k in _KERNELS.items():
        k[3][name] = 0


def check(a: torch.Tensor, tail: tuple, contiguous: bool = True) -> None:
    """Raise on what a kernel does not take: a tensor off the card, another
    type than int32, another trailing shape, or (where asked) gaps."""
    if a.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {a.device}")
    if a.dtype != torch.int32:
        raise TypeError(f"expected int32 rows, got {a.dtype}")
    if tuple(a.shape[a.dim() - len(tail):]) != tail:
        raise ValueError(f"expected shape (..., {', '.join(map(str, tail))}), "
                         f"got {tuple(a.shape)}")
    if contiguous and not a.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def row_view(t: torch.Tensor, batch: tuple, tail: tuple) -> tuple[torch.Tensor, int]:
    """`t` (batch..., *tail), broadcast over `batch`, as the kernels read an
    operand: a (rows, *tail) tensor to keep alive and its row stride in
    elements. The tail must be dense and the batch axes must merge into one
    stride, as they do for a contiguous tensor, for a slice of the tail's
    first axis of one, and for a broadcast over the whole batch (stride 0).
    Any other layout is copied first (one read and one write of the
    operand)."""
    t = t.expand(*batch, *tail)
    k = len(tail)
    dense = t.stride()[t.dim() - k:] == tuple(
        math.prod(tail[i + 1:]) for i in range(k))
    v = None
    if dense:
        try:
            v = t.view(math.prod(batch), *tail)
        except RuntimeError:  # the batch axes do not merge
            pass
    if v is None:
        v = t.contiguous().view(math.prod(batch), *tail)
    return v, v.stride(0)


def rows(t: torch.Tensor, batch: tuple, tail: tuple) -> tuple[torch.Tensor, int]:
    check(t, tail, contiguous=False)
    return row_view(t, batch, tail)
