"""The RNS tier's CUDA sources built for the host CPU, so that tests without
a card run the kernels' own code.

`build` compiles csrc/<source> with the host's C++ compiler (g++, C++20)
against a small stand-in for the CUDA runtime: a launch runs its blocks one
after another, each as one std::thread per CUDA thread, with a
std::barrier for __syncthreads and __shared__ as static storage. The build
defines RNS_HOST_EMU, under which rns_redc_tc.cuh takes `extend` from this
module (the tensor-core products as the same integer dot products of the
same u8 planes, written out: their mma.sync fragment layout is the one
part left to the card) and records every REDC a thread runs, its K input
residues and its K outputs, for `redc_log`.

`bind(monkeypatch, kernels, lib)` points ops/rns/kernels.py's launch
helpers at the built library (pytest's monkeypatch undoes it), so that a
wrapper's kernel path (`kernels._miller_run_kernel`, ...) lays out and
launches CPU tensors exactly as it does on a card.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "plonky2_bls12_381_pairing_torch" / "csrc"

_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim, gridDim;
inline std::barrier<>* g_barrier = nullptr;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__ __restrict
#define __grid_constant__
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
template <class K> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, int) {
  *n = 1;
  return 0;
}
inline float __int2float_rn(int x) { return static_cast<float>(x); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline int __float2int_rn(float x) { return static_cast<int>(std::nearbyint(x)); }

// per thread of the last launch (block * blockDim + thread): its REDCs as
// K, K inputs, K outputs
inline std::vector<std::vector<int>> g_logs;
inline thread_local std::vector<int>* t_log = nullptr;
template <int K> void emu_record(const int (&x)[K], bool first) {
  if (first) t_log->push_back(K);
  t_log->insert(t_log->end(), x, x + K);
}
#define RNS_REDC_RECORD(x, first) emu_record(x, first)
extern "C" int emu_log_threads() { return static_cast<int>(g_logs.size()); }
extern "C" int emu_log_len(int i) { return static_cast<int>(g_logs[i].size()); }
extern "C" const int* emu_log_data(int i) { return g_logs[i].data(); }

template <class Kernel, class... A> void emu_launch(int grid, int threads, Kernel kernel,
                                                    A... args) {
  blockDim.x = threads;
  gridDim.x = grid;
  g_logs.assign(static_cast<size_t>(grid) * threads, {});
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(threads);
    g_barrier = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        t_log = &g_logs[static_cast<size_t>(b) * threads + t];
        kernel(args...);
      });
    }
    for (auto& th : ts) th.join();
  }
}
"""

# rns_redc_tc.cuh's extend, as the integers the tensor cores sum
_EXTEND = r"""#pragma once
template <int M, int N>
inline void extend(const unsigned char (&sig)[3][M][TC_PITCH],
                   const unsigned char (&t)[3][N][TC_PITCH], int (&ext)[M][TC_N1]) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int m = idx / N, n = idx % N;
    int d[3];
    for (int p = 0; p < 3; ++p) {
      int acc = 0;
      for (int k = 0; k < TC_K; ++k) acc += int(sig[p][m][k]) * int(t[p][n][k]);
      d[p] = acc;
    }
    const int ll = d[0], hh = d[1];
    ext[m][n] = ll + ((d[2] - ll - hh) << RNS_PLANE_BITS) + (hh << (2 * RNS_PLANE_BITS));
  }
}

"""

def _launches_to_calls(text: str) -> str:
    """kernel<<<grid, threads, ...>>>(args) -> emu_launch(grid, threads, kernel, args)."""
    out, i = [], 0
    pat = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<")
    while (m := pat.search(text, i)) is not None:
        out.append(text[i:m.start()])
        j = text.index(">>>(", m.end())
        parts, depth, cur = [], 0, ""
        for ch in text[m.end():j]:
            depth += (ch in "(<") - (ch in ")>")
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        out.append(f"emu_launch({parts[0]}, {parts[1]}, {m.group(1)}, ")
        i = j + 4
    return "".join(out) + text[i:]


def compiler() -> str | None:
    return shutil.which("g++")


def build(source: str, out_dir: Path) -> ctypes.CDLL:
    """csrc/<source> built for the host CPU into out_dir; the loaded library."""
    from plonky2_bls12_381_pairing_torch.ops.rns import kernel_tables

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "rns_tables.h").write_text(kernel_tables.header_text())
    (out_dir / "cuda_runtime.h").write_text(_RUNTIME)
    (out_dir / "rns_emu_extend.h").write_text(_EXTEND)
    src = out_dir / (Path(source).stem + ".cpp")
    src.write_text(_launches_to_calls((CSRC / source).read_text()))
    lib = out_dir / f"lib{Path(source).stem}.so"
    subprocess.run([compiler() or "g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-w", "-DRNS_HOST_EMU", "-I", str(out_dir), "-I", str(CSRC), "-o",
                    str(lib), str(src)], check=True, capture_output=True, text=True)
    out = ctypes.CDLL(str(lib))
    out.emu_log_len.argtypes = [ctypes.c_int]
    out.emu_log_data.argtypes = [ctypes.c_int]
    out.emu_log_data.restype = ctypes.POINTER(ctypes.c_int)
    return out


def redc_log(lib: ctypes.CDLL, threads_per_row: int = 128) -> list[tuple[np.ndarray,
                                                                             np.ndarray]]:
    """The REDCs of the last launch in order, each as (inputs, outputs) of
    shape (K, rows, LANES): every thread runs the same REDCs, so the logs of
    its threads line up call by call."""
    n = lib.emu_log_threads()
    logs = [np.ctypeslib.as_array(lib.emu_log_data(i), (lib.emu_log_len(i),)).copy()
            if lib.emu_log_len(i) else np.zeros(0, np.int32) for i in range(n)]
    assert len({len(x) for x in logs}) == 1, "the threads ran different REDCs"
    rows = n // threads_per_row
    calls, pos = [], 0
    while pos < len(logs[0]):
        k = int(logs[0][pos])
        stack = np.stack([x[pos + 1:pos + 1 + 2 * k] for x in logs])  # (threads, 2K)
        stack = stack.reshape(rows, threads_per_row, 2, k).transpose(2, 3, 0, 1)
        calls.append((stack[0], stack[1]))
        pos += 1 + 2 * k
    return calls


def bind(monkeypatch, kernels, lib: ctypes.CDLL) -> None:
    """Route ops/rns/kernels.py's launch helpers to `lib`, for CPU tensors;
    each launch counts in kernels.launches, as on a card."""
    from plonky2_bls12_381_pairing_torch.ops import cuda_build

    def check(a, tail, contiguous=True):
        if a.dtype != torch.int32:
            raise TypeError(f"expected int32 rows, got {a.dtype}")
        if tuple(a.shape[a.dim() - len(tail):]) != tail:
            raise ValueError(f"expected (..., {tail}), got {tuple(a.shape)}")
        if contiguous and not a.is_contiguous():
            raise ValueError("expected a contiguous tensor")

    def rows(t, batch, tail):
        check(t, tail, contiguous=False)
        return cuda_build.row_view(t, batch, tail)

    def call(name, device, *args):
        _, entry, argtypes = kernels._KERNELS[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        if fn(*args, None) != 0:
            raise RuntimeError(f"{name} launch refused")
        kernels.launches[name] += 1

    monkeypatch.setattr(kernels, "_check", check)
    monkeypatch.setattr(kernels, "_rows", rows)
    monkeypatch.setattr(kernels, "_call", call)
