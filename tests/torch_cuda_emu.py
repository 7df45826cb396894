"""The port's CUDA sources built for the host CPU, so that tests without a
card run the kernels' own code.

`build` compiles csrc/<source> with the host's C++ compiler (g++, C++17,
as ops/cuda_build.py's nvcc: C++20 would find a function template by its
arguments where nvcc needs it declared) against a small stand-in for the
CUDA runtime and the generated headers of both tiers (rns_tables.h,
limb_tables.h): a launch runs its blocks one after
another, each block's CUDA threads as fibers on the calling host thread
(1-, 2- or 3-D blocks; a fiber runs until it waits at a barrier, and the
block's scheduler then resumes the next one whose barrier has opened, so no
thread spins and the host's load cannot starve a block; `set_order` makes
the scheduler resume them in reverse or in a shuffled order), with a barrier for
__syncthreads, one per warp of 32 threads for __syncwarp, the shuffles
(__shfl_sync, __shfl_up_sync, __shfl_down_sync, __shfl_xor_sync) and
__reduce_and_sync (through a per-warp exchange buffer), __shared__ as static
storage and `extern __shared__` as the launch's dynamic shared memory
(cudaFuncSetAttribute is a no-op), atomicAdd on int as the host's atomic
add, and `__grid_constant__` parameters passed by value. The build defines
RNS_HOST_EMU, under which rns_redc_tc.cuh takes `extend` from this module
(the tensor-core products as the same integer dot products of the same u8
planes, written out: their mma.sync fragment layout is the one part left to
the card) and records every REDC a thread runs, its K input residues and
its K outputs, for `redc_log`. What the emulator cannot show is left to
the card: timing, the compiler's limits, and most races: the threads of a
block take turns only at barriers, so two threads never run at once, and a
missing barrier between a write and another thread's read shows only where
the order of turns puts the read first (tests run such kernels under each
order of `set_order`). A barrier that some threads never reach aborts the
process with a message.

`bind(monkeypatch, kernels, lib)` points ops/rns/kernels.py's launch
helpers at the built library (pytest's monkeypatch undoes it), so that a
wrapper's kernel path (`kernels._miller_run_kernel`, ...) lays out and
launches CPU tensors exactly as it does on a card; `bind_limb` does the
same for the limb tier's wrappers (ops/cuda_build.py's `rows` and `call`).
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
#include <algorithm>
#include <atomic>
#include <functional>
#include <sys/mman.h>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline dim3 threadIdx, blockIdx;  // set by the scheduler on each switch
inline dim3 blockDim, gridDim;
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
template <class T> inline T min(T a, T b) { return b < a ? b : a; }
template <class T> inline T max(T a, T b) { return a < b ? b : a; }
// The CUDA threads of a block run as fibers on the calling host thread: a
// fiber runs until it waits at a barrier (or ends), then hands the host
// thread back to the block's scheduler, which resumes the next fiber whose
// barrier has opened. No thread spins, so the host's load does not starve a
// block, and the interleaving is the same on every run.
struct EmuFiber {
  void* sp = nullptr;              // saved stack pointer while switched out
  unsigned char* stack = nullptr;
  const unsigned* wait_phase = nullptr;  // the barrier phase it waits past
  unsigned wait_value = 0;
  bool done = false;
  std::function<void()> body;
};
constexpr size_t kFiberStack = size_t(8) << 20;  // as a host thread's
inline std::vector<EmuFiber> g_fibers;
inline int g_current = -1;
inline void* g_sched_sp = nullptr;
#if defined(__x86_64__)
// save the callee-saved registers on this stack, store the stack pointer in
// *from, load `to`, restore its registers, return into it
extern "C" void emu_switch(void** from, void* to);
asm(R"(
.text
.globl emu_switch
.hidden emu_switch
.type emu_switch,@function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
.size emu_switch, .-emu_switch
)");
#else
#error "the CUDA emulator's fibers switch stacks on x86-64 only"
#endif
inline void emu_yield() {  // back to the scheduler
  emu_switch(&g_fibers[g_current].sp, g_sched_sp);
}
extern "C" inline void emu_fiber_main() {
  EmuFiber& f = g_fibers[g_current];
  f.body();
  f.done = true;
  emu_yield();
  __builtin_unreachable();
}
inline void emu_fiber_start(EmuFiber& f) {
  // the first switch into the fiber pops six zero registers and returns
  // into emu_fiber_main with the stack aligned as after a call
  auto* top = reinterpret_cast<void**>(f.stack + kFiberStack);
  top[-1] = nullptr;
  top[-2] = reinterpret_cast<void*>(&emu_fiber_main);
  for (int i = 3; i <= 8; ++i) top[-i] = nullptr;
  f.sp = top - 8;
}
// a barrier of n threads (the block's __syncthreads, a warp's): the last to
// arrive opens it and goes on; the others wait as fibers
struct EmuBarrier {
  const int n;
  int count = 0;
  unsigned phase = 0;
  explicit EmuBarrier(int n_) : n(n_) {}
  void arrive_and_wait() {
    if (++count == n) {
      count = 0;
      ++phase;
      return;
    }
    EmuFiber& f = g_fibers[g_current];
    f.wait_phase = &phase;
    f.wait_value = phase;
    emu_yield();
  }
};
inline EmuBarrier* g_barrier = nullptr;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }

// warps: 32 consecutive threads of a block (x fastest, then y), each warp
// with its own barrier and exchange buffer for the shuffles
constexpr int kWarp = 32;
struct EmuWarp {
  EmuBarrier bar;
  int n;
  long long slot[kWarp];
  explicit EmuWarp(int n_) : bar(n_), n(n_) {}
};
inline EmuWarp* t_warp = nullptr;
inline int t_lane = 0;
inline void __syncwarp(unsigned = 0xffffffffu) { t_warp->bar.arrive_and_wait(); }
template <class T> T emu_shfl(T v, int src, bool keep) {
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  t_warp->slot[t_lane] = bits;
  t_warp->bar.arrive_and_wait();
  T out = v;
  if (!keep) std::memcpy(&out, &t_warp->slot[src], sizeof(T));
  t_warp->bar.arrive_and_wait();
  return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src, int width = kWarp) {
  return emu_shfl(v, (t_lane / width) * width + src % width, false);
}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned d, int width = kWarp) {
  const int s = t_lane % width - static_cast<int>(d);
  return emu_shfl(v, t_lane - static_cast<int>(d), s < 0);
}
template <class T> T __shfl_down_sync(unsigned, T v, unsigned d, int width = kWarp) {
  const int s = t_lane % width + static_cast<int>(d);
  return emu_shfl(v, t_lane + static_cast<int>(d), s >= width);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int m, int width = kWarp) {
  return emu_shfl(v, t_lane ^ m, false);
}
inline unsigned __reduce_and_sync(unsigned, unsigned v) {
  t_warp->slot[t_lane] = v;
  t_warp->bar.arrive_and_wait();
  unsigned out = ~0u;
  for (int i = 0; i < t_warp->n; ++i) out &= static_cast<unsigned>(t_warp->slot[i]);
  t_warp->bar.arrive_and_wait();
  return out;
}

// extern __shared__ arrays: one buffer of the launch's dynamic size, reused
// by the blocks in turn
inline std::vector<unsigned char> g_dyn_smem;

#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__ __restrict
#define __grid_constant__
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaDevAttrMultiProcessorCount = 16,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, int) {
  *n = 1;
  return 0;
}
inline float __int2float_rn(int x) { return static_cast<float>(x); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline int __float2int_rn(float x) { return static_cast<int>(std::nearbyint(x)); }

// per thread of the last launch (block * threads per block + thread): its
// REDCs as K, K inputs, K outputs
inline std::vector<std::vector<int>> g_logs;
inline std::vector<int>* t_log = nullptr;
template <int K> void emu_record(const int (&x)[K], bool first) {
  if (first) t_log->push_back(K);
  t_log->insert(t_log->end(), x, x + K);
}
#define RNS_REDC_RECORD(x, first) emu_record(x, first)
extern "C" int emu_log_threads() { return static_cast<int>(g_logs.size()); }
extern "C" int emu_log_len(int i) { return static_cast<int>(g_logs[i].size()); }
extern "C" const int* emu_log_data(int i) { return g_logs[i].data(); }

// the fibers' stacks, kept from launch to launch (pages are committed only
// where a fiber's stack reaches)
inline std::vector<unsigned char*> g_stacks;
inline unsigned char* emu_stack(size_t i) {
  while (g_stacks.size() <= i) {
    void* p = mmap(nullptr, kFiberStack, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) std::abort();
    g_stacks.push_back(static_cast<unsigned char*>(p));
  }
  return g_stacks[i];
}

// the order in which a round resumes a block's fibers: 0 by thread index,
// 1 the reverse, 2 a new shuffle every round (from a fixed seed, so a run
// repeats); a missing barrier between one thread's write and another's read
// shows under one order or another
inline int g_order = 0;
inline unsigned long long g_shuffle = 0x9E3779B97F4A7C15ull;
extern "C" void emu_set_order(int order) {
  g_order = order;
  g_shuffle = 0x9E3779B97F4A7C15ull;
}
inline void emu_round_order(std::vector<int>& order) {
  const int n = static_cast<int>(order.size());
  for (int i = 0; i < n; ++i) order[i] = g_order == 1 ? n - 1 - i : i;
  if (g_order != 2) return;
  for (int i = n - 1; i > 0; --i) {  // Fisher-Yates on an xorshift64 stream
    g_shuffle ^= g_shuffle << 13;
    g_shuffle ^= g_shuffle >> 7;
    g_shuffle ^= g_shuffle << 17;
    std::swap(order[i], order[static_cast<int>(g_shuffle % static_cast<unsigned>(i + 1))]);
  }
}

template <class Kernel, class... A> void emu_launch(dim3 grid, dim3 block, size_t smem,
                                                    Kernel kernel, A... args) {
  blockDim = block;
  gridDim = grid;
  const int threads = static_cast<int>(block.x * block.y * block.z);
  const int blocks = static_cast<int>(grid.x * grid.y * grid.z);
  g_logs.assign(static_cast<size_t>(blocks) * threads, {});
  g_dyn_smem.assign(smem, 0);
  for (int b = 0; b < blocks; ++b) {
    EmuBarrier bar(threads);
    g_barrier = &bar;
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int w = 0; w * kWarp < threads; ++w) {
      warps.push_back(std::make_unique<EmuWarp>(std::min(kWarp, threads - w * kWarp)));
    }
    g_fibers.assign(threads, EmuFiber{});
    for (int t = 0; t < threads; ++t) {
      g_fibers[t].stack = emu_stack(t);
      g_fibers[t].body = [=] { kernel(args...); };
      emu_fiber_start(g_fibers[t]);
    }
    // rounds: resume every fiber whose barrier has opened, in the order
    // emu_set_order chose, until all have ended; a round that resumes none
    // is a barrier no thread can pass
    std::vector<int> order(threads);
    for (int live = threads; live > 0;) {
      emu_round_order(order);
      bool ran = false;
      for (const int t : order) {
        EmuFiber& f = g_fibers[t];
        if (f.done || (f.wait_phase && *f.wait_phase == f.wait_value)) continue;
        f.wait_phase = nullptr;
        threadIdx = dim3(t % block.x, t / block.x % block.y, t / (block.x * block.y));
        blockIdx = dim3(b % grid.x, b / grid.x % grid.y, b / (grid.x * grid.y));
        t_warp = warps[t / kWarp].get();
        t_lane = t % kWarp;
        t_log = &g_logs[static_cast<size_t>(b) * threads + t];
        g_current = t;
        emu_switch(&g_sched_sp, f.sp);
        ran = true;
        live -= f.done;
      }
      if (!ran) {
        std::fprintf(stderr, "emulated block %d: its threads wait at barriers that "
                             "none of the others reach\n", b);
        std::abort();
      }
    }
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
        smem = parts[2] if len(parts) > 2 else "0"
        out.append(f"emu_launch({parts[0]}, {parts[1]}, {smem}, {m.group(1)}, ")
        i = j + 4
    return "".join(out) + text[i:]


_EXTERN_SHARED = re.compile(
    r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\];")


def _dynamic_shared(text: str) -> str:
    """extern __shared__ T name[]; -> a pointer into the launch's dynamic
    shared memory."""
    return _EXTERN_SHARED.sub(
        lambda m: f"{m.group(1)}* {m.group(2)} = "
                  f"reinterpret_cast<{m.group(1)}*>(g_dyn_smem.data());", text)


def compiler() -> str | None:
    return shutil.which("g++")


def build(source: str, out_dir: Path) -> ctypes.CDLL:
    """csrc/<source> built for the host CPU into out_dir; the loaded library."""
    from plonky2_bls12_381_pairing_torch.ops import cuda_build

    out_dir.mkdir(parents=True, exist_ok=True)
    for name, text in cuda_build.headers().items():
        (out_dir / name).write_text(text)
    (out_dir / "cuda_runtime.h").write_text(_RUNTIME)
    (out_dir / "rns_emu_extend.h").write_text(_EXTEND)
    src = out_dir / (Path(source).stem + ".cpp")
    src.write_text(_dynamic_shared(_launches_to_calls((CSRC / source).read_text())))
    lib = out_dir / f"lib{Path(source).stem}.so"
    proc = subprocess.run([compiler() or "g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                           "-pthread", "-w", "-DRNS_HOST_EMU", "-I", str(out_dir), "-I",
                           str(CSRC), "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the host build of {source} failed:\n{proc.stderr[-4000:]}")
    out = ctypes.CDLL(str(lib))
    out.emu_log_len.argtypes = [ctypes.c_int]
    out.emu_log_data.argtypes = [ctypes.c_int]
    out.emu_log_data.restype = ctypes.POINTER(ctypes.c_int)
    return out


#: the orders in which a block's fibers take their turns (emu_set_order)
ORDERS = ("forward", "reverse", "shuffled")


def set_order(lib: ctypes.CDLL, order: str) -> None:
    """Make `lib`'s launches resume a block's fibers by thread index
    ("forward", the default), in reverse, or in a new shuffle every round
    (from a fixed seed, restarted here)."""
    lib.emu_set_order(ORDERS.index(order))


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


def bind_limb(monkeypatch, lib: ctypes.CDLL) -> None:
    """Route ops/cuda_build.py's `rows` and `call`, through which the limb
    tier's wrappers launch, to `lib`, for CPU tensors; each launch counts in
    its tier's `launches`, as on a card."""
    from plonky2_bls12_381_pairing_torch.ops import cuda_build

    def rows(t, batch, tail):
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 rows, got {t.dtype}")
        return cuda_build.row_view(t, batch, tail)

    def call(name, device, *args):
        _, entry, argtypes, launches = cuda_build._KERNELS[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        if fn(*args, None) != 0:
            raise RuntimeError(f"{name} launch refused")
        launches[name] += 1

    monkeypatch.setattr(cuda_build, "rows", rows)
    monkeypatch.setattr(cuda_build, "call", call)
