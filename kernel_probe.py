"""Where the time of the hand-written kernels goes, on one CUDA card.

    python3 kernel_probe.py

The sources in csrc/ carry no instrumentation. The probe writes its own
copies into build/kernel_probe/ (gitignored) and builds them there, one nvcc
each, all started together: a copy is a csrc/ source with checked edits
(each edit's anchor must occur as often as the probe expects, or it stops),
or, for the block design that pow_static.cu had before its warp design,
embedded below. Every kernel it times is held to its plain version.

  1. pow_static before and after the warp design, timed the same way (20
     queued launches between two events): the block design (one 128-thread
     block per packed row, a block-wide redc, embedded below) and
     csrc/pow_static.cu, at the path's shape (128 packed rows) and for one
     row, for p - 2 (608 dependent steps).
  2. a pow_static step split by clock64() stamps on the first element's
     thread 0 into its phases (the product, REDC steps 1-4, the last
     Barrett), summed over the chain and divided by its steps, in both
     designs. A phase ends where its barrier (or __syncwarp / shuffle) lets
     thread 0 go on, so waits count in the phase they end.
  3. pow_static at 1, 2, 4 and 8 warps per block.
  4. the limb tower kernel's four entries at (2048, 12, 48) through their
     wrappers, and the time of its stages: copies of csrc/limb_tower.cu that
     stop after stage k (1 the operand slots, 2 the operand sums, 3 the
     products' columns).
  5. csrc/mont.cu's two warp kernels at 1, 2, 4, 8 and 16 warps per block:
     conv on 30 pairs of (2048, 48) operands in one launch (a cyclotomic
     squaring's group) and on one pair, mont_reduce on a (2048, 12, 95)
     stack and a (2048, 2, 95) one; the 30-pair conv at each count of rows
     per warp, cut short (its loads, staging and stores alone; without its
     atomic adds), and with launch bounds for 6 and 8 blocks per SM.
  6. csrc/kara_full.cu at the path's shape (1024 packed rows, |BLS_X|'s
     chain) and at 4 packed rows, in its two designs of the norms' Fermat
     chains: the shipped one (each step a 6-row REDC of the tensor-core
     tile, 2 packed rows per block, 4 blocks per SM) and the warp design
     embedded below (pow_static's warp REDC, no block barrier in the
     chains, three chains per warp), each also on the other tensor-core
     kernels' tile of 4 rows at two and at one block per SM; the shipped
     kernel with its snapshots and inverses in dynamic shared memory
     instead of the device scratch buffer; and cut short, without the
     inversion and after the chain alone.
  7. the limb mont_mul before and after its warp design at 2048 rows (the
     block design, one thread per column and block-wide barriers in every
     shift-add pass, embedded below) and the warp design at 1, 2, 4 and 8
     warps per block; mont_pow for p - 2 (608 dependent products) at 2048
     rows and for one row, its us per dependent step, at 1, 2, 4 and 8 warps
     per block, beside fp.pow_static's chain of 608 mont_mul launches in
     either design; a mont_pow product split by clock64() stamps into its
     phases (conv's runs, the reduction's passes and products), for one row
     and for row 0 of 2048; cyc_square_run (csrc/cyc_exp.cu) on tiles of 2 packed
     rows (four blocks per SM) and of 4 (two), at n = 32 and over the six
     runs of |x| at 1024 packed rows.
  8. csrc/kara_exp.cu's two walks of the Karabina chain on tiles of 2 packed
     rows (four blocks per SM) and of 4 (two) at 1024 packed rows: kara_exp
     with |BLS_X|'s six snapshots, kara_square_run at n = 32 and over the
     six runs of |x|.
  9. which runtime calls a launcher may make while torch.cuda.graph captures
     its stream in the default ("global") mode: a launch alone, a launch
     after cudaGetDevice and cudaDeviceGetAttribute (as tower_ops.cu's
     grid_for makes on every launch), and a launch after
     cudaFuncSetAttribute (as limb_tower.cu made on every launch before it
     set the attribute once per device); each launcher (embedded below)
     called eagerly, then captured and replayed.
Each design is timed over queued launches behind a held stream and held to
its plain version. Prints the card's name and power limit first and last.

    python3 kernel_probe.py [section ...]

runs only the sections named (1-3 are one, as they share their builds: any
of them runs the three); no argument runs them all.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from plonky2_bls12_381_pairing_torch import constants as LC
from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models.schedule import _GS_SEGMENTS, _KARA_SEGMENTS
from plonky2_bls12_381_pairing_torch.ops import cuda_build
from plonky2_bls12_381_pairing_torch.ops.kernels import mont as lmont
from plonky2_bls12_381_pairing_torch.ops.kernels import tower as ltower
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernels, tower
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "plonky2_bls12_381_pairing_torch" / "csrc"
OUT = ROOT / "build" / "kernel_probe"
PHASES = ("product", "step 1: sigma", "step 2: extension to B, alpha",
          "step 3: qhat, sigma'", "step 4: extension to A, beta", "last Barrett")

# The block design: block_pow_kernel as csrc/pow_static.cu had it (one
# block of 128 threads per packed row, one redc<1> per step: the one-row
# blocks' block-wide REDC, which the RNS kernels ran on before the
# tensor-core tile), and block_stamped_kernel, the same REDC written out
# with a stamp after each phase.
BLOCK_POW = r"""
#include "rns_common.cuh"
using namespace rns;

// Shared memory of one block. t1/t2 hold the base-extension block rows that
// can be nonzero (T1 from base-A rows, T2 from base-B rows); buf carries one
// value per lane for the cross-lane sums; fix carries each slot's alpha or
// beta (the value of the sum at the slot's ALPHA_LANE). KS is the largest
// number of stacked reductions the block runs on it.
template <int KS>
struct Smem {
  int t1[NCH * SUB];
  int t2[NCH * SUB];
  int buf[KS * LANES];
  int fix[KS * PACK];
};

template <int KS>
__device__ __forceinline__ void load_tables(Smem<KS>& s) {
  for (int i = threadIdx.x; i < NCH * SUB; i += blockDim.x) {
    s.t1[i] = RNS_T1A[i / SUB][i % SUB];
    s.t2[i] = RNS_T2B[i / SUB][i % SUB];
  }
}

// K stacked reductions: x[k] holds the lane's residue of X_k (value in
// [0, MA*p)); on return, the canonical residue of the stored element
// X_k * MA^-1 + q p (fp.redc, steps 1-4). Every thread of the block must call
// it: it synchronises four times. Reductions of any K may follow one
// another on one buffer: each shared word is rewritten only after a barrier
// that follows its last read.
template <int K, int KS>
__device__ __forceinline__ void redc(int (&x)[K], const Lane& c, Smem<KS>& s) {
  static_assert(K <= KS, "the shared buffer is too small for this stack");
  const int lane = threadIdx.x;
  const int slot = lane / SUB;
  const int l = lane % SUB;
  const int base = slot * SUB;
  const bool alpha_lane = l == RNS_ALPHA_LANE;

  // step 1: sigma_i = X * (-p^-1) * (MA/a_i)^-1 mod a_i (zero off base A)
#pragma unroll
  for (int k = 0; k < K; ++k) s.buf[k * LANES + lane] = mul_m(x[k], c.c_sigma, c);
  __syncthreads();

  // step 2: extend q to base B + r: a dot product over the slot's base-A
  // sigmas. Each term is below 2^26 and there are 31, so the int32 sum is
  // exact (it equals the plain version's three-plane matmul). The sum at
  // ALPHA_LANE is the Kawamura fixed-point alpha.
  int q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int acc = 0;
    if (!c.is_a) {
      const int* sig = &s.buf[k * LANES + base + RNS_A_LO];
#pragma unroll 8
      for (int i = 0; i < NCH; ++i) acc += sig[i] * s.t1[i * SUB + l];
    }
    q[k] = acc;
    if (alpha_lane) s.fix[k * PACK + slot] = acc >> RNS_ALPHA_T;
  }
  __syncthreads();

  // step 3: qhat = s - alpha * (MA mod m); sigma'_j = r_j (MB/b_j)^-1 mod b_j
  // straight from (X, qhat) with folded constants (zero off base B)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    q[k] = barrett(q[k] - s.fix[k * PACK + slot] * c.c_mamod, c);
    s.buf[k * LANES + lane] =
        barrett(x[k] * c.c_mainv_mbinv + q[k] * c.c_pmainv_mbinv, c);
  }
  __syncthreads();

  // step 4: extend r back to base A; the sum at ALPHA_LANE, rounded, is the
  // exact wrap count beta
  int s2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int acc = 0;
    if (c.is_a || alpha_lane) {
      const int* sig = &s.buf[k * LANES + base + RNS_B_LO];
#pragma unroll 8
      for (int j = 0; j < NCH; ++j) acc += sig[j] * s.t2[j * SUB + l];
    }
    s2[k] = acc;
    if (alpha_lane) s.fix[k * PACK + slot] = (acc + (1 << (RNS_BETA_T - 1))) >> RNS_BETA_T;
  }
  __syncthreads();

  // base A takes the back-extended value, base B + r takes
  // r = (X + qhat p) MA^-1
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int pre = c.is_a ? s2[k] - s.fix[k * PACK + slot] * c.c_mbmod
                           : x[k] * c.c_mainv + q[k] * c.c_pmainv;
    x[k] = barrett(pre, c);
  }
}


__global__ void __launch_bounds__(LANES)
    block_pow_kernel(const int* __restrict__ a, int* __restrict__ out,
                     const int* __restrict__ bits, int nbits) {
  __shared__ Smem<1> s;
  load_tables(s);
  __syncthreads();
  const int lane = threadIdx.x;
  const Lane c = load_lane(lane % SUB);
  const size_t row = blockIdx.x;
  const int base = a[row * LANES + lane];
  int acc[1] = {base};
  for (int i = 0; i < nbits; ++i) {
    acc[0] = mul_m(acc[0], acc[0], c);
    redc<1>(acc, c, s);
    if (bits[i]) {
      acc[0] = mul_m(acc[0], base, c);
      redc<1>(acc, c, s);
    }
  }
  out[row * LANES + lane] = acc[0];
}

extern "C" int block_pow_launch(const int* a, int* out, int rows, const int* bits,
                                int nbits, void* stream) {
  block_pow_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, out, bits,
                                                                          nbits);
  return static_cast<int>(cudaGetLastError());
}

__device__ long long block_cycles[8];
#define STAMP(k) if (on) { long long n = clock64(); block_cycles[k] += n - t0; t0 = n; }

__device__ __forceinline__ void redc1(int& x, const Lane& c, Smem<1>& s, bool on,
                                      long long& t0) {
  const int lane = threadIdx.x, slot = lane / SUB, l = lane % SUB, base = slot * SUB;
  const bool alpha_lane = l == RNS_ALPHA_LANE;
  s.buf[lane] = mul_m(x, c.c_sigma, c);
  __syncthreads();
  STAMP(1)
  int q = 0;
  if (!c.is_a) {
    const int* sig = &s.buf[base + RNS_A_LO];
#pragma unroll 8
    for (int i = 0; i < NCH; ++i) q += sig[i] * s.t1[i * SUB + l];
  }
  if (alpha_lane) s.fix[slot] = q >> RNS_ALPHA_T;
  __syncthreads();
  STAMP(2)
  q = barrett(q - s.fix[slot] * c.c_mamod, c);
  s.buf[lane] = barrett(x * c.c_mainv_mbinv + q * c.c_pmainv_mbinv, c);
  __syncthreads();
  STAMP(3)
  int s2 = 0;
  if (c.is_a || alpha_lane) {
    const int* sig = &s.buf[base + RNS_B_LO];
#pragma unroll 8
    for (int j = 0; j < NCH; ++j) s2 += sig[j] * s.t2[j * SUB + l];
  }
  if (alpha_lane) s.fix[slot] = (s2 + (1 << (RNS_BETA_T - 1))) >> RNS_BETA_T;
  __syncthreads();
  STAMP(4)
  x = barrett(c.is_a ? s2 - s.fix[slot] * c.c_mbmod : x * c.c_mainv + q * c.c_pmainv, c);
  STAMP(5)
}

__global__ void __launch_bounds__(LANES)
    block_stamped_kernel(const int* a, int* out, const int* bits, int nbits) {
  __shared__ Smem<1> s;
  load_tables(s);
  __syncthreads();
  const int lane = threadIdx.x;
  const Lane c = load_lane(lane % SUB);
  const size_t row = blockIdx.x;
  const bool on = row == 0 && lane == 0;
  const int base = a[row * LANES + lane];
  int acc = base;
  long long t0 = clock64();
  for (int i = 0; i < nbits; ++i) {
    acc = mul_m(acc, acc, c);
    STAMP(0)
    redc1(acc, c, s, on, t0);
    if (bits[i]) {
      acc = mul_m(acc, base, c);
      STAMP(0)
      redc1(acc, c, s, on, t0);
    }
  }
  out[row * LANES + lane] = acc;
}

extern "C" int block_stamped_launch(const int* a, int* out, int rows, const int* bits,
                                    int nbits, void* stream) {
  block_stamped_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, out, bits,
                                                                              nbits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int block_stamped_cycles(long long* host) {
  cudaMemcpyFromSymbol(host, block_cycles, sizeof(block_cycles));
  const long long zero[8] = {};
  cudaMemcpyToSymbol(block_cycles, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
"""

# pow_static.cu with the same stamps: (anchor, replacement, occurrences)
STAMP_DEFS = r"""
__device__ long long pow_stamp_cycles[8];
#define STAMP(k) if (stamp_on) { const long long now = clock64(); \
  pow_stamp_cycles[k] += now - stamp_t; stamp_t = now; }
extern "C" int pow_stamped_cycles(long long* host) {
  cudaMemcpyFromSymbol(host, pow_stamp_cycles, sizeof(pow_stamp_cycles));
  const long long zero[8] = {};
  cudaMemcpyToSymbol(pow_stamp_cycles, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
"""


def _after(anchor: str, insert: str, count: int = 1) -> tuple[str, str, int]:
    return anchor, anchor + insert, count


POW_STAMP_EDITS = [
    _after('#include "rns_common.cuh"\n', STAMP_DEFS),
    ("void run(int& x0, int& x1) const {",
     "void run(int& x0, int& x1, long long& stamp_t, bool stamp_on) const {", 1),
    _after("x1 = mul_m(x1, x1, r.c1);\n", "STAMP(0)\n"),
    _after("x1 = mul_m(x1, b1, r.c1);\n", "STAMP(0)\n"),
    ("__syncwarp();\n    // step 2", "__syncwarp();\n    STAMP(1)\n    // step 2", 1),
    _after(">> RNS_ALPHA_T;\n", "STAMP(2)\n"),
    ("__syncwarp();\n    // step 4", "__syncwarp();\n    STAMP(3)\n    // step 4", 1),
    _after(">> RNS_BETA_T;\n", "STAMP(4)\n"),
    _after("x1 = barrett(x1 * c1.c_mainv + q1 * c1.c_pmainv, c1);\n", "STAMP(5)\n"),
    ("r.run(x0, x1);", "r.run(x0, x1, stamp_t, stamp_on);", 2),
    ("  int bit = nbits > 0",
     "  const bool stamp_on = e == 0 && t == 0;\n  long long stamp_t = clock64();\n"
     "  int bit = nbits > 0", 1),
]


def tower_stop_edits(k: int) -> list[tuple[str, str, int]]:
    """limb_tower.cu stopping after stage k: each thread of the block's
    12 x 32 then writes one word of stage k's shared result and returns."""
    stop = "if ({k} == {stage}) {{ out[(row * 12 + w) * NLIMBS + lane] = {v}; return; }}\n"
    stages = ((1, "2. operand sums", "s.slots[w][lane]"),
              (2, "3. products", "s.ops[w * OP_STRIDE + lane]"),
              (3, "4. warp w", "s.prods[w][lane]"))
    return [(f"  __syncthreads();\n\n  // {label}",
             f"  __syncthreads();\n  {stop.format(k=k, stage=stage, v=v)}\n  // {label}", 1)
            for stage, label, v in stages]


def conv_stop_edits(k: int) -> list[tuple[str, str, int]]:
    """mont.cu's conv kernel cut short: k = 1 without the runs' products
    and sums (the loads, the staging and the stores alone); k = 2 with the
    products but their sums stored into shared memory instead of added
    atomically (both wrong results, for the time of the parts left out)."""
    piece = "        conv_quads(s.x, y, c, lo, PIECE / 4, acc);\n"
    add = "        add_rotated(s.out, c, (lo - max(0, c - NLIMBS)) / PIECE, acc);"
    if k == 1:
        return [(piece + add, "        acc[0] = y[lo];\n        store4(&s.out[c], acc);", 1)]
    return [(add, "        store4(&s.out[c], acc);", 1)]


def conv_blocks_edits(n: int) -> list[tuple[str, str, int]]:
    """mont.cu with the conv kernel's launch bounds asking for n blocks per
    SM (the compiler caps its registers to fit them)."""
    return [("__launch_bounds__(WARP * CONV_WARPS)\n    conv_kernel",
             f"__launch_bounds__(WARP * CONV_WARPS, {n})\n    conv_kernel", 1)]


def mont_warps_edits(w: int) -> list[tuple[str, str, int]]:
    """mont.cu with w warps (rows) per block in both warp kernels."""
    return [(f"constexpr int {name} = {shipped};", f"constexpr int {name} = {w};", 1)
            for name, shipped in (("CONV_WARPS", 8), ("REDUCE_WARPS", 4))]


# kara_full.cu's Fermat chains in the warp design: one warp per 64-lane
# norm with pow_static.cu's REDC, no block barrier in the chains. The tile's
# norms (six per slot) go to its warps, three each, through shared memory
# (the REDC tile's sigma planes and sums, free between REDCs); each warp runs
# its three chains interleaved: sigma rows in warp-private shared memory
# behind __syncwarp, alpha and beta by __shfl_sync, the extension columns in
# shared memory (at 64 registers a thread there is no room for them in
# registers), each column word read once for the three chains.
KF_WARP = r"""
constexpr int WCH = TILE * PACK * NSNAP / WARPS;  // chains per warp
static_assert(WCH * WARPS == TILE * PACK * NSNAP, "the warps share the norms evenly");
constexpr int C1W = NCH + 2;  // RNS_T1A columns B_LO .. ALPHA_LANE
constexpr int C2W = NCH + 1;  // RNS_T2B columns 0 .. NCH - 1 and ALPHA_LANE
constexpr int COLS = (NCH * (C1W + C2W) + 3) / 4 * 4;
static_assert(sizeof(TcSmem<TILE>::sig) + sizeof(TcSmem<TILE>::ext) >=
              (COLS + TILE * PACK * NSNAP * SUB) * sizeof(int), "room in the REDC tile");

__device__ __forceinline__ void warp_redc3(int (&x0)[WCH], int (&x1)[WCH], int t,
                                           const Lane& c0, const Lane& c1, const int* col1,
                                           const int* col2, int* sig) {
#pragma unroll
  for (int q = 0; q < WCH; ++q) sig[q * SUB + t] = mul_m(x0[q], c0.c_sigma, c0);
  __syncwarp();
  int qa[WCH], qb[WCH];
#pragma unroll
  for (int q = 0; q < WCH; ++q) qa[q] = qb[q] = 0;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    int w[WCH][4];
#pragma unroll
    for (int q = 0; q < WCH; ++q) {
      const int4 s4 = reinterpret_cast<const int4*>(sig + q * SUB)[v];
      w[q][0] = s4.x; w[q][1] = s4.y; w[q][2] = s4.z; w[q][3] = s4.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * v + k;
      if (i < NCH) {
        const int ch = col1[i * C1W + 1 + t], c31 = col1[i * C1W];
#pragma unroll
        for (int q = 0; q < WCH; ++q) {
          qa[q] += w[q][k] * ch;
          qb[q] += w[q][k] * c31;
        }
      }
    }
  }
  int q0[WCH], q1[WCH];
#pragma unroll
  for (int q = 0; q < WCH; ++q) {
    const int alpha = __shfl_sync(0xffffffffu, qa[q], 31) >> RNS_ALPHA_T;
    q0[q] = barrett((c0.is_a ? 0 : qb[q]) - alpha * c0.c_mamod, c0);
    q1[q] = barrett(qa[q] - alpha * c1.c_mamod, c1);
    const int sp0 = barrett(x0[q] * c0.c_mainv_mbinv + q0[q] * c0.c_pmainv_mbinv, c0);
    const int sp1 = barrett(x1[q] * c1.c_mainv_mbinv + q1[q] * c1.c_pmainv_mbinv, c1);
    sig[q * SUB + 32 + (t == 31 ? 0 : t + 1)] = t == 31 ? sp0 : sp1;
  }
  __syncwarp();
  int s2[WCH];
#pragma unroll
  for (int q = 0; q < WCH; ++q) s2[q] = 0;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    int w[WCH][4];
#pragma unroll
    for (int q = 0; q < WCH; ++q) {
      const int4 s4 = reinterpret_cast<const int4*>(sig + q * SUB + 32)[v];
      w[q][0] = s4.x; w[q][1] = s4.y; w[q][2] = s4.z; w[q][3] = s4.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * v + k;
      if (i < NCH) {
        const int cc = col2[i * C2W + t];
#pragma unroll
        for (int q = 0; q < WCH; ++q) s2[q] += w[q][k] * cc;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < WCH; ++q) {
    const int beta =
        (__shfl_sync(0xffffffffu, s2[q], 31) + (1 << (RNS_BETA_T - 1))) >> RNS_BETA_T;
    x0[q] = barrett(c0.is_a ? s2[q] - beta * c0.c_mbmod
                            : x0[q] * c0.c_mainv + q0[q] * c0.c_pmainv, c0);
    x1[q] = barrett(x1[q] * c1.c_mainv + q1[q] * c1.c_pmainv, c1);
  }
}

__device__ __forceinline__ void fermat_warp(int (&acc)[NSNAP], const int (&base)[NSNAP],
                                            TcSmem<TILE>& s, const int* __restrict__ bits,
                                            int nbits) {
  int* const col1 = reinterpret_cast<int*>(&s.sig[0][0][0]);
  int* const col2 = col1 + NCH * C1W;
  int* const nb = col1 + COLS;  // the norms; during the chains the sigma rows
  const int l = threadIdx.x % SUB;
  const int j0 = threadIdx.x / SUB * NSNAP;  // the first norm of the thread's slot
  __syncthreads();  // the last REDC's reads of its planes and sums are done
#pragma unroll
  for (int k = 0; k < NSNAP; ++k) nb[(j0 + k) * SUB + l] = base[k];
  for (int i = threadIdx.x; i < NCH * C1W; i += THREADS) {
    col1[i] = RNS_T1A[i / C1W][RNS_B_LO + i % C1W];
  }
  for (int i = threadIdx.x; i < NCH * C2W; i += THREADS) {
    const int j = i % C2W;
    col2[i] = RNS_T2B[i / C2W][j < NCH ? j : RNS_ALPHA_LANE];
  }
  __syncthreads();
  const int t = threadIdx.x % 32, wp = threadIdx.x / 32;
  int b0[WCH], b1[WCH], x0[WCH], x1[WCH];
#pragma unroll
  for (int q = 0; q < WCH; ++q) {
    const int j = wp * WCH + q;
    b0[q] = x0[q] = nb[j * SUB + t];
    b1[q] = x1[q] = nb[j * SUB + t + 32];
  }
  __syncthreads();  // every norm is read before the sigma rows take its words
  const Lane c0 = load_lane(t), c1 = load_lane(t + 32);
  int* const sig = nb + wp * WCH * SUB;
  int bit = nbits > 0 ? bits[0] : 0;
  for (int i = 0; i < nbits; ++i) {
    const int next = i + 1 < nbits ? bits[i + 1] : 0;
#pragma unroll
    for (int q = 0; q < WCH; ++q) {
      x0[q] = mul_m(x0[q], x0[q], c0);
      x1[q] = mul_m(x1[q], x1[q], c1);
    }
    warp_redc3(x0, x1, t, c0, c1, col1, col2, sig);
    if (bit) {
#pragma unroll
      for (int q = 0; q < WCH; ++q) {
        x0[q] = mul_m(x0[q], b0[q], c0);
        x1[q] = mul_m(x1[q], b1[q], c1);
      }
      warp_redc3(x0, x1, t, c0, c1, col1, col2, sig);
    }
    bit = next;
  }
  __syncthreads();  // every chain is done with the sigma rows
#pragma unroll
  for (int q = 0; q < WCH; ++q) {
    const int j = wp * WCH + q;
    nb[j * SUB + t] = x0[q];
    nb[j * SUB + t + 32] = x1[q];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NSNAP; ++k) acc[k] = nb[(j0 + k) * SUB + l];
  __syncthreads();  // read before the next REDC writes its planes
}

"""

KF_KERNEL = "// One block per TILE packed rows (the last tile masked); a and out are\n"
KF_FERMAT = "  fermat(acc, base, c, s, bits, nbits);\n"
KF_SMEM_BYTES = "TILE * SCRATCH * LANES * 4"


def kf_shape(tile: str, blocks: int) -> list[tuple[str, str, int]]:
    """kara_full.cu with `tile` packed rows per block and launch bounds for
    `blocks` blocks per SM (shipped: 2 and 4)."""
    return [("constexpr int TILE = 2;", f"constexpr int TILE = {tile};", 1),
            ("__global__ void __launch_bounds__(THREADS, 4)\n    kara_full_kernel",
             f"__global__ void __launch_bounds__(THREADS, {blocks})\n    kara_full_kernel", 1)]


KF_WARP_EDITS = [(KF_KERNEL, KF_WARP + KF_KERNEL, 1),
                 (KF_FERMAT, "  fermat_warp(acc, base, s, bits, nbits);\n", 1)]
#: kara_full.cu's variants: name -> anchored edits. The tile design as
#: shipped, and on the other tensor-core kernels' tile of RNS_TC_ROWS = 4
#: packed rows at two and at one block per SM; the warp design on both
#: tiles (64 registers a thread) and on the 4-row tile at one block per SM
#: (128); the shipped kernel with its scratch in dynamic shared memory, and
#: cut short.
KF_VARIANTS = {
    "kf_tile": [],
    "kf_tile4": kf_shape("RNS_TC_ROWS", 2),
    "kf_tile4_1blk": kf_shape("RNS_TC_ROWS", 1),
    "kf_warp": KF_WARP_EDITS,
    "kf_warp4": KF_WARP_EDITS + kf_shape("RNS_TC_ROWS", 2),
    "kf_warp4_1blk": KF_WARP_EDITS + kf_shape("RNS_TC_ROWS", 1),
    "kf_smem": [("  int* const my = scratch + r.row * SCRATCH * LANES + b.lane;",
                 "  extern __shared__ int snap_smem[];\n"
                 "  int* const my = snap_smem + threadIdx.x / LANES * SCRATCH * LANES + b.lane;",
                 1),
                ("    kara_full_kernel<<<(rows + TILE - 1) / TILE, THREADS, 0,",
                 "    cudaFuncSetAttribute(kara_full_kernel,\n"
                 f"        cudaFuncAttributeMaxDynamicSharedMemorySize, {KF_SMEM_BYTES});\n"
                 f"    kara_full_kernel<<<(rows + TILE - 1) / TILE, THREADS, {KF_SMEM_BYTES},",
                 1)],
    "kf_noinv": [(KF_FERMAT, "#pragma unroll\n  for (int k = 0; k < NSNAP; ++k) acc[k] = base[k];\n",
                  1)],
    "kf_chain": [("  // which snapshots have g2 == 0",
                  "  return;  // the chain alone\n  // which snapshots have g2 == 0", 1)],
}


# The block design of the limb mont_mul, as csrc/mont.cu and
# limb_common.cuh had it before the warp design: one thread per column, a
# group of 128 threads per row, four rows per block, two block-wide barriers
# in every shift-add pass.
BLOCK_MONT_MUL = r"""
#include "limb_common.cuh"
using namespace limb;
constexpr int GROUPS = 4;

struct Scratch {
  int a[LANES];
  int b[LANES];
};

__device__ __forceinline__ int conv_column(const int* x, const int* y, int lane) {
  int acc = 0;
  if (lane < NCOLS) {
    const int lo = lane < NLIMBS ? 0 : lane - (NLIMBS - 1);
    const int hi = lane < NLIMBS ? lane : NLIMBS - 1;
    for (int i = lo; i <= hi; ++i) acc += x[i] * y[lane - i];
  }
  return acc;
}

__device__ __forceinline__ int passes(int t, int lane, int* buf, int n) {
  for (int i = 0; i < n; ++i) {
    buf[lane] = t;
    __syncthreads();
    const int below = lane > 0 ? buf[lane - 1] : 0;
    __syncthreads();
    t = (t & 255) + (below >> 8);
  }
  return t;
}

__device__ __forceinline__ int mont_reduce_lanes(int col, int lane, Scratch& sc,
                                                 int npass) {
  const int t = passes(col + LIMB_BIAS[lane], lane, sc.a, npass);
  sc.a[lane] = t;
  __syncthreads();
  int m = 0;
  if (lane < NRED) {
    for (int j = 0; j <= lane; ++j) m += sc.a[j] * LIMB_PPRIME[lane - j];
  }
  m = passes(m, lane, sc.b, LIMB_NPASS_M);
  sc.b[lane] = lane < NRED ? m : 0;
  __syncthreads();
  int u = 0;
  if (lane < NRED + NLIMBS - 1) {
    const int lo = lane < NLIMBS ? 0 : lane - (NLIMBS - 1);
    const int hi = lane < NRED ? lane : NRED - 1;
    for (int j = lo; j <= hi; ++j) u += sc.b[j] * LIMB_P[lane - j];
  }
  const int s = passes(t + u, lane, sc.a, LIMB_NPASS_S);
  sc.a[lane] = s;
  __syncthreads();
  int res = lane < NLIMBS ? sc.a[lane + NRED] : 0;
  if (lane == 0) {
    int qsum = 0;
    for (int k = 0; k < NRED; ++k) qsum += sc.a[k] * LIMB_QW[k];
    res += (qsum % LIMB_QMOD) == LIMB_R_MOD_QMOD ? 1 : 0;
  }
  __syncthreads();
  return res;
}

__global__ void __launch_bounds__(LANES * GROUPS)
    block_mont_mul_kernel(const int* __restrict__ a, long long sa, const int* __restrict__ b,
                          long long sb, int* __restrict__ out, int rows) {
  __shared__ int xs[GROUPS][NLIMBS], ys[GROUPS][NLIMBS];
  __shared__ Scratch sc[GROUPS];
  const int lane = threadIdx.x, g = threadIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * GROUPS + g;
  const bool live = row < rows;
  if (lane < NLIMBS) {
    xs[g][lane] = live ? a[row * sa + lane] : 0;
    ys[g][lane] = live ? b[row * sb + lane] : 0;
  }
  __syncthreads();
  const int col = conv_column(xs[g], ys[g], lane);
  const int res = mont_reduce_lanes(col, lane, sc[g], LIMB_NPASS_MUL);
  if (live && lane < NLIMBS) out[row * NLIMBS + lane] = res;
}

extern "C" int limb_mont_mul_launch(const int* a, long long sa, const int* b, long long sb,
                                    int* out, int rows, void* stream) {
  block_mont_mul_kernel<<<(rows + GROUPS - 1) / GROUPS, dim3(LANES, GROUPS), 0,
                          static_cast<cudaStream_t>(stream)>>>(a, sa, b, sb, out, rows);
  return static_cast<int>(cudaGetLastError());
}
"""


# mont.cu's mont_pow with clock64() stamps on block 0's thread 0 after each
# phase of a product (mul_warp and limb_common.cuh's mont_reduce_warp,
# inlined into the copy): the phases' cycles summed over the chain
MONT_PHASES = ("the product's runs and their adds", "its columns read back",
               "t = passes(col + bias)", "m = passes(t * p')", "the product m * p",
               "s = passes(t + m * p)", "the quotient's sum", "the result's stores")
MONT_STAMP_DEFS = r"""
__device__ long long mont_stamp_cycles[8];
__shared__ long long stamp_last;
#define STAMP(k) if (blockIdx.x == 0 && threadIdx.x == 0) { const long long now = clock64(); \
  mont_stamp_cycles[k] += now - stamp_last; stamp_last = now; }
extern "C" int mont_stamp_read(long long* host) {
  cudaMemcpyFromSymbol(host, mont_stamp_cycles, sizeof(mont_stamp_cycles));
  const long long zero[8] = {};
  cudaMemcpyToSymbol(mont_stamp_cycles, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
"""
MONT_STAMP_COMMON_EDITS = [
    _after("  warp_passes(x, lane, npass);\n", "  STAMP(2)\n"),
    _after("  store4(&ws.m[c0], m);\n  __syncwarp();\n", "  STAMP(3)\n"),
    _after("(hi - lo) / 4 + 1 : 0, x);\n  }\n", "  STAMP(4)\n"),
    _after("  warp_passes(x, lane, LIMB_NPASS_S);\n", "  STAMP(5)\n"),
    _after("qsum += __shfl_xor_sync(FULL_MASK, qsum, d);\n", "  STAMP(6)\n"),
]
MONT_STAMP_EDITS = [
    ("  __syncwarp();\n  int cols[4] = {0, 0, 0, 0};\n",
     "  __syncwarp();\n  STAMP(0)\n  int cols[4] = {0, 0, 0, 0};\n", 1),
    ("  mont_reduce_warp(cols, lane, s.ws, k, LIMB_NPASS_MUL, dst);\n  __syncwarp();\n",
     "  STAMP(1)\n  mont_reduce_warp(cols, lane, s.ws, k, LIMB_NPASS_MUL, dst);\n"
     "  __syncwarp();\n  STAMP(7)\n", 1),
    _after("  stage_row(fetch_row(a + row * sa, lane), base, lane);\n  __syncwarp();\n",
           "  if (blockIdx.x == 0 && threadIdx.x == 0) stamp_last = clock64();\n"),
]


def with_common(source: str, common_edits=(), edits=(), prefix: str = "") -> str:
    """A csrc/ source of the limb tier with limb_common.cuh inlined, both
    edited, and `prefix` before the header's text."""
    common = edited(CSRC / "limb_common.cuh", list(common_edits))
    include = '#include "limb_common.cuh"\n'
    return edited(CSRC / source, [(include, prefix + common, 1)] + list(edits))


def mont_stamped() -> str:
    """mont.cu with limb_common.cuh inlined and both stamped."""
    return with_common("mont.cu", MONT_STAMP_COMMON_EDITS, MONT_STAMP_EDITS, MONT_STAMP_DEFS)


#: the unroll factor of limb_common.cuh's conv_quads loop (shipped: 4)
QUADS_UNROLL = "#pragma unroll 4\n  for (int k = 0; k < n; ++k) {"


def quads_unroll(u: int) -> list[tuple[str, str, int]]:
    return [(QUADS_UNROLL, QUADS_UNROLL.replace("unroll 4", f"unroll {u}"), 1)]


def constant_edit(source: str, name: str, value) -> tuple[str, str, int]:
    """The line `constexpr int <name> = ...;` of a csrc/ source, set to
    `value`."""
    prefix = f"constexpr int {name} = "
    line = next(x for x in (CSRC / source).read_text().splitlines() if x.startswith(prefix))
    return line, f"{prefix}{value};", 1


def mul_warps_edits(w: int) -> list[tuple[str, str, int]]:
    """mont.cu with w warps (rows) per block in mont_mul and mont_pow."""
    return [constant_edit("mont.cu", name, w) for name in ("MUL_WARPS", "POW_WARPS")]


def run_tile_edits(tile: int) -> list[tuple[str, str, int]]:
    """cyc_exp.cu with cyc_square_run on tiles of `tile` packed rows (8 /
    tile blocks per SM)."""
    return [constant_edit("cyc_exp.cu", "RUN_TILE", tile)]


def cyclotomic(rng: np.random.Generator, rows: int, dev: torch.device) -> torch.Tensor:
    """(rows, 12, 128) random elements of the cyclotomic subgroup, as the
    final exponentiation's easy part leaves them."""
    ints = np.empty((2 * rows, 12), dtype=object)
    for idx in np.ndindex(ints.shape):
        ints[idx] = int.from_bytes(rng.bytes(48), "little") % rm.P
    f = torch.from_numpy(fp.encode(ints)).to(dev)
    t0 = tower.mul(tower.conjugate(f), tower.inv(f))
    return tower.mul(tower.frobenius_pow(t0, 2), t0).contiguous()


def edited(src: Path, edits: list[tuple[str, str, int]]) -> str:
    text = src.read_text()
    for anchor, replacement, count in edits:
        found = text.count(anchor)
        if found != count:
            raise RuntimeError(f"{src.name}: {anchor!r} occurs {found} times, "
                               f"the probe expects {count}")
        text = text.replace(anchor, replacement)
    return text


def nvcc(sources: dict[str, str]) -> dict:
    """Build each source text (name -> text) into build/kernel_probe/, one
    nvcc each, all started together; the loaded libraries by name."""
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            cuda_build.nvcc_command(src, OUT / f"lib{name}.so", OUT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    return {name: ctypes.CDLL(str(OUT / f"lib{name}.so")) for name in sources}


def time_ms(fn, reps: int = 20) -> float:
    """The median over five samples of `reps` queued calls, per call; the
    stream is held busy for about 10 ms first, so that the host has queued
    them all before the first one starts (short launches would otherwise
    time the host's enqueue)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.01 * 1.98e9))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def probe_redesigns(libs: dict, dev: torch.device) -> None:
    """Section 7: the limb mont_mul before and after its warp design, the
    mont_pow chain against the chain of mont_mul launches it replaces, and
    cyc_square_run on 2- and 4-row tiles."""
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = lambda: P(torch.cuda.current_stream().cuda_stream)
    rows, warps = 2048, (1, 2, 4, 8)
    rng = np.random.default_rng(77)
    a, b = (torch.from_numpy(rng.integers(0, LC.SEMI_DIG + 1, (rows, 48), dtype=np.int32))
            for _ in range(2))
    for t in (a, b):
        t[:, -1] %= int(LC.P_LIMBS[-1])
    a, b = a.to(dev), b.to(dev)
    out = torch.empty_like(a)

    def mul(lib, x, y, dst, n=rows):
        err = lib.limb_mont_mul_launch(P(x.data_ptr()), S(48), P(y.data_ptr()), S(48),
                                       P(dst.data_ptr()), I(n), stream())
        assert err == 0, err

    want = lmont.mont_mul_plain(a, b)
    designs = {"block design (before)": libs["mont_mul_block"],
               **{f"warp design, {w} warp(s) per block": libs[f"mul_warps{w}"]
                  for w in warps}}
    for name, lib in designs.items():
        out.zero_()
        mul(lib, a, b, out)
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"mont_mul's {name} disagrees with mont_mul_plain"
        print(f"[mont_mul] {name}: {time_ms(lambda: mul(lib, a, b, out), 50):.4f} ms "
              f"at ({rows}, 48)")

    # mont_pow for p - 2 against fp.pow_static's chain of mont_mul launches
    e = rm.P - 2
    bits = lmont.pow_bits(e)
    steps = e.bit_length() - 1 + bin(e).count("1") - 1
    pow_want = lmont.mont_pow_plain(a, e)
    bufs = [torch.empty_like(a) for _ in range(2)]

    def chain(lib, n):
        """fp.pow_static's products, one launch each, into two buffers in
        turn."""
        src, k = a, 0
        for i in range(e.bit_length() - 2, -1, -1):
            for square in (True, False) if (e >> i) & 1 else (True,):
                dst = bufs[k % 2]
                mul(lib, src, src if square else a, dst, n)
                src, k = dst, k + 1
        return src

    def pow_run(lib, n):
        err = lib.limb_mont_pow_launch(P(a.data_ptr()), S(48), P(a.data_ptr()), S(48),
                                       P(ctypes.addressof(bits)), P(out.data_ptr()), I(n),
                                       stream())
        assert err == 0, err

    for name, lib in (("block design", libs["mont_mul_block"]),
                      ("warp design", libs["mul_warps4"])):
        got = chain(lib, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, pow_want), f"the chain of {name} mont_mul disagrees"
        ms, one = (time_ms(lambda n=n: chain(lib, n), 1) for n in (rows, 1))
        print(f"[mont_pow] {steps} mont_mul launches, {name}: {ms:.4f} ms at ({rows}, 48), "
              f"{one:.4f} ms for one row ({one / steps * 1e3:.3f} us per step)")
    cyc = (ctypes.c_longlong * 8)()
    lib = libs["mont_stamped"]
    for n in (1, rows):
        lib.mont_stamp_read(cyc)  # zero the counters
        pow_run(lib, n)
        torch.cuda.synchronize()
        assert torch.equal(out[:n], pow_want[:n]), "the stamped mont_pow disagrees"
        lib.mont_stamp_read(cyc)
        per = [cyc[k] / steps for k in range(len(MONT_PHASES))]
        print(f"[mont_pow split] cycles per dependent product (p - 2, {steps} products, "
              f"row 0 of {n}, stamps on): total {sum(per):.1f}")
        for label, c in zip(MONT_PHASES, per):
            print(f"[mont_pow split]   {label:36s} {c:8.1f}")
    for w in warps:
        lib = libs[f"mul_warps{w}"]
        out.zero_()
        pow_run(lib, rows)
        torch.cuda.synchronize()
        assert torch.equal(out, pow_want), f"mont_pow at {w} warps per block disagrees"
        ms, one = (time_ms(lambda n=n: pow_run(lib, n), 5) for n in (rows, 1))
        print(f"[mont_pow] p - 2 in one launch, {w} warp(s) per block: {ms:.4f} ms at "
              f"({rows}, 48) ({ms / steps * 1e3:.3f} us per step), {one:.4f} ms for one "
              f"row ({one / steps * 1e3:.3f} us per step)")

    # conv_quads' unroll factor: mont_pow, mont_mul and mont_reduce, and the
    # limb tower kernel (whose warp reductions run it), by factor
    cols = torch.stack([lmont.conv_plain(a, b)] * 12, dim=1)  # (rows, 12, 95)
    hi = lmont.MUL_COL_HI
    npass = lmont.first_pass_count(0, hi)
    red_want = lmont.mont_reduce_plain(cols, 0, hi)
    red_out = torch.empty_like(red_want)
    f12 = torch.from_numpy(rng.integers(0, LC.SEMI_DIG + 1, (rows, 12, 48), dtype=np.int32))
    f12[..., -1] %= int(LC.P_LIMBS[-1])
    f12 = f12.to(dev)
    tower_want = ltower.fq12_cyclotomic_square_plain(f12)
    tower_out = torch.empty_like(f12)
    for u in (1, 2, 4):
        lib, tlib = libs[f"mont_unroll{u}"], libs[f"limb_tower_unroll{u}"]
        red = lambda lib=lib: lib.limb_mont_reduce_launch(
            P(cols.data_ptr()), S(95), I(95), I(npass), P(red_out.data_ptr()), I(rows * 12),
            stream())
        sq = lambda tlib=tlib: tlib.limb_fq12_cyclotomic_square_launch(
            P(f12.data_ptr()), S(12 * 48), P(tower_out.data_ptr()), I(rows), stream())
        mul(lib, a, b, out)
        assert red() == 0 and sq() == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(red_out, red_want), u
        assert torch.equal(tower_out, tower_want), u
        out.zero_()
        pow_run(lib, rows)
        torch.cuda.synchronize()
        assert torch.equal(out, pow_want), u
        print(f"[conv_quads] unroll {u}: mont_pow {time_ms(lambda: pow_run(lib, rows), 5):.4f} ms "
              f"at ({rows}, 48), {time_ms(lambda: pow_run(lib, 1), 5):.4f} for one row; "
              f"mont_mul {time_ms(lambda: mul(lib, a, b, out), 50):.4f}; mont_reduce "
              f"({rows}, 12, 95) {time_ms(red, 50):.4f}; limb_fq12_cyclotomic_square "
              f"({rows}, 12, 48) {time_ms(sq, 50):.4f} ms")

    # cyc_square_run's tiles at the path's shape
    run_rows = 1024
    cyc = cyclotomic(rng, run_rows, dev)
    cyc_out = torch.empty_like(cyc)
    lengths = tuple(n for n, _ in _GS_SEGMENTS)
    wants = {n: kernels.cyc_square_run_plain(cyc, n) for n in set(lengths) | {32}}
    for tile in (2, 4):
        lib = libs[f"run_tile{tile}"]

        def run(n, lib=lib):
            err = lib.cyc_square_run_launch(P(cyc.data_ptr()), P(cyc_out.data_ptr()),
                                            I(run_rows), I(n), stream())
            assert err == 0, err

        times = {}
        for n in sorted(wants):
            run(n)
            torch.cuda.synchronize()
            assert torch.equal(cyc_out, wants[n]), f"cyc_square_run on {tile}-row tiles"
            times[n] = time_ms(lambda n=n: run(n), 10)
        print(f"[cyc_square_run] tiles of {tile} packed rows ({8 // tile} blocks per SM): "
              f"n = 32 {times[32]:.4f} ms at ({run_rows}, 12, 128); the runs {lengths} "
              + ", ".join(f"{times[n]:.4f}" for n in lengths)
              + f" ms, sum {sum(times[n] for n in lengths):.4f} ms")


def probe_karabina_tiles(libs: dict, dev: torch.device) -> None:
    """Section 8: kara_exp.cu's two walks on 2- and 4-row tiles at the
    paths' shape, each held to its plain version."""
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = lambda: P(torch.cuda.current_stream().cuda_stream)
    rows = 1024
    cyc = cyclotomic(np.random.default_rng(8), rows, dev)
    cyc[1] = tower.one((), dev)  # a zero compressed state
    c = tower.compress_cyclotomic(cyc).contiguous()
    segs = torch.tensor(_KARA_SEGMENTS, dtype=torch.int32, device=dev)
    snaps = torch.empty((len(_KARA_SEGMENTS), *c.shape), dtype=torch.int32, device=dev)
    run_out = torch.empty_like(c)
    snaps_want = kernels.kara_exp_plain(c, _KARA_SEGMENTS)
    lengths = tuple(_KARA_SEGMENTS)
    wants = {n: kernels.kara_square_run_plain(c, n) for n in set(lengths) | {32}}
    for tile in (2, 4):
        lib = libs[f"kara_tile{tile}"]

        def chain(lib=lib):
            err = lib.kara_exp_launch(P(c.data_ptr()), P(snaps.data_ptr()), I(rows),
                                      P(segs.data_ptr()), I(segs.numel()), stream())
            assert err == 0, err

        def run(n, lib=lib):
            err = lib.kara_square_run_launch(P(c.data_ptr()), P(run_out.data_ptr()), I(rows),
                                             I(n), stream())
            assert err == 0, err

        snaps.zero_()
        chain()
        torch.cuda.synchronize()
        assert torch.equal(snaps, snaps_want), f"kara_exp on {tile}-row tiles"
        times = {}
        for n in sorted(wants):
            run(n)
            torch.cuda.synchronize()
            assert torch.equal(run_out, wants[n]), f"kara_square_run on {tile}-row tiles"
            times[n] = time_ms(lambda n=n: run(n), 10)
        print(f"[kara_exp] tiles of {tile} packed rows ({8 // tile} blocks per SM): kara_exp "
              f"{time_ms(chain, 10):.4f} ms at ({rows}, 8, 128), segments {lengths}; "
              f"kara_square_run n = 32 {times[32]:.4f} ms; the runs {lengths} "
              + ", ".join(f"{times[n]:.4f}" for n in lengths)
              + f" ms, sum {sum(times[n] for n in lengths):.4f} ms")


#: Section 9's launchers: one kernel that writes its launch's tag, launched
#: with 64 KB of dynamic shared memory (above the default 48 KB, so that the
#: attribute is needed), after the runtime calls each launcher names.
CAPTURE_PROBE = r"""
#include <cuda_runtime.h>

__global__ void tag_kernel(int* out, int tag) {
  extern __shared__ int s[];
  s[threadIdx.x] = tag;
  __syncthreads();
  if (threadIdx.x == 0) out[0] = s[0];
}

constexpr int SMEM = 64 * 1024;

static int launch(int* out, int tag, void* stream) {
  tag_kernel<<<1, 32, SMEM, static_cast<cudaStream_t>(stream)>>>(out, tag);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_setup() {
  return static_cast<int>(cudaFuncSetAttribute(
      tag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
}

extern "C" int probe_plain(int* out, int tag, void* stream) { return launch(out, tag, stream); }

extern "C" int probe_query(int* out, int tag, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(out, tag, stream);
}

extern "C" int probe_attr(int* out, int tag, void* stream) {
  const int err = probe_setup();
  if (err != 0) return err;
  return launch(out, tag, stream);
}
"""


def probe_capture(lib: ctypes.CDLL, dev: torch.device) -> None:
    """Section 9: each launcher called eagerly, then captured into a CUDA
    graph (torch.cuda.graph, capture_error_mode "global") and replayed; what
    the capture made of it."""
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    assert lib.probe_setup() == 0
    for tag, name in enumerate(("probe_plain", "probe_query", "probe_attr"), start=1):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        assert fn(out.data_ptr(), tag, torch.cuda.current_stream().cuda_stream) == 0, name
        torch.cuda.synchronize()
        assert int(out.item()) == tag, name
        out.zero_()
        graph, codes = torch.cuda.CUDAGraph(), []
        try:
            with torch.cuda.graph(graph):
                codes.append(fn(out.data_ptr(), 10 + tag,
                                torch.cuda.current_stream().cuda_stream))
            graph.replay()
            torch.cuda.synchronize()
            verdict = (f"captured (launcher returned {codes[0]}), the replay wrote "
                       f"{int(out.item())} (expected {10 + tag})")
        except RuntimeError as e:  # the capture refused: what it said
            verdict = f"refused: launcher returned {codes}, {str(e).splitlines()[0]}"
        torch.cuda.synchronize()
        print(f"[capture] {name}: {verdict}")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sections = {int(x) for x in sys.argv[1:]} or set(range(1, 10))
    if sections & {1, 2, 3}:
        sections |= {1, 2, 3}
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    OUT.mkdir(parents=True, exist_ok=True)
    for name, text in cuda_build.headers().items():
        (OUT / name).write_text(text)
    pow_src, tower_src = CSRC / "pow_static.cu", CSRC / "limb_tower.cu"
    warps = (1, 2, 4, 8)
    mont_warps = (1, 2, 4, 8, 16)
    sources = {
        1: {"block_pow": BLOCK_POW,
            "pow_stamped": edited(pow_src, POW_STAMP_EDITS),
            **{f"pow_warps{w}": edited(pow_src, [("constexpr int WARPS = 1;",
                                                  f"constexpr int WARPS = {w};", 1)])
               for w in warps}},
        4: {f"tower_stop{k}": edited(tower_src, tower_stop_edits(k)) for k in (1, 2, 3)},
        5: {**{f"mont_warps{w}": edited(CSRC / "mont.cu", mont_warps_edits(w))
               for w in mont_warps},
            **{f"conv_stop{k}": edited(CSRC / "mont.cu", conv_stop_edits(k)) for k in (1, 2)},
            **{f"conv_blocks{n}": edited(CSRC / "mont.cu", conv_blocks_edits(n))
               for n in (6, 8)}},
        6: {name: edited(CSRC / "kara_full.cu", edits) for name, edits in KF_VARIANTS.items()},
        7: {"mont_mul_block": BLOCK_MONT_MUL, "mont_stamped": mont_stamped(),
            **{f"{src}_unroll{u}": with_common(f"{src}.cu", quads_unroll(u))
               for src in ("mont", "limb_tower") for u in (1, 2, 4)},
            **{f"mul_warps{w}": edited(CSRC / "mont.cu", mul_warps_edits(w)) for w in warps},
            **{f"run_tile{t}": edited(CSRC / "cyc_exp.cu", run_tile_edits(t))
               for t in (2, 4)}},
        8: {f"kara_tile{t}": edited(CSRC / "kara_exp.cu",
                                    [constant_edit("kara_exp.cu", "TILE", t)])
            for t in (2, 4)},
        9: {"capture_probe": CAPTURE_PROBE},
    }
    libs = nvcc({name: text for k, srcs in sources.items() if k in sections
                 for name, text in srcs.items()})
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = lambda: P(torch.cuda.current_stream().cuda_stream)
    rows = 2048

    if 1 in sections:
        rng = np.random.default_rng(7)
        e = rm.P - 2
        steps = len(fp.exponent_bits(e)) + sum(fp.exponent_bits(e))
        vals = [int.from_bytes(rng.bytes(48), "little") % rm.P for _ in range(256)]
        a = torch.from_numpy(fp.encode(vals)).to(dev)
        bits = torch.tensor(fp.exponent_bits(e), dtype=torch.int32, device=dev)
        want = fp.pow_static(a, e)

        def pow_run(lib, launch: str, out: torch.Tensor, rows: int) -> None:
            # pow_static_launch takes the recording build's steps after out
            # (null: the plain chain)
            rec = (P(None),) if launch == "pow_static_launch" else ()
            err = getattr(lib, launch)(P(a.data_ptr()), P(out.data_ptr()), *rec, I(rows),
                                       P(bits.data_ptr()), I(bits.numel()), stream())
            assert err == 0, (launch, err)

        def pow_times(name: str, lib, launch: str) -> None:
            out = torch.empty_like(a)
            pow_run(lib, launch, out, a.shape[0])
            torch.cuda.synchronize()
            assert torch.equal(out, want), f"{name} disagrees with fp.pow_static"
            ms = time_ms(lambda: pow_run(lib, launch, out, a.shape[0]))
            one = time_ms(lambda: pow_run(lib, launch, out, 1))
            print(f"[pow] {name}: {ms:.4f} ms at {tuple(a.shape)}, {one:.4f} ms for one row "
                  f"({one / steps * 1e3:.3f} us per step)")

        # 1. before and after, timed alike; 3. warps per block
        pow_times("block design (before)", libs["block_pow"], "block_pow_launch")
        for w in warps:
            pow_times(f"warp design, {w} warp(s) per block", libs[f"pow_warps{w}"],
                      "pow_static_launch")

        # 2. the split of a step
        cyc = (ctypes.c_longlong * 8)()
        for name, lib, launch, read in (
                ("block", libs["block_pow"], "block_stamped_launch", "block_stamped_cycles"),
                ("warp", libs["pow_stamped"], "pow_static_launch", "pow_stamped_cycles")):
            out = torch.empty_like(a[:1])
            getattr(lib, read)(cyc)  # zero the counters
            pow_run(lib, launch, out, 1)
            torch.cuda.synchronize()
            assert torch.equal(out, want[:1]), f"the stamped {name} kernel disagrees"
            getattr(lib, read)(cyc)
            per = [cyc[k] / steps for k in range(len(PHASES))]
            print(f"[pow split] {name} design, cycles per dependent step (p - 2, {steps} "
                  f"steps, one row, stamps on): total {sum(per):.1f}")
            for label, c in zip(PHASES, per):
                print(f"[pow split]   {label:32s} {c:8.1f}")
            ms = time_ms(lambda: pow_run(lib, launch, out, 1))
            print(f"[pow split] {name} design with stamps, one row: {ms:.4f} ms "
                  f"({ms / steps * 1e3:.3f} us per step)")

    if 4 in sections:
        rng = np.random.default_rng(4)
        # 4. the limb tower kernel, and the time of its first stages alone
        la = torch.from_numpy(rng.integers(0, 259, (rows, 12, 48), dtype=np.int32)).to(dev)
        lb = torch.from_numpy(rng.integers(0, 259, (rows, 12, 48), dtype=np.int32)).to(dev)
        la[..., -1] %= int(LC.P_LIMBS[-1])
        lb[..., -1] %= int(LC.P_LIMBS[-1])
        ld = lb[:, :6].contiguous()
        for name in ltower.FORMULAS:
            second, n = {"mul": (lb, 12), "mul_by_014": (ld, 6)}.get(name, (None, 0))
            args = (la,) if second is None else (la, second)
            plain = getattr(ltower, f"fq12_{name}_plain")(*args)
            run = lambda: getattr(ltower, f"fq12_{name}")(*args)
            assert torch.equal(run(), plain), name
            sink = torch.empty_like(la)
            ptrs = [P(la.data_ptr()), ctypes.c_longlong(12 * 48)]
            if second is not None:
                ptrs += [P(second.data_ptr()), ctypes.c_longlong(n * 48)]
            stages = []
            for k in (1, 2, 3):
                entry = getattr(libs[f"tower_stop{k}"], f"limb_fq12_{name}_launch")
                ms = time_ms(lambda: entry(*ptrs, P(sink.data_ptr()), I(rows), stream()))
                stages.append(f"stages 1-{k} {ms:.4f} ms")
            print(f"[tower] limb_fq12_{name} at ({rows}, 12, 48): {time_ms(run):.4f} ms; "
                  f"{', '.join(stages)}")
        for line in cuda_build.build_log.get("limb_tower.cu", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] limb_tower.cu: {line.strip()}")

    if 5 in sections:
        rng = np.random.default_rng(5)
        # 5. mont.cu's warp kernels by warps per block
        sa = torch.from_numpy(rng.integers(0, 517, (rows, 30, 2, 48), dtype=np.int32)).to(dev)
        pairs = [(sa[:, j, 0], sa[:, j, 1]) for j in range(30)]  # row stride 30 * 2 * 48
        arg = lmont._ConvPairs()
        for j, (x, y) in enumerate(pairs):
            arg.a[j], arg.b[j] = x.data_ptr(), y.data_ptr()
            arg.sa[j] = arg.sb[j] = x.stride(0)
        conv_out = torch.empty((30, rows, 95), dtype=torch.int32, device=dev)
        conv_want = torch.stack([lmont.conv_plain(x, y) for x, y in pairs])
        # (rows, 12, 95)
        cols = torch.stack([lmont.conv_plain(x, y) for x, y in pairs[:12]], dim=1)
        hi = 48 * 516 * 516
        npass = lmont.first_pass_count(0, hi)
        def conv(lib, k, per_warp=0):
            err = lib.limb_conv_launch(P(ctypes.addressof(arg)), I(k), P(conv_out.data_ptr()),
                                       I(rows), I(per_warp or lmont.conv_rows_per_warp(k, rows)),
                                       stream())
            assert err == 0, err

        def conv_checked(lib, per_warp=0):
            conv_out.zero_()
            conv(lib, 30, per_warp)
            torch.cuda.synchronize()
            return torch.equal(conv_out, conv_want)

        for w in mont_warps:
            lib = libs[f"mont_warps{w}"]
            assert conv_checked(lib), f"conv at {w} warps per block"
            times = [time_ms(lambda: conv(lib, 30)), time_ms(lambda: conv(lib, 1))]
            for n in (12, 2):
                red_in = cols[:, :n].contiguous()
                red_out = torch.empty((rows, n, 48), dtype=torch.int32, device=dev)
                red = lambda: lib.limb_mont_reduce_launch(
                    P(red_in.data_ptr()), ctypes.c_longlong(95), I(95), I(npass),
                    P(red_out.data_ptr()), I(rows * n), stream())
                assert red() == 0
                torch.cuda.synchronize()
                assert torch.equal(red_out, lmont.mont_reduce_plain(red_in, 0, hi)), (w, n)
                times.append(time_ms(red))
            print(f"[mont] {w} warp(s) per block: conv 30 pairs {times[0]:.4f} ms, one pair "
                  f"{times[1]:.4f} ms; mont_reduce (2048, 12, 95) {times[2]:.4f} ms, "
                  f"(2048, 2, 95) {times[3]:.4f} ms")
        lib = libs["mont_warps8"]  # conv as shipped
        for n in range(1, lmont.CONV_ROWS_PER_WARP + 1):
            assert conv_checked(lib, n), f"conv at {n} rows per warp"
            print(f"[mont] conv 30 pairs at {n} row(s) per warp: "
                  f"{time_ms(lambda: conv(lib, 30, n)):.4f} ms (the rule's: "
                  f"{lmont.conv_rows_per_warp(30, rows)})")
        for k, label in ((1, "the loads, staging and stores alone"),
                         (2, "without the atomic adds")):
            print(f"[mont] conv 30 pairs, {label}: "
                  f"{time_ms(lambda: conv(libs[f'conv_stop{k}'], 30)):.4f} ms")
        for n in (6, 8):
            lib = libs[f"conv_blocks{n}"]
            assert conv_checked(lib), f"conv at {n} blocks per SM"
            print(f"[mont] conv with launch bounds for {n} blocks per SM: 30 pairs "
                  f"{time_ms(lambda: conv(lib, 30)):.4f} ms, one pair "
                  f"{time_ms(lambda: conv(lib, 1)):.4f} ms")

    if 6 in sections:
        rng = np.random.default_rng(6)
        # 6. kara_full's designs at the path's shape, on cyclotomic rows with the
        # identity in a whole row and in one slot
        kf_rows, four_rows = 1024, 4
        cyc = cyclotomic(rng, kf_rows, dev)
        one = tower.one((), dev)
        cyc[1] = one
        cyc[2, :, RC.SUB:] = one[:, RC.SUB:]
        kf_want = kernels.kara_full_plain(cyc, _KARA_SEGMENTS)
        segs = torch.tensor(_KARA_SEGMENTS, dtype=torch.int32, device=dev)
        kbits = torch.tensor(fp.exponent_bits(rm.P - 2), dtype=torch.int32, device=dev)
        scratch = torch.empty((kf_rows, kernels._KARA_FULL_SCRATCH, RC.LANES), dtype=torch.int32,
                              device=dev)
        kf_out = torch.empty_like(cyc)

        def kf(lib, n):
            err = lib.kara_full_launch(P(cyc.data_ptr()), P(kf_out.data_ptr()),
                                       P(scratch.data_ptr()), I(n), P(segs.data_ptr()),
                                       I(segs.numel()), P(kbits.data_ptr()), I(kbits.numel()),
                                       stream())
            assert err == 0, err

        kf_ms = {}
        for name in KF_VARIANTS:
            kf(libs[name], kf_rows)
            torch.cuda.synchronize()
            exact = name not in ("kf_noinv", "kf_chain")
            assert not exact or torch.equal(kf_out, kf_want), (
                f"{name} disagrees with its plain version")
            kf_ms[name] = time_ms(lambda: kf(libs[name], kf_rows), 10)
            four = time_ms(lambda: kf(libs[name], four_rows), 20)
            note = "rows those of kara_full_plain" if exact else "cut short: timing only"
            print(f"[kara_full] {name}: {kf_ms[name]:.4f} ms at ({kf_rows}, 12, 128), "
                  f"{four:.4f} ms at ({four_rows}, 12, 128) ({note})")
        rest = kf_ms["kf_noinv"]
        for name in ("kf_tile", "kf_tile4", "kf_tile4_1blk", "kf_warp", "kf_warp4",
                     "kf_warp4_1blk"):
            print(f"[kara_full] {name}: the inversion {kf_ms[name] - rest:.4f} ms of "
                  f"{kf_ms[name]:.4f}; the rest {rest:.4f} ms, the chain alone "
                  f"{kf_ms['kf_chain']:.4f}")

    if 7 in sections:
        probe_redesigns(libs, dev)
    if 8 in sections:
        probe_karabina_tiles(libs, dev)
    if 9 in sections:
        probe_capture(libs["capture_probe"], dev)
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
