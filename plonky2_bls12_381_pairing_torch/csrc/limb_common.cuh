// Device functions shared by the limb tier's kernels (mont.cu,
// limb_tower.cu): the 48 x 48 limb convolution and the scan-free Montgomery
// reduction (R = 2^408) on radix-2^8 int32 limbs, block-wide (mont.cu's
// mont_mul) and on one warp (mont.cu's conv and mont_reduce, limb_tower.cu).
//
// The block-wide form lays work out as the TPU kernels lay out their lanes:
// one thread per column ("lane", 128 of them: 95 convolution columns, 100
// working columns of the reduction, the rest zero), a group of 128 threads
// per row. A block holds GROUPS groups (threadIdx.y); every group runs the
// same static sequence of steps, so the block-wide barriers inside are
// uniform.
//
// Everything is exact integer arithmetic in int32: `>>` on a negative int is
// arithmetic and `&` two's-complement, as in the plain PyTorch versions. The
// shift-add pass counts are part of the result and come from limb_tables.h
// or from the caller, never from the data.

#pragma once

#include <cuda_runtime.h>

#include "limb_tables.h"

namespace limb {

constexpr int NLIMBS = LIMB_NLIMBS;  // 48
constexpr int NRED = LIMB_NRED;      // 51
constexpr int NCOLS = LIMB_NCOLS;    // 95
constexpr int LANES = LIMB_LANES;    // 128
constexpr int GROUPS = 4;            // rows per block

// Scratch of one group: two lane buffers.
struct Scratch {
  int a[LANES];
  int b[LANES];
};

// Column `lane` of the convolution of two 48-limb operands in shared memory:
// sum_i x[i] * y[lane - i]. Exact while 48 * x_max * y_max < 2^31.
__device__ __forceinline__ int conv_column(const int* x, const int* y, int lane) {
  int acc = 0;
  if (lane < NCOLS) {
    const int lo = lane < NLIMBS ? 0 : lane - (NLIMBS - 1);
    const int hi = lane < NLIMBS ? lane : NLIMBS - 1;
    for (int i = lo; i <= hi; ++i) acc += x[i] * y[lane - i];
  }
  return acc;
}

// n shift-add passes over the group's 128 lanes: each lane keeps its low 8
// bits and takes the lane below's carry; the top lane's carry is dropped.
// Value-preserving mod 2^(8 * 128). Block-wide barriers: every thread of the
// block calls this with the same n.
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

// Scan-free Montgomery reduction of one row: `col` is this lane's signed
// column (0 beyond the row's columns), `npass` the static pass count of the
// first stage for the row's column bounds. Returns the lane's digit of the
// weakly reduced result (lanes < 48; digits <= 258, value < 2p), 0 elsewhere.
//   t = passes(col + bias)                  bias row: K_BIAS * p, digits >= 2^30
//   m = passes(t[:51] * p' mod R)           lanes < 51
//   s = passes(t + m * p)
//   q = [sum_k s[k] * 2^(8k) mod 65521 == R mod 65521]   low half is 0 or R
//   result = s[51:99], + q at lane 0
// Every thread of the block must call it (block-wide barriers inside).
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
    int qsum = 0;  // < 51 * 258 * 65521 < 2^31, non-negative
    for (int k = 0; k < NRED; ++k) qsum += sc.a[k] * LIMB_QW[k];
    res += (qsum % LIMB_QMOD) == LIMB_R_MOD_QMOD ? 1 : 0;
  }
  __syncthreads();  // the scratch is free again
  return res;
}

// ---------------------------------------------------------------------------
// The warp-synchronous reduction (mont.cu's mont_reduce, limb_tower.cu)
// ---------------------------------------------------------------------------
//
// The same reduction, steps and pass counts as mont_reduce_lanes, on one
// warp: thread j holds columns 4j .. 4j + 3 of the 128 in registers. A
// shift-add pass is a local step plus one __shfl_up_sync of the thread
// below's top column. The products by p' and p give each thread its own
// four columns too (conv_strip), reading t and m from the warp's shared
// scratch behind __syncwarp. The quotient test's sum is a warp reduction
// (an exact integer sum, so its order is free). No barrier spans more than
// the warp.

constexpr int WARP = 32;
constexpr int COLS_PER_THREAD = LANES / WARP;  // 4
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int PAD = 4;  // zeros before digit 0 of a padded constant row

// Scratch of one warp's reduction: t (later s) and m, 128 columns each
// (16-byte aligned: store4 writes them).
struct alignas(16) WarpScratch {
  int t[LANES];
  int m[LANES];
};

// p and p' digits in shared memory, read by every warp of the block, with
// zeros around them as far as conv_strip's windows reach (digits -3 .. 50
// of p, -3 .. 51 of p').
struct LimbConsts {
  int p[PAD + NLIMBS + 4];
  int pprime[PAD + NRED + 5];
};

__device__ __forceinline__ void load_consts(LimbConsts& k, int tid, int threads) {
  constexpr int NP = PAD + NLIMBS + 4, NQ = PAD + NRED + 5;
  for (int i = tid; i < NP + NQ; i += threads) {
    if (i < NP) {
      const int d = i - PAD;
      k.p[i] = d >= 0 && d < NLIMBS ? LIMB_P[d] : 0;
    } else {
      const int d = i - NP - PAD;
      k.pprime[i - NP] = d >= 0 && d < NRED ? LIMB_PPRIME[d] : 0;
    }
  }
}

// Four adjacent columns of a convolution: acc[q] += x[i] * y[c + q - i]
// over lo <= i <= hi (y readable, zero where it has no digit, from
// c - hi - 1 to c + 3 - lo). A window of four y digits slides down by one
// per term: two shared loads for four multiply-adds.
__device__ __forceinline__ void conv_strip(const int* x, const int* y, int c, int lo, int hi,
                                           int (&acc)[4]) {
  const int* w = y + c - lo;
  int w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
#pragma unroll 4
  for (int i = lo; i <= hi; ++i) {
    const int xi = x[i];
    acc[0] += xi * w0;
    acc[1] += xi * w1;
    acc[2] += xi * w2;
    acc[3] += xi * w3;
    w3 = w2;
    w2 = w1;
    w1 = w0;
    w0 = *(--w);
  }
}

__device__ __forceinline__ void store4(int* dst, const int (&v)[4]) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

// n shift-add passes over the warp's 128 columns (v: this thread's four);
// the top column's carry is dropped, as in `passes`.
__device__ __forceinline__ void warp_passes(int (&v)[4], int lane, int n) {
  for (int i = 0; i < n; ++i) {
    int below = __shfl_up_sync(FULL_MASK, v[3], 1);
    if (lane == 0) below = 0;
    v[3] = (v[3] & 255) + (v[2] >> 8);
    v[2] = (v[2] & 255) + (v[1] >> 8);
    v[1] = (v[1] & 255) + (v[0] >> 8);
    v[0] = (v[0] & 255) + (below >> 8);
  }
}

// mont_reduce_lanes on one warp: x holds this thread's four signed columns
// (0 beyond the row's columns). Writes the 48 digits of the weakly reduced
// result to out[0..47] (lanes < 16 store two each).
__device__ __forceinline__ void mont_reduce_warp(int (&x)[4], int lane, WarpScratch& ws,
                                                 const LimbConsts& k, int npass,
                                                 int* __restrict__ out) {
  const int c0 = COLS_PER_THREAD * lane;
  // t = passes(col + bias)
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] += LIMB_BIAS[c0 + q];
  warp_passes(x, lane, npass);
  store4(&ws.t[c0], x);
  __syncwarp();

  // m = passes(t[:51] * p' mod R): column c < 51 sums t[i] p'[c - i] over
  // i <= c (column 51 of thread 12's strip is dropped). Threads j < 13 take
  // the low half of strip j's terms, threads 16 + j the high half, whose
  // sums join over one shuffle each.
  int m[4] = {0, 0, 0, 0};
  {
    const int j = lane % (WARP / 2), cm = COLS_PER_THREAD * j;
    const int hi = min(cm + 3, NRED - 1), mid = hi / 2;
    if (cm < NRED) {
      if (lane < WARP / 2) {
        conv_strip(ws.t, k.pprime + PAD, cm, 0, mid, m);
      } else {
        conv_strip(ws.t, k.pprime + PAD, cm, mid + 1, hi, m);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] += __shfl_xor_sync(FULL_MASK, m[q], WARP / 2);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = c0 + q < NRED ? m[q] : 0;
  warp_passes(m, lane, LIMB_NPASS_M);
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = c0 + q < NRED ? m[q] : 0;  // mod R
  store4(&ws.m[c0], m);
  __syncwarp();

  // s = passes(t + m * p): column c < 98 of m * p sums m[j] p[c - j] over
  // max(0, c - 47) <= j <= min(c, 50); columns 98 .. 127 are 0
  conv_strip(ws.m, k.p + PAD, c0, max(0, c0 - (NLIMBS - 1)), min(c0 + 3, NRED - 1), x);
  warp_passes(x, lane, LIMB_NPASS_S);

  // q = [sum_k s[k] 2^(8k) mod 65521 == R mod 65521] over the 51 low
  // columns: each partial and the sum < 51 * 258 * 65521 < 2^31
  int qsum = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) qsum += c0 + q < NRED ? x[q] * LIMB_QW[c0 + q] : 0;
#pragma unroll
  for (int d = WARP / 2; d > 0; d /= 2) qsum += __shfl_xor_sync(FULL_MASK, qsum, d);

  // result = s[51:99], + q at digit 0
  store4(&ws.t[c0], x);  // t was last read before the m columns' __syncwarp
  __syncwarp();
  for (int l = lane; l < NLIMBS; l += WARP) {
    out[l] = ws.t[l + NRED] + (l == 0 && qsum % LIMB_QMOD == LIMB_R_MOD_QMOD ? 1 : 0);
  }
}

}  // namespace limb
