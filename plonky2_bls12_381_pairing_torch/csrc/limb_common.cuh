// Device functions shared by the limb tier's kernels (mont.cu,
// limb_tower.cu): the scan-free Montgomery reduction (R = 2^408) of a row's
// columns on one warp, on radix-2^8 int32 limbs, and the 4-column strips of
// a convolution (by term, and by groups of four terms) it is built from.
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

// ---------------------------------------------------------------------------
// The warp-synchronous reduction (mont.cu, limb_tower.cu)
// ---------------------------------------------------------------------------
//
// The reduction of the plain version (ops/fp.py mont_reduce_scanfree), on
// 128 working columns:
//   t = passes(col + bias)                  bias row: K_BIAS * p, digits >= 2^30
//   m = passes(t[:51] * p' mod R)           columns < 51
//   s = passes(t + m * p)
//   q = [sum_k s[k] * 2^(8k) mod 65521 == R mod 65521]   low half is 0 or R
//   result = s[51:99], + q at digit 0 (digits <= 258, value < 2p)
// where a shift-add pass keeps each column's low 8 bits and adds the
// column below's carry (the top column's carry is dropped). On one warp:
// thread j holds columns 4j .. 4j + 3 of the 128 in registers. A
// shift-add pass is a local step plus one __shfl_up_sync of the thread
// below's top column. The products by p' and p give each thread its own
// four columns too (conv_quads), reading t and m from the warp's shared
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
// zeros around them as far as conv_quads' windows reach (digits -4 .. 55 of
// either; 16-byte aligned at digit 0).
struct alignas(16) LimbConsts {
  int p[PAD + NLIMBS + 8];
  int pprime[PAD + NRED + 5];
};

__device__ __forceinline__ void load_consts(LimbConsts& k, int tid, int threads) {
  constexpr int NP = PAD + NLIMBS + 8, NQ = PAD + NRED + 5;
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

// The same four columns over the n groups of four terms lo .. lo + 4n - 1,
// lo and c multiples of 4 (x + lo and y + c - lo 16-byte aligned; y
// readable, zero where it has no digit, from c - lo - 4n to c - lo + 3):
// per group one 16-byte load of x and one of the next four y digits, for
// 16 multiply-adds, and the loads of a group do not wait for the last one's
// sums.
__device__ __forceinline__ void conv_quads(const int* x, const int* y, int c, int lo, int n,
                                           int (&acc)[4]) {
  const int4* xv = reinterpret_cast<const int4*>(x + lo);
  const int* yd = y + c - lo;
  int4 h = *reinterpret_cast<const int4*>(yd);  // y[d .. d + 3], d = c - lo - 4k
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const int4 u = xv[k];
    const int4 l = *reinterpret_cast<const int4*>(yd - 4 * k - 4);  // y[d - 4 .. d - 1]
    acc[0] += u.x * h.x + u.y * l.w + u.z * l.z + u.w * l.y;
    acc[1] += u.x * h.y + u.y * h.x + u.z * l.w + u.w * l.z;
    acc[2] += u.x * h.z + u.y * h.y + u.z * h.x + u.w * l.w;
    acc[3] += u.x * h.w + u.y * h.z + u.z * h.y + u.w * h.x;
    h = l;
  }
}

__device__ __forceinline__ void store4(int* dst, const int (&v)[4]) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

// n shift-add passes over the warp's 128 columns (v: this thread's four);
// the top column's carry is dropped.
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

// The reduction on one warp: x holds this thread's four signed columns
// (0 beyond the row's columns), npass is the static pass count of the first
// stage for the row's column bounds. Writes the 48 digits of the weakly reduced
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
  // i <= c. Strip j < 13 takes its terms in groups of four up to term
  // min(c + 3, 50) (the last group of strip 12 reaches term 51, which meets
  // only column 51, dropped with the rest of the column); thread j takes
  // the first half of the groups, thread 16 + j the rest, and their sums
  // join over one shuffle each.
  int m[4] = {0, 0, 0, 0};
  {
    const int j = lane % (WARP / 2), cm = COLS_PER_THREAD * j;
    const int groups = cm < NRED ? min(cm + 3, NRED - 1) / 4 + 1 : 0, half = (groups + 1) / 2;
    const int first = lane < WARP / 2 ? 0 : half;
    conv_quads(ws.t, k.pprime + PAD, cm, 4 * first,
               lane < WARP / 2 ? half : groups - half, m);
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
  // max(0, c - 47) <= j <= min(c, 50); columns 98 .. 127 are 0. In groups
  // of four terms from the multiple of 4 below the first: the terms added
  // below it meet p's zeros beyond digit 47, those beyond 50 m's zeros.
  {
    const int lo = max(0, c0 - (NLIMBS - 1)) & ~3, hi = min(c0 + 3, NRED - 1);
    conv_quads(ws.m, k.p + PAD, c0, lo, hi >= lo ? (hi - lo) / 4 + 1 : 0, x);
  }
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
