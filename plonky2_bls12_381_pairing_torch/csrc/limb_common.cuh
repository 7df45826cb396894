// Device functions shared by the limb tier's kernels (mont.cu,
// limb_tower.cu): the 48 x 48 limb convolution and the scan-free Montgomery
// reduction (R = 2^408) on radix-2^8 int32 limbs.
//
// Work is laid out as the TPU kernels lay out their lanes: one thread per
// column ("lane", 128 of them: 95 convolution columns, 100 working columns
// of the reduction, the rest zero), a group of 128 threads per row. A block
// holds LIMB_GROUPS groups (threadIdx.y); every group runs the same static
// sequence of steps, so the block-wide barriers inside are uniform.
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

}  // namespace limb
