// Device code shared by the RNS kernels: per-lane Barrett reduction,
// arithmetic on canonical residues, the Fq2 helpers, and the RNS Montgomery
// reduction (REDC) with its two base extensions.
//
// Layout: one thread per lane, 128 threads (one packed row of two field
// elements, 64 lanes each) per block. A thread holds its lane's residue of
// every value. Only REDC mixes lanes, and only within a 64-lane slot.
//
// Exactness: every value a thread holds is a canonical residue in [0, m)
// of its lane's modulus m (the padding lane has m = 1 and holds 0). A REDC
// output depends only on the residues of its input integer X, so computing
// X lane by lane modulo m gives the same stored row as the plain PyTorch
// formulas, which reach X through lazy int32 sums. The bias multiple k*p
// each plain formula adds before its REDC is a static decision of its bound
// tracking; it arrives as a residue row of the generated header
// rns_tables.h (ops/rns/kernel_tables.py).
#pragma once

#include <cuda_runtime.h>

#include "rns_tables.h"

namespace rns {

constexpr int LANES = RNS_LANES;
constexpr int SUB = RNS_SUB;
constexpr int PACK = RNS_PACK;
constexpr int NCH = RNS_NCH;

// Per-lane constants of one thread, held in registers.
struct Lane {
  int m;
  float inv_m;
  int c_sigma, c_mainv, c_pmainv, c_mamod;
  int c_mainv_mbinv, c_pmainv_mbinv, c_mbmod, ma_modp;
  bool is_a;
};

__device__ __forceinline__ Lane load_lane(int l) {
  Lane c;
  c.m = RNS_M[l];
  c.inv_m = RNS_INV_M[l];
  c.c_sigma = RNS_C_SIGMA[l];
  c.c_mainv = RNS_C_MAINV[l];
  c.c_pmainv = RNS_C_PMAINV[l];
  c.c_mamod = RNS_C_MAMOD[l];
  c.c_mainv_mbinv = RNS_C_MAINV_MBINV[l];
  c.c_pmainv_mbinv = RNS_C_PMAINV_MBINV[l];
  c.c_mbmod = RNS_C_MBMOD[l];
  c.ma_modp = RNS_MA_MODP[l];
  c.is_a = RNS_IS_A[l] != 0;
  return c;
}

// x mod m for |x| < 2^31 - 2^27, canonical in [0, m). The same steps as
// fp.barrett: an unfused float32 product, rounded half to even (which is
// why this file must not be built with --use_fast_math).
__device__ __forceinline__ int barrett(int x, const Lane& c) {
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(x), c.inv_m));
  const int r = x - q * c.m;
  return r < 0 ? r + c.m : r;
}

__device__ __forceinline__ int add_m(int a, int b, const Lane& c) {
  const int r = a + b;
  return r >= c.m ? r - c.m : r;
}

__device__ __forceinline__ int sub_m(int a, int b, const Lane& c) {
  const int r = a - b;
  return r < 0 ? r + c.m : r;
}

// Product of two canonical residues: below 7167^2 < 2^26, inside Barrett's
// domain.
__device__ __forceinline__ int mul_m(int a, int b, const Lane& c) {
  return barrett(a * b, c);
}

// ---------------------------------------------------------------------------
// Fq2 = Fp[u]/(u^2 + 1) on residues
// ---------------------------------------------------------------------------

struct F2 {
  int c0, c1;
};

__device__ __forceinline__ F2 f2_add(F2 a, F2 b, const Lane& c) {
  return {add_m(a.c0, b.c0, c), add_m(a.c1, b.c1, c)};
}

__device__ __forceinline__ F2 f2_sub(F2 a, F2 b, const Lane& c) {
  return {sub_m(a.c0, b.c0, c), sub_m(a.c1, b.c1, c)};
}

__device__ __forceinline__ F2 f2_scale(F2 a, int k, const Lane& c) {
  return {mul_m(a.c0, k, c), mul_m(a.c1, k, c)};
}

// Karatsuba: (a0 b0 - a1 b1, (a0 + a1)(b0 + b1) - a0 b0 - a1 b1).
__device__ __forceinline__ F2 f2_mul(F2 a, F2 b, const Lane& c) {
  const int t0 = mul_m(a.c0, b.c0, c);
  const int t1 = mul_m(a.c1, b.c1, c);
  const int ts = mul_m(add_m(a.c0, a.c1, c), add_m(b.c0, b.c1, c), c);
  return {sub_m(t0, t1, c), sub_m(sub_m(ts, t0, c), t1, c)};
}

// (u + 1) * x = (x0 - x1) + (x0 + x1) u.
__device__ __forceinline__ F2 f2_nonres(F2 x, const Lane& c) {
  return {sub_m(x.c0, x.c1, c), add_m(x.c0, x.c1, c)};
}

// A stored element lifted into the product domain (times MA mod p).
__device__ __forceinline__ F2 f2_lift(F2 x, const Lane& c) {
  return {mul_m(x.c0, c.ma_modp, c), mul_m(x.c1, c.ma_modp, c)};
}

// ---------------------------------------------------------------------------
// REDC
// ---------------------------------------------------------------------------

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

}  // namespace rns
