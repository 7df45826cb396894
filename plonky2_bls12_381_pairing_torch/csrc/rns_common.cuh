// Device code shared by the RNS kernels: per-lane Barrett reduction,
// arithmetic on canonical residues, and the Fq2 helpers. The RNS Montgomery
// reduction (REDC) that mixes the lanes is the tensor-core tile's
// (rns_redc_tc.cuh) or, in pow_static.cu, one warp's.
//
// Layout: a thread holds one lane's residue of every value; the 128 lanes
// of a packed row are two field elements, 64 lanes each. Only REDC mixes
// lanes, and only within a 64-lane slot.
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

}  // namespace rns
