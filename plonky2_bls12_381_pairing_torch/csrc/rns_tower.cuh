// Fq6/Fq12 tower formulas on residues, shared by the RNS kernels
// (cyc_exp.cu, kara_exp.cu, kara_full.cu, miller.cu, tower_ops.cu,
// easy_part.cu). Each Fq12 op takes the thread's 12 residues, computes the
// formula of ops/rns/tower.py lane by lane with canonical residues, adds the
// bias rows its plain formula adds before the REDC (rns_tables.h) and ends in
// one 12-row REDC; the Karabina squaring does the same on 8, the Frobenius
// map on 10.
//
// A bias argument points at the thread's entry of the first of 12 rows that
// lie BS ints apart: a register array (BS = 1) or a table of bias rows at
// the thread's lane (BS = SUB; the kernels copy theirs into shared memory).
// The formulas take the reduction's shared memory as a type S and end in
// the redc that S selects: TcSmem<R>, the tensor-core tile of R packed rows
// of rns_redc_tc.cuh, on which every RNS Fq12 kernel runs (cyc_exp,
// kara_exp, kara_full, tower_ops, miller).
#pragma once

#include "rns_redc_tc.cuh"

namespace rns {

// Bias rows, then the stacked reduction, in place: the redc of the type of
// s.
template <int BS, class S>
__device__ __forceinline__ void bias_redc(int (&a)[12], const F2 (&outs)[6], const Lane& c,
                                          S& s, const int* bias) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    a[2 * i] = add_m(outs[i].c0, bias[(2 * i) * BS], c);
    a[2 * i + 1] = add_m(outs[i].c1, bias[(2 * i + 1) * BS], c);
  }
  redc<12>(a, c, s);
}

// Granger-Scott squaring (tower.cyclotomic_square): the Fq4 squares of
// (z0, z1), (z2, z3), (z4, z5), recombined with 3*t -/+ 2*z and one REDC.
__device__ __forceinline__ void fp4_square(F2 a, F2 b, F2& r0, F2& r1, const Lane& c) {
  const F2 t0 = f2_mul(a, a, c);
  const F2 t1 = f2_mul(b, b, c);
  const F2 ab = f2_add(a, b, c);
  const F2 t2 = f2_sub(f2_sub(f2_mul(ab, ab, c), t0, c), t1, c);
  r0 = f2_add(f2_nonres(t1, c), t0, c);
  r1 = t2;
}

template <int BS, class S>
__device__ __forceinline__ void cyc_square(int (&a)[12], const Lane& c, S& s,
                                           const int* bias) {
  const F2 z0{a[0], a[1]}, z4{a[2], a[3]}, z3{a[4], a[5]};
  const F2 z2{a[6], a[7]}, z1{a[8], a[9]}, z5{a[10], a[11]};
  F2 t0_01, t1_01, t0_23, t1_23, t2_45, t3_45;
  fp4_square(z0, z1, t0_01, t1_01, c);
  fp4_square(z2, z3, t0_23, t1_23, c);
  fp4_square(z4, z5, t2_45, t3_45, c);
  const F2 nz0 = f2_sub(f2_scale(t0_01, 3, c), f2_scale(f2_lift(z0, c), 2, c), c);
  const F2 nz1 = f2_add(f2_scale(t1_01, 3, c), f2_scale(f2_lift(z1, c), 2, c), c);
  const F2 nz4 = f2_sub(f2_scale(t0_23, 3, c), f2_scale(f2_lift(z4, c), 2, c), c);
  const F2 nz5 = f2_add(f2_scale(t1_23, 3, c), f2_scale(f2_lift(z5, c), 2, c), c);
  const F2 nz2 = f2_add(f2_scale(f2_nonres(t3_45, c), 3, c),
                        f2_scale(f2_lift(z2, c), 2, c), c);
  const F2 nz3 = f2_sub(f2_scale(t2_45, 3, c), f2_scale(f2_lift(z3, c), 2, c), c);
  const F2 outs[6] = {nz0, nz4, nz3, nz2, nz1, nz5};
  bias_redc<BS>(a, outs, c, s, bias);
}

// Karabina compressed squaring (tower.compressed_square) of g = (g2, g3, g4,
// g5): with B45 = g4 g5, t45 = g4^2 + xi g5^2 = (g4 + g5)(g4 + xi g5) - B45 -
// xi B45 (and B23, t23 alike), the outputs are h2 = 2 g2 + 6 xi B45, h3 =
// 3 t45 - 2 g3, h4 = 3 t23 - 2 g4, h5 = 2 g5 + 6 B23, the bare g lifted into
// the product domain, and one 8-row REDC.
template <int BS, class S>
__device__ __forceinline__ void kara_square(int (&g)[8], const Lane& c, S& s,
                                            const int* bias) {
  const F2 g2{g[0], g[1]}, g3{g[2], g[3]}, g4{g[4], g[5]}, g5{g[6], g[7]};
  const F2 b45 = f2_mul(g4, g5, c);
  const F2 a45 = f2_mul(f2_add(g4, g5, c), f2_add(g4, f2_nonres(g5, c), c), c);
  const F2 b23 = f2_mul(g2, g3, c);
  const F2 a23 = f2_mul(f2_add(g2, g3, c), f2_add(g2, f2_nonres(g3, c), c), c);
  const F2 xb45 = f2_nonres(b45, c);
  const F2 t45 = f2_sub(f2_sub(a45, b45, c), xb45, c);
  const F2 t23 = f2_sub(f2_sub(a23, b23, c), f2_nonres(b23, c), c);
  const F2 h[4] = {
      f2_add(f2_scale(f2_lift(g2, c), 2, c), f2_scale(xb45, 6, c), c),
      f2_sub(f2_scale(t45, 3, c), f2_scale(f2_lift(g3, c), 2, c), c),
      f2_sub(f2_scale(t23, 3, c), f2_scale(f2_lift(g4, c), 2, c), c),
      f2_add(f2_scale(f2_lift(g5, c), 2, c), f2_scale(b23, 6, c), c),
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g[2 * i] = add_m(h[i].c0, bias[(2 * i) * BS], c);
    g[2 * i + 1] = add_m(h[i].c1, bias[(2 * i + 1) * BS], c);
  }
  redc<8>(g, c, s);
}

// Fq6 = Fq2[v]/(v^3 - xi) Karatsuba product (tower._fq6_mul).
__device__ __forceinline__ void fq6_mul(const F2 (&a)[3], const F2 (&b)[3], F2 (&r)[3],
                                        const Lane& c) {
  const F2 t0 = f2_mul(a[0], b[0], c);
  const F2 t1 = f2_mul(a[1], b[1], c);
  const F2 t2 = f2_mul(a[2], b[2], c);
  const F2 m12 = f2_mul(f2_add(a[1], a[2], c), f2_add(b[1], b[2], c), c);
  const F2 m01 = f2_mul(f2_add(a[0], a[1], c), f2_add(b[0], b[1], c), c);
  const F2 m02 = f2_mul(f2_add(a[0], a[2], c), f2_add(b[0], b[2], c), c);
  r[0] = f2_add(t0, f2_nonres(f2_sub(f2_sub(m12, t1, c), t2, c), c), c);
  r[1] = f2_add(f2_sub(f2_sub(m01, t0, c), t1, c), f2_nonres(t2, c), c);
  r[2] = f2_add(f2_sub(f2_sub(m02, t0, c), t2, c), t1, c);
}

// Sparse Fq6 product with b0 + b1 v (tower._fq6_mul_by_01).
__device__ __forceinline__ void fq6_mul_by_01(const F2 (&a)[3], F2 b0, F2 b1, F2 (&r)[3],
                                              const Lane& c) {
  const F2 t0 = f2_mul(a[0], b0, c);
  const F2 t1 = f2_mul(a[1], b1, c);
  const F2 m12 = f2_mul(f2_add(a[1], a[2], c), b1, c);
  const F2 m01 = f2_mul(f2_add(a[0], a[1], c), f2_add(b0, b1, c), c);
  const F2 t2 = f2_mul(a[2], b0, c);
  r[0] = f2_add(f2_nonres(f2_sub(m12, t1, c), c), t0, c);
  r[1] = f2_sub(f2_sub(m01, t0, c), t1, c);
  r[2] = f2_add(t2, t1, c);
}

// Sparse Fq6 product with b1 v (tower._fq6_mul_by_1): (xi a2 b1, a0 b1, a1 b1).
__device__ __forceinline__ void fq6_mul_by_1(const F2 (&a)[3], F2 b1, F2 (&r)[3],
                                             const Lane& c) {
  r[0] = f2_nonres(f2_mul(a[2], b1, c), c);
  r[1] = f2_mul(a[0], b1, c);
  r[2] = f2_mul(a[1], b1, c);
}

// The two Fq6 halves of an Fq12 element.
__device__ __forceinline__ void split(const int (&a)[12], F2 (&a0)[3], F2 (&a1)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a0[i] = {a[2 * i], a[2 * i + 1]};
    a1[i] = {a[6 + 2 * i], a[7 + 2 * i]};
  }
}

// Fq12 = Fq6[w]/(w^2 - v) Karatsuba product (tower.mul): a <- a * b.
template <int BS, class S>
__device__ __forceinline__ void fq12_mul(int (&a)[12], const int (&b)[12], const Lane& c,
                                         S& s, const int* bias) {
  F2 a0[3], a1[3], b0[3], b1[3], as[3], bs[3];
  split(a, a0, a1);
  split(b, b0, b1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    as[i] = f2_add(a0[i], a1[i], c);
    bs[i] = f2_add(b0[i], b1[i], c);
  }
  F2 t0[3], t1[3], t01[3];
  fq6_mul(a0, b0, t0, c);
  fq6_mul(a1, b1, t1, c);
  fq6_mul(as, bs, t01, c);
  // out0 = t0 + v t1 with v (x0, x1, x2) = (xi x2, x0, x1); out1 = t01 - t0 - t1
  const F2 outs[6] = {
      f2_add(t0[0], f2_nonres(t1[2], c), c),
      f2_add(t0[1], t1[0], c),
      f2_add(t0[2], t1[1], c),
      f2_sub(f2_sub(t01[0], t0[0], c), t1[0], c),
      f2_sub(f2_sub(t01[1], t0[1], c), t1[1], c),
      f2_sub(f2_sub(t01[2], t0[2], c), t1[2], c),
  };
  bias_redc<BS>(a, outs, c, s, bias);
}

// Complex squaring (tower.square): with ab = a0 a1 and st = (a0 + a1)(a0 + v a1),
// out0 = st - ab - v ab, out1 = 2 ab.
template <int BS, class S>
__device__ __forceinline__ void fq12_square(int (&a)[12], const Lane& c, S& s,
                                            const int* bias) {
  F2 a0[3], a1[3];
  split(a, a0, a1);
  const F2 sm[3] = {f2_add(a0[0], a1[0], c), f2_add(a0[1], a1[1], c),
                    f2_add(a0[2], a1[2], c)};
  const F2 t[3] = {f2_add(a0[0], f2_nonres(a1[2], c), c), f2_add(a0[1], a1[0], c),
                   f2_add(a0[2], a1[1], c)};
  F2 ab[3], st[3];
  fq6_mul(a0, a1, ab, c);
  fq6_mul(sm, t, st, c);
  const F2 outs[6] = {
      f2_sub(f2_sub(st[0], ab[0], c), f2_nonres(ab[2], c), c),
      f2_sub(f2_sub(st[1], ab[1], c), ab[0], c),
      f2_sub(f2_sub(st[2], ab[2], c), ab[1], c),
      f2_add(ab[0], ab[0], c),
      f2_add(ab[1], ab[1], c),
      f2_add(ab[2], ab[2], c),
  };
  bias_redc<BS>(a, outs, c, s, bias);
}

// Sparse product with (d0 + d1 v) + (d4 v) w (tower.mul_by_014): with
// aa = a0 (d0 + d1 v), bb = a1 (d4 v), t1 = (a0 + a1)(d0 + (d1 + d4) v),
// out0 = v bb + aa, out1 = t1 - aa - bb.
template <int BS, class S>
__device__ __forceinline__ void fq12_mul_by_014(int (&a)[12], F2 d0, F2 d1, F2 d4,
                                                const Lane& c, S& s,
                                                const int* bias) {
  F2 a0[3], a1[3];
  split(a, a0, a1);
  const F2 as[3] = {f2_add(a0[0], a1[0], c), f2_add(a0[1], a1[1], c),
                    f2_add(a0[2], a1[2], c)};
  F2 aa[3], bb[3], t1[3];
  fq6_mul_by_01(a0, d0, d1, aa, c);
  fq6_mul_by_1(a1, d4, bb, c);
  fq6_mul_by_01(as, d0, f2_add(d1, d4, c), t1, c);
  const F2 outs[6] = {
      f2_add(f2_nonres(bb[2], c), aa[0], c),
      f2_add(bb[0], aa[1], c),
      f2_add(bb[1], aa[2], c),
      f2_sub(f2_sub(t1[0], aa[0], c), bb[0], c),
      f2_sub(f2_sub(t1[1], aa[1], c), bb[1], c),
      f2_sub(f2_sub(t1[2], aa[2], c), bb[2], c),
  };
  bias_redc<BS>(a, outs, c, s, bias);
}

// One Frobenius power (tower.frobenius_map_plain): component pairs 1..5
// conjugated (4p - c1) and scaled by their gamma constants (RNS_FROB at the
// thread's lane l) in one 10-row REDC, pair 0 conjugated without a product.
template <int BS, class S>
__device__ __forceinline__ void frobenius(int (&a)[12], int l, const Lane& c, S& s,
                                          const int* bias) {
  const int pmul4 = RNS_PMUL4[l];
  int x[10];
#pragma unroll
  for (int i = 1; i < 6; ++i) {
    const F2 conj{a[2 * i], sub_m(pmul4, a[2 * i + 1], c)};
    const F2 g{RNS_FROB[2 * i - 2][l], RNS_FROB[2 * i - 1][l]};
    const F2 p = f2_mul(conj, g, c);
    x[2 * i - 2] = add_m(p.c0, bias[(2 * i - 2) * BS], c);
    x[2 * i - 1] = add_m(p.c1, bias[(2 * i - 1) * BS], c);
  }
  redc<10>(x, c, s);
  a[1] = sub_m(pmul4, a[1], c);
#pragma unroll
  for (int k = 0; k < 10; ++k) a[2 + k] = x[k];
}

// The thread's entry of a bias table of rns_tables.h.
__device__ __forceinline__ const int* bias_at(const int (*table)[SUB], int l) {
  return &table[0][l];
}

// Loads and stores of one packed row of 12 components; rows lie `stride`
// ints apart, components LANES apart.
__device__ __forceinline__ void load12(int (&f)[12], const int* base, long long stride,
                                       size_t row, int lane) {
  const int* p = base + row * stride + lane;
#pragma unroll
  for (int k = 0; k < 12; ++k) f[k] = p[k * LANES];
}

__device__ __forceinline__ F2 load2(const int* base, long long stride, size_t row, int lane) {
  const int* p = base + row * stride + lane;
  return {p[0], p[LANES]};
}

__device__ __forceinline__ void store12(const int (&f)[12], int* base, size_t row, int lane) {
  int* p = base + row * 12 * LANES + lane;
#pragma unroll
  for (int k = 0; k < 12; ++k) p[k * LANES] = f[k];
}

}  // namespace rns
