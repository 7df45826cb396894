// The G2 line steps on residues: point doubling with its tangent line and
// mixed addition with its chord line (ops/rns/lines.py doubling_step and
// addition_step), stage by stage, each stage ending in one stacked REDC.
//
// As in rns_tower.cuh, a thread holds its lane's canonical residue of every
// value, and a stage's REDC inputs are the plain formula's integers modulo
// the lane's modulus: the same polynomial in the same stored residues, plus
// the bias multiple k*p the plain formula's bound tracking adds to each
// input row (the RNS_DBL*_BIAS / RNS_ADD_*_BIAS rows of rns_tables.h,
// kernel_tables.line_biases). The plain formula's .canon() and .scale(k)
// change no residue beyond the multiplication by k, and its zero with
// tmp5's bounds (tmp5_w[0].scale(0)) is the residue 0. A value the plain
// formula keeps wide (before its REDC) for a later stage is kept here as
// its unreduced residue.
//
// With SCALE (scale=(py, px) in the plain formulas) the ell coefficients
// come out scaled, (c0 P.y, c1 P.x, c2): the scaling rides the last stage's
// REDC. Every thread of the block runs every stage (each REDC has
// barriers); the stages do not depend on the data.
#pragma once

#include "rns_tower.cuh"

namespace rns {

// A projective G2 point (x, y, z) and an affine one (x, y).
struct G2P {
  F2 x, y, z;
};

struct G2A {
  F2 x, y;
};

// One line: (c0, c1, c2) stored, or (c0 P.y, c1 P.x, c2) with SCALE.
struct Line {
  F2 c0, c1, c2;
};

// Bias rows of a stacked REDC: the thread's residue of k*p for each row.
template <int K>
__device__ __forceinline__ void add_bias(int (&x)[K], const int (*table)[SUB], int l,
                                         const Lane& c) {
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = add_m(x[k], table[k][l], c);
}

__device__ __forceinline__ F2 f2_sq(F2 a, const Lane& c) { return f2_mul(a, a, c); }

__device__ __forceinline__ F2 f2_at(const int* x, int i) { return {x[2 * i], x[2 * i + 1]}; }

__device__ __forceinline__ void put2(int* x, int i, F2 v) {
  x[2 * i] = v.c0;
  x[2 * i + 1] = v.c1;
}

// The scaling rows (c0 P.y, c1 P.x) of a line into x[2..5].
__device__ __forceinline__ void put_scaled(int* x, F2 c0, F2 c1, int py, int px,
                                           const Lane& c) {
  put2(x, 1, f2_scale(c0, py, c));
  put2(x, 2, f2_scale(c1, px, c));
}

// r <- 2r, and the tangent line at r (lines.py doubling_step).
template <bool SCALE, class S>
__device__ __forceinline__ Line doubling_step(G2P& r, int py, int px, const Lane& c, S& s,
                                              int l) {
  // stage 1: x^2, y^2, z^2, z_out = (z + y)^2 - y^2 - z^2 (8 rows)
  const F2 tmp0 = f2_sq(r.x, c), tmp1 = f2_sq(r.y, c), zsq = f2_sq(r.z, c);
  const F2 zout = f2_sub(f2_sub(f2_sq(f2_add(r.z, r.y, c), c), tmp1, c), zsq, c);
  int s1[8];
  put2(s1, 0, tmp0);
  put2(s1, 1, tmp1);
  put2(s1, 2, zsq);
  put2(s1, 3, zout);
  add_bias(s1, RNS_DBL1_BIAS, l, c);
  redc<8>(s1, c, s);
  const F2 tmp1s = f2_at(s1, 1), zsqs = f2_at(s1, 2), zouts = f2_at(s1, 3);
  const F2 tmp4 = f2_scale(f2_at(s1, 0), 3, c);  // 3 x^2
  const F2 tmp6 = f2_add(tmp4, r.x, c);

  // stage 2: x_out = tmp5 - 2 tmp3, tmp3 = 2 ((y^2 + x)^2 - x^2 - y^4),
  // c0 = 2 z_out z^2, c1 = -2 tmp4 z^2, c2 = tmp6^2 - x^2 - tmp5 - 4 y^2
  // with tmp5 = tmp4^2 (10 rows)
  const F2 tmp2 = f2_sq(tmp1s, c);
  const F2 t13 = f2_sq(f2_add(tmp1s, r.x, c), c);
  const F2 tmp5 = f2_sq(tmp4, c);
  const F2 t66 = f2_sq(tmp6, c);
  const F2 t4z = f2_mul(tmp4, zsqs, c);
  const F2 tzz = f2_mul(zouts, zsqs, c);
  const F2 tmp3 = f2_scale(f2_sub(f2_sub(t13, tmp0, c), tmp2, c), 2, c);
  int s2[10];
  put2(s2, 0, f2_sub(tmp5, f2_scale(tmp3, 2, c), c));
  put2(s2, 1, tmp3);
  put2(s2, 2, f2_scale(tzz, 2, c));
  put2(s2, 3, f2_sub(F2{0, 0}, f2_scale(t4z, 2, c), c));
  put2(s2, 4, f2_sub(f2_sub(f2_sub(t66, tmp0, c), tmp5, c), f2_scale(tmp1, 4, c), c));
  add_bias(s2, RNS_DBL2_BIAS, l, c);
  redc<10>(s2, c, s);
  const F2 xouts = f2_at(s2, 0);

  // stage 3: y_out = (tmp3 - x_out) tmp4 - 8 y^4 (2 rows; with SCALE also
  // the scaling rows c0 P.y, c1 P.x: 6 rows)
  const F2 yout = f2_sub(f2_mul(f2_sub(f2_at(s2, 1), xouts, c), tmp4, c),
                         f2_scale(tmp2, 8, c), c);
  Line out;
  if constexpr (SCALE) {
    int s3[6];
    put2(s3, 0, yout);
    put_scaled(s3, f2_at(s2, 2), f2_at(s2, 3), py, px, c);
    add_bias(s3, RNS_DBL3S_BIAS, l, c);
    redc<6>(s3, c, s);
    r.y = f2_at(s3, 0);
    out = {f2_at(s3, 1), f2_at(s3, 2), f2_at(s2, 4)};
  } else {
    int s3[2];
    put2(s3, 0, yout);
    add_bias(s3, RNS_DBL3_BIAS, l, c);
    redc<2>(s3, c, s);
    r.y = f2_at(s3, 0);
    out = {f2_at(s2, 2), f2_at(s2, 3), f2_at(s2, 4)};
  }
  r.x = xouts;
  r.z = zouts;
  return out;
}

// r <- r + q, and the chord line through them (lines.py addition_step).
template <bool SCALE, class S>
__device__ __forceinline__ Line addition_step(G2P& r, const G2A& q, int py, int px,
                                              const Lane& c, S& s, int l) {
  // stage A: z^2, qy^2, u = (qy + z)^2 - qy^2 - z^2 (6 rows)
  const F2 zsq = f2_sq(r.z, c), ysq = f2_sq(q.y, c);
  int sa[6];
  put2(sa, 0, zsq);
  put2(sa, 1, ysq);
  put2(sa, 2, f2_sub(f2_sub(f2_sq(f2_add(q.y, r.z, c), c), ysq, c), zsq, c));
  add_bias(sa, RNS_ADD_A_BIAS, l, c);
  redc<6>(sa, c, s);

  // stage B: t0 = z^2 qx, t1 = u z^2 (4 rows)
  int sb[4];
  put2(sb, 0, f2_mul(f2_at(sa, 0), q.x, c));
  put2(sb, 1, f2_mul(f2_at(sa, 2), f2_at(sa, 0), c));
  add_bias(sb, RNS_ADD_B_BIAS, l, c);
  redc<4>(sb, c, s);
  const F2 t1s = f2_at(sb, 1);

  // stage C: t3 = t2^2, t9 = t6 qx, z_out = (z + t2)^2 - z^2 - t3 with
  // t2 = t0 - rx, t6 = t1 - 2 ry; t6^2 stays unreduced (6 rows)
  const F2 t2 = f2_sub(f2_at(sb, 0), r.x, c);
  const F2 t6 = f2_sub(t1s, f2_scale(r.y, 2, c), c);
  const F2 t3 = f2_sq(t2, c);
  const F2 t6sq = f2_sq(t6, c);
  int sc[6];
  put2(sc, 0, t3);
  put2(sc, 1, f2_mul(t6, q.x, c));
  put2(sc, 2, f2_sub(f2_sub(f2_sq(f2_add(r.z, t2, c), c), zsq, c), t3, c));
  add_bias(sc, RNS_ADD_C_BIAS, l, c);
  redc<6>(sc, c, s);
  const F2 t3s = f2_at(sc, 0), zouts = f2_at(sc, 2);

  // stage D: t5 = 4 t3 t2, t7 = 4 t3 rx, x_out = t6^2 - t5 - 2 t7,
  // c2 = 2 t9 - ((qy + z_out)^2 - qy^2 - z_out^2) (8 rows); the bare values
  // of c0 = 2 z_out and c1 = 4 ry - 2 t1 lifted into the product domain
  // (with SCALE they join this REDC: 12 rows)
  const F2 t5 = f2_scale(f2_mul(t3s, t2, c), 4, c);
  const F2 t7 = f2_scale(f2_mul(t3s, r.x, c), 4, c);
  const F2 t10b = f2_sub(f2_sub(f2_sq(f2_add(q.y, zouts, c), c), ysq, c), f2_sq(zouts, c), c);
  const F2 c0w = f2_scale(f2_lift(zouts, c), 2, c);
  const F2 c1w = f2_sub(f2_scale(f2_lift(r.y, c), 4, c), f2_scale(f2_lift(t1s, c), 2, c), c);
  int sd[SCALE ? 12 : 8];
  put2(sd, 0, t5);
  put2(sd, 1, t7);
  put2(sd, 2, f2_sub(f2_sub(t6sq, t5, c), f2_scale(t7, 2, c), c));
  put2(sd, 3, f2_sub(f2_scale(f2_lift(f2_at(sc, 1), c), 2, c), t10b, c));
  if constexpr (SCALE) {
    put2(sd, 4, c0w);
    put2(sd, 5, c1w);
    add_bias(sd, RNS_ADD_DS_BIAS, l, c);
  } else {
    add_bias(sd, RNS_ADD_D_BIAS, l, c);
  }
  redc<SCALE ? 12 : 8>(sd, c, s);
  const F2 xouts = f2_at(sd, 2);

  // stage E: y_out = (t7 - x_out) t6 - 2 ry t5, with c0 and c1 (6 rows;
  // with SCALE the rows c0 P.y and c1 P.x instead)
  const F2 yout = f2_sub(f2_mul(f2_sub(f2_at(sd, 1), xouts, c), t6, c),
                         f2_scale(f2_mul(r.y, f2_at(sd, 0), c), 2, c), c);
  int se[6];
  put2(se, 0, yout);
  if constexpr (SCALE) {
    put_scaled(se, f2_at(sd, 4), f2_at(sd, 5), py, px, c);
    add_bias(se, RNS_ADD_ES_BIAS, l, c);
  } else {
    put2(se, 1, c0w);
    put2(se, 2, c1w);
    add_bias(se, RNS_ADD_E_BIAS, l, c);
  }
  redc<6>(se, c, s);
  r = {xouts, f2_at(se, 0), zouts};
  return {f2_at(se, 1), f2_at(se, 2), f2_at(sd, 3)};
}

}  // namespace rns
