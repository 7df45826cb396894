// The PyTorch port's host oracle: BLS12-381 on the host CPU in C++.
//
// A fast, host-side, exact implementation of the whole pairing, used
//   * as the full-batch oracle that the port's device outputs are held to
//     (chip_smoke.py: all 2,048 pairings of a run),
//   * to make batched inputs fast (G1/G2 scalar multiplication:
//     chip_smoke.py's points, parallel/multihost.py run's points).
// The port's own copy of the JAX package's native tier, with the same
// algorithms, which mirror the port's utils/refmodel.py (the exact-integer
// oracle) one for one, so the Python-int, C++ and tensor tiers can be held to
// one another. Field core: 6 x 64-bit CIOS Montgomery, R = 2^384; the
// Fq2/Fq6/Fq12 tower, Granger-Scott squaring and the chain final
// exponentiation, the doubling_step / addition_step Miller loop, Jacobian
// scalar multiplication, batches split over std::thread.
//
// Exposed through a plain C ABI (bound with ctypes in __init__.py):
//   pairing_batch, multi_pairing_product, g1_mul_batch, g2_mul_batch,
//   fp_mul_batch, fp_inv_batch.
// All external values are *standard-form* little-endian 6x u64 limbs.
//
// Host C++, not a device kernel: built with g++, not nvcc. native.build()
// generates constants.inc (gen_constants.py) into build/native/<hash>/ and
// builds there:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -I <dir> bls12_381.cpp -o libbls.so

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

using u64 = uint64_t;
using u128 = unsigned __int128;

struct Fp {
  u64 v[6];
};
struct Fq2 {
  Fp c0, c1;
};

#include "constants.inc"

// ---------------------------------------------------------------------------
// Fp: 6x64 Montgomery (CIOS)
// ---------------------------------------------------------------------------

static inline bool fp_geq(const Fp &a, const Fp &b) {
  for (int i = 5; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

static inline void fp_sub_inner(Fp &out, const Fp &a, const Fp &b) {
  u64 borrow = 0;
  for (int i = 0; i < 6; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    out.v[i] = (u64)d;
    borrow = (u64)((d >> 64) & 1);
  }
}

static inline void fp_add(Fp &out, const Fp &a, const Fp &b) {
  u64 carry = 0;
  for (int i = 0; i < 6; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    out.v[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  // p < 2^381 so the 6-limb sum never overflows 2^384; reduce once if >= p
  if (carry || fp_geq(out, P_CONST)) fp_sub_inner(out, out, P_CONST);
}

static inline void fp_sub(Fp &out, const Fp &a, const Fp &b) {
  u64 borrow = 0;
  for (int i = 0; i < 6; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    out.v[i] = (u64)d;
    borrow = (u64)((d >> 64) & 1);
  }
  if (borrow) {
    u64 carry = 0;
    for (int i = 0; i < 6; ++i) {
      u128 s = (u128)out.v[i] + P_CONST.v[i] + carry;
      out.v[i] = (u64)s;
      carry = (u64)(s >> 64);
    }
  }
}

static inline void fp_neg(Fp &out, const Fp &a) {
  bool zero = true;
  for (int i = 0; i < 6; ++i) zero &= (a.v[i] == 0);
  if (zero) {
    out = a;
    return;
  }
  fp_sub_inner(out, P_CONST, a);
}

static void fp_mont_mul(Fp &out, const Fp &a, const Fp &b) {
  u64 t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 6; ++i) {
    u64 carry = 0;
    for (int j = 0; j < 6; ++j) {
      u128 s = (u128)a.v[i] * b.v[j] + t[j] + carry;
      t[j] = (u64)s;
      carry = (u64)(s >> 64);
    }
    u128 s = (u128)t[6] + carry;
    t[6] = (u64)s;
    t[7] = (u64)(s >> 64);

    u64 m = t[0] * PINV;
    u128 s2 = (u128)m * P_CONST.v[0] + t[0];
    carry = (u64)(s2 >> 64);
    for (int j = 1; j < 6; ++j) {
      u128 s3 = (u128)m * P_CONST.v[j] + t[j] + carry;
      t[j - 1] = (u64)s3;
      carry = (u64)(s3 >> 64);
    }
    u128 s4 = (u128)t[6] + carry;
    t[5] = (u64)s4;
    t[6] = t[7] + (u64)(s4 >> 64);
    t[7] = 0;
  }
  for (int i = 0; i < 6; ++i) out.v[i] = t[i];
  if (t[6] || fp_geq(out, P_CONST)) fp_sub_inner(out, out, P_CONST);
}

static inline void fp_sq(Fp &out, const Fp &a) { fp_mont_mul(out, a, a); }

static inline bool fp_is_zero(const Fp &a) {
  u64 acc = 0;
  for (int i = 0; i < 6; ++i) acc |= a.v[i];
  return acc == 0;
}

static const Fp FP_ZERO = {};

// a^e for a little-endian multiword exponent (Fermat inverse, sqrt, ...)
static void fp_pow(Fp &out, const Fp &a, const u64 *e, int ewords) {
  Fp acc = ONE_MONT, base = a;
  for (int w = 0; w < ewords; ++w) {
    u64 bits = e[w];
    for (int i = 0; i < 64; ++i) {
      if (bits & 1) fp_mont_mul(acc, acc, base);
      bits >>= 1;
      fp_sq(base, base);
    }
  }
  out = acc;
}

static void fp_inv(Fp &out, const Fp &a) {  // Fermat: a^(p-2); inv0(0) = 0
  Fp pm2;
  fp_sub_inner(pm2, P_CONST, {{2, 0, 0, 0, 0, 0}});
  fp_pow(out, a, pm2.v, 6);
}

static inline void fp_to_mont(Fp &out, const Fp &a_std) {
  fp_mont_mul(out, a_std, R2_CONST);
}
static inline void fp_from_mont(Fp &out, const Fp &a) {
  Fp one = {{1, 0, 0, 0, 0, 0}};
  fp_mont_mul(out, a, one);
}

// ---------------------------------------------------------------------------
// Fq2 = Fp[u] / (u^2 + 1)
// ---------------------------------------------------------------------------

static const Fq2 FQ2_ZERO = {};

static inline void f2_add(Fq2 &o, const Fq2 &a, const Fq2 &b) {
  fp_add(o.c0, a.c0, b.c0);
  fp_add(o.c1, a.c1, b.c1);
}
static inline void f2_sub(Fq2 &o, const Fq2 &a, const Fq2 &b) {
  fp_sub(o.c0, a.c0, b.c0);
  fp_sub(o.c1, a.c1, b.c1);
}
static inline void f2_neg(Fq2 &o, const Fq2 &a) {
  fp_neg(o.c0, a.c0);
  fp_neg(o.c1, a.c1);
}
static inline void f2_conj(Fq2 &o, const Fq2 &a) {
  o.c0 = a.c0;
  fp_neg(o.c1, a.c1);
}

static void f2_mul(Fq2 &o, const Fq2 &a, const Fq2 &b) {
  Fp t0, t1, s0, s1, r0;
  fp_mont_mul(t0, a.c0, b.c0);
  fp_mont_mul(t1, a.c1, b.c1);
  fp_add(s0, a.c0, a.c1);
  fp_add(s1, b.c0, b.c1);
  fp_sub(r0, t0, t1);  // c0 = a0b0 - a1b1
  Fp mid;
  fp_mont_mul(mid, s0, s1);
  fp_sub(mid, mid, t0);
  fp_sub(mid, mid, t1);  // c1 = (a0+a1)(b0+b1) - t0 - t1
  o.c0 = r0;
  o.c1 = mid;
}

static void f2_sq(Fq2 &o, const Fq2 &a) {
  Fp sum, dif, dbl;
  fp_add(sum, a.c0, a.c1);
  fp_sub(dif, a.c0, a.c1);
  fp_add(dbl, a.c0, a.c0);
  Fp c0, c1;
  fp_mont_mul(c0, sum, dif);   // a0^2 - a1^2
  fp_mont_mul(c1, dbl, a.c1);  // 2 a0 a1
  o.c0 = c0;
  o.c1 = c1;
}

static inline void f2_mul_nonres(Fq2 &o, const Fq2 &a) {  // *(u+1)
  Fp c0, c1;
  fp_sub(c0, a.c0, a.c1);
  fp_add(c1, a.c0, a.c1);
  o.c0 = c0;
  o.c1 = c1;
}

static void f2_inv(Fq2 &o, const Fq2 &a) {
  Fp n0, n1, norm, ninv;
  fp_sq(n0, a.c0);
  fp_sq(n1, a.c1);
  fp_add(norm, n0, n1);
  fp_inv(ninv, norm);
  fp_mont_mul(o.c0, a.c0, ninv);
  Fp t;
  fp_mont_mul(t, a.c1, ninv);
  fp_neg(o.c1, t);
}

static inline void f2_scale_fp(Fq2 &o, const Fq2 &a, const Fp &k) {
  fp_mont_mul(o.c0, a.c0, k);
  fp_mont_mul(o.c1, a.c1, k);
}

static inline bool f2_is_zero(const Fq2 &a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v] / (v^3 - (u+1)),  Fq12 = Fq6[w] / (w^2 - v)
// ---------------------------------------------------------------------------

struct Fq6 {
  Fq2 c0, c1, c2;
};
struct Fq12 {
  Fq6 c0, c1;
};

static inline void f6_add(Fq6 &o, const Fq6 &a, const Fq6 &b) {
  f2_add(o.c0, a.c0, b.c0);
  f2_add(o.c1, a.c1, b.c1);
  f2_add(o.c2, a.c2, b.c2);
}
static inline void f6_sub(Fq6 &o, const Fq6 &a, const Fq6 &b) {
  f2_sub(o.c0, a.c0, b.c0);
  f2_sub(o.c1, a.c1, b.c1);
  f2_sub(o.c2, a.c2, b.c2);
}
static inline void f6_neg(Fq6 &o, const Fq6 &a) {
  f2_neg(o.c0, a.c0);
  f2_neg(o.c1, a.c1);
  f2_neg(o.c2, a.c2);
}

static void f6_mul(Fq6 &o, const Fq6 &a, const Fq6 &b) {
  Fq2 t00, t11, t22, m01, m02, m12, x;
  f2_mul(t00, a.c0, b.c0);
  f2_mul(t11, a.c1, b.c1);
  f2_mul(t22, a.c2, b.c2);
  // m01 = a0 b1 + a1 b0 (Karatsuba), etc.
  Fq2 sA, sB;
  f2_add(sA, a.c0, a.c1);
  f2_add(sB, b.c0, b.c1);
  f2_mul(m01, sA, sB);
  f2_sub(m01, m01, t00);
  f2_sub(m01, m01, t11);
  f2_add(sA, a.c0, a.c2);
  f2_add(sB, b.c0, b.c2);
  f2_mul(m02, sA, sB);
  f2_sub(m02, m02, t00);
  f2_sub(m02, m02, t22);
  f2_add(sA, a.c1, a.c2);
  f2_add(sB, b.c1, b.c2);
  f2_mul(m12, sA, sB);
  f2_sub(m12, m12, t11);
  f2_sub(m12, m12, t22);

  f2_mul_nonres(x, m12);
  f2_add(o.c0, t00, x);  // c0 = t00 + xi*(a1b2 + a2b1)
  f2_mul_nonres(x, t22);
  f2_add(o.c1, m01, x);  // c1 = m01 + xi*t22
  f2_add(o.c2, m02, t11);  // c2 = m02 + t11
}

static void f6_sq(Fq6 &o, const Fq6 &a) { f6_mul(o, a, a); }

static void f6_mul_nonres(Fq6 &o, const Fq6 &a) {  // * v
  Fq2 t;
  f2_mul_nonres(t, a.c2);
  Fq2 old0 = a.c0, old1 = a.c1;
  o.c0 = t;
  o.c1 = old0;
  o.c2 = old1;
}

static void f6_mul_by_01(Fq6 &o, const Fq6 &a, const Fq2 &b0, const Fq2 &b1) {
  // sparse schoolbook: c0 = a0b0 + xi a2b1; c1 = a0b1 + a1b0; c2 = a2b0 + a1b1
  Fq2 t0, t1, x, a2b1, a0b1, a1b0, a2b0;
  f2_mul(t0, a.c0, b0);
  f2_mul(t1, a.c1, b1);
  f2_mul(a2b1, a.c2, b1);
  f2_mul_nonres(x, a2b1);
  f2_add(o.c0, t0, x);
  f2_mul(a0b1, a.c0, b1);
  f2_mul(a1b0, a.c1, b0);
  f2_add(o.c1, a0b1, a1b0);
  f2_mul(a2b0, a.c2, b0);
  f2_add(o.c2, a2b0, t1);
}

static void f6_mul_by_1(Fq6 &o, const Fq6 &a, const Fq2 &b1) {
  Fq2 t, x;
  f2_mul(t, a.c2, b1);
  f2_mul_nonres(x, t);
  Fq2 c1, c2;
  f2_mul(c1, a.c0, b1);
  f2_mul(c2, a.c1, b1);
  o.c0 = x;
  o.c1 = c1;
  o.c2 = c2;
}

static void f6_inv(Fq6 &o, const Fq6 &a) {
  // adjugate / norm (reference fq6_target_tree.rs:59-89 semantics)
  Fq2 t0, t1, t2, x, norm, ninv;
  f2_sq(t0, a.c0);
  f2_mul(x, a.c1, a.c2);
  f2_mul_nonres(x, x);
  f2_sub(t0, t0, x);  // t0 = a0^2 - xi a1 a2
  f2_sq(t1, a.c2);
  f2_mul_nonres(t1, t1);
  f2_mul(x, a.c0, a.c1);
  f2_sub(t1, t1, x);  // t1 = xi a2^2 - a0 a1
  f2_sq(t2, a.c1);
  f2_mul(x, a.c0, a.c2);
  f2_sub(t2, t2, x);  // t2 = a1^2 - a0 a2
  Fq2 y, z;
  f2_mul(y, a.c2, t1);
  f2_mul(z, a.c1, t2);
  f2_add(y, y, z);
  f2_mul_nonres(y, y);
  f2_mul(z, a.c0, t0);
  f2_add(norm, z, y);
  f2_inv(ninv, norm);
  f2_mul(o.c0, t0, ninv);
  f2_mul(o.c1, t1, ninv);
  f2_mul(o.c2, t2, ninv);
}

static void f6_frob(Fq6 &o, const Fq6 &a) {
  Fq2 t;
  f2_conj(o.c0, a.c0);
  f2_conj(t, a.c1);
  f2_mul(o.c1, t, FROB_G6_1);
  f2_conj(t, a.c2);
  f2_mul(o.c2, t, FROB_G6_2);
}

static const Fq6 FQ6_ZERO = {};

static void f12_one(Fq12 &o) {
  o.c0 = FQ6_ZERO;
  o.c1 = FQ6_ZERO;
  o.c0.c0.c0 = ONE_MONT;
}

static void f12_mul(Fq12 &o, const Fq12 &a, const Fq12 &b) {
  Fq6 t0, t1, s0, s1, x;
  f6_mul(t0, a.c0, b.c0);
  f6_mul(t1, a.c1, b.c1);
  f6_add(s0, a.c0, a.c1);
  f6_add(s1, b.c0, b.c1);
  f6_mul(x, s0, s1);
  f6_sub(x, x, t0);
  f6_sub(x, x, t1);
  Fq6 nr;
  f6_mul_nonres(nr, t1);
  f6_add(o.c0, t0, nr);
  o.c1 = x;
}

static void f12_sq(Fq12 &o, const Fq12 &a) {
  // complex squaring over Fq6
  Fq6 ab, s, t, nr;
  f6_mul(ab, a.c0, a.c1);
  f6_add(s, a.c0, a.c1);
  f6_mul_nonres(nr, a.c1);
  f6_add(t, a.c0, nr);
  Fq6 big;
  f6_mul(big, s, t);
  f6_sub(big, big, ab);
  f6_mul_nonres(nr, ab);
  f6_sub(big, big, nr);
  o.c0 = big;
  f6_add(o.c1, ab, ab);
}

static void f12_conj(Fq12 &o, const Fq12 &a) {
  o.c0 = a.c0;
  f6_neg(o.c1, a.c1);
}

static void f12_mul_by_014(Fq12 &o, const Fq12 &f, const Fq2 &c0,
                           const Fq2 &c1, const Fq2 &c4) {
  Fq6 aa, bb, t1s;
  f6_mul_by_01(aa, f.c0, c0, c1);
  f6_mul_by_1(bb, f.c1, c4);
  Fq2 c1c4;
  f2_add(c1c4, c1, c4);
  Fq6 sum;
  f6_add(sum, f.c0, f.c1);
  f6_mul_by_01(t1s, sum, c0, c1c4);
  Fq6 nr;
  f6_mul_nonres(nr, bb);
  f6_add(o.c0, nr, aa);
  f6_sub(t1s, t1s, aa);
  f6_sub(o.c1, t1s, bb);
}

static void f12_inv(Fq12 &o, const Fq12 &a) {
  Fq6 t0, t1, nr, d, dinv;
  f6_sq(t0, a.c0);
  f6_sq(t1, a.c1);
  f6_mul_nonres(nr, t1);
  f6_sub(d, t0, nr);
  f6_inv(dinv, d);
  f6_mul(o.c0, a.c0, dinv);
  Fq6 x;
  f6_mul(x, a.c1, dinv);
  f6_neg(o.c1, x);
}

static void f12_frob(Fq12 &o, const Fq12 &a) {
  Fq6 c0, c1;
  f6_frob(c0, a.c0);
  f6_frob(c1, a.c1);
  // scale c1 by gamma12 (an Fq2 scalar on each Fq2 coefficient)
  f2_mul(c1.c0, c1.c0, FROB_G12);
  f2_mul(c1.c1, c1.c1, FROB_G12);
  f2_mul(c1.c2, c1.c2, FROB_G12);
  o.c0 = c0;
  o.c1 = c1;
}

static void f12_frob_pow(Fq12 &o, const Fq12 &a, int n) {
  o = a;
  for (int i = 0; i < n; ++i) {
    Fq12 t;
    f12_frob(t, o);
    o = t;
  }
}

// Granger–Scott cyclotomic squaring (refmodel.cyclotomic_square)
static void fp4_square(Fq2 &o0, Fq2 &o1, const Fq2 &a, const Fq2 &b) {
  Fq2 t0, t1, t2, s;
  f2_sq(t0, a);
  f2_sq(t1, b);
  f2_add(s, a, b);
  f2_sq(t2, s);
  f2_sub(t2, t2, t0);
  f2_sub(t2, t2, t1);  // 2ab
  Fq2 nr;
  f2_mul_nonres(nr, t1);
  f2_add(o0, nr, t0);
  o1 = t2;
}

static void f12_cyc_sq(Fq12 &o, const Fq12 &f) {
  Fq2 z0 = f.c0.c0, z4 = f.c0.c1, z3 = f.c0.c2;
  Fq2 z2 = f.c1.c0, z1 = f.c1.c1, z5 = f.c1.c2;
  Fq2 t0, t1, t2, t3;

  fp4_square(t0, t1, z0, z1);
  f2_sub(z0, t0, z0);
  f2_add(z0, z0, z0);
  f2_add(z0, z0, t0);
  f2_add(z1, t1, z1);
  f2_add(z1, z1, z1);
  f2_add(z1, z1, t1);

  fp4_square(t0, t1, z2, z3);
  fp4_square(t2, t3, z4, z5);

  f2_sub(z4, t0, z4);
  f2_add(z4, z4, z4);
  f2_add(z4, z4, t0);
  f2_add(z5, t1, z5);
  f2_add(z5, z5, z5);
  f2_add(z5, z5, t1);
  Fq2 nr;
  f2_mul_nonres(nr, t3);
  f2_add(z2, nr, z2);
  f2_add(z2, z2, z2);
  f2_add(z2, z2, nr);
  f2_sub(z3, t2, z3);
  f2_add(z3, z3, z3);
  f2_add(z3, z3, t2);

  o.c0.c0 = z0;
  o.c0.c1 = z4;
  o.c0.c2 = z3;
  o.c1.c0 = z2;
  o.c1.c1 = z1;
  o.c1.c2 = z5;
}

static void f12_cyc_exp(Fq12 &o, const Fq12 &f) {  // f^(-|x|)
  Fq12 tmp;
  f12_one(tmp);
  bool found_one = false;
  for (int i = 63; i >= 0; --i) {
    if (found_one) {
      Fq12 t;
      f12_cyc_sq(t, tmp);
      tmp = t;
    } else {
      found_one = ((BLS_X >> i) & 1) == 1;
    }
    if (((BLS_X >> i) & 1) == 1) {
      Fq12 t;
      f12_mul(t, tmp, f);
      tmp = t;
    }
  }
  f12_conj(o, tmp);
}

static void final_exponentiation(Fq12 &o, const Fq12 &f) {
  Fq12 t0, t1, t2, t3, t4, t5, t6, x;
  f12_frob_pow(t0, f, 6);
  f12_inv(t1, f);
  f12_mul(t2, t0, t1);
  t1 = t2;
  f12_frob_pow(t2, t2, 2);
  f12_mul(x, t2, t1);
  t2 = x;  // easy part done

  f12_cyc_sq(t1, t2);
  f12_conj(t1, t1);
  f12_cyc_exp(t3, t2);
  f12_cyc_sq(t4, t3);
  f12_mul(t5, t1, t3);
  f12_cyc_exp(t1, t5);
  f12_cyc_exp(t0, t1);
  f12_cyc_exp(t6, t0);
  f12_mul(x, t6, t4);
  t6 = x;
  f12_cyc_exp(t4, t6);
  f12_conj(t5, t5);
  f12_mul(x, t4, t5);
  f12_mul(t4, x, t2);
  f12_conj(t5, t2);
  f12_mul(x, t1, t2);
  t1 = x;
  f12_frob_pow(t1, t1, 3);
  f12_mul(x, t6, t5);
  t6 = x;
  f12_frob(x, t6);
  t6 = x;
  f12_mul(x, t3, t0);
  t3 = x;
  f12_frob_pow(t3, t3, 2);
  f12_mul(x, t3, t1);
  t3 = x;
  f12_mul(x, t3, t6);
  t3 = x;
  f12_mul(o, t3, t4);
}

// ---------------------------------------------------------------------------
// Curve + Miller loop
// ---------------------------------------------------------------------------

struct G2Proj {
  Fq2 x, y, z;
};
struct LineTriple {
  Fq2 c0, c1, c2;
};

// refmodel.doubling_step (Alg. 26 of eprint 2010/354)
static void doubling_step(G2Proj &r, LineTriple &l) {
  Fq2 tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, zsq, t;
  f2_sq(tmp0, r.x);
  f2_sq(tmp1, r.y);
  f2_sq(tmp2, tmp1);
  f2_add(t, tmp1, r.x);
  f2_sq(tmp3, t);
  f2_sub(tmp3, tmp3, tmp0);
  f2_sub(tmp3, tmp3, tmp2);
  f2_add(tmp3, tmp3, tmp3);
  f2_add(tmp4, tmp0, tmp0);
  f2_add(tmp4, tmp4, tmp0);
  f2_add(tmp6, r.x, tmp4);
  f2_sq(tmp5, tmp4);
  f2_sq(zsq, r.z);
  f2_sub(r.x, tmp5, tmp3);
  f2_sub(r.x, r.x, tmp3);
  f2_add(t, r.z, r.y);
  f2_sq(t, t);
  f2_sub(t, t, tmp1);
  f2_sub(r.z, t, zsq);
  f2_sub(t, tmp3, r.x);
  f2_mul(r.y, t, tmp4);
  Fq2 e8;
  f2_add(e8, tmp2, tmp2);
  f2_add(e8, e8, e8);
  f2_add(e8, e8, e8);
  f2_sub(r.y, r.y, e8);
  f2_mul(t, tmp4, zsq);
  f2_add(t, t, t);
  f2_neg(l.c1, t);
  f2_sq(t, tmp6);
  f2_sub(t, t, tmp0);
  f2_sub(t, t, tmp5);
  Fq2 y4;
  f2_add(y4, tmp1, tmp1);
  f2_add(y4, y4, y4);
  f2_sub(l.c2, t, y4);
  f2_mul(t, r.z, zsq);
  f2_add(l.c0, t, t);
}

// refmodel.addition_step (Alg. 27)
static void addition_step(G2Proj &r, const Fq2 &qx, const Fq2 &qy,
                          LineTriple &l) {
  Fq2 zsq, ysq, t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, x;
  f2_sq(zsq, r.z);
  f2_sq(ysq, qy);
  f2_mul(t0, zsq, qx);
  f2_add(x, qy, r.z);
  f2_sq(x, x);
  f2_sub(x, x, ysq);
  f2_sub(x, x, zsq);
  f2_mul(t1, x, zsq);
  f2_sub(t2, t0, r.x);
  f2_sq(t3, t2);
  f2_add(t4, t3, t3);
  f2_add(t4, t4, t4);
  f2_mul(t5, t4, t2);
  f2_sub(t6, t1, r.y);
  f2_sub(t6, t6, r.y);
  f2_mul(t9, t6, qx);
  f2_mul(t7, t4, r.x);
  f2_sq(x, t6);
  f2_sub(x, x, t5);
  f2_sub(x, x, t7);
  f2_sub(r.x, x, t7);
  f2_add(x, r.z, t2);
  f2_sq(x, x);
  f2_sub(x, x, zsq);
  f2_sub(r.z, x, t3);
  f2_add(t10, qy, r.z);
  f2_sub(x, t7, r.x);
  f2_mul(t8, x, t6);
  f2_mul(t0, r.y, t5);
  f2_add(t0, t0, t0);
  f2_sub(r.y, t8, t0);
  f2_sq(x, t10);
  f2_sub(x, x, ysq);
  Fq2 zt;
  f2_sq(zt, r.z);
  f2_sub(t10, x, zt);
  f2_add(t9, t9, t9);
  f2_sub(t9, t9, t10);
  f2_add(l.c0, r.z, r.z);
  Fq2 t6n;
  f2_neg(t6n, t6);
  f2_add(l.c1, t6n, t6n);
  l.c2 = t9;
}

static const int NUM_COEFFS = 68;

static void prepare_g2(LineTriple *coeffs, const Fq2 &qx, const Fq2 &qy) {
  G2Proj r;
  r.x = qx;
  r.y = qy;
  r.z = FQ2_ZERO;
  r.z.c0 = ONE_MONT;
  int idx = 0;
  bool found_one = false;
  u64 xh = BLS_X >> 1;
  for (int i = 63; i >= 0; --i) {
    bool bit = ((xh >> i) & 1) == 1;
    if (!found_one) {
      found_one = bit;
      continue;
    }
    doubling_step(r, coeffs[idx++]);
    if (bit) addition_step(r, qx, qy, coeffs[idx++]);
  }
  doubling_step(r, coeffs[idx++]);
  // idx == 68 by construction (62 dbl + 5 add + 1 dbl)
}

static void ell(Fq12 &f, const LineTriple &l, const Fp &px, const Fp &py) {
  Fq2 c0, c1;
  f2_scale_fp(c0, l.c0, py);
  f2_scale_fp(c1, l.c1, px);
  Fq12 t;
  f12_mul_by_014(t, f, l.c2, c1, c0);
  f = t;
}

// Fused multi-Miller loop over nterms (coeffs laid out per term), with a skip
// mask for infinity terms (refmodel.multi_miller_loop).
static void multi_miller_loop(Fq12 &out, const LineTriple *coeffs,
                              const Fp *pxs, const Fp *pys,
                              const uint8_t *skip, long nterms) {
  Fq12 f;
  f12_one(f);
  int idx = 0;
  bool found_one = false;
  u64 xh = BLS_X >> 1;
  for (int i = 63; i >= 0; --i) {
    bool bit = ((xh >> i) & 1) == 1;
    if (!found_one) {
      found_one = bit;
      continue;
    }
    for (long t = 0; t < nterms; ++t)
      if (!skip[t]) ell(f, coeffs[t * NUM_COEFFS + idx], pxs[t], pys[t]);
    idx++;
    if (bit) {
      for (long t = 0; t < nterms; ++t)
        if (!skip[t]) ell(f, coeffs[t * NUM_COEFFS + idx], pxs[t], pys[t]);
      idx++;
    }
    Fq12 s;
    f12_sq(s, f);
    f = s;
  }
  for (long t = 0; t < nterms; ++t)
    if (!skip[t]) ell(f, coeffs[t * NUM_COEFFS + idx], pxs[t], pys[t]);
  // BLS_X is negative
  f12_conj(out, f);
}

// Generic Jacobian scalar multiplication, templated over the field.
template <typename F>
struct CurveOps;

template <>
struct CurveOps<Fp> {
  static void add(Fp &o, const Fp &a, const Fp &b) { fp_add(o, a, b); }
  static void sub(Fp &o, const Fp &a, const Fp &b) { fp_sub(o, a, b); }
  static void mul(Fp &o, const Fp &a, const Fp &b) { fp_mont_mul(o, a, b); }
  static void sq(Fp &o, const Fp &a) { fp_sq(o, a); }
  static void inv(Fp &o, const Fp &a) { fp_inv(o, a); }
  static bool is_zero(const Fp &a) { return fp_is_zero(a); }
  static Fp zero() { return FP_ZERO; }
  static Fp one() { return ONE_MONT; }
};

template <>
struct CurveOps<Fq2> {
  static void add(Fq2 &o, const Fq2 &a, const Fq2 &b) { f2_add(o, a, b); }
  static void sub(Fq2 &o, const Fq2 &a, const Fq2 &b) { f2_sub(o, a, b); }
  static void mul(Fq2 &o, const Fq2 &a, const Fq2 &b) { f2_mul(o, a, b); }
  static void sq(Fq2 &o, const Fq2 &a) { f2_sq(o, a); }
  static void inv(Fq2 &o, const Fq2 &a) { f2_inv(o, a); }
  static bool is_zero(const Fq2 &a) { return f2_is_zero(a); }
  static Fq2 zero() { return FQ2_ZERO; }
  static Fq2 one() {
    Fq2 r = FQ2_ZERO;
    r.c0 = ONE_MONT;
    return r;
  }
};

template <typename F>
struct JPoint {
  F x, y, z;  // Jacobian; z == 0 encodes infinity
};

template <typename F>
static void jdouble(JPoint<F> &o, const JPoint<F> &p) {
  using O = CurveOps<F>;
  if (O::is_zero(p.z)) {
    o = p;
    return;
  }
  F a, b, c, d, e, f, t, t2;
  O::sq(a, p.x);
  O::sq(b, p.y);
  O::sq(c, b);
  O::add(t, p.x, b);
  O::sq(t, t);
  O::sub(t, t, a);
  O::sub(t, t, c);
  O::add(d, t, t);  // d = 2((x+b)^2 - a - c)
  O::add(e, a, a);
  O::add(e, e, a);  // e = 3a
  O::sq(f, e);
  O::sub(t, f, d);
  O::sub(o.x, t, d);
  O::mul(t2, p.y, p.z);
  O::sub(t, d, o.x);
  O::mul(t, e, t);
  F c8;
  O::add(c8, c, c);
  O::add(c8, c8, c8);
  O::add(c8, c8, c8);
  O::sub(o.y, t, c8);
  O::add(o.z, t2, t2);
}

template <typename F>
static void jadd_affine(JPoint<F> &o, const JPoint<F> &p, const F &qx,
                        const F &qy) {
  using O = CurveOps<F>;
  if (O::is_zero(p.z)) {
    o.x = qx;
    o.y = qy;
    o.z = O::one();
    return;
  }
  F z2, u2, s2, h, hh, i, j, rr, v, t;
  O::sq(z2, p.z);
  O::mul(u2, qx, z2);
  O::mul(t, qy, z2);
  O::mul(s2, t, p.z);
  O::sub(h, u2, p.x);
  F s2my;
  O::sub(s2my, s2, p.y);
  if (O::is_zero(h) && O::is_zero(s2my)) {
    jdouble(o, p);
    return;
  }
  O::sq(hh, h);
  O::add(i, hh, hh);
  O::add(i, i, i);
  O::mul(j, h, i);
  O::add(rr, s2my, s2my);
  O::mul(v, p.x, i);
  F r2;
  O::sq(r2, rr);
  O::sub(t, r2, j);
  O::sub(t, t, v);
  O::sub(o.x, t, v);
  O::sub(t, v, o.x);
  O::mul(t, rr, t);
  F yj;
  O::mul(yj, p.y, j);
  O::add(yj, yj, yj);
  O::sub(o.y, t, yj);
  O::mul(t, p.z, h);
  O::add(o.z, t, t);
}

template <typename F>
static void jscalar_mul(F &ox, F &oy, bool &oinf, const F &gx, const F &gy,
                        const u64 *k, int kwords) {
  using O = CurveOps<F>;
  JPoint<F> acc;
  acc.x = O::one();
  acc.y = O::one();
  acc.z = O::zero();
  int top = kwords * 64 - 1;
  while (top >= 0 && !((k[top / 64] >> (top % 64)) & 1)) --top;
  for (int i = top; i >= 0; --i) {
    JPoint<F> t;
    jdouble(t, acc);
    acc = t;
    if ((k[i / 64] >> (i % 64)) & 1) {
      jadd_affine(t, acc, gx, gy);
      acc = t;
    }
  }
  if (O::is_zero(acc.z)) {
    oinf = true;
    ox = O::zero();
    oy = O::zero();
    return;
  }
  oinf = false;
  F zi, zi2, zi3;
  O::inv(zi, acc.z);
  O::sq(zi2, zi);
  O::mul(zi3, zi2, zi);
  O::mul(ox, acc.x, zi2);
  O::mul(oy, acc.y, zi3);
}

// ---------------------------------------------------------------------------
// C ABI (all external limbs are standard form, little-endian u64 x 6)
// ---------------------------------------------------------------------------

static void load_fp(Fp &o, const u64 *src) {
  Fp s;
  std::memcpy(s.v, src, 48);
  fp_to_mont(o, s);
}
static void store_fp(u64 *dst, const Fp &a) {
  Fp s;
  fp_from_mont(s, a);
  std::memcpy(dst, s.v, 48);
}
static void load_f2(Fq2 &o, const u64 *src) {
  load_fp(o.c0, src);
  load_fp(o.c1, src + 6);
}
static void store_f12(u64 *dst, const Fq12 &f) {
  const Fq2 *cs[6] = {&f.c0.c0, &f.c0.c1, &f.c0.c2,
                      &f.c1.c0, &f.c1.c1, &f.c1.c2};
  for (int i = 0; i < 6; ++i) {
    store_fp(dst + i * 12, cs[i]->c0);
    store_fp(dst + i * 12 + 6, cs[i]->c1);
  }
}

static void parallel_for_impl(long n, const std::function<void(long, long)> &fn) {
  unsigned hw = std::thread::hardware_concurrency();
  long nthreads = hw ? (long)hw : 1;
  if (nthreads > n) nthreads = n > 0 ? n : 1;
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  long chunk = (n + nthreads - 1) / nthreads;
  for (long t = 0; t < nthreads; ++t) {
    long lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto &t : ts) t.join();
}

extern "C" {

// e(P_i, Q_i) for i in [0, n): g1: n*2*6 u64, g2: n*4*6 u64, out: n*12*6 u64.
// Infinity flags: 1 byte per point; an infinite term yields 1 in Gt.
int pairing_batch(const u64 *g1, const uint8_t *g1inf, const u64 *g2,
                  const uint8_t *g2inf, u64 *out, long n) {
  parallel_for_impl(n, [&](long lo, long hi) {
    std::vector<LineTriple> coeffs(NUM_COEFFS);
    for (long i = lo; i < hi; ++i) {
      Fp px, py;
      Fq2 qx, qy;
      load_fp(px, g1 + i * 12);
      load_fp(py, g1 + i * 12 + 6);
      uint8_t skip = (g1inf && g1inf[i]) || (g2inf && g2inf[i]);
      if (g2inf && g2inf[i]) {
        qx = G2_GEN_X;  // generator substitution (miller_loop.rs:218-219)
        qy = G2_GEN_Y;
      } else {
        load_f2(qx, g2 + i * 24);
        load_f2(qy, g2 + i * 24 + 12);
      }
      prepare_g2(coeffs.data(), qx, qy);
      Fq12 f, e;
      multi_miller_loop(f, coeffs.data(), &px, &py, &skip, 1);
      final_exponentiation(e, f);
      store_f12(out + i * 72, e);
    }
  });
  return 0;
}

// prod_i e(P_i, Q_i): one fused Miller loop + one final exponentiation.
int multi_pairing_product(const u64 *g1, const uint8_t *g1inf, const u64 *g2,
                          const uint8_t *g2inf, u64 *out, long n) {
  std::vector<LineTriple> coeffs(NUM_COEFFS * n);
  std::vector<Fp> pxs(n), pys(n);
  std::vector<uint8_t> skip(n);
  parallel_for_impl(n, [&](long lo, long hi) {
    for (long i = lo; i < hi; ++i) {
      load_fp(pxs[i], g1 + i * 12);
      load_fp(pys[i], g1 + i * 12 + 6);
      skip[i] = (g1inf && g1inf[i]) || (g2inf && g2inf[i]);
      Fq2 qx, qy;
      if (g2inf && g2inf[i]) {
        qx = G2_GEN_X;
        qy = G2_GEN_Y;
      } else {
        load_f2(qx, g2 + i * 24);
        load_f2(qy, g2 + i * 24 + 12);
      }
      prepare_g2(coeffs.data() + i * NUM_COEFFS, qx, qy);
    }
  });
  Fq12 f, e;
  multi_miller_loop(f, coeffs.data(), pxs.data(), pys.data(), skip.data(), n);
  final_exponentiation(e, f);
  store_f12(out, e);
  return 0;
}

// out_i = k_i * G for a fixed affine base G (input gen / witness hints).
// base: 2*6 u64; scalars: n*4 u64 (256-bit LE); out: n*2*6 u64; inf: n bytes.
int g1_mul_batch(const u64 *base, const u64 *scalars, u64 *out, uint8_t *inf,
                 long n) {
  Fp gx, gy;
  load_fp(gx, base);
  load_fp(gy, base + 6);
  parallel_for_impl(n, [&](long lo, long hi) {
    for (long i = lo; i < hi; ++i) {
      Fp ox, oy;
      bool oinf;
      jscalar_mul<Fp>(ox, oy, oinf, gx, gy, scalars + i * 4, 4);
      store_fp(out + i * 12, ox);
      store_fp(out + i * 12 + 6, oy);
      if (inf) inf[i] = oinf ? 1 : 0;
    }
  });
  return 0;
}

int g2_mul_batch(const u64 *base, const u64 *scalars, u64 *out, uint8_t *inf,
                 long n) {
  Fq2 gx, gy;
  load_f2(gx, base);
  load_f2(gy, base + 12);
  parallel_for_impl(n, [&](long lo, long hi) {
    for (long i = lo; i < hi; ++i) {
      Fq2 ox, oy;
      bool oinf;
      jscalar_mul<Fq2>(ox, oy, oinf, gx, gy, scalars + i * 4, 4);
      store_fp(out + i * 24, ox.c0);
      store_fp(out + i * 24 + 6, ox.c1);
      store_fp(out + i * 24 + 12, oy.c0);
      store_fp(out + i * 24 + 18, oy.c1);
      if (inf) inf[i] = oinf ? 1 : 0;
    }
  });
  return 0;
}

// Elementwise c = a*b mod p and inv0 (hint generation; standard-form limbs).
int fp_mul_batch(const u64 *a, const u64 *b, u64 *out, long n) {
  parallel_for_impl(n, [&](long lo, long hi) {
    for (long i = lo; i < hi; ++i) {
      Fp x, y, z;
      load_fp(x, a + i * 6);
      load_fp(y, b + i * 6);
      fp_mont_mul(z, x, y);
      store_fp(out + i * 6, z);
    }
  });
  return 0;
}

int fp_inv_batch(const u64 *a, u64 *out, long n) {
  parallel_for_impl(n, [&](long lo, long hi) {
    for (long i = lo; i < hi; ++i) {
      Fp x, z;
      load_fp(x, a + i * 6);
      fp_inv(z, x);
      store_fp(out + i * 6, z);
    }
  });
  return 0;
}

}  // extern "C"
