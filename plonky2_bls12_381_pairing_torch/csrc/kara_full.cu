// The whole Karabina exponentiation a^|x| of cyclotomic Fq12 elements in one
// kernel: compress to (g2, g3, g4, g5), the chain of compressed squarings
// with its six snapshots f^(2^e_k), the decompression of the six (the
// numerators, the g2 == 0 choice of numerator and denominator, the six Fq2
// norms, their inverses, g1 and g0), and the product of the six,
// ((s0 s1)(s2 s3))(s4 s5).
//
// Replaces the TPU kernel kara_full_run (plonky2_bls12_381_pairing_tpu/ops/
// rns/pallas.py, _build_kara_full). Its plain PyTorch version is
// ops/rns/kernels.py kara_full_plain; the rows agree bit for bit.
//
// The inversion. The TPU kernel inverts the norms of a block of rows through
// a product tree across those rows, down to a floor of 128 rows, and raises
// the root to p - 2; under the floor it raises every norm itself. Blocks
// here share nothing and a row's stored representative depends on the tree's
// shape, so this kernel takes the form without a tree: the six norms of a
// packed row go through one Fermat chain together, a 6-row REDC per step,
// with the bits of p - 2 read from device memory. Zero maps to zero.
//
// What bounds it on an H100: latency, then integer issue. The Fermat chain is
// about 570 dependent REDC steps where the chain of squarings is 63 and the
// rest about 30, each step four block-wide synchronisations; the data moved
// is one 12 x 128 int32 row in and out.
//
// State: one block per packed row, one thread per lane. Every value but a
// REDC's cross-lane sums is private to its lane. The six snapshots (48
// residues a thread) do not fit in registers beside the working set, so they
// lie in shared memory, each thread reading only what it wrote; the running
// product of the tree is parked in the rows of the snapshots already
// consumed.

#include "rns_tower.cuh"

namespace {

using namespace rns;

constexpr int NSNAP = 6;

// Which of K stored values (<= 4p, canonical residues) are 0 mod p, per
// packed slot (fp.is_zero): a value is zero iff its slot equals the residues
// of k*p on every channel lane for one k in 0..4. Bit k of the result is set
// if x[k] is zero in the calling thread's slot. Each thread forms a 5-bit
// match mask per value, a warp reduces by AND, and the two warps of a slot
// meet in shared memory. Every thread of the block must call it.
template <int K, int KS>
__device__ __forceinline__ unsigned zero_mask(const int (&x)[K], int l, Smem<KS>& s) {
  static_assert(5 * K <= 32, "one 32-bit mask holds the match bits");
  static_assert(SUB == 64 && KS * PACK >= LANES / 32, "two warps per slot, a word each");
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    unsigned b = 0;
#pragma unroll
    for (int r = 0; r < 5; ++r) b |= (x[k] == RNS_ZERO_TEST[r][l] ? 1u : 0u) << r;
    if (l == RNS_ALPHA_LANE) b = 31u;  // not a channel: matches any row
    m |= b << (5 * k);
  }
  m = __reduce_and_sync(0xffffffffu, m);
  __syncthreads();  // the last reduction's reads of s.fix are done
  if ((threadIdx.x & 31) == 0) s.fix[threadIdx.x >> 5] = static_cast<int>(m);
  __syncthreads();
  // what follows rewrites s.fix only after a barrier of its own
  const int w = (threadIdx.x / SUB) * 2;
  m = static_cast<unsigned>(s.fix[w] & s.fix[w + 1]);
  unsigned z = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) z |= (((m >> (5 * k)) & 31u) != 0 ? 1u : 0u) << k;
  return z;
}

// x[k] for a k known only at run time, x staying in registers.
__device__ __forceinline__ int pick(const int (&x)[NSNAP], int k) {
  int v = x[0];
#pragma unroll
  for (int i = 1; i < NSNAP; ++i) v = (i == k) ? x[i] : v;
  return v;
}

// One snapshot (the thread's 8 residues at g[i * LANES]) to the full element
// f, given nq = the inverse of its denominator's norm over 4 and z = whether
// its g2 is zero (tower.decompress_cyclotomic):
//   g1 = num * conj(den) * nq, (num, den) = (8 g4 g5, g3) where g2 == 0, else
//        (xi g5^2 + 3 g4^2 - 2 g3, g2);
//   g0 = xi (2 g1^2 + g2 g5 - 3 g3 g4) + 1;
//   f = ((g0, g4, g3), (g2, g1, g5)).
template <int KS>
__device__ __forceinline__ void decompress(const int* g, int nq, bool z, int (&f)[12],
                                           const Lane& c, Smem<KS>& s, int l) {
  const F2 g2{g[0], g[LANES]}, g3{g[2 * LANES], g[3 * LANES]};
  const F2 g4{g[4 * LANES], g[5 * LANES]}, g5{g[6 * LANES], g[7 * LANES]};

  const F2 num1 = f2_sub(f2_add(f2_nonres(f2_mul(g5, g5, c), c),
                                f2_scale(f2_mul(g4, g4, c), 3, c), c),
                         f2_scale(f2_lift(g3, c), 2, c), c);
  const F2 num2 = f2_scale(f2_mul(g4, g5, c), 8, c);
  int n4[4] = {add_m(num1.c0, RNS_KNUM_BIAS[0][l], c), add_m(num1.c1, RNS_KNUM_BIAS[1][l], c),
               add_m(num2.c0, RNS_KNUM_BIAS[2][l], c), add_m(num2.c1, RNS_KNUM_BIAS[3][l], c)};
  redc<4>(n4, c, s);
  const F2 num = z ? F2{n4[2], n4[3]} : F2{n4[0], n4[1]};
  const F2 den = z ? g3 : g2;

  // conj(den) * nq, the negation as 4p - x
  int d[2] = {add_m(mul_m(den.c0, nq, c), RNS_KDINV_BIAS[0][l], c),
              add_m(mul_m(sub_m(RNS_PMUL4[l], den.c1, c), nq, c), RNS_KDINV_BIAS[1][l], c)};
  redc<2>(d, c, s);

  const F2 g1w = f2_mul(num, F2{d[0], d[1]}, c);
  int g1[2] = {add_m(g1w.c0, RNS_KG1_BIAS[0][l], c), add_m(g1w.c1, RNS_KG1_BIAS[1][l], c)};
  redc<2>(g1, c, s);

  const F2 g1f{g1[0], g1[1]};
  const F2 inner = f2_sub(f2_add(f2_scale(f2_mul(g1f, g1f, c), 2, c), f2_mul(g2, g5, c), c),
                          f2_scale(f2_mul(g3, g4, c), 3, c), c);
  const F2 xin = f2_nonres(inner, c);
  // + 1, lifted into the product domain
  const int one_p = mul_m(RNS_ONE[l], c.ma_modp, c);
  int g0[2] = {add_m(add_m(xin.c0, one_p, c), RNS_KG0_BIAS[0][l], c),
               add_m(xin.c1, RNS_KG0_BIAS[1][l], c)};
  redc<2>(g0, c, s);

  f[0] = g0[0]; f[1] = g0[1];
  f[2] = g4.c0; f[3] = g4.c1;
  f[4] = g3.c0; f[5] = g3.c1;
  f[6] = g2.c0; f[7] = g2.c1;
  f[8] = g1[0]; f[9] = g1[1];
  f[10] = g5.c0; f[11] = g5.c1;
}

// One block per packed row; a and out are (rows, 12, 128) int32; segs holds
// the NSNAP chain lengths, bits the nbits bits of p - 2 after its leading one,
// MSB first.
__global__ void __launch_bounds__(LANES)
    kara_full_kernel(const int* __restrict__ a, int* __restrict__ out,
                     const int* __restrict__ segs, const int* __restrict__ bits, int nbits) {
  __shared__ Smem<12> s;
  __shared__ int snaps[NSNAP * 8 * LANES];
  load_tables(s);
  __syncthreads();

  const int lane = threadIdx.x;
  const int l = lane % SUB;
  const Lane c = load_lane(l);
  const size_t row = blockIdx.x;
  int* const my = snaps + lane;  // residue i of snapshot k at my[(k * 8 + i) * LANES]

  // the chain
  {
    const int idx[8] = RNS_KARA_IDX;
    int g[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      g[i] = a[(row * 12 + idx[i]) * LANES + lane];
      b[i] = RNS_KARA_BIAS[i][l];
    }
    for (int k = 0; k < NSNAP; ++k) {
      const int n = segs[k];
      for (int i = 0; i < n; ++i) kara_square<1>(g, c, s, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) my[(k * 8 + i) * LANES] = g[i];
    }
  }

  // which snapshots have g2 == 0 (both components), per slot
  unsigned zg2;
  {
    int c0[NSNAP], c1[NSNAP];
#pragma unroll
    for (int k = 0; k < NSNAP; ++k) {
      c0[k] = my[(k * 8) * LANES];
      c1[k] = my[(k * 8 + 1) * LANES];
    }
    zg2 = zero_mask(c0, l, s) & zero_mask(c1, l, s);
  }

  // the six denominators' norms c0^2 + c1^2
  int base[NSNAP], acc[NSNAP];
#pragma unroll
  for (int k = 0; k < NSNAP; ++k) {
    const int o = ((zg2 >> k) & 1u) ? 2 : 0;  // g3 where g2 == 0
    const int d0 = my[(k * 8 + o) * LANES], d1 = my[(k * 8 + o + 1) * LANES];
    base[k] = add_m(mul_m(d0, d0, c), mul_m(d1, d1, c), c);
  }
  redc<NSNAP>(base, c, s);

  // their inverses norm^(p - 2), zero to zero, then over 4
  const unsigned zn = zero_mask(base, l, s);
  const int one = RNS_ONE[l];
#pragma unroll
  for (int k = 0; k < NSNAP; ++k) {
    if ((zn >> k) & 1u) base[k] = one;
    acc[k] = base[k];
  }
  for (int i = 0; i < nbits; ++i) {
#pragma unroll
    for (int k = 0; k < NSNAP; ++k) acc[k] = mul_m(acc[k], acc[k], c);
    redc<NSNAP>(acc, c, s);
    if (bits[i]) {
#pragma unroll
      for (int k = 0; k < NSNAP; ++k) acc[k] = mul_m(acc[k], base[k], c);
      redc<NSNAP>(acc, c, s);
    }
  }
  const int quarter = RNS_QUARTER[l];
#pragma unroll
  for (int k = 0; k < NSNAP; ++k) acc[k] = ((zn >> k) & 1u) ? 0 : mul_m(acc[k], quarter, c);
  redc<NSNAP>(acc, c, s);

  // decompress pair by pair and multiply: p_j = s_2j s_2j+1, then (p0 p1) p2
  const int* mb = bias_at(RNS_MUL_BIAS, l);
  int fa[12], fb[12];
#pragma unroll 1
  for (int j = 0; j < NSNAP / 2; ++j) {
    decompress(my + (2 * j) * 8 * LANES, pick(acc, 2 * j), (zg2 >> (2 * j)) & 1u, fa, c, s,
               l);
    decompress(my + (2 * j + 1) * 8 * LANES, pick(acc, 2 * j + 1), (zg2 >> (2 * j + 1)) & 1u,
               fb, c, s, l);
    fq12_mul<SUB>(fa, fb, c, s, mb);
    if (j > 0) {
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        fb[i] = fa[i];
        fa[i] = my[i * LANES];
      }
      fq12_mul<SUB>(fa, fb, c, s, mb);
    }
    // park the running product in the rows of snapshots 0 and 1, consumed
    // in the first round
#pragma unroll
    for (int i = 0; i < 12; ++i) my[i * LANES] = fa[i];
  }
  store12(fa, out, row, lane);
}

}  // namespace

extern "C" int kara_full_launch(const int* a, int* out, int rows, const int* segs, int nseg,
                                const int* bits, int nbits, void* stream) {
  if (nseg != NSNAP) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    kara_full_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, out, segs,
                                                                            bits, nbits);
  }
  return static_cast<int>(cudaGetLastError());
}
