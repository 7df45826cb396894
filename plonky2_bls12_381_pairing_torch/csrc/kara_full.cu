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
// shape, so this kernel takes the form without a tree: each norm goes
// through its own Fermat chain, acc^2 and then acc * norm where the bit of
// p - 2 (read from device memory, MSB first after the leading one) is set,
// 608 REDCs. Zero maps to zero; the Karabina 1/4 is folded in after.
//
// The design: every REDC runs on the tensor-core tile of rns_redc_tc.cuh. A
// block holds TILE packed rows, one thread per lane and row, through the
// whole exponentiation: the compressed state (8 residues) in registers for
// the 63 squarings; the six snapshots and the six inverses in a scratch
// buffer in device memory that the wrapper allocates (54 x 128 int32 per
// packed row, rows padded to whole tiles; 28 MB at 2048 pairings, inside
// the 50 MB L2), each thread reading back only what it wrote; the Fermat
// chains of a slot's six norms as one 6-row REDC per step, whose bits are
// the same for the whole block, so every thread takes every barrier. The
// zero tests reduce over a slot's two warps through one shared word per
// warp. Rows past the end (in the last tile) compute on zeros and store
// nothing. At the 64 registers of four blocks per SM the decompression and
// the products spill 84 bytes a thread; they take under 0.2 ms.
//
// What bounds it on an H100: the Fermat chains, 608 steps of a 6-row REDC
// (lane arithmetic, two tensor-core extensions, four block barriers)
// against 63 8-row ones for the chain and about 40 REDC rows of
// decompression and products. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (kernel_probe.py, 1024 packed rows): 3.10 ms, of which the inversion
// 2.46, the chain 0.46; 1.56 ms for 4 rows alone, so about half of the
// time is the chains' latency and half the SMs' throughput on their lane
// arithmetic. chip_smoke.py reads 3.24-3.33 ms (one launch between two
// events), against 9.11-9.15 ms for the one-row blocks with a block-wide
// REDC that it had before, timed alongside it, and a work bound of
// 0.019 ms. The warp design of pow_static.cu for the chains measured no
// faster (3.08-3.50 ms; PERF.md).

#include "rns_tile.cuh"

namespace {

using namespace rns;

constexpr int NSNAP = 6;
// packed rows per block, four blocks per SM: 3.5-5.6 % faster than the other
// tensor-core kernels' RNS_TC_ROWS = 4 at two blocks per SM
// (kernel_probe.py; PERF.md)
constexpr int TILE = 2;
constexpr int THREADS = TILE * LANES;
constexpr int WARPS = THREADS / 32;
// residues per lane and packed row in the scratch buffer: the six
// snapshots' 8 components, then the six norms' inverses over 4
constexpr int INV = NSNAP * 8;
constexpr int SCRATCH = INV + NSNAP;

// Which of K stored values (<= 4p, canonical residues) are 0 mod p, per
// packed slot (fp.is_zero): a value is zero iff its slot equals the residues
// of k*p on every channel lane for one k in 0..4. Bit k of the result is set
// if x[k] is zero in the calling thread's slot. Each thread forms a 5-bit
// match mask per value, a warp reduces by AND, and the two warps of a slot
// meet in `words`, one per warp of the block. Every thread of the block
// must call it.
template <int K>
__device__ __forceinline__ unsigned zero_mask(const int (&x)[K], int l, int (&words)[WARPS]) {
  static_assert(5 * K <= 32, "one 32-bit mask holds the match bits");
  static_assert(SUB == 64, "two warps per slot");
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
  __syncthreads();  // the last call's reads of words are done
  if ((threadIdx.x & 31) == 0) words[threadIdx.x >> 5] = static_cast<int>(m);
  __syncthreads();
  const int w = (threadIdx.x / SUB) * 2;
  m = static_cast<unsigned>(words[w] & words[w + 1]);
  unsigned z = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) z |= (((m >> (5 * k)) & 31u) != 0 ? 1u : 0u) << k;
  return z;
}

// The bias rows of the chain, the decompression and the products, and the
// rows of 1 and 4p, in shared memory: read from device memory (const), the
// compiler hoists them out of the loops and holds them in registers.
struct Rows {
  int kara[8][SUB];
  int knum[4][SUB], kdinv[2][SUB], kg1[2][SUB], kg0[2][SUB];
  int mul[12][SUB];
  int one[SUB], pmul4[SUB];
};

__device__ __forceinline__ void load_rows(Rows& w) {
  for (int i = threadIdx.x; i < SUB; i += THREADS) {
#pragma unroll
    for (int k = 0; k < 8; ++k) w.kara[k][i] = RNS_KARA_BIAS[k][i];
#pragma unroll
    for (int k = 0; k < 4; ++k) w.knum[k][i] = RNS_KNUM_BIAS[k][i];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      w.kdinv[k][i] = RNS_KDINV_BIAS[k][i];
      w.kg1[k][i] = RNS_KG1_BIAS[k][i];
      w.kg0[k][i] = RNS_KG0_BIAS[k][i];
    }
#pragma unroll
    for (int k = 0; k < 12; ++k) w.mul[k][i] = RNS_MUL_BIAS[k][i];
    w.one[i] = RNS_ONE[i];
    w.pmul4[i] = RNS_PMUL4[i];
  }
}

// One snapshot (the thread's 8 residues at g[i * LANES]) to the full element
// f, given nq = the inverse of its denominator's norm over 4 and z = whether
// its g2 is zero (tower.decompress_cyclotomic):
//   g1 = num * conj(den) * nq, (num, den) = (8 g4 g5, g3) where g2 == 0, else
//        (xi g5^2 + 3 g4^2 - 2 g3, g2);
//   g0 = xi (2 g1^2 + g2 g5 - 3 g3 g4) + 1;
//   f = ((g0, g4, g3), (g2, g1, g5)).
__device__ __forceinline__ void decompress(const int* g, int nq, bool z, int (&f)[12],
                                           const Lane& c, TcSmem<TILE>& s, const Rows& w,
                                           int l) {
  const F2 g2{g[0], g[LANES]}, g3{g[2 * LANES], g[3 * LANES]};
  const F2 g4{g[4 * LANES], g[5 * LANES]}, g5{g[6 * LANES], g[7 * LANES]};

  const F2 num1 = f2_sub(f2_add(f2_nonres(f2_mul(g5, g5, c), c),
                                f2_scale(f2_mul(g4, g4, c), 3, c), c),
                         f2_scale(f2_lift(g3, c), 2, c), c);
  const F2 num2 = f2_scale(f2_mul(g4, g5, c), 8, c);
  int n4[4] = {add_m(num1.c0, w.knum[0][l], c), add_m(num1.c1, w.knum[1][l], c),
               add_m(num2.c0, w.knum[2][l], c), add_m(num2.c1, w.knum[3][l], c)};
  redc<4>(n4, c, s);
  const F2 num = z ? F2{n4[2], n4[3]} : F2{n4[0], n4[1]};
  const F2 den = z ? g3 : g2;

  // conj(den) * nq, the negation as 4p - x
  int d[2] = {add_m(mul_m(den.c0, nq, c), w.kdinv[0][l], c),
              add_m(mul_m(sub_m(w.pmul4[l], den.c1, c), nq, c), w.kdinv[1][l], c)};
  redc<2>(d, c, s);

  const F2 g1w = f2_mul(num, F2{d[0], d[1]}, c);
  int g1[2] = {add_m(g1w.c0, w.kg1[0][l], c), add_m(g1w.c1, w.kg1[1][l], c)};
  redc<2>(g1, c, s);

  const F2 g1f{g1[0], g1[1]};
  const F2 inner = f2_sub(f2_add(f2_scale(f2_mul(g1f, g1f, c), 2, c), f2_mul(g2, g5, c), c),
                          f2_scale(f2_mul(g3, g4, c), 3, c), c);
  const F2 xin = f2_nonres(inner, c);
  // + 1, lifted into the product domain
  const int one_p = mul_m(w.one[l], c.ma_modp, c);
  int g0[2] = {add_m(add_m(xin.c0, one_p, c), w.kg0[0][l], c),
               add_m(xin.c1, w.kg0[1][l], c)};
  redc<2>(g0, c, s);

  f[0] = g0[0]; f[1] = g0[1];
  f[2] = g4.c0; f[3] = g4.c1;
  f[4] = g3.c0; f[5] = g3.c1;
  f[6] = g2.c0; f[7] = g2.c1;
  f[8] = g1[0]; f[9] = g1[1];
  f[10] = g5.c0; f[11] = g5.c1;
}

// acc[k] <- base[k]^(p - 2), the six norms of the thread's slot: one Fermat
// chain per norm, a 6-row REDC of the tile per step.
__device__ __forceinline__ void fermat(int (&acc)[NSNAP], const int (&base)[NSNAP],
                                       const Lane& c, TcSmem<TILE>& s,
                                       const int* __restrict__ bits, int nbits) {
#pragma unroll
  for (int k = 0; k < NSNAP; ++k) acc[k] = base[k];
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
}

// One block per TILE packed rows (the last tile masked); a and out are
// (rows, 12, 128) int32, scratch (whole tiles, SCRATCH, 128) int32; segs
// holds the NSNAP chain lengths, bits the nbits bits of p - 2 after its
// leading one, MSB first.
__global__ void __launch_bounds__(THREADS, 4)
    kara_full_kernel(const int* __restrict__ a, int* __restrict__ out,
                     int* __restrict__ scratch, int rows, const int* __restrict__ segs,
                     const int* __restrict__ bits, int nbits) {
  __shared__ TcSmem<TILE> s;
  __shared__ Rows w;
  __shared__ int words[WARPS];
  load_rows(w);
  const Block b = enter(s);
  const Lane& c = b.c;
  const int l = b.l;
  const Row r = row_of<TILE>(blockIdx.x, rows);
  // residue i of snapshot k at my[(k * 8 + i) * LANES], the inverse of its
  // norm over 4 at my[(INV + k) * LANES]
  int* const my = scratch + r.row * SCRATCH * LANES + b.lane;

  // the chain
  {
    const int idx[8] = RNS_KARA_IDX;
    int g[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = r.live ? a[(r.row * 12 + idx[i]) * LANES + b.lane] : 0;
    for (int k = 0; k < NSNAP; ++k) {
      const int n = segs[k];
      for (int i = 0; i < n; ++i) kara_square<SUB>(g, c, s, &w.kara[0][l]);
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
    zg2 = zero_mask(c0, l, words) & zero_mask(c1, l, words);
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
  const unsigned zn = zero_mask(base, l, words);
#pragma unroll
  for (int k = 0; k < NSNAP; ++k) {
    if ((zn >> k) & 1u) base[k] = w.one[l];
  }
  fermat(acc, base, c, s, bits, nbits);
  const int quarter = RNS_QUARTER[l];
#pragma unroll
  for (int k = 0; k < NSNAP; ++k) acc[k] = ((zn >> k) & 1u) ? 0 : mul_m(acc[k], quarter, c);
  redc<NSNAP>(acc, c, s);
#pragma unroll
  for (int k = 0; k < NSNAP; ++k) my[(INV + k) * LANES] = acc[k];

  // decompress pair by pair and multiply: p_j = s_2j s_2j+1, then (p0 p1) p2
  const int* mb = &w.mul[0][l];
  int fa[12], fb[12];
#pragma unroll 1
  for (int j = 0; j < NSNAP / 2; ++j) {
    decompress(my + (2 * j) * 8 * LANES, my[(INV + 2 * j) * LANES], (zg2 >> (2 * j)) & 1u,
               fa, c, s, w, l);
    decompress(my + (2 * j + 1) * 8 * LANES, my[(INV + 2 * j + 1) * LANES],
               (zg2 >> (2 * j + 1)) & 1u, fb, c, s, w, l);
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
  if (r.live) store12(fa, out, r.row, b.lane);
}

}  // namespace

extern "C" int kara_full_launch(const int* a, int* out, int* scratch, int rows,
                                const int* segs, int nseg, const int* bits, int nbits,
                                void* stream) {
  if (nseg != NSNAP) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    kara_full_kernel<<<(rows + TILE - 1) / TILE, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, out, scratch, rows, segs,
                                                            bits, nbits);
  }
  return static_cast<int>(cudaGetLastError());
}
