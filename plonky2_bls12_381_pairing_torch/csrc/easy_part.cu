// The final exponentiation's easy part, f^((p^6 - 1)(p^2 + 1)) =
// frob^2(t) * t with t = conj(f) * inv(f), as three entry points around the
// batched Fp inverse of fp.inv:
//   easy_down  per packed row, from f down to one Fp element per slot:
//              tower.inv's norm into Fq6 (6-row REDC), _fq6_inv's adjugate
//              (6) and norm (2), _fq2_inv's norm (1); fp.inv's zero mask (a
//              zero norm goes into the tree as one);
//   tree_mul   one level of fp.inv's product tree: out[i] = a[i & amask] *
//              b[i ^ bxor], which is cur[:h] * cur[h:] up the tree and both
//              halves of [invc * level[h:], invc * level[:h]] down it; rows of
//              b past b_rows read as one (the padding to a power of two);
//   easy_up    per packed row, from the norm's inverse (zero where the norm
//              was zero) back up: _fq2_inv's scaled conjugate (2), _fq6_inv's
//              product (6), tower.inv's (12), conj(f) * inv(f) (12), two
//              Frobenius maps (10 each) and the last product (12).
// Between them the wrapper (ops/rns/kernels.py easy_part) runs the tree's
// levels down to fp._TREE_FLOOR rows and the unchanged Fermat root
// (pow_static.cu), so the rows are those of fp.inv's tree pair for pair.
//
// Replaces the PyTorch composition of models/pairing_rns.py's easy part,
// which on a card ran its formulas as a few thousand small kernels; its
// plain version is ops/rns/kernels.py easy_part_plain, and the rows agree
// bit for bit. Every REDC input is the plain formula's integer: the same
// stacking and order of reductions, and the bias multiple of each of their
// rows from rns_tables.h (kernel_tables.static_biases, EASY_STAGES).
//
// The design: the tensor-core REDC (rns_redc_tc.cuh) on tiles of TILE packed
// rows, as tower_ops.cu; persistent blocks striding over the tiles. Each
// per-row kernel keeps every intermediate of its formulas in registers and
// stores its result once; easy_down leaves easy_up the adjugate, the Fq6
// norm and the zero mask (9 x 128 int32 a packed row). The tree's product
// kernel takes 12 Fp rows per thread, so that one 12-row REDC of the tile
// reduces 12 independent products.
//
// What bounds them on an H100: latency. Measured on an NVIDIA H100 80GB HBM3
// at 700 W (chip_smoke.py phase 2, 1024 packed rows): easy_down 0.028 ms,
// the tree's six tree_mul launches 0.066 together, easy_up 0.080, against
// bounds of 0.003, 0.0005 and 0.005 ms by bytes; a tile's REDCs (4 in
// easy_down, 7 in easy_up) run one after another, four block barriers each.
// The whole chain, pow_static's 0.19 ms included, takes 0.364 ms, where the
// PyTorch composition took about 7.5 ms in 3,502 kernels inside the
// pairing's graph.

#include <algorithm>

#include "rns_tile.cuh"

namespace {

using namespace rns;

// packed rows per tile
constexpr int TILE = RNS_TC_ROWS;
constexpr int THREADS = TILE * LANES;
constexpr int WARPS = THREADS / 32;
// residues per lane and packed row that easy_down leaves for easy_up: the
// Fq6 adjugate, its norm and the zero mask of the norm's norm
constexpr int MID_ADJ = 0, MID_NORM = 6, MID_ZERO = 8, MID = 9;

// The bias rows of a K-row stage (rns_tables.h, the thread's lane l), then
// its stacked reduction, in place.
template <int K>
__device__ __forceinline__ void bias_redc_k(int (&x)[K], const int (*bias)[SUB], int l,
                                            const Lane& c, TcSmem<TILE>& s) {
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = add_m(x[k], bias[k][l], c);
  redc<K>(x, c, s);
}

// f: rows of (12, 128) int32, sf ints apart; mid: (rows, MID, 128); nrm:
// (rows, 128), the norm's norm with one in the slots where it is zero.
__global__ void __launch_bounds__(THREADS, 2)
    easy_down_kernel(const int* __restrict__ f, long long sf, int* __restrict__ mid,
                     int* __restrict__ nrm, int rows) {
  __shared__ TcSmem<TILE> s;
  __shared__ int words[WARPS];
  const Block t = enter(s);
  const Lane& c = t.c;
  for (int tile = blockIdx.x; tile * TILE < rows; tile += gridDim.x) {
    const Row r = row_of<TILE>(tile, rows);
    // tower.inv: the norm into Fq6, c0^2 - v c1^2 with v (x0, x1, x2) =
    // (xi x2, x0, x1)
    int x[6];
    {
      int a[12];
      load12m(a, f, sf, r, t.lane);
      F2 a0[3], a1[3], sq0[3], sq1[3];
      split(a, a0, a1);
      fq6_mul(a0, a0, sq0, c);
      fq6_mul(a1, a1, sq1, c);
      const F2 d[3] = {f2_sub(sq0[0], f2_nonres(sq1[2], c), c), f2_sub(sq0[1], sq1[0], c),
                       f2_sub(sq0[2], sq1[1], c)};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        x[2 * i] = d[i].c0;
        x[2 * i + 1] = d[i].c1;
      }
    }
    bias_redc_k(x, RNS_INV_NORM_BIAS, t.l, c, s);
    // _fq6_inv: the adjugate t0 = a0^2 - xi a1 a2, t1 = xi a2^2 - a0 a1,
    // t2 = a1^2 - a0 a2 of (a0, a1, a2)
    const F2 a0{x[0], x[1]}, a1{x[2], x[3]}, a2{x[4], x[5]};
    int adj[6];
    {
      const F2 d[3] = {f2_sub(f2_mul(a0, a0, c), f2_nonres(f2_mul(a1, a2, c), c), c),
                       f2_sub(f2_nonres(f2_mul(a2, a2, c), c), f2_mul(a0, a1, c), c),
                       f2_sub(f2_mul(a1, a1, c), f2_mul(a0, a2, c), c)};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        adj[2 * i] = d[i].c0;
        adj[2 * i + 1] = d[i].c1;
      }
    }
    bias_redc_k(adj, RNS_F6_ADJ_BIAS, t.l, c, s);
    // its norm a0 t0 + xi (a2 t1 + a1 t2)
    int nv[2];
    {
      const F2 n = f2_add(f2_mul(a0, F2{adj[0], adj[1]}, c),
                          f2_nonres(f2_add(f2_mul(a2, F2{adj[2], adj[3]}, c),
                                           f2_mul(a1, F2{adj[4], adj[5]}, c), c),
                                    c),
                          c);
      nv[0] = n.c0;
      nv[1] = n.c1;
    }
    bias_redc_k(nv, RNS_F6_NORM_BIAS, t.l, c, s);
    // _fq2_inv: the norm c0^2 + c1^2, no bias
    int nn[1] = {add_m(mul_m(nv[0], nv[0], c), mul_m(nv[1], nv[1], c), c)};
    redc<1>(nn, c, s);
    // fp.inv's zero mask
    const bool zero = zero_mask(nn, t.l, words) & 1u;
    if (r.live) {
      int* m = mid + r.row * MID * LANES + t.lane;
#pragma unroll
      for (int k = 0; k < 6; ++k) m[(MID_ADJ + k) * LANES] = adj[k];
      m[MID_NORM * LANES] = nv[0];
      m[(MID_NORM + 1) * LANES] = nv[1];
      m[MID_ZERO * LANES] = zero;
      nrm[r.row * LANES + t.lane] = zero ? RNS_ONE[t.l] : nn[0];
    }
  }
}

// out[i] = a[i & amask] * b[i ^ bxor] for i < count, (rows, 128) int32 each;
// rows of b at or past b_rows read as one. Thread (group g, lane) takes the
// 12 rows 12 g .. 12 g + 11, TILE groups a block.
__global__ void __launch_bounds__(THREADS, 2)
    tree_mul_kernel(const int* __restrict__ a, int amask, const int* __restrict__ b, int bxor,
                    int b_rows, int* __restrict__ out, int count) {
  __shared__ TcSmem<TILE> s;
  const Block t = enter(s);
  const Lane& c = t.c;
  const int one = RNS_ONE[t.l];
  const int groups = (count + 11) / 12;
  for (int tile = blockIdx.x; tile * TILE < groups; tile += gridDim.x) {
    const int first = (tile * TILE + static_cast<int>(threadIdx.x) / LANES) * 12;
    int x[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const int i = first + k, j = i ^ bxor;
      const int bv = j < b_rows ? b[static_cast<long long>(j) * LANES + t.lane] : one;
      x[k] = i < count
                 ? mul_m(a[static_cast<long long>(i & amask) * LANES + t.lane], bv, c)
                 : 0;
    }
    redc<12>(x, c, s);
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      if (first + k < count) out[static_cast<long long>(first + k) * LANES + t.lane] = x[k];
    }
  }
}

// f as easy_down's; mid its output; w: (rows, 128), the inverse of its nrm;
// out: (rows, 12, 128).
__global__ void __launch_bounds__(THREADS, 1)
    easy_up_kernel(const int* __restrict__ f, long long sf, const int* __restrict__ mid,
                   const int* __restrict__ w, int* __restrict__ out, int rows) {
  __shared__ TcSmem<TILE> s;
  const Block t = enter(s);
  const Lane& c = t.c;
  const int l = t.l;
  const int pmul4 = RNS_PMUL4[l];
  for (int tile = blockIdx.x; tile * TILE < rows; tile += gridDim.x) {
    const Row r = row_of<TILE>(tile, rows);
    int adj[6], d[2];
    {
      int nv[2] = {0, 0}, iv = 0;
#pragma unroll
      for (int k = 0; k < 6; ++k) adj[k] = 0;
      if (r.live) {
        const int* m = mid + r.row * MID * LANES + t.lane;
#pragma unroll
        for (int k = 0; k < 6; ++k) adj[k] = m[(MID_ADJ + k) * LANES];
        nv[0] = m[MID_NORM * LANES];
        nv[1] = m[(MID_NORM + 1) * LANES];
        // fp.inv: zero where the norm was zero
        iv = m[MID_ZERO * LANES] ? 0 : w[r.row * LANES + t.lane];
      }
      // _fq2_inv: (c0 - c1 u) times the inverse
      d[0] = mul_m(nv[0], iv, c);
      d[1] = mul_m(sub_m(pmul4, nv[1], c), iv, c);
    }
    bias_redc_k(d, RNS_KDINV_BIAS, l, c, s);
    // _fq6_inv: the adjugate times the norm's inverse
    int ti[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const F2 p = f2_mul(F2{adj[2 * i], adj[2 * i + 1]}, F2{d[0], d[1]}, c);
      ti[2 * i] = p.c0;
      ti[2 * i + 1] = p.c1;
    }
    bias_redc_k(ti, RNS_F6_OUT_BIAS, l, c, s);
    // tower.inv: (c0 - c1 w) ti, the negation as 4p - x
    int a[12], g[12];
    load12m(a, f, sf, r, t.lane);
    {
      F2 a0[3], a1[3], tv[3], o0[3], o1[3];
      split(a, a0, a1);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a1[i] = {sub_m(pmul4, a1[i].c0, c), sub_m(pmul4, a1[i].c1, c)};
        tv[i] = {ti[2 * i], ti[2 * i + 1]};
      }
      fq6_mul(a0, tv, o0, c);
      fq6_mul(a1, tv, o1, c);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        g[2 * i] = o0[i].c0;
        g[2 * i + 1] = o0[i].c1;
        g[6 + 2 * i] = o1[i].c0;
        g[7 + 2 * i] = o1[i].c1;
      }
    }
    bias_redc_k(g, RNS_INV_OUT_BIAS, l, c, s);
    // t = conj(f) inv(f)
#pragma unroll
    for (int k = 6; k < 12; ++k) a[k] = sub_m(pmul4, a[k], c);
    fq12_mul<SUB>(a, g, c, s, bias_at(RNS_MUL_BIAS, l));
    // frob^2(t) t
#pragma unroll
    for (int k = 0; k < 12; ++k) g[k] = a[k];
    frobenius<SUB>(g, l, c, s, bias_at(RNS_FROB_BIAS, l));
    frobenius<SUB>(g, l, c, s, bias_at(RNS_FROB_BIAS, l));
    fq12_mul<SUB>(g, a, c, s, bias_at(RNS_MUL_BIAS, l));
    if (r.live) store12(g, out, r.row, t.lane);
  }
}

// Persistent grid: one block per tile, at most as many as the card holds at
// once (the blocks then stride over the rest).
template <auto kernel>
int grid_for(int tiles) {
  static int per_sm = 0;  // the same on every card of the build's architecture
  if (per_sm == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::max(1, std::min(tiles, sms * std::max(per_sm, 1)));
}

inline int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" int easy_down_launch(const int* f, long long sf, int* mid, int* nrm, int rows,
                                void* stream) {
  if (rows > 0) {
    const int grid = grid_for<easy_down_kernel>((rows + TILE - 1) / TILE);
    easy_down_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(f, sf, mid, nrm,
                                                                             rows);
  }
  return launched();
}

extern "C" int tree_mul_launch(const int* a, int amask, const int* b, int bxor, int b_rows,
                               int* out, int count, void* stream) {
  if (count > 0) {
    const int grid = grid_for<tree_mul_kernel>(((count + 11) / 12 + TILE - 1) / TILE);
    tree_mul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, amask, b, bxor, b_rows, out, count);
  }
  return launched();
}

extern "C" int easy_up_launch(const int* f, long long sf, const int* mid, const int* w,
                              int* out, int rows, void* stream) {
  if (rows > 0) {
    const int grid = grid_for<easy_up_kernel>((rows + TILE - 1) / TILE);
    easy_up_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(f, sf, mid, w,
                                                                           out, rows);
  }
  return launched();
}
