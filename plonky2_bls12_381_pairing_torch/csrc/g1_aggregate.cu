// The segmented sum of G1 public keys (FastAggregateVerify's aggregation) on
// the RNS tier: a signature set's keys are registry rows picked by its bits
// through an index list, summed in projective coordinates by the complete
// formulas of ops/rns/g1.py (Renes-Costello-Batina, a = 0), two kernels:
//   g1_sum      per piece of a set (a run of its bits): from the point at
//               infinity, for each bit in order, P <- P + key where the bit is
//               set (Algorithm 8, the key affine); one partial sum a piece;
//   g1_combine  per set: its pieces' partial sums added in order
//               (Algorithm 7).
// A set's bit i picks the key registry[index[set_off[set] + i]]; its bits are
// 32 to a word, bit i in word i / 32 at i % 32. The pieces and the sets'
// piece ranges are tables the wrapper makes once per shape
// (ops/rns/kernels.py g1_aggregate). Its plain version is
// kernels.g1_aggregate_plain: the same pieces, the same order of additions,
// and every REDC input the plain formula's integer (g1.py's stacking and
// order of reductions, and the bias multiple of each second-stage row from
// rns_tables.h, kernel_tables.static_biases "g1_madd" / "g1_add"), so the rows
// agree bit for bit.
//
// The design: the tensor-core REDC (rns_redc_tc.cuh) on tiles of TILE packed
// rows, as kara_exp.cu; persistent blocks striding over the tiles. The 64
// threads of a packed slot (one lane each) carry ACC independent
// accumulators, each on its own piece (or set), so that one stacked REDC of
// the tile reduces ACC additions' stages at once: 5 ACC then 3 ACC rows a
// step of g1_sum, 6 ACC then 3 ACC of g1_combine. All of a tile's threads run
// the longest piece's steps (the REDC's barriers), and a step whose bit is
// clear keeps its accumulator. The next step's key and the step after's
// index are read while the current step reduces (Reader).

#include <algorithm>

#include "rns_tile.cuh"

namespace {

using namespace rns;

// packed rows per tile: 2-row tiles run three blocks an SM (80 registers),
// where 4-row tiles run one; on an H100 g1_sum takes 42.3 ms for the
// electra-agg-64x12 cell's sums against 50.0 (46.7 at two blocks an SM)
constexpr int TILE = 2;
constexpr int THREADS = TILE * LANES;
// 64-thread slots per tile, accumulators per thread, pieces (sets) per tile
constexpr int SLOTS = TILE * PACK;
constexpr int ACC = 2;
constexpr int PER_TILE = SLOTS * ACC;
// int32 per key row of the registry: x's slot, then y's
constexpr int KEY = 2 * SUB;
constexpr int B3 = 12;

// A lane of a projective point.
struct Pt {
  int x, y, z;
};

// The second stage of both additions (g1.py _level2_terms) from the first's
// residues: X3 = t3 (t1 - t2) - t4 y3s, Y3 = (t1 - t2)(t1 + t2) + y3s t0x3,
// Z3 = (t1 + t2) t4 + t0x3 t3 with y3s = b3 y3, t0x3 = 3 t0, t2 already b3
// times its product; the bias rows added.
__device__ __forceinline__ void level2(int t0, int t1, int t3, int t4, int y3, int t2,
                                       int* out, const int (*bias)[SUB], int l,
                                       const Lane& c) {
  const int t0x3 = add_m(add_m(t0, t0, c), t0, c);
  const int z3 = add_m(t1, t2, c);
  const int t1m = sub_m(t1, t2, c);
  const int y3s = mul_m(y3, B3, c);
  // each output one Barrett: two products of residues and a bias residue
  // stay below 2^27, inside its domain
  out[0] = barrett(t3 * t1m - t4 * y3s + bias[0][l], c);
  out[1] = barrett(t1m * z3 + y3s * t0x3 + bias[1][l], c);
  out[2] = barrett(z3 * t4 + t0x3 * t3 + bias[2][l], c);
}

// P + (x2, y2) (Algorithm 8), both stages' REDCs over the ACC accumulators.
__device__ __forceinline__ void madd(Pt (&p)[ACC], const int (&x2)[ACC], const int (&y2)[ACC],
                                     int l, const Lane& c, TcSmem<TILE>& s) {
  int a[5 * ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    a[5 * k] = mul_m(p[k].x, x2[k], c);
    a[5 * k + 1] = mul_m(p[k].y, y2[k], c);
    a[5 * k + 2] = mul_m(add_m(x2[k], y2[k], c), add_m(p[k].x, p[k].y, c), c);
    a[5 * k + 3] = mul_m(y2[k], p[k].z, c);
    a[5 * k + 4] = mul_m(x2[k], p[k].z, c);
  }
  redc<5 * ACC>(a, c, s);
  int b[3 * ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    const int* t = a + 5 * k;
    level2(t[0], t[1], sub_m(sub_m(t[2], t[0], c), t[1], c), add_m(t[3], p[k].y, c),
           add_m(t[4], p[k].x, c), mul_m(p[k].z, B3, c), b + 3 * k, RNS_G1_MADD_BIAS, l, c);
  }
  redc<3 * ACC>(b, c, s);
#pragma unroll
  for (int k = 0; k < ACC; ++k) p[k] = {b[3 * k], b[3 * k + 1], b[3 * k + 2]};
}

// P + Q (Algorithm 7), both stages' REDCs over the ACC accumulators.
__device__ __forceinline__ void add(Pt (&p)[ACC], const Pt (&q)[ACC], int l, const Lane& c,
                                    TcSmem<TILE>& s) {
  int a[6 * ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    a[6 * k] = mul_m(p[k].x, q[k].x, c);
    a[6 * k + 1] = mul_m(p[k].y, q[k].y, c);
    a[6 * k + 2] = mul_m(p[k].z, q[k].z, c);
    a[6 * k + 3] = mul_m(add_m(p[k].x, p[k].y, c), add_m(q[k].x, q[k].y, c), c);
    a[6 * k + 4] = mul_m(add_m(p[k].y, p[k].z, c), add_m(q[k].y, q[k].z, c), c);
    a[6 * k + 5] = mul_m(add_m(p[k].x, p[k].z, c), add_m(q[k].x, q[k].z, c), c);
  }
  redc<6 * ACC>(a, c, s);
  int b[3 * ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    const int* t = a + 6 * k;
    level2(t[0], t[1], sub_m(sub_m(t[3], t[0], c), t[1], c),
           sub_m(sub_m(t[4], t[1], c), t[2], c), sub_m(sub_m(t[5], t[0], c), t[2], c),
           mul_m(t[2], B3, c), b + 3 * k, RNS_G1_ADD_BIAS, l, c);
  }
  redc<3 * ACC>(b, c, s);
#pragma unroll
  for (int k = 0; k < ACC; ++k) p[k] = {b[3 * k], b[3 * k + 1], b[3 * k + 2]};
}

// One accumulator's piece (int4: set, its first word in `words`, its first
// bit in the set, its bits) and its reads, made a step ahead: while step i
// reduces, step i + 1's key row and bit word are on their way, and step
// i + 2's index, so that no load is waited for inside a step (a key is read
// whether its bit is set or not; a step past the piece reads key 0 and no
// bit).
struct Reader {
  const int* pos;   // the piece's positions in the index list
  const int* word;  // its bit words
  int bit0, bits;
  int idx, kx, ky, w;  // step i + 1's index, key lanes and bit word
  int idx2;            // step i + 2's index

  __device__ __forceinline__ void start(const int4& v, const int* __restrict__ index,
                                        const int* __restrict__ set_off,
                                        const int* __restrict__ words) {
    bit0 = v.z;
    bits = v.w;
    pos = index + (bits ? set_off[v.x] : 0) + bit0;
    word = words + v.y;
    idx2 = bits > 0 ? pos[0] : 0;
  }

  // Issue the reads of step i + 1's key and word and step i + 2's index.
  __device__ __forceinline__ void read(int i, const int* keys, int l) {
    idx = idx2;
    const int* key = keys + static_cast<long long>(idx) * KEY + l;
    kx = key[0];
    ky = key[SUB];
    w = i + 1 < bits ? word[(bit0 + i + 1) >> 5] : 0;
    idx2 = i + 2 < bits ? pos[i + 2] : 0;
  }

  // Whether step i + 1's bit is set.
  __device__ __forceinline__ bool bit(int i) const {
    return (w >> ((bit0 + i + 1) & 31)) & 1;
  }
};

// keys: (n, 2, 64) registry rows; index: the index list; set_off: (sets,)
// each set's first position in it; words: the sets' bit words; pieces:
// (n_pieces, 4); partial: (n_pieces, 3, 64).
__global__ void __launch_bounds__(THREADS, 3)
    g1_sum_kernel(const int* __restrict__ keys, const int* __restrict__ index,
                  const int* __restrict__ set_off, const int* __restrict__ words,
                  const int4* __restrict__ pieces, int n_pieces, int* __restrict__ partial) {
  __shared__ TcSmem<TILE> s;
  const Block t = enter(s);
  const Lane& c = t.c;
  const int l = t.l, slot = threadIdx.x / SUB;
  const int one = RNS_ONE[l];
  for (int tile = blockIdx.x; tile * PER_TILE < n_pieces; tile += gridDim.x) {
    int steps = 0;
    for (int k = 0; k < PER_TILE && tile * PER_TILE + k < n_pieces; ++k) {
      steps = max(steps, pieces[tile * PER_TILE + k].w);
    }
    Reader r[ACC];
    Pt p[ACC];
#pragma unroll
    for (int k = 0; k < ACC; ++k) {
      const int i = tile * PER_TILE + k * SLOTS + slot;
      r[k].start(i < n_pieces ? pieces[i] : make_int4(0, 0, 0, 0), index, set_off, words);
      r[k].read(-1, keys, l);
      p[k] = {0, one, 0};
    }
    for (int i = 0; i < steps; ++i) {
      int x2[ACC], y2[ACC];
      bool use[ACC];
      Pt old[ACC];
#pragma unroll
      for (int k = 0; k < ACC; ++k) {
        x2[k] = r[k].kx;
        y2[k] = r[k].ky;
        use[k] = r[k].bit(i - 1);
        old[k] = p[k];
        r[k].read(i, keys, l);
      }
      madd(p, x2, y2, l, c, s);
#pragma unroll
      for (int k = 0; k < ACC; ++k) {
        if (!use[k]) p[k] = old[k];
      }
    }
#pragma unroll
    for (int k = 0; k < ACC; ++k) {
      const int i = tile * PER_TILE + k * SLOTS + slot;
      if (i < n_pieces) {
        int* o = partial + static_cast<long long>(i) * 3 * SUB + l;
        o[0] = p[k].x;
        o[SUB] = p[k].y;
        o[2 * SUB] = p[k].z;
      }
    }
  }
}

// partial: (n_pieces, 3, 64); sets: (n_sets, 2), each set's first piece and
// its count of pieces; out: (3, n_sets, 64).
__global__ void __launch_bounds__(THREADS, 3)
    g1_combine_kernel(const int* __restrict__ partial, const int* __restrict__ sets, int n_sets,
                      int* __restrict__ out) {
  __shared__ TcSmem<TILE> s;
  const Block t = enter(s);
  const Lane& c = t.c;
  const int l = t.l, slot = threadIdx.x / SUB;
  const int one = RNS_ONE[l];
  for (int tile = blockIdx.x; tile * PER_TILE < n_sets; tile += gridDim.x) {
    int steps = 0;
    for (int k = 0; k < PER_TILE && tile * PER_TILE + k < n_sets; ++k) {
      steps = max(steps, sets[2 * (tile * PER_TILE + k) + 1]);
    }
    int first[ACC], count[ACC];
    Pt p[ACC];
#pragma unroll
    for (int k = 0; k < ACC; ++k) {
      const int i = tile * PER_TILE + k * SLOTS + slot;
      first[k] = i < n_sets ? sets[2 * i] : 0;
      count[k] = i < n_sets ? sets[2 * i + 1] : 0;
      const int* v = partial + static_cast<long long>(first[k]) * 3 * SUB + l;
      p[k] = count[k] ? Pt{v[0], v[SUB], v[2 * SUB]} : Pt{0, one, 0};
    }
    for (int j = 1; j < steps; ++j) {
      Pt qv[ACC], old[ACC];
#pragma unroll
      for (int k = 0; k < ACC; ++k) {
        old[k] = p[k];
        qv[k] = {0, one, 0};
        if (j < count[k]) {
          const int* v = partial + static_cast<long long>(first[k] + j) * 3 * SUB + l;
          qv[k] = {v[0], v[SUB], v[2 * SUB]};
        }
      }
      add(p, qv, l, c, s);
#pragma unroll
      for (int k = 0; k < ACC; ++k) {
        if (j >= count[k]) p[k] = old[k];
      }
    }
#pragma unroll
    for (int k = 0; k < ACC; ++k) {
      const int i = tile * PER_TILE + k * SLOTS + slot;
      if (i < n_sets) {
        out[static_cast<long long>(i) * SUB + l] = p[k].x;
        out[(static_cast<long long>(n_sets) + i) * SUB + l] = p[k].y;
        out[(2 * static_cast<long long>(n_sets) + i) * SUB + l] = p[k].z;
      }
    }
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

extern "C" int g1_sum_launch(const int* keys, const int* index, const int* set_off,
                             const int* words, const int* pieces, int n_pieces, int* partial,
                             void* stream) {
  if (n_pieces > 0) {
    const int grid = grid_for<g1_sum_kernel>((n_pieces + PER_TILE - 1) / PER_TILE);
    g1_sum_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, index, set_off, words, reinterpret_cast<const int4*>(pieces), n_pieces, partial);
  }
  return launched();
}

extern "C" int g1_combine_launch(const int* partial, const int* sets, int n_sets, int* out,
                                 void* stream) {
  if (n_sets > 0) {
    const int grid = grid_for<g1_combine_kernel>((n_sets + PER_TILE - 1) / PER_TILE);
    g1_combine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        partial, sets, n_sets, out);
  }
  return launched();
}
