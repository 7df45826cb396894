// Tiles of packed rows for the kernels on the tensor-core REDC
// (rns_redc_tc.cuh): a block of TILE * 128 threads works on TILE packed rows
// at once, thread = row in the tile * 128 + lane. Rows past the end (in the
// last tile) compute on zeros and store nothing; their threads still take
// every barrier.
#pragma once

#include "rns_redc_tc.cuh"
#include "rns_tower.cuh"

namespace rns {

// The thread's lane and constants.
struct Block {
  Lane c;
  int lane, l;
};

// Copy the plane tables into shared memory and read the thread's lane
// constants.
template <int TILE>
__device__ __forceinline__ Block enter(TcSmem<TILE>& s) {
  load_tc_tables(s);
  __syncthreads();
  Block b;
  b.lane = threadIdx.x % LANES;
  b.l = b.lane % SUB;
  b.c = load_lane(b.l);
  return b;
}

// The thread's packed row in tile `tile`.
struct Row {
  long long row;
  bool live;
};

template <int TILE>
__device__ __forceinline__ Row row_of(int tile, int rows) {
  const long long row = static_cast<long long>(tile) * TILE + threadIdx.x / LANES;
  return {row, row < rows};
}

__device__ __forceinline__ void load12m(int (&f)[12], const int* base, long long stride,
                                        const Row& r, int lane) {
  if (r.live) {
    load12(f, base, stride, r.row, lane);
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) f[k] = 0;
  }
}

__device__ __forceinline__ F2 load2m(const int* base, long long stride, const Row& r,
                                     int lane) {
  return r.live ? load2(base, stride, r.row, lane) : F2{0, 0};
}

// One int of the thread's row and lane of a (rows, 128) array.
__device__ __forceinline__ int load1m(const int* base, const Row& r, int lane) {
  return r.live ? base[r.row * LANES + lane] : 0;
}

// Which of K stored values (<= 4p, canonical residues) are 0 mod p, per
// packed slot (fp.is_zero): a value is zero iff its slot equals the residues
// of k*p on every channel lane for one k in 0..4. Bit k of the result is set
// if x[k] is zero in the calling thread's slot. Each thread forms a 5-bit
// match mask per value, a warp reduces by AND, and the two warps of a slot
// meet in `words`, one per warp of the block. Every thread of the block
// must call it.
template <int K, int W>
__device__ __forceinline__ unsigned zero_mask(const int (&x)[K], int l, int (&words)[W]) {
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

}  // namespace rns
