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

}  // namespace rns
