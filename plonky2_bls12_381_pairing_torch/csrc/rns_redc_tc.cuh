// The RNS Montgomery reduction with its two base extensions on the tensor
// cores (ops/rns/fp.py redc), for a tile of R packed rows per block.
//
// Layout: 128 threads per packed row, R rows per block (thread = row * 128 +
// lane); a thread holds its lane's residue of every value (rns_common.cuh).
// Steps 1, 3 and 5 run lane by lane. Steps 2 and 4, the two
// base extensions, are matrix products over the tile: the M = 24 R rows
// (12 components x 2 slots x R rows) of sigmas, K = 32 (the 31 channels of
// one base and a zero pad), times the extension block (fp._ext_matmul's
// matrices, restricted to the columns the step needs). Each product is
// three exact u8 tensor-core products (mma.sync m16n8k32, s32 sums) of the
// 7/6-bit planes lo, hi and lo + hi of both operands, combined in int32 as
// ll + ((sum - ll - hh) << 7) + (hh << 14), as fp._ext_matmul does. Every
// plane is below 2^8 (sigma: lo < 128, hi <= 55, lo + hi <= 182; table:
// lo + hi <= 190) and every partial and combined sum below 2^31, so the
// integers are those of the per-lane dot products over the slot's sigmas,
// and a REDC output, which depends only on them, is the same row.
//
// Columns: step 2 writes slot lanes B_LO..ALPHA_LANE (31 base B, the
// redundant lane, the alpha column) as columns 0..32, padded to 40; step 4
// writes base-A lanes 0..30 as columns 0..30 and the beta column (lane
// ALPHA_LANE) as column 31. The u8 plane tables come from rns_tables.h
// (ops/rns/kernel_tables.py) as [plane][column][k], the "col" operand of
// mma.sync; the block copies them into shared memory once.
#pragma once

#include <cstdint>

#include "rns_common.cuh"

// A build of these sources for the host CPU (tests/torch_cuda_emu.py)
// defines RNS_HOST_EMU: it brings its own extend, the same integer sums
// without the tensor cores, and its RNS_REDC_RECORD logs every REDC's
// inputs and outputs.
#ifndef RNS_HOST_EMU
#define RNS_REDC_RECORD(x, first)
#endif

namespace rns {

constexpr int TC_K = RNS_TC_K;    // channels of one base and a zero pad
constexpr int TC_N1 = RNS_TC_N1;  // step-2 columns (33 used)
constexpr int TC_N2 = RNS_TC_N2;  // step-4 columns
// bytes per plane row in shared memory: 12 words, so that the eight rows a
// fragment load touches fall in distinct banks
constexpr int TC_PITCH = 48;

static_assert(RNS_NCH < TC_K && TC_N1 >= SUB - RNS_B_LO && TC_N2 == RNS_NCH + 1,
              "the plane tables do not fit the tensor-core tile");

// Shared memory of one block of R packed rows.
template <int R>
struct TcSmem {
  static constexpr int M = 12 * PACK * R;
  static_assert(M % 16 == 0, "R must make the sigma matrix a whole number of 16-row tiles");
  alignas(16) unsigned char t1[3][TC_N1][TC_PITCH];
  alignas(16) unsigned char t2[3][TC_N2][TC_PITCH];
  // sigma planes of step 2, then the sigma' planes of step 4
  alignas(16) unsigned char sig[3][M][TC_PITCH];
  // the extension's sums of step 2, then of step 4
  alignas(16) int ext[M][TC_N1];
};

// Copy the plane tables into shared memory; a barrier must follow before
// the first REDC reads them (the REDC's own first barrier does).
template <int R>
__device__ __forceinline__ void load_tc_tables(TcSmem<R>& s) {
  for (int i = threadIdx.x; i < 3 * TC_N1 * TC_K; i += blockDim.x) {
    const int p = i / (TC_N1 * TC_K), n = i / TC_K % TC_N1, k = i % TC_K;
    s.t1[p][n][k] = RNS_T1_PLANES[p][n][k];
  }
  for (int i = threadIdx.x; i < 3 * TC_N2 * TC_K; i += blockDim.x) {
    const int p = i / (TC_N2 * TC_K), n = i / TC_K % TC_N2, k = i % TC_K;
    s.t2[p][n][k] = RNS_T2_PLANES[p][n][k];
  }
}

// The three planes of a canonical residue v < 2^13 at row m, column k.
template <int M>
__device__ __forceinline__ void put_planes(unsigned char (&sig)[3][M][TC_PITCH], int m, int k,
                                           int v) {
  const int lo = v & ((1 << RNS_PLANE_BITS) - 1), hi = v >> RNS_PLANE_BITS;
  sig[0][m][k] = static_cast<unsigned char>(lo);
  sig[1][m][k] = static_cast<unsigned char>(hi);
  sig[2][m][k] = static_cast<unsigned char>(lo + hi);
}

__device__ __forceinline__ uint32_t ld4(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

#ifdef RNS_HOST_EMU
#include "rns_emu_extend.h"
#else
// d = a (16 x 32, u8, row) * b (32 x 8, u8, col) on the tensor cores.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0), "r"(0),
        "r"(0), "r"(0));
}

// ext[m][n] = sum_k sigma[m][k] T[k][n] for the M x N tile: the block's
// warps take its 16 x 8 output tiles in turn, each as three plane products.
template <int M, int N>
__device__ __forceinline__ void extend(const unsigned char (&sig)[3][M][TC_PITCH],
                                       const unsigned char (&t)[3][N][TC_PITCH],
                                       int (&ext)[M][TC_N1]) {
  constexpr int NT = N / 8, TILES = M / 16 * NT;
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int g = threadIdx.x % 32 / 4, q = threadIdx.x % 4;
  for (int tile = warp; tile < TILES; tile += nwarps) {
    const int m0 = tile / NT * 16, n0 = tile % NT * 8;
    int d[3][4];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint32_t a[4] = {ld4(&sig[p][m0 + g][4 * q]), ld4(&sig[p][m0 + g + 8][4 * q]),
                             ld4(&sig[p][m0 + g][16 + 4 * q]),
                             ld4(&sig[p][m0 + g + 8][16 + 4 * q])};
      const uint32_t b[2] = {ld4(&t[p][n0 + g][4 * q]), ld4(&t[p][n0 + g][16 + 4 * q])};
      mma_u8(d[p], a, b);
    }
    int v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ll = d[0][i], hh = d[1][i];
      v[i] = ll + ((d[2][i] - ll - hh) << RNS_PLANE_BITS) + (hh << (2 * RNS_PLANE_BITS));
    }
    ext[m0 + g][n0 + 2 * q] = v[0];
    ext[m0 + g][n0 + 2 * q + 1] = v[1];
    ext[m0 + g + 8][n0 + 2 * q] = v[2];
    ext[m0 + g + 8][n0 + 2 * q + 1] = v[3];
  }
}

#endif  // RNS_HOST_EMU

// K <= 12 stacked reductions of the thread's row (fp.redc, steps 1-4):
// x[k] holds the lane's residue of X_k (value in
// [0, MA*p)); on return, the canonical residue of the stored element. Every
// thread of the block must call it (four barriers). Each shared word is
// rewritten only after a barrier that follows its last read: the sigma
// planes of step 1 are last read in step 2, rewritten in step 3; the sums of
// step 2 last read in step 3, rewritten in step 4; the planes of step 3 and
// the sums of step 4 are rewritten by the next REDC after its first barrier.
template <int K, int R>
__device__ __forceinline__ void redc(int (&x)[K], const Lane& c, TcSmem<R>& s) {
  static_assert(K <= 12, "the tile holds 12 components");
  RNS_REDC_RECORD(x, true);
  const int lane = threadIdx.x % LANES;
  const int l = lane % SUB;
  const int m0 = (threadIdx.x / LANES * PACK + lane / SUB) * 12;

  // step 1: sigma_i = X * (-p^-1) * (MA/a_i)^-1 mod a_i on base A; lane
  // B_LO's sigma is 0 and fills the pad column
  if (l < TC_K) {
#pragma unroll
    for (int k = 0; k < K; ++k) put_planes(s.sig, m0 + k, l, mul_m(x[k], c.c_sigma, c));
  }
  __syncthreads();

  // step 2: extend q to base B + r; column ALPHA_LANE - B_LO holds the
  // Kawamura fixed-point alpha
  extend(s.sig, s.t1, s.ext);
  __syncthreads();

  // step 3, lanes B_LO..ALPHA_LANE: qhat = s - alpha * (MA mod m); the
  // output r = (X + qhat p) MA^-1 and sigma'_j = r_j (MB/b_j)^-1 mod b_j
  // straight from (X, qhat). The redundant lane's sigma' is 0 and fills the
  // pad column; the alpha lane's constants are 0.
  if (l >= RNS_B_LO) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int* e = s.ext[m0 + k];
      const int alpha = e[RNS_ALPHA_LANE - RNS_B_LO] >> RNS_ALPHA_T;
      const int qh = barrett(e[l - RNS_B_LO] - alpha * c.c_mamod, c);
      const int sp = barrett(x[k] * c.c_mainv_mbinv + qh * c.c_pmainv_mbinv, c);
      x[k] = barrett(x[k] * c.c_mainv + qh * c.c_pmainv, c);
      if (l < RNS_B_LO + TC_K) put_planes(s.sig, m0 + k, l - RNS_B_LO, sp);
    }
  }
  __syncthreads();

  // step 4: extend r back to base A; column TC_N2 - 1, rounded, is the exact
  // wrap count beta
  extend(s.sig, s.t2, s.ext);
  __syncthreads();

  // base A takes the back-extended value
  if (c.is_a) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int* e = s.ext[m0 + k];
      const int beta = (e[TC_N2 - 1] + (1 << (RNS_BETA_T - 1))) >> RNS_BETA_T;
      x[k] = barrett(e[l] - beta * c.c_mbmod, c);
    }
  }
  RNS_REDC_RECORD(x, false);
}

}  // namespace rns
