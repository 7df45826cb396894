// One kernel per Fq12 tower op: the full product, the complex squaring, the
// sparse product mul_by_014, mul_by_014 followed by a squaring (the Miller
// step's ell and square), the Granger-Scott cyclotomic squaring, and one
// Frobenius power.
//
// Replaces the TPU kernel fused_op (plonky2_bls12_381_pairing_tpu/ops/rns/
// pallas.py, _build), which runs any tower formula as one kernel over row
// blocks with the formula's constants collected into its inputs; the JAX
// package sends the first five formulas through it (ops/rns/tower.py) and
// leaves the Frobenius map to XLA's fusions, which on a card were some 250
// small PyTorch kernels a call. Their plain PyTorch versions are
// ops/rns/tower.py mul_plain, square_plain, mul_by_014_plain,
// mul_by_014_square_plain, cyclotomic_square_plain and frobenius_map_plain;
// the rows agree bit for bit.
//
// What bounds them on an H100: bytes, narrowly. An op reads one or two 6 KB
// Fq12 rows and writes one, and does one 12-row REDC plus the formula's lane
// products on them; at the card's peak rates the traffic takes somewhat longer
// than the integer work (chip_smoke.py counts both from the shapes, the
// REDC's base extensions at the tensor cores' u8 rate). The design reads
// every operand once, straight into registers (one thread per lane, 128
// consecutive int32 per component: coalesced), keeps every intermediate of
// the formula on chip and stores the row once; the plain versions write each
// of the formula's intermediates to device memory instead. The REDC runs on
// the tensor cores (rns_redc_tc.cuh) over tiles of TILE packed rows. Blocks
// are persistent, as many as fit on the card at once, each striding over the
// tiles, so the u8 plane tables (7 KB) are copied into shared memory once
// per block and not once per row. Operands come with a row stride, so that
// a broadcast operand (stride 0) or a slice of a wider tensor is read in
// place.

#include <algorithm>

#include "rns_tile.cuh"

namespace {

using namespace rns;

// packed rows per tile
constexpr int TILE = RNS_TC_ROWS;
constexpr int THREADS = TILE * LANES;

// a, b: rows of (12, 128) int32, sa and sb ints apart; out: (rows, 12, 128).
__global__ void __launch_bounds__(THREADS, 2)
    fq12_mul_kernel(const int* __restrict__ a, long long sa, const int* __restrict__ b,
                    long long sb, int* __restrict__ out, int rows) {
  __shared__ TcSmem<TILE> s;
  const Block t = enter(s);
  for (int tile = blockIdx.x; tile * TILE < rows; tile += gridDim.x) {
    const Row r = row_of<TILE>(tile, rows);
    int f[12], g[12];
    load12m(f, a, sa, r, t.lane);
    load12m(g, b, sb, r, t.lane);
    fq12_mul<SUB>(f, g, t.c, s, bias_at(RNS_MUL_BIAS, t.l));
    if (r.live) store12(f, out, r.row, t.lane);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    fq12_square_kernel(const int* __restrict__ a, long long sa, int* __restrict__ out,
                       int rows) {
  __shared__ TcSmem<TILE> s;
  const Block t = enter(s);
  for (int tile = blockIdx.x; tile * TILE < rows; tile += gridDim.x) {
    const Row r = row_of<TILE>(tile, rows);
    int f[12];
    load12m(f, a, sa, r, t.lane);
    fq12_square<SUB>(f, t.c, s, bias_at(RNS_SQ_BIAS, t.l));
    if (r.live) store12(f, out, r.row, t.lane);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    fq12_cyclotomic_square_kernel(const int* __restrict__ a, long long sa,
                                  int* __restrict__ out, int rows) {
  __shared__ TcSmem<TILE> s;
  const Block t = enter(s);
  for (int tile = blockIdx.x; tile * TILE < rows; tile += gridDim.x) {
    const Row r = row_of<TILE>(tile, rows);
    int f[12];
    load12m(f, a, sa, r, t.lane);
    cyc_square<SUB>(f, t.c, s, bias_at(RNS_CYC_BIAS, t.l));
    if (r.live) store12(f, out, r.row, t.lane);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    fq12_frobenius_kernel(const int* __restrict__ a, long long sa, int* __restrict__ out,
                          int rows) {
  __shared__ TcSmem<TILE> s;
  const Block t = enter(s);
  for (int tile = blockIdx.x; tile * TILE < rows; tile += gridDim.x) {
    const Row r = row_of<TILE>(tile, rows);
    int f[12];
    load12m(f, a, sa, r, t.lane);
    frobenius<SUB>(f, t.l, t.c, s, bias_at(RNS_FROB_BIAS, t.l));
    if (r.live) store12(f, out, r.row, t.lane);
  }
}

// d0, d1, d4: rows of (2, 128) int32 (stored Fq2), s0, s1, s4 ints apart.
// SQUARE: the squaring follows, and before it the lanes that skip marks
// (rows of 128 int32, ss apart; may be null) take a back.
template <bool SQUARE>
__global__ void __launch_bounds__(THREADS, 2)
    fq12_mul_by_014_kernel(const int* __restrict__ a, long long sa,
                           const int* __restrict__ d0, long long s0,
                           const int* __restrict__ d1, long long s1,
                           const int* __restrict__ d4, long long s4,
                           const int* __restrict__ skip, long long ss,
                           int* __restrict__ out, int rows) {
  __shared__ TcSmem<TILE> s;
  const Block t = enter(s);
  for (int tile = blockIdx.x; tile * TILE < rows; tile += gridDim.x) {
    const Row r = row_of<TILE>(tile, rows);
    int f[12];
    load12m(f, a, sa, r, t.lane);
    const F2 e0 = load2m(d0, s0, r, t.lane);
    const F2 e1 = load2m(d1, s1, r, t.lane);
    const F2 e4 = load2m(d4, s4, r, t.lane);
    if constexpr (SQUARE) {
      const bool keep = r.live && skip != nullptr && skip[r.row * ss + t.lane] != 0;
      int g[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) g[k] = f[k];
      fq12_mul_by_014<SUB>(g, e0, e1, e4, t.c, s, bias_at(RNS_M014_BIAS, t.l));
#pragma unroll
      for (int k = 0; k < 12; ++k) f[k] = keep ? f[k] : g[k];
      fq12_square<SUB>(f, t.c, s, bias_at(RNS_SQ_BIAS, t.l));
    } else {
      fq12_mul_by_014<SUB>(f, e0, e1, e4, t.c, s, bias_at(RNS_M014_BIAS, t.l));
    }
    if (r.live) store12(f, out, r.row, t.lane);
  }
}

// Persistent grid: one block per tile, at most as many as the card holds at
// once (the blocks then stride over the rest).
template <auto kernel>
int grid_for(int rows) {
  static int per_sm = 0;  // the same on every card of the build's architecture
  if (per_sm == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::max(1, std::min((rows + TILE - 1) / TILE, sms * std::max(per_sm, 1)));
}

inline int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" int fq12_mul_launch(const int* a, long long sa, const int* b, long long sb,
                               int* out, int rows, void* stream) {
  if (rows > 0) {
    const int grid = grid_for<fq12_mul_kernel>(rows);
    fq12_mul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, sa, b, sb,
                                                                            out, rows);
  }
  return launched();
}

extern "C" int fq12_square_launch(const int* a, long long sa, int* out, int rows,
                                  void* stream) {
  if (rows > 0) {
    const int grid = grid_for<fq12_square_kernel>(rows);
    fq12_square_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, sa, out,
                                                                               rows);
  }
  return launched();
}

extern "C" int fq12_cyclotomic_square_launch(const int* a, long long sa, int* out,
                                             int rows, void* stream) {
  if (rows > 0) {
    const int grid = grid_for<fq12_cyclotomic_square_kernel>(rows);
    fq12_cyclotomic_square_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, sa, out, rows);
  }
  return launched();
}

extern "C" int fq12_frobenius_launch(const int* a, long long sa, int* out, int rows,
                                     void* stream) {
  if (rows > 0) {
    const int grid = grid_for<fq12_frobenius_kernel>(rows);
    fq12_frobenius_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, sa, out,
                                                                                  rows);
  }
  return launched();
}

extern "C" int fq12_mul_by_014_launch(const int* a, long long sa, const int* d0,
                                      long long s0, const int* d1, long long s1,
                                      const int* d4, long long s4, int* out, int rows,
                                      void* stream) {
  if (rows > 0) {
    const int grid = grid_for<fq12_mul_by_014_kernel<false>>(rows);
    fq12_mul_by_014_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, sa, d0, s0, d1, s1, d4, s4, nullptr, 0, out, rows);
  }
  return launched();
}

extern "C" int fq12_mul_by_014_square_launch(const int* a, long long sa, const int* d0,
                                             long long s0, const int* d1, long long s1,
                                             const int* d4, long long s4, const int* skip,
                                             long long ss, int* out, int rows,
                                             void* stream) {
  if (rows > 0) {
    const int grid = grid_for<fq12_mul_by_014_kernel<true>>(rows);
    fq12_mul_by_014_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, sa, d0, s0, d1, s1, d4, s4, skip, ss, out, rows);
  }
  return launched();
}
