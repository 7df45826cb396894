// Whole-exponent Granger-Scott exponentiation a^X of cyclotomic Fq12
// elements: X is given as MSB-first (n_squares, multiply_after) segments
// after its leading bit; each segment is n cyclotomic squarings, then, if
// flagged, one full Fq12 product with the base.
//
// Replaces the TPU kernel cyc_exp_run (plonky2_bls12_381_pairing_tpu/ops/rns/
// pallas.py, _build_cyc_exp), which keeps the base and the accumulator in
// VMEM for the whole exponent. Its plain PyTorch version is
// ops/rns/kernels.py cyc_exp_plain; the rows agree bit for bit.
//
// What bounds it on an H100: integer issue. Per packed row, |BLS_X| costs 63
// squarings and 5 products, each one 12-row REDC plus the lane arithmetic of
// the Fq2 formulas; the data moved is only the 12 x 128 int32 input and
// output of each row. The REDC's two base extensions (31 x 33 and 31 x 32
// multiply-adds per component) are matrix products, which the design runs
// on the tensor cores (rns_redc_tc.cuh): a block holds a tile of TILE packed
// rows for the whole exponent, one thread per lane and row, the accumulator
// (12 residues) in registers (the base is read again from device memory for
// each of the 5 products), the u8 plane tables, the bias rows and the sigma
// planes and extension sums in shared memory. What is
// left on the integer pipe is the lane arithmetic (Barrett reductions of
// the Fq2 products and of REDC steps 1, 3 and 5). Nothing but the final row
// goes back to device memory.
//
// cyc_exp_cond is the same kernel walking the exponent by levels: each level
// a squaring and, where the level's flag is set, the product with the base.
// It replaces the same TPU function in its one-loop build
// (_build_cyc_exp_cond); same operations in the same order, so the same
// rows. Its plain version is ops/rns/kernels.py cyc_exp_cond_plain.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 2, 1024
// packed rows, |BLS_X|): cyc_exp 0.815-0.823 ms, cyc_exp_cond 0.824-0.844 ms
// (2.015-2.036 ms in the one-row blocks of rns_common.cuh that it had
// before, timed alongside it), against a work bound of 0.026 ms.

#include "rns_redc_tc.cuh"
#include "rns_tower.cuh"

namespace {

using namespace rns;

// packed rows per block of cyc_exp
constexpr int TILE = RNS_TC_ROWS;
constexpr int THREADS = TILE * LANES;

// One block per TILE packed rows (the last tile masked); a and out are
// (rows, 12, 128) int32. The schedule walks the exponent after its leading
// bit in nsteps steps, each n cyclotomic squarings and then, if flagged, one
// product with the base: for cyc_exp sched holds (n_squares,
// multiply_after) pairs; for cyc_exp_cond (LEVELS) one multiply flag per
// level, each level one squaring.
template <bool LEVELS>
__global__ void __launch_bounds__(THREADS, 2)
    cyc_exp_kernel(const int* __restrict__ a, int* __restrict__ out, int rows,
                   const int* __restrict__ sched, int nsteps) {
  __shared__ TcSmem<TILE> s;
  __shared__ int bias[2][12][SUB];  // RNS_CYC_BIAS, RNS_MUL_BIAS
  load_tc_tables(s);
  for (int i = threadIdx.x; i < 12 * SUB; i += THREADS) {
    bias[0][i / SUB][i % SUB] = RNS_CYC_BIAS[i / SUB][i % SUB];
    bias[1][i / SUB][i % SUB] = RNS_MUL_BIAS[i / SUB][i % SUB];
  }
  __syncthreads();

  const int lane = threadIdx.x % LANES;
  const int l = lane % SUB;
  const Lane c = load_lane(l);
  const long long row = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x / LANES;
  const bool live = row < rows;
  const int* base = a + row * 12 * LANES + lane;
  int acc[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) acc[k] = live ? base[k * LANES] : 0;
  for (int g = 0; g < nsteps; ++g) {
    const int n_sq = LEVELS ? 1 : sched[2 * g];
    for (int i = 0; i < n_sq; ++i) cyc_square<SUB>(acc, c, s, &bias[0][0][l]);
    if (sched[LEVELS ? g : 2 * g + 1]) {
      // the base is read again for each of the few products (from the L2
      // cache): held in registers for the whole exponent it would spill
      int f[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) f[k] = live ? base[k * LANES] : 0;
      fq12_mul<SUB>(acc, f, c, s, &bias[1][0][l]);
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < 12; ++k) out[(row * 12 + k) * LANES + lane] = acc[k];
  }
}

template <bool LEVELS>
int launch(const int* a, int* out, int rows, const int* sched, int nsteps, void* stream) {
  if (rows > 0) {
    cyc_exp_kernel<LEVELS><<<(rows + TILE - 1) / TILE, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(a, out, rows, sched,
                                                                  nsteps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cyc_exp_launch(const int* a, int* out, int rows, const int* segs, int nseg,
                              void* stream) {
  return launch<false>(a, out, rows, segs, nseg, stream);
}

// flags holds one multiply flag per level.
extern "C" int cyc_exp_cond_launch(const int* a, int* out, int rows, const int* flags,
                                   int nlevels, void* stream) {
  return launch<true>(a, out, rows, flags, nlevels, stream);
}
