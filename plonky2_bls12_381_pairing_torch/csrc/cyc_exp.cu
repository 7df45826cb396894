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
// cyc_square_run is the same kernel walking one run of n squarings and no
// product (n a launch argument), on tiles of RUN_TILE packed rows. It
// replaces the TPU kernel cyc_square_run (pallas.py, _build_square_run),
// which keeps a component-major block in VMEM for the run; its plain
// version is ops/rns/kernels.py cyc_square_run_plain.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 2, 1024
// packed rows, |BLS_X|): cyc_exp 0.815-0.823 ms, cyc_exp_cond 0.824-0.844 ms
// (2.015-2.036 ms in the one-row blocks with a block-wide REDC that it
// had before, timed alongside it), against a work bound of 0.026 ms.
// cyc_square_run (kernel_probe.py, queued launches): n = 32 0.354 ms, the
// six runs of |x| (1, 2, 3, 9, 32, 16) summed 0.740 ms, against 0.854 and
// 1.710 ms in the one-row blocks it had before
// (chip_smoke.py, the same call), and a work bound of 0.012 and 0.033 ms.

#include "rns_redc_tc.cuh"
#include "rns_tower.cuh"

namespace {

using namespace rns;

// packed rows per block of cyc_exp and cyc_exp_cond, and of cyc_square_run
// (2-row tiles 1.2-2.0 % faster than 4-row ones for its runs,
// kernel_probe.py); a tile of T rows takes 8 / T blocks per SM (64
// registers a thread)
constexpr int TILE = RNS_TC_ROWS;
constexpr int RUN_TILE = 2;

// How the kernel walks the exponent after its leading bit.
enum Walk {
  SEGMENTS,  // sched: nsteps (n_squares, multiply_after) pairs
  LEVELS,    // sched: one multiply flag per level, each level one squaring
  RUN,       // nsteps squarings and no product; sched unused
};

// One block per T packed rows (the last tile masked); a and out are
// (rows, 12, 128) int32. Each step of the walk is n cyclotomic squarings
// and then, if flagged, one product with the base.
template <Walk WALK, int T>
__global__ void __launch_bounds__(T * LANES, 8 / T)
    cyc_exp_kernel(const int* __restrict__ a, int* __restrict__ out, int rows,
                   const int* __restrict__ sched, int nsteps) {
  static_assert(T == 2 || T == 4, "a tile of 2 or 4 packed rows");
  __shared__ TcSmem<T> s;
  __shared__ int bias[2][12][SUB];  // RNS_CYC_BIAS, RNS_MUL_BIAS
  load_tc_tables(s);
  for (int i = threadIdx.x; i < 12 * SUB; i += T * LANES) {
    bias[0][i / SUB][i % SUB] = RNS_CYC_BIAS[i / SUB][i % SUB];
    bias[1][i / SUB][i % SUB] = RNS_MUL_BIAS[i / SUB][i % SUB];
  }
  __syncthreads();

  const int lane = threadIdx.x % LANES;
  const int l = lane % SUB;
  const Lane c = load_lane(l);
  const long long row = static_cast<long long>(blockIdx.x) * T + threadIdx.x / LANES;
  const bool live = row < rows;
  const int* base = a + row * 12 * LANES + lane;
  int acc[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) acc[k] = live ? base[k * LANES] : 0;
  const int steps = WALK == RUN ? 1 : nsteps;
  for (int g = 0; g < steps; ++g) {
    const int n_sq = WALK == RUN ? nsteps : WALK == LEVELS ? 1 : sched[2 * g];
    for (int i = 0; i < n_sq; ++i) cyc_square<SUB>(acc, c, s, &bias[0][0][l]);
    if (WALK != RUN && sched[WALK == LEVELS ? g : 2 * g + 1]) {
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

template <Walk WALK, int T>
int launch(const int* a, int* out, int rows, const int* sched, int nsteps, void* stream) {
  if (rows > 0) {
    cyc_exp_kernel<WALK, T><<<(rows + T - 1) / T, T * LANES, 0,
                              static_cast<cudaStream_t>(stream)>>>(a, out, rows, sched,
                                                                   nsteps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cyc_exp_launch(const int* a, int* out, int rows, const int* segs, int nseg,
                              void* stream) {
  return launch<SEGMENTS, TILE>(a, out, rows, segs, nseg, stream);
}

// flags holds one multiply flag per level.
extern "C" int cyc_exp_cond_launch(const int* a, int* out, int rows, const int* flags,
                                   int nlevels, void* stream) {
  return launch<LEVELS, TILE>(a, out, rows, flags, nlevels, stream);
}

// n Granger-Scott squarings; n = 0 copies the rows.
extern "C" int cyc_square_run_launch(const int* a, int* out, int rows, int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<RUN, RUN_TILE>(a, out, rows, nullptr, n, stream);
}
