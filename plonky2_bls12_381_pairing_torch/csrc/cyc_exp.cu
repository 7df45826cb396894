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
// squarings and 5 products, each one 12-row REDC (two 31-term cross-lane dot
// products per lane and component) plus the lane arithmetic of the Fq2
// formulas; the data moved is only the 12 x 128 int32 input and output of
// each row. The design keeps the whole state of a row on chip for the whole
// exponent: one block per packed row, one thread per lane, the base and the
// accumulator (12 + 12 residues) in registers, the base-extension blocks and
// the cross-lane sums in shared memory. Nothing but the final row goes back
// to device memory.
//
// cyc_exp_cond is the kernel's other form: one loop over the exponent's
// levels, each a squaring and, where the level's flag is set, the product
// with the base. It replaces the same TPU function in its one-loop build
// (_build_cyc_exp_cond); same operations in the same order, so the same
// rows. Its plain version is ops/rns/kernels.py cyc_exp_cond_plain.

#include "rns_tower.cuh"

namespace {

using namespace rns;

// One block per packed row; a and out are (rows, 12, 128) int32;
// segs holds nseg (n_squares, multiply_after) pairs.
__global__ void __launch_bounds__(LANES)
    cyc_exp_kernel(const int* __restrict__ a, int* __restrict__ out,
                   const int* __restrict__ segs, int nseg) {
  __shared__ Smem<12> s;
  load_tables(s);
  __syncthreads();

  const int lane = threadIdx.x;
  const int l = lane % SUB;
  const Lane c = load_lane(l);
  int cb[12], mb[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    cb[k] = RNS_CYC_BIAS[k][l];
    mb[k] = RNS_MUL_BIAS[k][l];
  }

  const size_t row = blockIdx.x;
  int f[12], acc[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    f[k] = a[(row * 12 + k) * LANES + lane];
    acc[k] = f[k];
  }
  for (int g = 0; g < nseg; ++g) {
    const int n_sq = segs[2 * g];
    for (int i = 0; i < n_sq; ++i) cyc_square<1>(acc, c, s, cb);
    if (segs[2 * g + 1]) fq12_mul<1>(acc, f, c, s, mb);
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) out[(row * 12 + k) * LANES + lane] = acc[k];
}

// flags holds one multiply flag per level.
__global__ void __launch_bounds__(LANES)
    cyc_exp_cond_kernel(const int* __restrict__ a, int* __restrict__ out,
                        const int* __restrict__ flags, int nlevels) {
  __shared__ Smem<12> s;
  load_tables(s);
  __syncthreads();

  const int lane = threadIdx.x;
  const int l = lane % SUB;
  const Lane c = load_lane(l);
  int cb[12], mb[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    cb[k] = RNS_CYC_BIAS[k][l];
    mb[k] = RNS_MUL_BIAS[k][l];
  }

  const size_t row = blockIdx.x;
  int f[12], acc[12];
  load12(f, a, 12 * LANES, row, lane);
#pragma unroll
  for (int k = 0; k < 12; ++k) acc[k] = f[k];
  for (int i = 0; i < nlevels; ++i) {
    cyc_square<1>(acc, c, s, cb);
    if (flags[i]) fq12_mul<1>(acc, f, c, s, mb);
  }
  store12(acc, out, row, lane);
}

}  // namespace

extern "C" int cyc_exp_cond_launch(const int* a, int* out, int rows, const int* flags,
                                   int nlevels, void* stream) {
  if (rows > 0) {
    cyc_exp_cond_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(
        a, out, flags, nlevels);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cyc_exp_launch(const int* a, int* out, int rows, const int* segs, int nseg,
                              void* stream) {
  if (rows > 0) {
    cyc_exp_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, out, segs,
                                                                          nseg);
  }
  return static_cast<int>(cudaGetLastError());
}
