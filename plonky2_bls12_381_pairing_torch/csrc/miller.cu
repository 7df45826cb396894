// The whole single-term Miller accumulation: for each of the 68 line triples
// (c0, c1, c2) of one G2 point, f <- f * ell with ell = (c2, c1 * P.x, c0 * P.y)
// as the sparse product mul_by_014 (f unchanged where the term has an input at
// infinity), then f <- f^2 where the schedule says so (62 of the 68 steps).
//
// Replaces the TPU kernel miller_run (plonky2_bls12_381_pairing_tpu/ops/rns/
// pallas.py, _build_miller). That kernel's grid is (step, row block): the
// accumulator of every row lives in one persistent VMEM scratch across the
// step axis, the coefficient blocks stream through, and batches beyond 4096
// rows are cut into separate calls so that the scratch fits. Its plain
// PyTorch version is ops/rns/kernels.py miller_run_plain; the rows agree bit
// for bit.
//
// What bounds it on an H100: integer throughput. Per element a loop is 1,832 REDC
// rows (68 x (4 + 12) + 62 x 12) plus the lane products of the formulas, while
// the data is one pass over the coefficient tensor (six residues per step and
// lane) and one Fq12 row in and out. Blocks on a GPU share nothing and run in
// no order, so the step axis is a loop inside the block: one block per packed
// row, one thread per lane, f[12] in registers for all 68 steps, the
// base-extension blocks and the cross-lane sums in shared memory (one buffer
// serves the 4-row scaling REDC and the 12-row ones). Each step's six
// coefficient residues are read straight from device memory, 128 consecutive
// int32 per component, one step ahead of their use so that the load is in
// flight during the previous step's arithmetic. Only the final row is
// written. The row chunking has no counterpart here.

#include "rns_tower.cuh"

namespace {

using namespace rns;

// One block per packed row. f0: rows of (12, 128), sf ints apart; coeffs:
// (nsteps, rows, 3, 2, 128); py, px, skip: (rows, 128); flags: nsteps
// do-square flags; out: (rows, 12, 128). All int32.
__global__ void __launch_bounds__(LANES)
    miller_run_kernel(const int* __restrict__ f0, long long sf,
                      const int* __restrict__ coeffs, const int* __restrict__ py,
                      const int* __restrict__ px, const int* __restrict__ skip,
                      const int* __restrict__ flags, int nsteps, int* __restrict__ out) {
  __shared__ Smem<12> s;
  load_tables(s);
  __syncthreads();

  const int lane = threadIdx.x;
  const int l = lane % SUB;
  const Lane c = load_lane(l);
  const size_t row = blockIdx.x;
  const size_t rows = gridDim.x;
  const int y = py[row * LANES + lane];
  const int x = px[row * LANES + lane];
  const bool keep = skip[row * LANES + lane] != 0;
  const int* ell_bias = bias_at(RNS_ELL_BIAS, l);
  const int* m014_bias = bias_at(RNS_M014_BIAS, l);
  const int* sq_bias = bias_at(RNS_SQ_BIAS, l);

  int f[12];
  load12(f, f0, sf, row, lane);
  const int* cp = coeffs + row * 6 * LANES + lane;
  const size_t step = rows * 6 * LANES;
  int nxt[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) nxt[k] = nsteps > 0 ? cp[k * LANES] : 0;

  for (int j = 0; j < nsteps; ++j) {
    int cur[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) cur[k] = nxt[k];
    if (j + 1 < nsteps) {
      cp += step;
#pragma unroll
      for (int k = 0; k < 6; ++k) nxt[k] = cp[k * LANES];
    }
    // rows 0:2 = c0 * P.y, rows 2:4 = c1 * P.x, one stacked REDC
    int sc[4] = {mul_m(cur[0], y, c), mul_m(cur[1], y, c), mul_m(cur[2], x, c),
                 mul_m(cur[3], x, c)};
#pragma unroll
    for (int k = 0; k < 4; ++k) sc[k] = add_m(sc[k], ell_bias[k * SUB], c);
    redc<4>(sc, c, s);

    int g[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) g[k] = f[k];
    fq12_mul_by_014<SUB>(g, F2{cur[4], cur[5]}, F2{sc[2], sc[3]}, F2{sc[0], sc[1]}, c, s,
                         m014_bias);
#pragma unroll
    for (int k = 0; k < 12; ++k) f[k] = keep ? f[k] : g[k];
    if (flags[j]) fq12_square<SUB>(f, c, s, sq_bias);
  }
  store12(f, out, row, lane);
}

}  // namespace

extern "C" int miller_run_launch(const int* f0, long long sf, const int* coeffs,
                                 const int* py, const int* px, const int* skip,
                                 const int* flags, int nsteps, int* out, int rows,
                                 void* stream) {
  if (rows > 0) {
    miller_run_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(
        f0, sf, coeffs, py, px, skip, flags, nsteps, out);
  }
  return static_cast<int>(cudaGetLastError());
}
