// Runs of Karabina squarings of compressed cyclotomic Fq12 elements (8
// components) with the state on chip: n squarings in one launch.
//
// Replaces the TPU kernel kara_square_run
// (plonky2_bls12_381_pairing_tpu/ops/rns/pallas.py, _build_square_run),
// which keeps a component-major block in VMEM for the run. Its plain
// PyTorch version is ops/rns/kernels.py kara_square_run_plain (n times
// tower.compressed_square_plain); the rows agree bit for bit. The same TPU
// function's Granger-Scott runs (cyc_square_run) are cyc_exp.cu's kernel on
// the tensor-core REDC tile.
//
// What bounds it on an H100: integer issue, as cyc_exp.cu: per squaring one
// 8-row REDC and the lane arithmetic of 4 Fq2 products, against one read
// and one write of the row for the whole run. The design: one block per
// packed row, one thread per lane, the state in registers, rows read in
// place as (rows, 8, 128). n is a launch argument, so one build serves
// every run length.

#include "rns_tower.cuh"

namespace {

using namespace rns;

constexpr int NC = 8;

// a and out are (rows, 8, 128) int32.
__global__ void __launch_bounds__(LANES)
    kara_square_run_kernel(const int* __restrict__ a, int* __restrict__ out, int n) {
  __shared__ Smem<NC> s;
  load_tables(s);
  __syncthreads();

  const int lane = threadIdx.x;
  const int l = lane % SUB;
  const Lane c = load_lane(l);
  const size_t row = blockIdx.x;
  int x[NC], b[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    x[k] = a[(row * NC + k) * LANES + lane];
    b[k] = RNS_KARA_BIAS[k][l];
  }
  for (int i = 0; i < n; ++i) kara_square<1>(x, c, s, b);
#pragma unroll
  for (int k = 0; k < NC; ++k) out[(row * NC + k) * LANES + lane] = x[k];
}

}  // namespace

extern "C" int kara_square_run_launch(const int* a, int* out, int rows, int n,
                                      void* stream) {
  if (rows > 0) {
    kara_square_run_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
