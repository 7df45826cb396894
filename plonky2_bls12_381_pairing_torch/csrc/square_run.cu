// Runs of squarings with the state on chip: n Granger-Scott squarings of
// cyclotomic Fq12 elements (12 components), or n Karabina squarings of
// compressed elements (8 components), in one launch.
//
// Replaces the TPU kernels cyc_square_run and kara_square_run
// (plonky2_bls12_381_pairing_tpu/ops/rns/pallas.py, _build_square_run), which
// keep a component-major block in VMEM for the run. Their plain PyTorch
// versions are ops/rns/kernels.py cyc_square_run_plain and
// kara_square_run_plain (n times tower.cyclotomic_square_plain /
// compressed_square_plain); the rows agree bit for bit.
//
// What bounds it on an H100: integer issue, as cyc_exp.cu: per squaring one
// 12- or 8-row REDC and the lane arithmetic of 9 or 4 Fq2 products, against
// one read and one write of the row for the whole run. The design is
// cyc_exp.cu's: one block per packed row, one thread per lane, the state in
// registers, rows read in place as (rows, ncomp, 128). n is a launch
// argument, so one build serves every run length.

#include "rns_tower.cuh"

namespace {

using namespace rns;

// a and out are (rows, NC, 128) int32; NC = 12 runs Granger-Scott, NC = 8
// Karabina.
template <int NC>
__global__ void __launch_bounds__(LANES)
    square_run_kernel(const int* __restrict__ a, int* __restrict__ out, int n) {
  static_assert(NC == 12 || NC == 8, "12 components or 8 compressed ones");
  __shared__ Smem<12> s;
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
    if constexpr (NC == 12) {
      b[k] = RNS_CYC_BIAS[k][l];
    } else {
      b[k] = RNS_KARA_BIAS[k][l];
    }
  }
  for (int i = 0; i < n; ++i) {
    if constexpr (NC == 12) {
      cyc_square<1>(x, c, s, b);
    } else {
      kara_square<1>(x, c, s, b);
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) out[(row * NC + k) * LANES + lane] = x[k];
}

template <int NC>
int launch(const int* a, int* out, int rows, int n, void* stream) {
  if (rows > 0) {
    square_run_kernel<NC><<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cyc_square_run_launch(const int* a, int* out, int rows, int n, void* stream) {
  return launch<12>(a, out, rows, n, stream);
}

extern "C" int kara_square_run_launch(const int* a, int* out, int rows, int n,
                                      void* stream) {
  return launch<8>(a, out, rows, n, stream);
}
