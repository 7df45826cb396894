// The Karabina squaring chain of an exponentiation, with snapshots: the
// compressed state (g2, g3, g4, g5) is squared segs[k] times for each k in
// turn and written out after each segment, so that snapshot k is the
// compressed form of f^(2^(segs[0] + ... + segs[k])).
//
// Replaces the TPU kernel kara_exp_run (plonky2_bls12_381_pairing_tpu/ops/rns/
// pallas.py, _build_kara_exp), which keeps the state in VMEM for the whole
// chain. Its plain PyTorch version is ops/rns/kernels.py kara_exp_plain; the
// rows agree bit for bit.
//
// What bounds it on an H100: integer issue. For |BLS_X| the chain is 63
// squarings, each one 8-row REDC and four Fq2 products, against 8 x 128
// int32 read and six times that written per packed row. One block per packed
// row, one thread per lane, the 8 residues in registers for the whole chain;
// only the snapshots go to device memory.

#include "rns_tower.cuh"

namespace {

using namespace rns;

// a is (rows, 8, 128) int32, out (nseg, rows, 8, 128).
__global__ void __launch_bounds__(LANES)
    kara_exp_kernel(const int* __restrict__ a, int* __restrict__ out,
                    const int* __restrict__ segs, int nseg) {
  __shared__ Smem<8> s;
  load_tables(s);
  __syncthreads();

  const int lane = threadIdx.x;
  const int l = lane % SUB;
  const Lane c = load_lane(l);
  const size_t row = blockIdx.x;
  const size_t rows = gridDim.x;
  int g[8], b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    g[k] = a[(row * 8 + k) * LANES + lane];
    b[k] = RNS_KARA_BIAS[k][l];
  }
  for (int k = 0; k < nseg; ++k) {
    const int n = segs[k];
    for (int i = 0; i < n; ++i) kara_square<1>(g, c, s, b);
    int* o = out + ((k * rows + row) * 8) * LANES + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i * LANES] = g[i];
  }
}

}  // namespace

extern "C" int kara_exp_launch(const int* a, int* out, int rows, const int* segs, int nseg,
                               void* stream) {
  if (rows > 0) {
    kara_exp_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, out, segs,
                                                                           nseg);
  }
  return static_cast<int>(cudaGetLastError());
}
