// Per-element power a^e of stored Fp elements by MSB-first square-and-
// multiply over e's bits (after its leading 1), each step redc(acc * acc)
// and, where the bit is set, redc(acc * a). 0 maps to 0.
//
// Replaces the TPU kernel pow_static_fused (plonky2_bls12_381_pairing_tpu/
// ops/rns/pallas.py, _build_pow), which runs the whole bit loop inside one
// kernel with the bits in scalar memory. Its plain PyTorch version is
// ops/rns/fp.py pow_static; the rows agree bit for bit.
//
// What bounds it on an H100: latency. On the pairing's path it raises the
// 128-row root of the batched inverse's product tree to p - 2: 608
// dependent REDCs over 128 blocks, far fewer than the card has room for, so
// the chain of dependent steps (each with its four block-wide
// synchronisations) sets the time, not issue rate or bytes. The design
// keeps each row's base and accumulator in registers for the whole loop and
// reads the bits from device memory (one uniform load per step).

#include "rns_common.cuh"

namespace {

using namespace rns;

// One block per packed row; a and out are (rows, 128) int32.
__global__ void __launch_bounds__(LANES)
    pow_static_kernel(const int* __restrict__ a, int* __restrict__ out,
                      const int* __restrict__ bits, int nbits) {
  __shared__ Smem<1> s;
  load_tables(s);
  __syncthreads();

  const int lane = threadIdx.x;
  const Lane c = load_lane(lane % SUB);
  const size_t row = blockIdx.x;
  const int base = a[row * LANES + lane];
  int acc[1] = {base};
  for (int i = 0; i < nbits; ++i) {
    acc[0] = mul_m(acc[0], acc[0], c);
    redc<1>(acc, c, s);
    if (bits[i]) {
      acc[0] = mul_m(acc[0], base, c);
      redc<1>(acc, c, s);
    }
  }
  out[row * LANES + lane] = acc[0];
}

}  // namespace

extern "C" int pow_static_launch(const int* a, int* out, int rows, const int* bits,
                                 int nbits, void* stream) {
  if (rows > 0) {
    pow_static_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, out, bits,
                                                                             nbits);
  }
  return static_cast<int>(cudaGetLastError());
}
