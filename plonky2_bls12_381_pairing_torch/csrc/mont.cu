// The limb tier's Montgomery kernels: the 48 x 48 limb convolution, the
// scan-free Montgomery reduction, and the two fused into one product.
//
// Replace the TPU kernels conv, mont_reduce and mont_mul
// (plonky2_bls12_381_pairing_tpu/ops/pallas/mont.py), which hold 256 rows x
// 128 lanes per grid step and multiply by the constants p and p' on the
// matrix unit. Their plain PyTorch versions are conv_plain,
// mont_reduce_plain and mont_mul_plain (ops/kernels/mont.py); the rows agree
// bit for bit.
//
// What bounds them on an H100: conv moves 2 * 192 bytes in and 380 out per
// row for 2,304 multiply-adds, and is bound by bytes; mont_reduce (about
// 5,000 multiply-adds per row behind a dozen block-wide barriers) and
// mont_mul are bound by operations, and in this first design by the
// barriers' latency. The design is the simple one: one thread per column, a
// group of 128 threads per row, four rows per block, operands and the
// reduction's digits in shared memory, columns never in device memory
// between the product and its reduction.

#include "limb_common.cuh"

namespace {

using namespace limb;

// Rows of a block: row = blockIdx.x * GROUPS + threadIdx.y; groups beyond
// the last row compute on zeros (the barriers are block-wide) and store
// nothing.

__global__ void __launch_bounds__(LANES * GROUPS)
    conv_kernel(const int* __restrict__ a, long long sa, const int* __restrict__ b,
                long long sb, int* __restrict__ out, int rows) {
  __shared__ int xs[GROUPS][NLIMBS], ys[GROUPS][NLIMBS];
  const int lane = threadIdx.x, g = threadIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * GROUPS + g;
  const bool live = row < rows;
  if (lane < NLIMBS) {
    xs[g][lane] = live ? a[row * sa + lane] : 0;
    ys[g][lane] = live ? b[row * sb + lane] : 0;
  }
  __syncthreads();
  if (live && lane < NCOLS) out[row * NCOLS + lane] = conv_column(xs[g], ys[g], lane);
}

__global__ void __launch_bounds__(LANES * GROUPS)
    mont_reduce_kernel(const int* __restrict__ cols, long long stride, int ncols, int npass,
                       int* __restrict__ out, int rows) {
  __shared__ Scratch sc[GROUPS];
  const int lane = threadIdx.x, g = threadIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * GROUPS + g;
  const bool live = row < rows;
  const int col = live && lane < ncols ? cols[row * stride + lane] : 0;
  const int res = mont_reduce_lanes(col, lane, sc[g], npass);
  if (live && lane < NLIMBS) out[row * NLIMBS + lane] = res;
}

__global__ void __launch_bounds__(LANES * GROUPS)
    mont_mul_kernel(const int* __restrict__ a, long long sa, const int* __restrict__ b,
                    long long sb, int* __restrict__ out, int rows) {
  __shared__ int xs[GROUPS][NLIMBS], ys[GROUPS][NLIMBS];
  __shared__ Scratch sc[GROUPS];
  const int lane = threadIdx.x, g = threadIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * GROUPS + g;
  const bool live = row < rows;
  if (lane < NLIMBS) {
    xs[g][lane] = live ? a[row * sa + lane] : 0;
    ys[g][lane] = live ? b[row * sb + lane] : 0;
  }
  __syncthreads();
  const int col = conv_column(xs[g], ys[g], lane);
  const int res = mont_reduce_lanes(col, lane, sc[g], LIMB_NPASS_MUL);
  if (live && lane < NLIMBS) out[row * NLIMBS + lane] = res;
}

inline dim3 block_dim() { return dim3(LANES, GROUPS); }
inline int grid_dim(int rows) { return (rows + GROUPS - 1) / GROUPS; }

}  // namespace

extern "C" int limb_conv_launch(const int* a, long long sa, const int* b, long long sb,
                                int* out, int rows, void* stream) {
  if (rows > 0) {
    conv_kernel<<<grid_dim(rows), block_dim(), 0, static_cast<cudaStream_t>(stream)>>>(
        a, sa, b, sb, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int limb_mont_reduce_launch(const int* cols, long long stride, int ncols,
                                       int npass, int* out, int rows, void* stream) {
  if (rows > 0) {
    mont_reduce_kernel<<<grid_dim(rows), block_dim(), 0,
                         static_cast<cudaStream_t>(stream)>>>(cols, stride, ncols, npass,
                                                              out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int limb_mont_mul_launch(const int* a, long long sa, const int* b, long long sb,
                                    int* out, int rows, void* stream) {
  if (rows > 0) {
    mont_mul_kernel<<<grid_dim(rows), block_dim(), 0, static_cast<cudaStream_t>(stream)>>>(
        a, sa, b, sb, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
