// The limb tier's Montgomery kernels: the 48 x 48 limb convolution of up to
// LIMB_CONV_KMAX operand pairs in one launch, the scan-free Montgomery
// reduction, and the two fused into one product.
//
// Replace the TPU kernels conv, mont_reduce and mont_mul
// (plonky2_bls12_381_pairing_tpu/ops/pallas/mont.py), which hold 256 rows x
// 128 lanes per grid step and multiply by the constants p and p' on the
// matrix unit. Their plain PyTorch versions are conv_plain,
// mont_reduce_plain and mont_mul_plain (ops/kernels/mont.py); the rows agree
// bit for bit.
//
// What bounds them on an H100:
//   conv moves 2 * 192 bytes in and 380 out per row for 2,304 multiply-adds
//   and is bound by bytes; the path calls it for every group of products
//   that no reduction separates (a tower op's 30 to 63), so its cost was
//   the launch. One launch now takes the whole group: the pairs' pointers
//   and row strides travel by value in the kernel's parameters (a
//   __grid_constant__ struct, no table copied to the card per call), the
//   grid spans (row tile, pair), and a warp computes one row at a time (in
//   a large launch a few in turn, the next row's operands loading while it
//   computes one): both operands into its shared memory (16-byte loads
//   where the row is aligned), then each thread two runs of 12 terms of
//   4-column strips (LIMB_CONV_PIECE: every thread the same trip counts;
//   two 16-byte shared loads per 16 multiply-adds), the runs' sums added
//   into the row's columns in shared memory (runs of one strip on different
//   columns at a time), and coalesced stores. No barrier spans more than
//   the warp. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py,
//   kernel_probe.py): a cyclotomic squaring's 30 pairs at 2048 rows in
//   0.031 ms against a bytes bound of 0.011 (30 launches of 0.005 before);
//   its loads and stores alone take about 0.022.
//   mont_reduce (about 5,000 multiply-adds per row) is bound by operations:
//   one warp per row on limb_common.cuh's mont_reduce_warp (four columns a
//   thread, a shift-add pass is a local step and one shuffle), the p and p'
//   digits staged once per block behind the kernel's only block barrier:
//   0.041 ms at (2048, 12, 95), 0.109 in the block design before it.
//   mont_mul keeps the first design, one thread per column, a group of 128
//   threads per row, four rows per block, and block-wide barriers in every
//   shift-add pass.

#include "limb_common.cuh"

namespace {

using namespace limb;

constexpr int KMAX = LIMB_CONV_KMAX;
constexpr int PIECE = LIMB_CONV_PIECE_TERMS;  // 12
// warps (rows) per block of the two warp kernels (kernel_probe.py: 1 to 16
// move either kernel's time by less than 10 %)
constexpr int CONV_WARPS = 8;
constexpr int REDUCE_WARPS = 4;

// The operand pairs of one launch: pair j's rows are a[j] + r * sa[j] and
// b[j] + r * sb[j] (a stride of 0 broadcasts one row).
struct ConvPairs {
  const int* a[KMAX];
  const int* b[KMAX];
  long long sa[KMAX];
  long long sb[KMAX];
};

// One warp's row: x with zeros at digits 48 .. 63, y with zeros at digits
// -16 .. -1 and 48 .. 51 (as far as a run's terms and window reach), and
// the row's 96 columns; every part 16-byte aligned.
constexpr int X_LEN = NLIMBS + 16;
constexpr int Y_PAD = 16;
constexpr int Y_LEN = Y_PAD + NLIMBS + 4;
constexpr int OUT_LEN = NCOLS + 1;
struct alignas(16) ConvScratch {
  int x[X_LEN];
  int y[Y_LEN];
  int out[OUT_LEN];
};

// PIECE terms lo .. lo + PIECE - 1 of the 4-column strip at column c:
// acc[q] += x[i] * y[c + q - i]. lo and c are multiples of 4, so x and y are
// read four digits at a time: per four terms one 16-byte load of x and one
// of the next four y digits, for 16 multiply-adds.
__device__ __forceinline__ void conv_piece(const int* x, const int* y, int c, int lo,
                                           int (&acc)[4]) {
  const int4* xv = reinterpret_cast<const int4*>(x + lo);
  const int* yd = y + c - lo;
  int4 h = *reinterpret_cast<const int4*>(yd);  // y[d .. d + 3], d = c - lo - 4k
#pragma unroll
  for (int k = 0; k < PIECE / 4; ++k) {
    const int4 u = xv[k];
    const int4 l = *reinterpret_cast<const int4*>(yd - 4 * k - 4);  // y[d - 4 .. d - 1]
    acc[0] += u.x * h.x + u.y * l.w + u.z * l.z + u.w * l.y;
    acc[1] += u.x * h.y + u.y * h.x + u.z * l.w + u.w * l.z;
    acc[2] += u.x * h.z + u.y * h.y + u.z * h.x + u.w * l.w;
    acc[3] += u.x * h.w + u.y * h.z + u.z * h.y + u.w * h.x;
    h = l;
  }
}

// acc's four sums added into columns c .. c + 3 of `out`, in the order
// rotated by r: runs of one strip (r their index in it) add to different
// columns in each instruction.
__device__ __forceinline__ void add_rotated(int* out, int c, int r, const int (&acc)[4]) {
  int v0 = acc[0], v1 = acc[1], v2 = acc[2], v3 = acc[3];
  if (r & 1) {
    const int t = v0;
    v0 = v1;
    v1 = v2;
    v2 = v3;
    v3 = t;
  }
  if (r & 2) {
    int t = v0;
    v0 = v2;
    v2 = t;
    t = v1;
    v1 = v3;
    v3 = t;
  }
  atomicAdd(&out[c + (r & 3)], v0);
  atomicAdd(&out[c + ((r + 1) & 3)], v1);
  atomicAdd(&out[c + ((r + 2) & 3)], v2);
  atomicAdd(&out[c + ((r + 3) & 3)], v3);
}

// One operand row in flight to shared memory: lanes 0 .. 11 hold its 48
// digits as twelve 16-byte loads where the row is aligned; else every lane
// holds digits lane and lane + 32.
struct RowPart {
  int4 v;
  bool vec;
};

__device__ __forceinline__ RowPart fetch_row(const int* src, int lane) {
  RowPart r{make_int4(0, 0, 0, 0), (reinterpret_cast<unsigned long long>(src) & 15) == 0};
  if (r.vec) {
    if (lane < NLIMBS / 4) r.v = *reinterpret_cast<const int4*>(src + 4 * lane);
  } else {
    r.v.x = src[lane];
    if (lane < NLIMBS - WARP) r.v.y = src[lane + WARP];
  }
  return r;
}

__device__ __forceinline__ void stage_row(const RowPart& r, int* dst, int lane) {
  if (r.vec) {
    if (lane < NLIMBS / 4) *reinterpret_cast<int4*>(dst + 4 * lane) = r.v;
  } else {
    dst[lane] = r.v.x;
    if (lane < NLIMBS - WARP) dst[lane + WARP] = r.v.y;
  }
}

// Grid (row tiles, pairs); out: (pairs, rows, 95) dense. Warp w of tile t
// computes rows (t * per_warp + i) * CONV_WARPS + w, i < per_warp, in turn,
// the next row's operands loading while it computes one.
__global__ void __launch_bounds__(WARP * CONV_WARPS)
    conv_kernel(const __grid_constant__ ConvPairs p, int* __restrict__ out, int rows,
                int per_warp) {
  __shared__ ConvScratch scratch[CONV_WARPS];
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int j = blockIdx.y;
  const long long first = static_cast<long long>(blockIdx.x) * per_warp * CONV_WARPS + w;
  if (first >= rows) return;
  ConvScratch& s = scratch[w];
  int run[4];  // this thread's runs: (c, first term) of a rising and a falling strip
#pragma unroll
  for (int i = 0; i < 4; ++i) run[i] = LIMB_CONV_PIECE[lane][i];
  if (lane < 16) {
    s.x[NLIMBS + lane] = 0;
    s.y[lane] = 0;
  } else if (lane < 20) {
    s.y[Y_PAD + NLIMBS + lane - 16] = 0;
  }
  RowPart a = fetch_row(p.a[j] + first * p.sa[j], lane);
  RowPart b = fetch_row(p.b[j] + first * p.sb[j], lane);
  const int* y = s.y + Y_PAD;
  for (int i = 0; i < per_warp; ++i) {
    const long long row = first + static_cast<long long>(i) * CONV_WARPS;
    if (row >= rows) break;
    stage_row(a, s.x, lane);
    stage_row(b, s.y + Y_PAD, lane);
    for (int c = lane; c < OUT_LEN; c += WARP) s.out[c] = 0;
    __syncwarp();
    const long long next = row + CONV_WARPS;
    if (i + 1 < per_warp && next < rows) {
      a = fetch_row(p.a[j] + next * p.sa[j], lane);
      b = fetch_row(p.b[j] + next * p.sb[j], lane);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = run[2 * half], lo = run[2 * half + 1];
      if (c >= 0) {
        int acc[4] = {0, 0, 0, 0};
        conv_piece(s.x, y, c, lo, acc);
        add_rotated(s.out, c, (lo - max(0, c - NLIMBS)) / PIECE, acc);
      }
    }
    __syncwarp();
    int* dst = out + (static_cast<long long>(j) * rows + row) * NCOLS;
    for (int c = lane; c < NCOLS; c += WARP) dst[c] = s.out[c];
    __syncwarp();  // the scratch is free for the next row
  }
}

// cols: (rows, ncols <= 95) with row stride `stride`; out: (rows, 48) dense.
__global__ void __launch_bounds__(WARP * REDUCE_WARPS)
    mont_reduce_kernel(const int* __restrict__ cols, long long stride, int ncols, int npass,
                       int* __restrict__ out, int rows) {
  __shared__ LimbConsts k;
  __shared__ WarpScratch ws[REDUCE_WARPS];
  load_consts(k, threadIdx.x, blockDim.x);
  __syncthreads();  // the constants are staged; no block barrier follows
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long row = static_cast<long long>(blockIdx.x) * REDUCE_WARPS + w;
  if (row >= rows) return;
  const int* src = cols + row * stride;
  int x[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = COLS_PER_THREAD * lane + q;
    x[q] = c < ncols ? src[c] : 0;
  }
  mont_reduce_warp(x, lane, ws[w], k, npass, out + row * NLIMBS);
}

// Rows of a block: row = blockIdx.x * GROUPS + threadIdx.y; groups beyond
// the last row compute on zeros (the barriers are block-wide) and store
// nothing.
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

inline int tiles(long long rows, int per_block) {
  return static_cast<int>((rows + per_block - 1) / per_block);
}


}  // namespace

// pairs: a host ConvPairs, copied into the launch's parameters; per_warp:
// the rows each warp computes in turn.
extern "C" int limb_conv_launch(const void* pairs, int k, int* out, int rows, int per_warp,
                                void* stream) {
  if (k < 1 || k > KMAX || per_warp < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    conv_kernel<<<dim3(tiles(rows, per_warp * CONV_WARPS), k), WARP * CONV_WARPS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        *static_cast<const ConvPairs*>(pairs), out, rows, per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int limb_mont_reduce_launch(const int* cols, long long stride, int ncols,
                                       int npass, int* out, int rows, void* stream) {
  if (rows > 0) {
    mont_reduce_kernel<<<tiles(rows, REDUCE_WARPS), WARP * REDUCE_WARPS, 0,
                         static_cast<cudaStream_t>(stream)>>>(cols, stride, ncols, npass,
                                                              out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int limb_mont_mul_launch(const int* a, long long sa, const int* b, long long sb,
                                    int* out, int rows, void* stream) {
  if (rows > 0) {
    mont_mul_kernel<<<tiles(rows, GROUPS), dim3(LANES, GROUPS), 0,
                      static_cast<cudaStream_t>(stream)>>>(a, sa, b, sb, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
