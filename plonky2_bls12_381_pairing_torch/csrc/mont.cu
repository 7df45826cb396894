// The limb tier's Montgomery kernels: the 48 x 48 limb convolution of up to
// LIMB_CONV_KMAX operand pairs in one launch, the scan-free Montgomery
// reduction, the two fused into one product, and a static power as one
// chain of those products.
//
// Replace the TPU kernels conv, mont_reduce and mont_mul
// (plonky2_bls12_381_pairing_tpu/ops/pallas/mont.py), which hold 256 rows x
// 128 lanes per grid step and multiply by the constants p and p' on the
// matrix unit, and (mont_pow) the JAX package's lax.scan of mont_mul over
// a static exponent's bits (ops/fp.py pow_static). Their plain PyTorch
// versions are conv_plain, mont_reduce_plain, mont_mul_plain and
// mont_pow_plain (ops/kernels/mont.py); the rows agree bit for bit.
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
//   mont_mul (about 7,300 multiply-adds per row) and mont_pow (a chain of
//   them) are one warp per row on the same two pieces (mul_warp): conv's
//   runs into the row's columns in the warp's shared memory, each thread's
//   four columns read back into registers, and mont_reduce_warp on them;
//   the constants staged behind the only block barrier, as in mont_reduce.
//   mont_pow keeps its base and its accumulator in the warp's shared
//   memory for a piece of the exponent, whose bits after the leading one
//   travel by value in the parameters (up to 32 * LIMB_POW_WORDS a
//   launch): a squaring per bit, then a product with the base where it is
//   set, the products fp.pow_static launches one by one, in its order. A
//   longer exponent is one launch per piece, each starting from the
//   accumulator the one before wrote (ops/kernels/mont.py). Its steps depend on each other, so a row's chain is
//   latency: a product takes about 3,500 cycles alone, 4,900 among the
//   2048 rows' 15 warps per SM, of which the reduction's two strip
//   products (m = t p' and m p) a half and conv's runs a sixth. Measured on
//   an H100 80GB HBM3 at 700 W (kernel_probe.py, queued launches):
//   mont_mul 0.0068 ms at 2048 rows; mont_pow(p - 2) 1.78 ms at 2048 rows,
//   0.84 ms for one row (1.4 us per product), against 8.98 ms for its 608
//   mont_mul launches in the block design mont_mul had before (one thread
//   per column, 128 per row, block-wide barriers in every shift-add pass:
//   0.0148 ms a launch; the probe keeps it).

#include "limb_common.cuh"

namespace {

using namespace limb;

constexpr int KMAX = LIMB_CONV_KMAX;
constexpr int PIECE = LIMB_CONV_PIECE_TERMS;  // 12
// warps (rows) per block of the two warp kernels (kernel_probe.py: 1 to 16
// move either kernel's time by less than 10 %)
constexpr int CONV_WARPS = 8;
constexpr int REDUCE_WARPS = 4;
// warps (rows) per block of mont_mul and mont_pow (kernel_probe.py: 1 to 8
// move either by less than 5 %; at 2 or more ptxas spills 4 to 8 bytes in
// mont_pow's chain, at 1 none)
constexpr int MUL_WARPS = 4;
constexpr int POW_WARPS = 1;

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
        conv_quads(s.x, y, c, lo, PIECE / 4, acc);
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

// One warp's product scratch (mont_mul, mont_pow): two operands with 16
// zeros on either side of their 48 digits (the reach of conv_quads' reads
// as x and as y), and the 96 columns the runs add into (zero between
// products).
constexpr int OP_PAD = 16;
constexpr int OP_LEN = OP_PAD + NLIMBS + OP_PAD;
struct alignas(16) MulScratch {
  WarpScratch ws;
  int x[OP_LEN];
  int y[OP_LEN];
  int out[OUT_LEN];
};

__device__ __forceinline__ void zero_pads(MulScratch& s, int lane) {
  if (lane < OP_PAD) {
    s.x[lane] = s.y[lane] = 0;
    s.x[OP_PAD + NLIMBS + lane] = s.y[OP_PAD + NLIMBS + lane] = 0;
  }
  for (int c = lane; c < OUT_LEN; c += WARP) s.out[c] = 0;
}

// The Montgomery product of the digits x[0..47] and y[0..47] (padded rows of
// the warp's scratch) into dst[0..47] (shared or device memory, which may
// be x or y): conv's runs (`run`: this thread's, from LIMB_CONV_PIECE) add
// the 95 columns into s.out, each thread reads back its four columns (and
// zeroes them for the next product), and mont_reduce_warp reduces them with
// the fused product's first pass count. The warp's stores to dst are
// visible to it on return.
__device__ __forceinline__ void mul_warp(const int* x, const int* y, const int (&run)[4],
                                         int lane, MulScratch& s, const LimbConsts& k,
                                         int* dst) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = run[2 * half], lo = run[2 * half + 1];
    if (c >= 0) {
      int acc[4] = {0, 0, 0, 0};
      conv_quads(x, y, c, lo, PIECE / 4, acc);
      add_rotated(s.out, c, (lo - max(0, c - NLIMBS)) / PIECE, acc);
    }
  }
  __syncwarp();
  int cols[4] = {0, 0, 0, 0};
  if (lane < OUT_LEN / COLS_PER_THREAD) {
    int4* mine = reinterpret_cast<int4*>(&s.out[COLS_PER_THREAD * lane]);
    const int4 v = *mine;
    cols[0] = v.x;
    cols[1] = v.y;
    cols[2] = v.z;
    cols[3] = v.w;
    *mine = make_int4(0, 0, 0, 0);
  }
  mont_reduce_warp(cols, lane, s.ws, k, LIMB_NPASS_MUL, dst);
  __syncwarp();
}

__device__ __forceinline__ void load_run(int (&run)[4], int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) run[i] = LIMB_CONV_PIECE[lane][i];
}

// a, b: (rows, 48) with row strides sa, sb (0 broadcasts one row); out:
// (rows, 48) dense. One warp per row.
__global__ void __launch_bounds__(WARP * MUL_WARPS)
    mont_mul_kernel(const int* __restrict__ a, long long sa, const int* __restrict__ b,
                    long long sb, int* __restrict__ out, int rows) {
  __shared__ LimbConsts k;
  __shared__ MulScratch scratch[MUL_WARPS];
  load_consts(k, threadIdx.x, blockDim.x);
  __syncthreads();  // the constants are staged; no block barrier follows
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long row = static_cast<long long>(blockIdx.x) * MUL_WARPS + w;
  if (row >= rows) return;
  MulScratch& s = scratch[w];
  int run[4];
  load_run(run, lane);
  zero_pads(s, lane);
  stage_row(fetch_row(a + row * sa, lane), s.x + OP_PAD, lane);
  stage_row(fetch_row(b + row * sb, lane), s.y + OP_PAD, lane);
  __syncwarp();
  mul_warp(s.x + OP_PAD, s.y + OP_PAD, run, lane, s, k, out + row * NLIMBS);
}

// The bits of a static exponent after its leading one, MSB first: bit i is
// bit i % 32 of w[i / 32].
struct PowBits {
  unsigned w[LIMB_POW_WORDS];
  int n;
};

// a: (rows, 48) with row stride sa, the base; from: (rows, 48) with row
// stride sfrom, the accumulator to start from (the base itself for a whole
// exponent, or for the first piece of a longer one); out: (rows, 48) dense:
// from^(2^n) times the powers of a that `bits` selects (n = bits.n), i.e.
// a^e for the exponent e whose bits after the leading one are `bits` when
// from is a. One warp per row: the base in s.y, the accumulator in s.x.
__global__ void __launch_bounds__(WARP * POW_WARPS)
    mont_pow_kernel(const int* __restrict__ a, long long sa, const int* __restrict__ from,
                    long long sfrom, const __grid_constant__ PowBits bits,
                    int* __restrict__ out, int rows) {
  __shared__ LimbConsts k;
  __shared__ MulScratch scratch[POW_WARPS];
  load_consts(k, threadIdx.x, blockDim.x);
  __syncthreads();  // the constants are staged; no block barrier follows
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long row = static_cast<long long>(blockIdx.x) * POW_WARPS + w;
  if (row >= rows) return;
  MulScratch& s = scratch[w];
  int run[4];
  load_run(run, lane);
  zero_pads(s, lane);
  int* const acc = s.x + OP_PAD;
  int* const base = s.y + OP_PAD;
  stage_row(fetch_row(from + row * sfrom, lane), acc, lane);
  stage_row(fetch_row(a + row * sa, lane), base, lane);
  __syncwarp();
  for (int i = 0; i < bits.n; ++i) {
    mul_warp(acc, acc, run, lane, s, k, acc);
    if ((bits.w[i / 32] >> (i % 32)) & 1u) mul_warp(acc, base, run, lane, s, k, acc);
  }
  int* dst = out + row * NLIMBS;
  for (int l = lane; l < NLIMBS; l += WARP) dst[l] = acc[l];
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
    mont_mul_kernel<<<tiles(rows, MUL_WARPS), WARP * MUL_WARPS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, sa, b, sb, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// bits: a host PowBits, copied into the launch's parameters; from: the
// accumulator's rows (a, sa on a chain's first launch).
extern "C" int limb_mont_pow_launch(const int* a, long long sa, const int* from,
                                    long long sfrom, const void* bits, int* out, int rows,
                                    void* stream) {
  const PowBits& e = *static_cast<const PowBits*>(bits);
  if (e.n < 0 || e.n > 32 * LIMB_POW_WORDS) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    mont_pow_kernel<<<tiles(rows, POW_WARPS), WARP * POW_WARPS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, sa, from, sfrom, e, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
