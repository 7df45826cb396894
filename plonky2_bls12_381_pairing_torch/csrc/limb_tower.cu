// The limb tier's fused Fq12 tower kernels: one whole formula per launch
// (product, complex squaring, sparse product mul_by_014, Granger-Scott
// cyclotomic squaring) on stored (12, 48) int32 limb elements.
//
// Replace the TPU kernels fq12_mul, fq12_square, fq12_mul_by_014 and
// fq12_cyclotomic_square (plonky2_bls12_381_pairing_tpu/ops/pallas/tower.py,
// all through _run), which stack a block's operand pairs on sublanes for one
// 48-step roll-accumulate and reduce the 12 outputs in one stacked
// reduction. Their plain PyTorch versions are the fq12_*_plain of
// ops/kernels/tower.py; the rows agree bit for bit.
//
// A formula is three tables (limb_tables.h, from ops/kernels/tower.py): each
// product's two operands as small signed sums of operand slots (the 12
// components of a, those of the second operand, the constant rows NEGC and
// R mod p), each output wide as an integer combination of the products, and
// the pass count of the merged reduction. A block of 12 warps computes one
// element:
//   1. the operand slots into shared memory;
//   2. every product's two operand sums;
//   3. every product's 95 columns: a task is two 4-column strips of one
//      product, the rising strip s and the falling strip s + 12, 51 terms
//      of four multiply-adds for every s, each term two shared loads;
//   4. warp j: output j's signed sum of its products' columns and its
//      scan-free reduction on the warp alone (limb_common.cuh
//      mont_reduce_warp), the 12 outputs in parallel.
// Block barriers separate the four stages only; no shift-add pass waits
// for more than its warp. Nothing but the operands and the result touches
// device memory.
//
// What bounds it on an H100: operations (54 / 36 / 39 / 39 products of 2,304
// multiply-adds and 12 reductions of about 5,000 per element, against 1 to
// 1.7 KB moved): the bound is 0.020-0.026 ms at 2048 elements. Measured on
// an H100 80GB HBM3 at 700 W (chip_smoke.py, kernel_probe.py): 0.088 ms
// (cyclotomic squaring) to 0.117 ms (product), against 0.25-0.31 ms for the earlier
// design of one 512-thread block per element whose reductions took two
// block-wide barriers per shift-add pass. Of the product's time stages 1-2
// take about a quarter, the products a quarter to a third, the 12 warp
// reductions the rest (PERF.md).

#include "limb_common.cuh"

namespace {

using namespace limb;

constexpr int NSLOTS = LIMB_TOWER_NSLOTS;
constexpr int MAX_TERMS = LIMB_TOWER_MAX_TERMS;
constexpr int MAX_PRODUCTS = LIMB_TOWER_MAX_PRODUCTS;
constexpr int OUTPUTS = 12;
constexpr int THREADS = WARP * OUTPUTS;  // one element's group
constexpr int PROD_STRIDE = NCOLS + 1;   // 96
// A product's operands in shared memory: x[i] at i, y[j] at Y_OFF + j, with
// zeros for -4 <= j < 0 and 48 <= j <= 50 (the windows of the column strips
// reach there); an odd stride, so that 32 products fall in 32 banks.
constexpr int Y_OFF = NLIMBS + 4;               // 52
constexpr int OP_STRIDE = Y_OFF + NLIMBS + 3;   // 103
constexpr int STRIPS = NCOLS / 8 + 1;           // 12 pairs of 4-column strips

struct Smem {
  int slots[NSLOTS][NLIMBS];
  union {  // the operand sums are dead once the products are formed
    int ops[MAX_PRODUCTS * OP_STRIDE];
    WarpScratch ws[OUTPUTS];
  };
  alignas(16) int prods[MAX_PRODUCTS][PROD_STRIDE];
  LimbConsts k;
};

// a: (rows, 12, 48) with row stride sa; b: (rows, n_second, 48) with row
// stride sb (unused when n_second == 0); out: (rows, 12, 48) dense.
__global__ void __launch_bounds__(THREADS)
    tower_kernel(int formula, int products, int n_second, int npass,
                 const int* __restrict__ a, long long sa, const int* __restrict__ b,
                 long long sb, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& s = *reinterpret_cast<Smem*>(raw);
  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * WARP + lane;
  const long long row = blockIdx.x;

  // 1. operand slots and the constant digits
  int* flat = &s.slots[0][0];
  for (int i = tid; i < NSLOTS * NLIMBS; i += THREADS) {
    const int slot = i / NLIMBS, limb = i % NLIMBS;
    int v = 0;
    if (slot < 12) {
      v = a[row * sa + i];
    } else if (slot < LIMB_TOWER_SLOT_B + n_second) {
      v = b[row * sb + (i - LIMB_TOWER_SLOT_B * NLIMBS)];
    } else if (slot == LIMB_TOWER_SLOT_NEGC) {
      v = LIMB_NEGC[limb];
    } else if (slot == LIMB_TOWER_SLOT_ONE) {
      v = LIMB_ONE_MONT[limb];
    }
    flat[i] = v;
  }
  load_consts(s.k, tid, THREADS);
  __syncthreads();

  // 2. operand sums: warp w takes the product sides ps = w, w + 12, ...
  // (product ps / 2, side ps % 2), lane l its limbs l and l + 32; a side's
  // terms are the same for the whole warp (packed: a coefficient 0 ends
  // them), and the y side writes its zero pads
  for (int ps = w; ps < 2 * products; ps += OUTPUTS) {
    const int p = ps / 2, side = ps % 2;
    const bool two = lane < NLIMBS - WARP;
    int acc0 = 0, acc1 = 0;
    for (int t = 0; t < MAX_TERMS; ++t) {
      const int c = LIMB_TOWER_COEF[formula][p][side][t];
      if (c == 0) break;
      const int* src = s.slots[LIMB_TOWER_SLOT[formula][p][side][t]];
      acc0 += c * src[lane];
      if (two) acc1 += c * src[lane + WARP];
    }
    int* dst = &s.ops[p * OP_STRIDE + (side ? Y_OFF : 0)];
    dst[lane] = acc0;
    if (two) dst[lane + WARP] = acc1;
    if (side == 1 && lane < 4) dst[lane - 4] = 0;
    if (side == 1 && lane < 3) dst[NLIMBS + lane] = 0;
  }
  __syncthreads();

  // 3. products: a task is strip s (columns 4s .. 4s + 3, terms 0 .. 4s + 3)
  // and strip s + 12 (columns 4s + 48 .. 4s + 51, terms 4s + 1 .. 47) of one
  // product: 51 terms for every s. Consecutive threads take consecutive
  // products of one s, so a warp's loops share their trip counts. Column 95
  // is the pad (0: its terms reach past x).
  for (int i = tid; i < products * STRIPS; i += THREADS) {
    const int p = i % products, st = i / products;
    const int* op = &s.ops[p * OP_STRIDE];
    int lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
    conv_strip(op, op + Y_OFF, 4 * st, 0, 4 * st + 3, lo);
    conv_strip(op, op + Y_OFF, 4 * st + 48, 4 * st + 1, NLIMBS - 1, hi);
    store4(&s.prods[p][4 * st], lo);
    store4(&s.prods[p][4 * st + 48], hi);
  }
  __syncthreads();

  // 4. warp w: output w's wide and its reduction
  const int c0 = COLS_PER_THREAD * lane;
  int col[4] = {0, 0, 0, 0};
  if (c0 < PROD_STRIDE) {
    const int n = LIMB_TOWER_OUT_N[formula][w];
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const int c = LIMB_TOWER_OUT_C[formula][w][t];
      const int* prod = s.prods[LIMB_TOWER_OUT_P[formula][w][t]];
      const int4 v = *reinterpret_cast<const int4*>(&prod[c0]);
      col[0] += c * v.x;
      col[1] += c * v.y;
      col[2] += c * v.z;
      col[3] += c * v.w;
    }
  }
  mont_reduce_warp(col, lane, s.ws[w], s.k, npass, out + (row * 12 + w) * NLIMBS);
}

int launch(int formula, int products, int n_second, int npass, const int* a, long long sa,
           const int* b, long long sb, int* out, int rows, void* stream) {
  if (rows > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    tower_kernel<<<rows, dim3(WARP, OUTPUTS), sizeof(Smem),
                   static_cast<cudaStream_t>(stream)>>>(formula, products, n_second, npass,
                                                        a, sa, b, sb, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int limb_fq12_mul_launch(const int* a, long long sa, const int* b, long long sb,
                                    int* out, int rows, void* stream) {
  return launch(LIMB_TOWER_MUL, LIMB_TOWER_MUL_PRODUCTS, 12, LIMB_TOWER_MUL_NPASS, a, sa, b,
                sb, out, rows, stream);
}

extern "C" int limb_fq12_square_launch(const int* a, long long sa, int* out, int rows,
                                       void* stream) {
  return launch(LIMB_TOWER_SQUARE, LIMB_TOWER_SQUARE_PRODUCTS, 0, LIMB_TOWER_SQUARE_NPASS, a,
                sa, nullptr, 0, out, rows, stream);
}

extern "C" int limb_fq12_mul_by_014_launch(const int* a, long long sa, const int* d,
                                           long long sd, int* out, int rows, void* stream) {
  return launch(LIMB_TOWER_MUL_BY_014, LIMB_TOWER_MUL_BY_014_PRODUCTS, 6,
                LIMB_TOWER_MUL_BY_014_NPASS, a, sa, d, sd, out, rows, stream);
}

extern "C" int limb_fq12_cyclotomic_square_launch(const int* a, long long sa, int* out,
                                                  int rows, void* stream) {
  return launch(LIMB_TOWER_CYCLOTOMIC_SQUARE, LIMB_TOWER_CYCLOTOMIC_SQUARE_PRODUCTS, 0,
                LIMB_TOWER_CYCLOTOMIC_SQUARE_NPASS, a, sa, nullptr, 0, out, rows, stream);
}
