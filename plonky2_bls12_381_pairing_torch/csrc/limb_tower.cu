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
// the pass count of the merged reduction. One block computes one element:
//   1. the operand slots into shared memory;
//   2. every product's two operand sums;
//   3. every product's 95 columns (one thread per column);
//   4. per output, the signed sum of its products' columns and the scan-free
//      reduction, four outputs at a time (one group of 128 threads each).
// Nothing but the operands and the result touches device memory.
//
// What bounds it on an H100: operations (54 / 36 / 39 / 39 products of 2,304
// multiply-adds and 12 reductions of about 5,000 per element, against 1 to
// 1.7 KB moved). The design is the simple one; it keeps about 50 KB of shared
// memory per block, so four blocks share an SM.

#include "limb_common.cuh"

namespace {

using namespace limb;

constexpr int NSLOTS = LIMB_TOWER_NSLOTS;
constexpr int MAX_TERMS = LIMB_TOWER_MAX_TERMS;
constexpr int MAX_PRODUCTS = LIMB_TOWER_MAX_PRODUCTS;
constexpr int THREADS = LANES * GROUPS;
constexpr int PROD_STRIDE = NCOLS + 1;  // 96

struct Smem {
  int slots[NSLOTS][NLIMBS];
  int ops[MAX_PRODUCTS][2][NLIMBS];
  int prods[MAX_PRODUCTS][PROD_STRIDE];
  Scratch sc[GROUPS];
};

// a: (rows, 12, 48) with row stride sa; b: (rows, n_second, 48) with row
// stride sb (unused when n_second == 0); out: (rows, 12, 48) dense.
__global__ void __launch_bounds__(THREADS)
    tower_kernel(int formula, int products, int n_second, int npass,
                 const int* __restrict__ a, long long sa, const int* __restrict__ b,
                 long long sb, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& s = *reinterpret_cast<Smem*>(raw);
  const int lane = threadIdx.x, g = threadIdx.y;
  const int tid = g * LANES + lane;
  const long long row = blockIdx.x;

  // 1. operand slots
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
  __syncthreads();

  // 2. operand sums
  for (int i = tid; i < products * 2 * NLIMBS; i += THREADS) {
    const int limb = i % NLIMBS, side = (i / NLIMBS) % 2, p = i / (2 * NLIMBS);
    int acc = 0;
    for (int t = 0; t < MAX_TERMS; ++t) {
      const int c = LIMB_TOWER_COEF[formula][p][side][t];
      if (c != 0) acc += c * s.slots[LIMB_TOWER_SLOT[formula][p][side][t]][limb];
    }
    s.ops[p][side][limb] = acc;
  }
  __syncthreads();

  // 3. products
  for (int i = tid; i < products * PROD_STRIDE; i += THREADS) {
    const int p = i / PROD_STRIDE, k = i % PROD_STRIDE;
    s.prods[p][k] = conv_column(s.ops[p][0], s.ops[p][1], k);
  }
  __syncthreads();

  // 4. wide combines and the reductions: group g takes outputs g, g + 4, g + 8
  for (int j = g; j < 12; j += GROUPS) {
    int col = 0;
    if (lane < NCOLS) {
      for (int p = 0; p < products; ++p) {
        const int c = LIMB_TOWER_OUT[formula][j][p];
        if (c != 0) col += c * s.prods[p][lane];
      }
    }
    const int res = mont_reduce_lanes(col, lane, s.sc[g], npass);
    if (lane < NLIMBS) out[(row * 12 + j) * NLIMBS + lane] = res;
  }
}

int launch(int formula, int products, int n_second, int npass, const int* a, long long sa,
           const int* b, long long sb, int* out, int rows, void* stream) {
  if (rows > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    tower_kernel<<<rows, dim3(LANES, GROUPS), sizeof(Smem),
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
