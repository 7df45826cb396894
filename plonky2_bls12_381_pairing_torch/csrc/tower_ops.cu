// One kernel per Fq12 tower op: the full product, the complex squaring, the
// sparse product mul_by_014, mul_by_014 followed by a squaring (the Miller
// step's ell and square), and the Granger-Scott cyclotomic squaring.
//
// Replaces the TPU kernel fused_op (plonky2_bls12_381_pairing_tpu/ops/rns/
// pallas.py, _build), which runs any tower formula as one kernel over row
// blocks with the formula's constants collected into its inputs; the JAX
// package sends exactly these five formulas through it (ops/rns/tower.py).
// Their plain PyTorch versions are ops/rns/tower.py mul_plain, square_plain,
// mul_by_014_plain, mul_by_014_square_plain and cyclotomic_square_plain; the
// rows agree bit for bit.
//
// What bounds them on an H100: bytes, narrowly. An op reads one or two 6 KB
// Fq12 rows and writes one, and does one 12-row REDC plus the formula's lane
// products on them; at the card's peak rates the traffic takes somewhat longer
// than the integer work (chip_smoke.py counts both from the shapes). The
// design reads every operand once, straight into registers (one block per
// packed row, one thread per lane, 128 consecutive int32 per component:
// coalesced), keeps every intermediate of the formula on chip, runs the REDC
// through shared memory and stores the row once. The plain versions write
// each of the formula's intermediates to device memory instead. Operands come
// with a row stride, so that a broadcast operand (stride 0) or a slice of a
// wider tensor is read in place. What the design does not avoid: each block
// first copies the two base-extension blocks (16 KB, from the L2 cache) into
// its shared memory, which for a single REDC is traffic of the size of the
// row's own.

#include "rns_tower.cuh"

namespace {

using namespace rns;

struct Block {
  Lane c;
  int lane, l;
  size_t row;
};

__device__ __forceinline__ Block enter(Smem<12>& s) {
  load_tables(s);
  __syncthreads();
  Block b;
  b.lane = threadIdx.x;
  b.l = b.lane % SUB;
  b.c = load_lane(b.l);
  b.row = blockIdx.x;
  return b;
}

// a, b: rows of (12, 128) int32, sa and sb ints apart; out: (rows, 12, 128).
__global__ void __launch_bounds__(LANES)
    fq12_mul_kernel(const int* __restrict__ a, long long sa, const int* __restrict__ b,
                    long long sb, int* __restrict__ out) {
  __shared__ Smem<12> s;
  const Block t = enter(s);
  int f[12], g[12];
  load12(f, a, sa, t.row, t.lane);
  load12(g, b, sb, t.row, t.lane);
  fq12_mul<SUB>(f, g, t.c, s, bias_at(RNS_MUL_BIAS, t.l));
  store12(f, out, t.row, t.lane);
}

__global__ void __launch_bounds__(LANES)
    fq12_square_kernel(const int* __restrict__ a, long long sa, int* __restrict__ out) {
  __shared__ Smem<12> s;
  const Block t = enter(s);
  int f[12];
  load12(f, a, sa, t.row, t.lane);
  fq12_square<SUB>(f, t.c, s, bias_at(RNS_SQ_BIAS, t.l));
  store12(f, out, t.row, t.lane);
}

__global__ void __launch_bounds__(LANES)
    fq12_cyclotomic_square_kernel(const int* __restrict__ a, long long sa,
                                  int* __restrict__ out) {
  __shared__ Smem<12> s;
  const Block t = enter(s);
  int f[12];
  load12(f, a, sa, t.row, t.lane);
  cyc_square<SUB>(f, t.c, s, bias_at(RNS_CYC_BIAS, t.l));
  store12(f, out, t.row, t.lane);
}

// d0, d1, d4: rows of (2, 128) int32 (stored Fq2), s0, s1, s4 ints apart.
// SQUARE: the squaring follows, and before it the lanes that skip marks
// (rows of 128 int32, ss apart; may be null) take a back.
template <bool SQUARE>
__global__ void __launch_bounds__(LANES)
    fq12_mul_by_014_kernel(const int* __restrict__ a, long long sa,
                           const int* __restrict__ d0, long long s0,
                           const int* __restrict__ d1, long long s1,
                           const int* __restrict__ d4, long long s4,
                           const int* __restrict__ skip, long long ss,
                           int* __restrict__ out) {
  __shared__ Smem<12> s;
  const Block t = enter(s);
  int f[12];
  load12(f, a, sa, t.row, t.lane);
  const F2 e0 = load2(d0, s0, t.row, t.lane);
  const F2 e1 = load2(d1, s1, t.row, t.lane);
  const F2 e4 = load2(d4, s4, t.row, t.lane);
  if constexpr (SQUARE) {
    const bool keep = skip != nullptr && skip[t.row * ss + t.lane] != 0;
    int g[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) g[k] = f[k];
    fq12_mul_by_014<SUB>(g, e0, e1, e4, t.c, s, bias_at(RNS_M014_BIAS, t.l));
#pragma unroll
    for (int k = 0; k < 12; ++k) f[k] = keep ? f[k] : g[k];
    fq12_square<SUB>(f, t.c, s, bias_at(RNS_SQ_BIAS, t.l));
  } else {
    fq12_mul_by_014<SUB>(f, e0, e1, e4, t.c, s, bias_at(RNS_M014_BIAS, t.l));
  }
  store12(f, out, t.row, t.lane);
}

inline int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" int fq12_mul_launch(const int* a, long long sa, const int* b, long long sb,
                               int* out, int rows, void* stream) {
  if (rows > 0) {
    fq12_mul_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, sa, b, sb,
                                                                           out);
  }
  return launched();
}

extern "C" int fq12_square_launch(const int* a, long long sa, int* out, int rows,
                                  void* stream) {
  if (rows > 0) {
    fq12_square_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, sa, out);
  }
  return launched();
}

extern "C" int fq12_cyclotomic_square_launch(const int* a, long long sa, int* out,
                                             int rows, void* stream) {
  if (rows > 0) {
    fq12_cyclotomic_square_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(
        a, sa, out);
  }
  return launched();
}

extern "C" int fq12_mul_by_014_launch(const int* a, long long sa, const int* d0,
                                      long long s0, const int* d1, long long s1,
                                      const int* d4, long long s4, int* out, int rows,
                                      void* stream) {
  if (rows > 0) {
    fq12_mul_by_014_kernel<false><<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(
        a, sa, d0, s0, d1, s1, d4, s4, nullptr, 0, out);
  }
  return launched();
}

extern "C" int fq12_mul_by_014_square_launch(const int* a, long long sa, const int* d0,
                                             long long s0, const int* d1, long long s1,
                                             const int* d4, long long s4, const int* skip,
                                             long long ss, int* out, int rows,
                                             void* stream) {
  if (rows > 0) {
    fq12_mul_by_014_kernel<true><<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(
        a, sa, d0, s0, d1, s1, d4, s4, skip, ss, out);
  }
  return launched();
}
