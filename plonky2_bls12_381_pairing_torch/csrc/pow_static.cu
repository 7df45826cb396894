// Per-element power a^e of stored Fp elements by MSB-first square-and-
// multiply over e's bits (after its leading 1), each step redc(acc * acc)
// and, where the bit is set, redc(acc * a). 0 maps to 0.
//
// The recording build (a non-null `rec`) is the chain of a witness trace,
// the select form of ops/rns/fp.py pow_static_steps: the product with a is
// formed on every bit, kept where the bit is set, and each step writes its
// square and its product to rec (plane 2i the square of bit i, 2i + 1 the
// product), from which the trace's rns_mul rows are read.
//
// Replaces the TPU kernel pow_static_fused (plonky2_bls12_381_pairing_tpu/
// ops/rns/pallas.py, _build_pow), which runs the whole bit loop inside one
// kernel with the bits in scalar memory. Its plain PyTorch version is
// ops/rns/fp.py pow_static; the rows agree bit for bit.
//
// What bounds it on an H100: latency. On the pairing's path it raises the
// 128-row root of the batched inverse's product tree to p - 2: 256 elements,
// each a chain of 608 dependent REDCs; the work bound is 0.0018 ms, so the
// time is one element's chain. Measured on an H100 80GB HBM3 at 700 W
// (kernel_probe.py, both timed alike): 0.19 ms at (128, 128), 0.31 us (about
// 610 cycles) per dependent step, against 0.67 ms and 1.1 us for the earlier
// design of one 128-thread block per packed row with a block-wide redc
// (kernel_probe.py keeps it: four __syncthreads per REDC, the two 31-term
// sums on one accumulator each, two shared loads per term; PERF.md). The
// design shortens the step:
//   * one warp per element (a 64-lane slot): thread t holds slot lanes t and
//     t + 32, i.e. base-A lane t (t < 31) and base-B lane t + 32 (the
//     redundant lane at t = 30, the alpha column at t = 31; thread 31's
//     first lane is base-B lane 31);
//   * no block barrier in the bit loop: the two sigma rows go through
//     warp-private shared memory behind __syncwarp, alpha and beta through
//     one __shfl_sync each;
//   * the thread's columns of the two base-extension blocks (RNS_T1A column
//     t + 32, RNS_T2B column t, or 63 for beta) sit in registers, so a dot
//     product reads only the 31 sigmas, in 16-byte loads;
//   * each 31-term dot product runs on four accumulators.
// Step 2 has 33 columns (31 base-B lanes, the redundant lane, alpha) for 32
// threads: every thread also forms base-B lane 31's sum, which only thread
// 31 keeps (its inputs are the same for the whole warp). A REDC output
// depends only on these exact integer sums, so the order is free and the
// rows stay those of fp.redc. The split of a step
// by clock64() stamps: PERF.md.

#include "rns_common.cuh"

namespace {

using namespace rns;

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
// Warps (elements) per block: one measured as fast as two or four and
// faster than eight (kernel_probe.py; PERF.md).
constexpr int WARPS = 1;

// sum_i sig[i] * col[i] over the 31 channels; sig holds 32 words (the last
// is 0) in warp-private shared memory, read 4 at a time.
struct Dot2 {
  int a, b;
};

__device__ __forceinline__ Dot2 dot2(const int* sig, const int (&ca)[NCH],
                                     const int (&cb)[NCH]) {
  int a[4] = {0, 0, 0, 0}, b[4] = {0, 0, 0, 0};
  const int4* s4 = reinterpret_cast<const int4*>(sig);
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int4 s = s4[v];
    const int w[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * v + k;
      if (i < NCH) {
        a[k] += w[k] * ca[i];
        b[k] += w[k] * cb[i];
      }
    }
  }
  return {(a[0] + a[1]) + (a[2] + a[3]), (b[0] + b[1]) + (b[2] + b[3])};
}

__device__ __forceinline__ int dot(const int* sig, const int (&c)[NCH]) {
  int a[4] = {0, 0, 0, 0};
  const int4* s4 = reinterpret_cast<const int4*>(sig);
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int4 s = s4[v];
    const int w[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * v + k < NCH) a[k] += w[k] * c[4 * v + k];
    }
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// One warp's REDC of the element whose lanes t and t + 32 hold x0 and x1
// (fp.redc, steps 1-4, with the same integers at every step).
struct WarpRedc {
  int t;
  Lane c0, c1;
  int t1_hi[NCH];  // RNS_T1A column t + 32
  int t1_31[NCH];  // RNS_T1A column 31 (base-B lane 31, thread 31's lane t)
  int t2[NCH];     // RNS_T2B column t, or the beta column 63 at t = 31
  int* sig;        // warp-private: sigma, then sigma'
  int* sig2;

  __device__ __forceinline__ void run(int& x0, int& x1) const {
    // step 1: sigma on base A (c_sigma is 0 elsewhere: word 31 is the pad)
    sig[t] = mul_m(x0, c0.c_sigma, c0);
    __syncwarp();
    // step 2: lane t + 32's sum and base-B lane 31's; thread 31's lane
    // t + 32 is the alpha column
    const Dot2 q = dot2(sig, t1_hi, t1_31);
    const int alpha = __shfl_sync(FULL, q.a, WARP - 1) >> RNS_ALPHA_T;
    // step 3: qhat and sigma' on lane t (base-B only at t = 31) and lane
    // t + 32 (base B for t < 30)
    const int q0 = barrett((c0.is_a ? 0 : q.b) - alpha * c0.c_mamod, c0);
    const int q1 = barrett(q.a - alpha * c1.c_mamod, c1);
    const int sp0 = barrett(x0 * c0.c_mainv_mbinv + q0 * c0.c_pmainv_mbinv, c0);
    const int sp1 = barrett(x1 * c1.c_mainv_mbinv + q1 * c1.c_pmainv_mbinv, c1);
    // base-B channel j is slot lane 31 + j: thread 31's lane t for j = 0,
    // thread j - 1's lane t + 32 for 1 <= j <= 30; word 31 is the pad
    // (thread 30's lane t + 32 is the redundant lane, sigma' 0)
    sig2[t == WARP - 1 ? 0 : t + 1] = t == WARP - 1 ? sp0 : sp1;
    __syncwarp();
    // step 4: lane t's back extension (the beta column at t = 31)
    const int s2 = dot(sig2, t2);
    const int beta =
        (__shfl_sync(FULL, s2, WARP - 1) + (1 << (RNS_BETA_T - 1))) >> RNS_BETA_T;
    x0 = barrett(c0.is_a ? s2 - beta * c0.c_mbmod : x0 * c0.c_mainv + q0 * c0.c_pmainv, c0);
    x1 = barrett(x1 * c1.c_mainv + q1 * c1.c_pmainv, c1);
  }
};

// a and out are (rows, 128) int32: element e is slot e % 2 of row e / 2;
// rec (RECORD only) is (2 * nbits, rows, 128). Block (32, WARPS): warp
// threadIdx.y takes element blockIdx.x * WARPS + threadIdx.y.
template <bool RECORD>
__global__ void __launch_bounds__(WARP * WARPS)
    pow_static_kernel(const int* __restrict__ a, int* __restrict__ out,
                      int* __restrict__ rec, int elements,
                      const int* __restrict__ bits, int nbits) {
  __shared__ __align__(16) int buf[WARPS][2][WARP];
  const int t = threadIdx.x, w = threadIdx.y;
  const int e = blockIdx.x * WARPS + w;
  if (e >= elements) return;  // a whole warp: no barrier spans warps

  WarpRedc r;
  r.t = t;
  r.c0 = load_lane(t);
  r.c1 = load_lane(t + WARP);
  const int col2 = t < NCH ? t : RNS_ALPHA_LANE;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    r.t1_hi[i] = RNS_T1A[i][t + WARP];
    r.t1_31[i] = RNS_T1A[i][RNS_B_LO];
    r.t2[i] = RNS_T2B[i][col2];
  }
  r.sig = buf[w][0];
  r.sig2 = buf[w][1];

  const size_t base = static_cast<size_t>(e / PACK) * LANES + (e % PACK) * SUB + t;
  const size_t plane = static_cast<size_t>(elements / PACK) * LANES;
  const int b0 = a[base], b1 = a[base + WARP];
  int x0 = b0, x1 = b1;
  int bit = nbits > 0 ? bits[0] : 0;
  for (int i = 0; i < nbits; ++i) {
    const int next = i + 1 < nbits ? bits[i + 1] : 0;  // loaded a step ahead
    x0 = mul_m(x0, x0, r.c0);
    x1 = mul_m(x1, x1, r.c1);
    r.run(x0, x1);
    if (bit || RECORD) {
      const int s0 = x0, s1 = x1;
      x0 = mul_m(x0, b0, r.c0);
      x1 = mul_m(x1, b1, r.c1);
      r.run(x0, x1);
      if (RECORD) {
        int* sq = rec + 2 * static_cast<size_t>(i) * plane + base;
        sq[0] = s0;
        sq[WARP] = s1;
        sq[plane] = x0;
        sq[plane + WARP] = x1;
        if (!bit) {
          x0 = s0;
          x1 = s1;
        }
      }
    }
    bit = next;
  }
  out[base] = x0;
  out[base + WARP] = x1;
}

}  // namespace

// rec: null for the plain chain, else the recording build's (2 * nbits,
// rows, 128) steps
extern "C" int pow_static_launch(const int* a, int* out, int* rec, int rows,
                                 const int* bits, int nbits, void* stream) {
  const int elements = rows * PACK;
  if (elements > 0) {
    const dim3 grid((elements + WARPS - 1) / WARPS), block(WARP, WARPS);
    const auto s = static_cast<cudaStream_t>(stream);
    if (rec != nullptr) {
      pow_static_kernel<true><<<grid, block, 0, s>>>(a, out, rec, elements, bits, nbits);
    } else {
      pow_static_kernel<false><<<grid, block, 0, s>>>(a, out, rec, elements, bits, nbits);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
