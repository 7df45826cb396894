// Whole-exponent Granger-Scott exponentiation a^X of cyclotomic Fq12
// elements: X is given as MSB-first (n_squares, multiply_after) segments
// after its leading bit; each segment is n cyclotomic squarings, then, if
// flagged, one full Fq12 product with the base.
//
// Replaces the TPU kernel cyc_exp_run (plonky2_bls12_381_pairing_tpu/ops/rns/
// pallas.py, _build_cyc_exp), which keeps the base and the accumulator in
// VMEM for the whole exponent. Its plain PyTorch version is
// ops/rns/kernels.py cyc_exp_plain; the rows agree bit for bit.
//
// What bounds it on an H100: integer issue. Per packed row, |BLS_X| costs 63
// squarings and 5 products, each one 12-row REDC (two 31-term cross-lane dot
// products per lane and component) plus the lane arithmetic of the Fq2
// formulas; the data moved is only the 12 x 128 int32 input and output of
// each row. The design keeps the whole state of a row on chip for the whole
// exponent: one block per packed row, one thread per lane, the base and the
// accumulator (12 + 12 residues) in registers, the base-extension blocks and
// the cross-lane sums in shared memory. Nothing but the final row goes back
// to device memory.

#include "rns_common.cuh"

namespace {

using namespace rns;

// Granger-Scott squaring (tower.cyclotomic_square): the Fq4 squares of
// (z0, z1), (z2, z3), (z4, z5), recombined with 3*t -/+ 2*z and one REDC.
__device__ __forceinline__ void fp4_square(F2 a, F2 b, F2& r0, F2& r1, const Lane& c) {
  const F2 t0 = f2_mul(a, a, c);
  const F2 t1 = f2_mul(b, b, c);
  const F2 ab = f2_add(a, b, c);
  const F2 t2 = f2_sub(f2_sub(f2_mul(ab, ab, c), t0, c), t1, c);
  r0 = f2_add(f2_nonres(t1, c), t0, c);
  r1 = t2;
}

__device__ __forceinline__ void cyc_square(int (&a)[12], const Lane& c, Smem<12>& s,
                                           const int* bias) {
  const F2 z0{a[0], a[1]}, z4{a[2], a[3]}, z3{a[4], a[5]};
  const F2 z2{a[6], a[7]}, z1{a[8], a[9]}, z5{a[10], a[11]};
  F2 t0_01, t1_01, t0_23, t1_23, t2_45, t3_45;
  fp4_square(z0, z1, t0_01, t1_01, c);
  fp4_square(z2, z3, t0_23, t1_23, c);
  fp4_square(z4, z5, t2_45, t3_45, c);
  const F2 nz0 = f2_sub(f2_scale(t0_01, 3, c), f2_scale(f2_lift(z0, c), 2, c), c);
  const F2 nz1 = f2_add(f2_scale(t1_01, 3, c), f2_scale(f2_lift(z1, c), 2, c), c);
  const F2 nz4 = f2_sub(f2_scale(t0_23, 3, c), f2_scale(f2_lift(z4, c), 2, c), c);
  const F2 nz5 = f2_add(f2_scale(t1_23, 3, c), f2_scale(f2_lift(z5, c), 2, c), c);
  const F2 nz2 = f2_add(f2_scale(f2_nonres(t3_45, c), 3, c),
                        f2_scale(f2_lift(z2, c), 2, c), c);
  const F2 nz3 = f2_sub(f2_scale(t2_45, 3, c), f2_scale(f2_lift(z3, c), 2, c), c);
  const F2 outs[6] = {nz0, nz4, nz3, nz2, nz1, nz5};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    a[2 * i] = add_m(outs[i].c0, bias[2 * i], c);
    a[2 * i + 1] = add_m(outs[i].c1, bias[2 * i + 1], c);
  }
  redc<12>(a, c, s);
}

// Fq6 = Fq2[v]/(v^3 - xi) Karatsuba product (tower._fq6_mul).
__device__ __forceinline__ void fq6_mul(const F2 (&a)[3], const F2 (&b)[3], F2 (&r)[3],
                                        const Lane& c) {
  const F2 t0 = f2_mul(a[0], b[0], c);
  const F2 t1 = f2_mul(a[1], b[1], c);
  const F2 t2 = f2_mul(a[2], b[2], c);
  const F2 m12 = f2_mul(f2_add(a[1], a[2], c), f2_add(b[1], b[2], c), c);
  const F2 m01 = f2_mul(f2_add(a[0], a[1], c), f2_add(b[0], b[1], c), c);
  const F2 m02 = f2_mul(f2_add(a[0], a[2], c), f2_add(b[0], b[2], c), c);
  r[0] = f2_add(t0, f2_nonres(f2_sub(f2_sub(m12, t1, c), t2, c), c), c);
  r[1] = f2_add(f2_sub(f2_sub(m01, t0, c), t1, c), f2_nonres(t2, c), c);
  r[2] = f2_add(f2_sub(f2_sub(m02, t0, c), t2, c), t1, c);
}

// Fq12 = Fq6[w]/(w^2 - v) Karatsuba product (tower.mul): a <- a * b.
__device__ __forceinline__ void fq12_mul(int (&a)[12], const int (&b)[12], const Lane& c,
                                         Smem<12>& s, const int* bias) {
  F2 a0[3], a1[3], b0[3], b1[3], as[3], bs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a0[i] = {a[2 * i], a[2 * i + 1]};
    a1[i] = {a[6 + 2 * i], a[7 + 2 * i]};
    b0[i] = {b[2 * i], b[2 * i + 1]};
    b1[i] = {b[6 + 2 * i], b[7 + 2 * i]};
    as[i] = f2_add(a0[i], a1[i], c);
    bs[i] = f2_add(b0[i], b1[i], c);
  }
  F2 t0[3], t1[3], t01[3];
  fq6_mul(a0, b0, t0, c);
  fq6_mul(a1, b1, t1, c);
  fq6_mul(as, bs, t01, c);
  // out0 = t0 + v t1 with v (x0, x1, x2) = (xi x2, x0, x1); out1 = t01 - t0 - t1
  const F2 outs[6] = {
      f2_add(t0[0], f2_nonres(t1[2], c), c),
      f2_add(t0[1], t1[0], c),
      f2_add(t0[2], t1[1], c),
      f2_sub(f2_sub(t01[0], t0[0], c), t1[0], c),
      f2_sub(f2_sub(t01[1], t0[1], c), t1[1], c),
      f2_sub(f2_sub(t01[2], t0[2], c), t1[2], c),
  };
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    a[2 * i] = add_m(outs[i].c0, bias[2 * i], c);
    a[2 * i + 1] = add_m(outs[i].c1, bias[2 * i + 1], c);
  }
  redc<12>(a, c, s);
}

// One block per packed row; a and out are (rows, 12, 128) int32;
// segs holds nseg (n_squares, multiply_after) pairs.
__global__ void __launch_bounds__(LANES)
    cyc_exp_kernel(const int* __restrict__ a, int* __restrict__ out,
                   const int* __restrict__ segs, int nseg) {
  __shared__ Smem<12> s;
  load_tables(s);
  __syncthreads();

  const int lane = threadIdx.x;
  const int l = lane % SUB;
  const Lane c = load_lane(l);
  int cb[12], mb[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    cb[k] = RNS_CYC_BIAS[k][l];
    mb[k] = RNS_MUL_BIAS[k][l];
  }

  const size_t row = blockIdx.x;
  int f[12], acc[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    f[k] = a[(row * 12 + k) * LANES + lane];
    acc[k] = f[k];
  }
  for (int g = 0; g < nseg; ++g) {
    const int n_sq = segs[2 * g];
    for (int i = 0; i < n_sq; ++i) cyc_square(acc, c, s, cb);
    if (segs[2 * g + 1]) fq12_mul(acc, f, c, s, mb);
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) out[(row * 12 + k) * LANES + lane] = acc[k];
}

}  // namespace

extern "C" int cyc_exp_launch(const int* a, int* out, int rows, const int* segs, int nseg,
                              void* stream) {
  if (rows > 0) {
    cyc_exp_kernel<<<rows, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a, out, segs,
                                                                          nseg);
  }
  return static_cast<int>(cudaGetLastError());
}
