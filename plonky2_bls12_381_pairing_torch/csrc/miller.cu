// The RNS Miller loop in one kernel per call, on the tensor-core REDC
// (rns_redc_tc.cuh), in three entries:
//
//   miller_run        the Miller accumulation over step-major raw line
//                     triples of T >= 1 terms: per step and term the
//                     coefficient scaling (c0 P.y, c1 P.x: a 4-row REDC), the
//                     sparse product mul_by_014 with the identity-select (f
//                     unchanged where the term has an input at infinity);
//                     then f <- f^2 where the step's flag says so;
//   miller_fused      the single-term loop with the G2 preparation fused in:
//                     (R, f) run through the schedule together, per step the
//                     line step (doubling, or addition where flagged) with
//                     the scaling riding its last REDC (rns_lines.cuh), the
//                     ell with the identity-select, and the square where
//                     flagged;
//   prepare_g2_lines  the line steps alone: the (steps, rows, 3, 2, 128) raw
//                     triples that miller_run reads.
//
// miller_run replaces the TPU kernel miller_run (plonky2_bls12_381_pairing_
// tpu/ops/rns/pallas.py, _build_miller), whose grid is (step, row block) with
// the accumulator in a persistent VMEM scratch across the step axis, for one
// term. miller_fused and prepare_g2_lines take over what the JAX package
// leaves to XLA's fusions: models/pairing_rns.py miller_loop_fused and
// prepare_g2_stepmajor (the line steps of ops/rns/lines.py). Their plain
// PyTorch versions are ops/rns/kernels.py miller_run_plain,
// miller_fused_plain and prepare_g2_lines_plain; the rows agree bit for bit.
//
// What bounds them on an H100: the REDCs' base extensions and lane
// arithmetic, not bytes. A one-term loop is 1,832 REDC rows per element
// (68 x (4 + 12) + 62 x 12) plus the formulas' lane products, the fused loop
// about 3,400 (the line steps' 20-34 rows per step on top of the ell and the
// square), while the data is one pass over the coefficients (six residues per
// step, term and lane; none for miller_fused) and one Fq12 row out. The
// design: the step axis is a loop inside the block, which holds a tile of
// TILE packed rows (one thread per lane and row) for the whole loop, the
// accumulator f, the point R, Q and P in registers, and runs every stacked
// REDC on the tensor cores. The state (f 12, R 6, Q 4, P 2 residues) and the
// line steps' live values do not fit the 64 registers of two 512-thread
// blocks per SM, so a block takes an SM to itself and 128 registers.
// miller_run reads each (step, term)'s six coefficient residues straight
// from device memory, 128 consecutive int32 per component, one (step, term)
// ahead of their use, so that the load is in flight during the previous
// one's arithmetic. The terms come as one base pointer and strides per
// operand (Terms), so that one launch takes any number of terms, reads no
// table the host wrote for it, and replays from a CUDA graph with the
// pointers it was captured with.

#include "rns_lines.cuh"
#include "rns_tile.cuh"

namespace {

using namespace rns;

constexpr int TILE = RNS_TC_ROWS;
constexpr int THREADS = TILE * LANES;

// The terms of one miller_run launch, each operand a base pointer and
// strides in int32 elements, held in 64 bits (130 terms' coefficients at
// 1,024 packed rows are 6.95e9 int32): term t's coefficients of step j, a
// (rows, 3, 2, 128) block, at coeffs + j * coeff_step + t * coeff_term; its
// P.y, P.x and skip mask, (rows, 128) each, at py + t * py_term, and so on.
struct Terms {
  const int* coeffs;
  const int* py;
  const int* px;
  const int* skip;
  long long coeff_step, coeff_term, py_term, px_term, skip_term;
};

// f <- f where keep, else f * ((d0 + d1 v) + (d4 v) w).
__device__ __forceinline__ void ell_select(int (&f)[12], F2 d0, F2 d1, F2 d4, bool keep,
                                           const Lane& c, TcSmem<TILE>& s, int l) {
  int g[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) g[k] = f[k];
  fq12_mul_by_014<SUB>(g, d0, d1, d4, c, s, bias_at(RNS_M014_BIAS, l));
#pragma unroll
  for (int k = 0; k < 12; ++k) f[k] = keep ? f[k] : g[k];
}

// The six coefficient residues of the thread's row and lane at p (a step's
// (rows, 3, 2, 128) block).
__device__ __forceinline__ void load6(int (&v)[6], const int* p, const Row& r, int lane) {
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = r.live ? p[(r.row * 6 + k) * LANES + lane] : 0;
}

// f0: rows of (12, 128), sf ints apart; tt: nterms terms; flags: nsteps
// do-square flags; out: (rows, 12, 128).
__global__ void __launch_bounds__(THREADS, 1)
    miller_run_kernel(const int* __restrict__ f0, long long sf, const Terms tt, int nterms,
                      const int* __restrict__ flags, int nsteps, int* __restrict__ out,
                      int rows) {
  __shared__ TcSmem<TILE> s;
  const Block b = enter(s);
  const Row r = row_of<TILE>(blockIdx.x, rows);
  int f[12];
  load12m(f, f0, sf, r, b.lane);

  const int total = nsteps * nterms;
  int nxt[6];
  if (total > 0) load6(nxt, tt.coeffs, r, b.lane);
  int i = 0;
  for (int j = 0; j < nsteps; ++j) {
    for (int t = 0; t < nterms; ++t, ++i) {
      int cur[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) cur[k] = nxt[k];
      if (i + 1 < total) {
        const int tn = t + 1 < nterms ? t + 1 : 0;
        const int jn = t + 1 < nterms ? j : j + 1;
        load6(nxt, tt.coeffs + jn * tt.coeff_step + tn * tt.coeff_term, r, b.lane);
      }
      const int y = load1m(tt.py + t * tt.py_term, r, b.lane);
      const int x = load1m(tt.px + t * tt.px_term, r, b.lane);
      const bool keep = load1m(tt.skip + t * tt.skip_term, r, b.lane) != 0;
      // rows 0:2 = c0 P.y, rows 2:4 = c1 P.x, one stacked REDC
      int sc[4] = {mul_m(cur[0], y, b.c), mul_m(cur[1], y, b.c), mul_m(cur[2], x, b.c),
                   mul_m(cur[3], x, b.c)};
      add_bias(sc, RNS_ELL_BIAS, b.l, b.c);
      redc<4>(sc, b.c, s);
      ell_select(f, F2{cur[4], cur[5]}, F2{sc[2], sc[3]}, F2{sc[0], sc[1]}, keep, b.c, s, b.l);
    }
    if (flags[j]) fq12_square<SUB>(f, b.c, s, bias_at(RNS_SQ_BIAS, b.l));
  }
  if (r.live) store12(f, out, r.row, b.lane);
}

// The starting point R = (rx, ry, rz) and Q = (qx, qy): rows of (2, 128),
// each with its row stride.
struct Points {
  const int *rx, *ry, *rz, *qx, *qy;
  long long srx, sry, srz, sqx, sqy;
};

__device__ __forceinline__ G2P load_r(const Points& p, const Row& r, int lane) {
  return {load2m(p.rx, p.srx, r, lane), load2m(p.ry, p.sry, r, lane),
          load2m(p.rz, p.srz, r, lane)};
}

__device__ __forceinline__ G2A load_q(const Points& p, const Row& r, int lane) {
  return {load2m(p.qx, p.sqx, r, lane), load2m(p.qy, p.sqy, r, lane)};
}

// py, px, skip: (rows, 128); flags: per step, bit 0 square after the ell,
// bit 1 an addition step (else a doubling step).
__global__ void __launch_bounds__(THREADS, 1)
    miller_fused_kernel(const int* __restrict__ f0, long long sf, const Points pts,
                        const int* __restrict__ py, const int* __restrict__ px,
                        const int* __restrict__ skip, const int* __restrict__ flags,
                        int nsteps, int* __restrict__ out, int rows) {
  __shared__ TcSmem<TILE> s;
  const Block b = enter(s);
  const Row r = row_of<TILE>(blockIdx.x, rows);
  int f[12];
  load12m(f, f0, sf, r, b.lane);
  G2P R = load_r(pts, r, b.lane);
  const G2A Q = load_q(pts, r, b.lane);
  const int y = load1m(py, r, b.lane);
  const int x = load1m(px, r, b.lane);
  const bool keep = load1m(skip, r, b.lane) != 0;
  for (int j = 0; j < nsteps; ++j) {
    const int fl = flags[j];
    const Line e = (fl & 2) ? addition_step<true>(R, Q, y, x, b.c, s, b.l)
                            : doubling_step<true>(R, y, x, b.c, s, b.l);
    // ell = (c2, c1 P.x, c0 P.y) as mul_by_014's (d0, d1, d4)
    ell_select(f, e.c2, e.c1, e.c0, keep, b.c, s, b.l);
    if (fl & 1) fq12_square<SUB>(f, b.c, s, bias_at(RNS_SQ_BIAS, b.l));
  }
  if (r.live) store12(f, out, r.row, b.lane);
}

// flags: per step, 1 for an addition step; out: (nsteps, rows, 3, 2, 128).
__global__ void __launch_bounds__(THREADS, 1)
    prepare_g2_lines_kernel(const Points pts, const int* __restrict__ flags, int nsteps,
                            int* __restrict__ out, int rows) {
  __shared__ TcSmem<TILE> s;
  const Block b = enter(s);
  const Row r = row_of<TILE>(blockIdx.x, rows);
  G2P R = load_r(pts, r, b.lane);
  const G2A Q = load_q(pts, r, b.lane);
  for (int j = 0; j < nsteps; ++j) {
    const Line e = flags[j] ? addition_step<false>(R, Q, 0, 0, b.c, s, b.l)
                            : doubling_step<false>(R, 0, 0, b.c, s, b.l);
    if (r.live) {
      int* p = out + ((static_cast<long long>(j) * rows + r.row) * 6) * LANES + b.lane;
      const int v[6] = {e.c0.c0, e.c0.c1, e.c1.c0, e.c1.c1, e.c2.c0, e.c2.c1};
#pragma unroll
      for (int k = 0; k < 6; ++k) p[k * LANES] = v[k];
    }
  }
}

int tiles(int rows) { return (rows + TILE - 1) / TILE; }

Points points(const int* rx, long long srx, const int* ry, long long sry, const int* rz,
              long long srz, const int* qx, long long sqx, const int* qy, long long sqy) {
  return {rx, ry, rz, qx, qy, srx, sry, srz, sqx, sqy};
}

}  // namespace

// The nterms terms' operands as Terms describes them: coeffs with its step
// and term strides, py, px and skip with their term strides.
extern "C" int miller_run_launch(const int* f0, long long sf, const int* coeffs,
                                 long long coeff_step, long long coeff_term, const int* py,
                                 long long py_term, const int* px, long long px_term,
                                 const int* skip, long long skip_term, int nterms,
                                 const int* flags, int nsteps, int* out, int rows,
                                 void* stream) {
  if (nterms < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    const Terms tt{coeffs, py, px, skip, coeff_step, coeff_term, py_term, px_term, skip_term};
    miller_run_kernel<<<tiles(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        f0, sf, tt, nterms, flags, nsteps, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int miller_fused_launch(const int* f0, long long sf, const int* rx, long long srx,
                                   const int* ry, long long sry, const int* rz, long long srz,
                                   const int* qx, long long sqx, const int* qy, long long sqy,
                                   const int* py, const int* px, const int* skip,
                                   const int* flags, int nsteps, int* out, int rows,
                                   void* stream) {
  if (rows > 0) {
    miller_fused_kernel<<<tiles(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        f0, sf, points(rx, srx, ry, sry, rz, srz, qx, sqx, qy, sqy), py, px, skip, flags,
        nsteps, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int prepare_g2_lines_launch(const int* rx, long long srx, const int* ry,
                                       long long sry, const int* rz, long long srz,
                                       const int* qx, long long sqx, const int* qy,
                                       long long sqy, const int* flags, int nsteps, int* out,
                                       int rows, void* stream) {
  if (rows > 0) {
    prepare_g2_lines_kernel<<<tiles(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        points(rx, srx, ry, sry, rz, srz, qx, sqx, qy, sqy), flags, nsteps, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
