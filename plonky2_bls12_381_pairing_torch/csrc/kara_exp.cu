// The Karabina squaring chain of compressed cyclotomic Fq12 elements (g2,
// g3, g4, g5: 8 components), one kernel body walking it in two ways:
//   kara_exp, snapshots: for each k in turn segs[k] squarings, then the
//     state written out as snapshot k, the compressed form of
//     f^(2^(segs[0] + ... + segs[k]));
//   kara_square_run, one run: n squarings, then one store (n = 0 copies
//     the rows).
//
// Replaces the TPU kernels kara_exp_run (plonky2_bls12_381_pairing_tpu/ops/
// rns/pallas.py, _build_kara_exp), which keeps the state in VMEM for the
// whole chain, and kara_square_run (pallas.py, _build_square_run), which
// keeps a component-major block in VMEM for the run. Their plain PyTorch
// versions are ops/rns/kernels.py kara_exp_plain and kara_square_run_plain
// (n times tower.compressed_square_plain); the rows agree bit for bit.
//
// What bounds it on an H100: integer issue. For |BLS_X| the chain is 63
// squarings, each one 8-row REDC and the lane arithmetic of four Fq2
// products, against 8 x 128 int32 read and (kara_exp) six times that
// written per packed row. The REDC's two base extensions are matrix
// products, which run on the tensor cores (rns_redc_tc.cuh), as in
// cyc_exp.cu and kara_full.cu's chain: a block holds a tile of TILE packed
// rows for the whole chain, one thread per lane and row, the 8 residues in
// registers; the u8 plane tables, the bias rows (RNS_KARA_BIAS: const
// rows read from device memory inside the loop would be hoisted into
// registers and spill) and the REDC's planes and sums in shared memory.
// Only the snapshots, or the run's end, go to device memory. Rows past the
// end (in the last tile) compute on zeros and store nothing; their threads
// take every barrier, and the chain lengths, read from device memory, are
// the same for the whole block.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (kernel_probe.py section 8,
// queued launches, 1024 packed rows, |BLS_X|'s chain): kara_exp 0.473 ms,
// kara_square_run 0.246 ms at n = 32 and 0.524 ms over the six runs of |x|
// (1.124, 0.575 and 1.125 ms in the one-row blocks with a block-wide REDC
// that they had before, chip_smoke.py), against work bounds of 0.015,
// 0.007 and 0.021 ms; on tiles of 4 packed rows 0.495, 0.258 and 0.538 ms.
// ptxas: 62 registers (kara_exp), 56 (the runs), no spill.

#include "rns_tile.cuh"

namespace {

using namespace rns;

// packed rows per block; a tile of T rows takes 8 / T blocks per SM (64
// registers a thread)
constexpr int TILE = 2;

// How the kernel walks the chain.
enum Walk {
  SNAPSHOTS,  // segs: nseg chain lengths, the state stored after each
  RUN,        // nseg squarings, then one store; segs unused
};

// One block per T packed rows (the last tile masked); a is (rows, 8, 128)
// int32, out (nseg, rows, 8, 128) for SNAPSHOTS and (rows, 8, 128) for RUN.
template <Walk WALK, int T>
__global__ void __launch_bounds__(T * LANES, 8 / T)
    kara_exp_kernel(const int* __restrict__ a, int* __restrict__ out, int rows,
                    const int* __restrict__ segs, int nseg) {
  static_assert(T == 2 || T == 4, "a tile of 2 or 4 packed rows");
  __shared__ TcSmem<T> s;
  __shared__ int bias[8][SUB];  // RNS_KARA_BIAS
  for (int i = threadIdx.x; i < 8 * SUB; i += T * LANES) {
    bias[i / SUB][i % SUB] = RNS_KARA_BIAS[i / SUB][i % SUB];
  }
  const Block b = enter(s);  // its barrier also orders the bias rows
  const Row r = row_of<T>(blockIdx.x, rows);
  int g[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) g[k] = r.live ? a[(r.row * 8 + k) * LANES + b.lane] : 0;
  const int steps = WALK == RUN ? 1 : nseg;
  for (int k = 0; k < steps; ++k) {
    const int n = WALK == RUN ? nseg : segs[k];
    for (int i = 0; i < n; ++i) kara_square<SUB>(g, b.c, s, &bias[0][b.l]);
    if (r.live) {
      int* o = out + ((static_cast<long long>(k) * rows + r.row) * 8) * LANES + b.lane;
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i * LANES] = g[i];
    }
  }
}

template <Walk WALK, int T>
int launch(const int* a, int* out, int rows, const int* segs, int nseg, void* stream) {
  if (rows > 0) {
    kara_exp_kernel<WALK, T><<<(rows + T - 1) / T, T * LANES, 0,
                               static_cast<cudaStream_t>(stream)>>>(a, out, rows, segs,
                                                                    nseg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// segs holds nseg chain lengths, one per snapshot.
extern "C" int kara_exp_launch(const int* a, int* out, int rows, const int* segs, int nseg,
                               void* stream) {
  return launch<SNAPSHOTS, TILE>(a, out, rows, segs, nseg, stream);
}

// n Karabina squarings; n = 0 copies the rows.
extern "C" int kara_square_run_launch(const int* a, int* out, int rows, int n,
                                      void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<RUN, TILE>(a, out, rows, nullptr, n, stream);
}
