"""The RNS tier's hand-written CUDA kernels (the JAX package's
ops/rns/pallas.py on the pairing's paths) and their plain PyTorch versions.

  cyc_exp(a, segments)            <- pallas.cyc_exp_run      (csrc/cyc_exp.cu)
  cyc_exp_cond(a, segments)       <- pallas.cyc_exp_run in its one-loop build,
                                     _build_cyc_exp_cond     (csrc/cyc_exp.cu)
  cyc_square_run(a, n)            <- pallas.cyc_square_run   (csrc/cyc_exp.cu)
  kara_square_run(c, n)           <- pallas.kara_square_run  (csrc/kara_exp.cu)
  kara_exp(c, segments)           <- pallas.kara_exp_run     (csrc/kara_exp.cu)
  kara_full(a, segments)          <- pallas.kara_full_run    (csrc/kara_full.cu)
  pow_static_fused(a, exponent)   <- pallas.pow_static_fused (csrc/pow_static.cu)
  pow_static_steps(a, exponent)   the same kernel's recording build, for the
                                  witness trace's chains (csrc/pow_static.cu)
  miller_run(f0, coeffs, py, px, skip, flags)
                                  <- pallas.miller_run, for any T >= 1 terms
                                                             (csrc/miller.cu)
  miller_fused(f0, rx, ry, rz, qx, qy, py, px, skip, flags)
                                  <- models/pairing_rns.py miller_loop_fused,
                                     XLA fusions in the JAX package
                                                             (csrc/miller.cu)
  prepare_g2_lines(rx, ry, rz, qx, qy, is_add)
                                  <- models/pairing_rns.py prepare_g2_stepmajor,
                                     XLA fusions in the JAX package
                                                             (csrc/miller.cu)
  fq12_mul, fq12_square, fq12_mul_by_014, fq12_mul_by_014_square,
  fq12_cyclotomic_square          <- pallas.fused_op over the tower formulas
                                     (csrc/tower_ops.cu)

Each wrapper runs its plain version for a tensor on the CPU and launches its
kernel for a tensor on a CUDA device; there is no fallback between the two.
`launches` counts kernel launches per wrapper. The plain versions call the
plain tower formulas (tower.<op>_plain), never the dispatching ones, so a
plain run on a card launches none of these kernels.

The kernels are built at first use and bound by ops/cuda_build.py, which the
limb tier's kernels (ops/kernels/) share.
"""

from __future__ import annotations

import math

import torch

from .. import cuda_build
# the shared build and binding under the names this module has always had
from ..cuda_build import build, build_log  # noqa: F401
from ..cuda_build import call as _call
from ..cuda_build import check as _check
from ..cuda_build import row_view as _row_view  # noqa: F401
from ..cuda_build import rows as _rows
from . import fp, lines, tower

LANES = fp.LANES
_FQ2 = (2, LANES)

_PTR, _INT, _STRIDE = cuda_build.PTR, cuda_build.INT, cuda_build.STRIDE
#: kernel name -> (source, C entry point, its argument types). A tensor
#: operand with a row stride is (_PTR, _STRIDE); every entry ends in the
#: output pointer, the row count and the stream, but for the exponentiation
#: and pow kernels, which take (a, out, rows, int array, its length, stream;
#: kara_full a scratch buffer after out and two arrays, pow_static its steps
#: buffer or null after out), and the square runs, which take (a, out, rows,
#: n, stream).
_KERNELS = {
    "cyc_exp": ("cyc_exp.cu", "cyc_exp_launch",
                [_PTR, _PTR, _INT, _PTR, _INT, _PTR]),
    "cyc_exp_cond": ("cyc_exp.cu", "cyc_exp_cond_launch",
                     [_PTR, _PTR, _INT, _PTR, _INT, _PTR]),
    "cyc_square_run": ("cyc_exp.cu", "cyc_square_run_launch",
                       [_PTR, _PTR, _INT, _INT, _PTR]),
    "kara_square_run": ("kara_exp.cu", "kara_square_run_launch",
                        [_PTR, _PTR, _INT, _INT, _PTR]),
    "kara_exp": ("kara_exp.cu", "kara_exp_launch",
                 [_PTR, _PTR, _INT, _PTR, _INT, _PTR]),
    "kara_full": ("kara_full.cu", "kara_full_launch",
                  [_PTR, _PTR, _PTR, _INT, _PTR, _INT, _PTR, _INT, _PTR]),
    "pow_static": ("pow_static.cu", "pow_static_launch",
                   [_PTR, _PTR, _PTR, _INT, _PTR, _INT, _PTR]),
    "miller_run": ("miller.cu", "miller_run_launch",
                   [_PTR, _STRIDE, _PTR, _STRIDE, _STRIDE] + [_PTR, _STRIDE] * 3
                   + [_INT, _PTR, _INT, _PTR, _INT, _PTR]),
    "miller_fused": ("miller.cu", "miller_fused_launch",
                     [_PTR, _STRIDE] * 6 + [_PTR] * 4 + [_INT, _PTR, _INT, _PTR]),
    "prepare_g2_lines": ("miller.cu", "prepare_g2_lines_launch",
                         [_PTR, _STRIDE] * 5 + [_PTR, _INT, _PTR, _INT, _PTR]),
    "fq12_mul": ("tower_ops.cu", "fq12_mul_launch",
                 [_PTR, _STRIDE] * 2 + [_PTR, _INT, _PTR]),
    "fq12_square": ("tower_ops.cu", "fq12_square_launch",
                    [_PTR, _STRIDE, _PTR, _INT, _PTR]),
    "fq12_mul_by_014": ("tower_ops.cu", "fq12_mul_by_014_launch",
                        [_PTR, _STRIDE] * 4 + [_PTR, _INT, _PTR]),
    "fq12_mul_by_014_square": ("tower_ops.cu", "fq12_mul_by_014_square_launch",
                               [_PTR, _STRIDE] * 5 + [_PTR, _INT, _PTR]),
    "fq12_cyclotomic_square": ("tower_ops.cu", "fq12_cyclotomic_square_launch",
                               [_PTR, _STRIDE, _PTR, _INT, _PTR]),
}
#: Kernel launches per wrapper since the last reset_launches().
launches = {name: 0 for name in _KERNELS}
cuda_build.register(_KERNELS, launches)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def cyc_exp_plain(a: torch.Tensor, segments) -> torch.Tensor:
    """a^X for cyclotomic Fq12 a (..., 12, LANES), X given as MSB-first
    (n_squares, multiply_after) segments after its leading bit: Granger-Scott
    squarings and full products with the base."""
    acc = a
    for n_sq, mul_after in segments:
        for _ in range(n_sq):
            acc = tower.cyclotomic_square_plain(acc)
        if mul_after:
            acc = tower.mul_plain(acc, a)
    return acc


def _segments_to_flags(segments) -> tuple[int, ...]:
    """(n_squares, multiply_after) segments -> per-level multiply flags:
    level i is one squaring, then a multiply by the base iff flags[i]."""
    flags: list[int] = []
    for n_sq, mul_after in segments:
        flags.extend([0] * n_sq)
        if mul_after:
            flags[-1] = 1
    return tuple(flags)


def cyc_exp_cond_plain(a: torch.Tensor, segments) -> torch.Tensor:
    """cyc_exp_plain's value and rows from one loop over the exponent's
    levels: a squaring, then the product with the base where the level's
    flag is set."""
    acc = a
    for flag in _segments_to_flags(segments):
        acc = tower.cyclotomic_square_plain(acc)
        if flag:
            acc = tower.mul_plain(acc, a)
    return acc


def cyc_square_run_plain(a: torch.Tensor, n: int) -> torch.Tensor:
    """n Granger-Scott squarings of cyclotomic a (..., 12, LANES)."""
    for _ in range(n):
        a = tower.cyclotomic_square_plain(a)
    return a


def kara_square_run_plain(c: torch.Tensor, n: int) -> torch.Tensor:
    """n Karabina squarings of compressed c (..., 8, LANES)."""
    for _ in range(n):
        c = tower.compressed_square_plain(c)
    return c


def kara_exp_plain(c: torch.Tensor, segments) -> torch.Tensor:
    """The Karabina chain with snapshots: compressed c (..., 8, LANES) ->
    (len(segments), ..., 8, LANES), snapshot k the state after
    sum(segments[:k + 1]) squarings."""
    snaps = []
    for n in segments:
        c = kara_square_run_plain(c, n)
        snaps.append(c)
    return torch.stack(snaps)


#: Snapshots of kara_full: its product tree is written out for six.
KARA_FULL_SNAPSHOTS = 6


def kara_full_plain(a: torch.Tensor, segments) -> torch.Tensor:
    """a^|x| for cyclotomic a (..., 12, LANES), |x| = sum_k 2^(e_k) with
    e_k the running sums of the six `segments`: the Karabina chain, the
    decompression of the six snapshots and their product
    ((s0 s1)(s2 s3))(s4 s5).

    The steps of tower.decompress_cyclotomic in the order of the
    whole-exponentiation kernel: every norm is inverted by its own Fermat
    power (no product tree across rows), and the Karabina 1/4 is folded into
    the norm's inverse before it scales the conjugate, where
    decompress_cyclotomic scales the finished inverse: equal values, other
    rows."""
    snaps = kara_exp_plain(tower.compress_cyclotomic(a), segments)
    s1 = fp.redc_stack(tower._decompress_num_terms(snaps))
    num, den = tower._decompress_select(snaps, s1)
    norm = tower._fq2_norm(den)
    zero = fp.slot_lanes(fp.is_zero(norm))
    safe = torch.where(zero, fp.cst(("one",), norm), norm)
    ninv = torch.where(zero, torch.zeros_like(norm), fp.pow_static(safe, fp.P - 2))
    nq = fp.redc(fp.mul_rr(fp.wrap(ninv), tower.quarter(ninv)))
    dq = fp.redc_stack(tower._fq2_conj_scaled_terms(den, fp.wrap(nq)))
    g1s = fp.redc_stack(tower._decompress_g1_terms(num, dq))
    g0s = fp.redc_stack(tower._decompress_g0_terms(snaps, g1s))
    fulls = tower._decompress_assemble(snaps, g0s, g1s)
    p = tower.mul_plain(fulls[0::2], fulls[1::2])
    return tower.mul_plain(tower.mul_plain(p[0], p[1]), p[2])


# The plain version of pow_static_fused is fp.pow_static; those of the tower
# kernels are tower.mul_plain, square_plain, mul_by_014_plain,
# mul_by_014_square_plain and cyclotomic_square_plain.


def _as_terms(x) -> list:
    """One term's tensor, or a list of the terms' tensors, as a list."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def miller_run_plain(f0: torch.Tensor, coeffs_stepmajor, py, px, skip,
                     do_square_flags) -> torch.Tensor:
    """The Miller accumulation over step-major raw line triples of T terms
    (each argument but f0 one term's tensor or a list of T): per step and
    term the coefficient scaling (c0*P.y, c1*P.x, one 4-row REDC), the sparse
    product with the identity-select on the term's skip mask, then the square
    where the step's flag is set."""
    terms = list(zip(*(_as_terms(x) for x in (coeffs_stepmajor, py, px, skip))))
    scales = [(fp.wrap(y[..., None, :]), fp.wrap(x[..., None, :])) for _, y, x, _ in terms]
    f = f0
    for j, sq in enumerate(do_square_flags):
        for (coeffs, _, _, sk), (pyw, pxw) in zip(terms, scales):
            triple = coeffs[j]
            sc = fp.redc_cat(lines.scale_terms(triple[..., 0, :, :], triple[..., 1, :, :],
                                               pyw, pxw))
            g = tower.mul_by_014_plain(f, triple[..., 2, :, :], sc[..., 2:4, :],
                                       sc[..., 0:2, :])
            f = tower.select(sk, f, g)
        if sq:
            f = tower.square_plain(f)
    return f


def miller_fused_plain(f0: torch.Tensor, rx, ry, rz, qx, qy, py, px, skip,
                       step_flags) -> torch.Tensor:
    """The single-term Miller loop with the G2 preparation fused in, from the
    accumulator f0 and the point R = (rx, ry, rz) (Q = (qx, qy)): per step
    the line step, doubling or (flag bit 1) addition, with the ell scaling by
    P.y and P.x riding its last REDC, the sparse product with the
    identity-select on skip, and (flag bit 0) the square."""
    r = lines.G2Projective(rx, ry, rz)
    q = lines.G2Affine(qx, qy, None)
    scale = (fp.wrap(py[..., None, :]), fp.wrap(px[..., None, :]))
    f = f0
    for flag in step_flags:
        if flag & 2:
            r, (sc0, sc1, c2) = lines.addition_step(r, q, scale=scale)
        else:
            r, (sc0, sc1, c2) = lines.doubling_step(r, scale=scale)
        f = tower.select(skip, f, tower.mul_by_014_plain(f, c2, sc1, sc0))
        if flag & 1:
            f = tower.square_plain(f)
    return f


def prepare_g2_lines_plain(rx, ry, rz, qx, qy, is_add) -> torch.Tensor:
    """The raw line triples (steps, ..., 3, 2, LANES) of the schedule from
    R = (rx, ry, rz), Q = (qx, qy): per step a doubling or (is_add) an
    addition step."""
    r = lines.G2Projective(rx, ry, rz)
    q = lines.G2Affine(qx, qy, None)
    triples = []
    for add in is_add:
        r, cs = lines.addition_step(r, q) if add else lines.doubling_step(r)
        triples.append(torch.stack(cs, dim=-3))
    return torch.stack(triples)


# ---------------------------------------------------------------------------
# Launch helpers
# ---------------------------------------------------------------------------

_ARGS: dict = {}


def _int_arg(key, values, device: torch.device) -> torch.Tensor:
    """A small int32 argument array on the device, made once per key."""
    k = (key, device)
    if k not in _ARGS:
        _ARGS[k] = torch.tensor(values, dtype=torch.int32, device=device)
    return _ARGS[k]


def _launch(name: str, a: torch.Tensor, rows: int, arg: torch.Tensor,
            n_arg: int) -> torch.Tensor:
    out = torch.empty_like(a)
    _call(name, a.device, a.data_ptr(), out.data_ptr(), rows, arg.data_ptr(), n_arg)
    return out


def _tower_op(name: str, a: torch.Tensor, operands=(), skip=None) -> torch.Tensor:
    """Launch one tower-op kernel: `a` and the (tensor, tail) operands share
    their (broadcast) batch axes, which are flattened into rows; the output
    is (batch..., 12, LANES)."""
    ops = [(a, (12, LANES)), *operands]
    if skip is not None:
        ops.append((skip, (LANES,)))
    batch = torch.broadcast_shapes(*(t.shape[:t.dim() - len(tail)] for t, tail in ops))
    out = torch.empty((*batch, 12, LANES), dtype=torch.int32, device=a.device)
    views, args = [], []
    for t, tail in ops:
        if t.device != a.device:
            raise ValueError(f"operands on {a.device} and {t.device}")
        v, stride = _rows(t, batch, tail)
        views.append(v)  # alive until the launch is enqueued
        args += [v.data_ptr(), stride]
    if name == "fq12_mul_by_014_square" and skip is None:
        args += [None, 0]
    _call(name, a.device, *args, out.data_ptr(), math.prod(batch))
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def cyc_exp(a: torch.Tensor, segments) -> torch.Tensor:
    """a^X for cyclotomic Fq12 rows a (..., 12, LANES) int32, X given as
    MSB-first (n_squares, multiply_after) segments after its leading bit."""
    segments = tuple((int(n), int(bool(m))) for n, m in segments)
    if a.device.type == "cpu":
        return cyc_exp_plain(a, segments)
    return _cyc_exp_kernel(a, segments)


def _cyc_exp_kernel(a: torch.Tensor, segments: tuple) -> torch.Tensor:
    """cyc_exp's launch, tiles of kernel_tables.TC_ROWS packed rows."""
    _check(a, (12, LANES))
    segs = _int_arg(("segs", segments), [v for s in segments for v in s], a.device)
    return _launch("cyc_exp", a, a.numel() // (12 * LANES), segs, len(segments))


def cyc_exp_cond(a: torch.Tensor, segments) -> torch.Tensor:
    """cyc_exp's a^X, row for row, as one loop over X's levels with the
    product under a per-level flag."""
    segments = tuple((int(n), int(bool(m))) for n, m in segments)
    if a.device.type == "cpu":
        return cyc_exp_cond_plain(a, segments)
    return _cyc_exp_cond_kernel(a, segments)


def _cyc_exp_cond_kernel(a: torch.Tensor, segments: tuple) -> torch.Tensor:
    """cyc_exp_cond's launch: cyc_exp's kernel walking one flag per level."""
    _check(a, (12, LANES))
    flags = _segments_to_flags(segments)
    arg = _int_arg(("levels", flags), flags or [0], a.device)
    return _launch("cyc_exp_cond", a, a.numel() // (12 * LANES), arg, len(flags))


def _square_run(name: str, plain, a: torch.Tensor, n: int, ncomp: int) -> torch.Tensor:
    n = int(n)
    if n < 0:
        raise ValueError("the number of squarings must be >= 0")
    if a.device.type == "cpu":
        return plain(a, n)
    return _square_run_kernel(name, a, n, ncomp)


def _square_run_kernel(name: str, a: torch.Tensor, n: int, ncomp: int) -> torch.Tensor:
    """A square run's launch on rows a (..., ncomp, LANES), on tiles of
    packed rows: cyc_square_run cyc_exp's kernel body walking one run,
    kara_square_run kara_exp's."""
    _check(a, (ncomp, LANES))
    out = torch.empty_like(a)
    _call(name, a.device, a.data_ptr(), out.data_ptr(), a.numel() // (ncomp * LANES), n)
    return out


def cyc_square_run(a: torch.Tensor, n: int) -> torch.Tensor:
    """n Granger-Scott squarings of cyclotomic Fq12 rows a (..., 12, LANES)
    int32, the state on chip for the run (cyc_exp's kernel on tiles of
    packed rows)."""
    return _square_run("cyc_square_run", cyc_square_run_plain, a, n, 12)


def kara_square_run(c: torch.Tensor, n: int) -> torch.Tensor:
    """n Karabina squarings of compressed rows c (..., 8, LANES) int32
    (tower.compressed_square), the state on chip for the run (kara_exp's
    kernel on tiles of packed rows)."""
    return _square_run("kara_square_run", kara_square_run_plain, c, n, 8)


def _chain_lengths(segments) -> tuple[int, ...]:
    segments = tuple(int(n) for n in segments)
    if not segments or min(segments) < 0:
        raise ValueError("expected one chain length >= 0 per snapshot")
    return segments


def kara_exp(c: torch.Tensor, segments) -> torch.Tensor:
    """The Karabina chain with snapshots: compressed rows c (..., 8, LANES)
    int32 -> (len(segments), ..., 8, LANES), snapshot k the state after
    sum(segments[:k + 1]) squarings."""
    segments = _chain_lengths(segments)
    if c.device.type == "cpu":
        return kara_exp_plain(c, segments)
    return _kara_exp_kernel(c, segments)


def _kara_exp_kernel(c: torch.Tensor, segments: tuple) -> torch.Tensor:
    """kara_exp's launch, tiles of packed rows; snapshot k of row r at
    out[k, r]."""
    _check(c, (8, LANES))
    out = torch.empty((len(segments), *c.shape), dtype=torch.int32, device=c.device)
    segs = _int_arg(("chain", segments), segments, c.device)
    _call("kara_exp", c.device, c.data_ptr(), out.data_ptr(), c.numel() // (8 * LANES),
          segs.data_ptr(), len(segments))
    return out


def kara_full(a: torch.Tensor, segments) -> torch.Tensor:
    """a^|x| for cyclotomic Fq12 rows a (..., 12, LANES) int32, |x| given by
    the six Karabina chain lengths: chain, decompression, the inversions and
    the snapshots' product in one kernel."""
    segments = _chain_lengths(segments)
    if len(segments) != KARA_FULL_SNAPSHOTS:
        raise ValueError(f"expected {KARA_FULL_SNAPSHOTS} chain lengths, "
                         f"got {len(segments)}")
    if a.device.type == "cpu":
        return kara_full_plain(a, segments)
    return _kara_full_kernel(a, segments)


#: int32 per lane and packed row of kara_full's scratch buffer: the six
#: snapshots' 8 components and the six inverses; packed rows per block
#: (csrc/kara_full.cu SCRATCH, TILE)
_KARA_FULL_SCRATCH = KARA_FULL_SNAPSHOTS * 8 + KARA_FULL_SNAPSHOTS
_KARA_FULL_TILE = 2


def _kara_full_kernel(a: torch.Tensor, segments: tuple) -> torch.Tensor:
    """kara_full's launch, tiles of _KARA_FULL_TILE packed rows; its scratch
    rows are padded to whole tiles."""
    _check(a, (12, LANES))
    out = torch.empty_like(a)
    rows = a.numel() // (12 * LANES)
    tile = _KARA_FULL_TILE
    scratch = torch.empty((-(-rows // tile) * tile, _KARA_FULL_SCRATCH, LANES),
                          dtype=torch.int32, device=a.device)
    segs = _int_arg(("chain", segments), segments, a.device)
    bits = fp.exponent_bits(fp.P - 2)
    _call("kara_full", a.device, a.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows,
          segs.data_ptr(), len(segments),
          _int_arg(("bits", fp.P - 2), bits, a.device).data_ptr(), len(bits))
    return out


def pow_static_fused(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent (exponent >= 1) for stored Fp rows a (..., LANES) int32,
    Montgomery in and out; 0 maps to 0."""
    if exponent < 1:
        raise ValueError("exponent must be >= 1")
    if a.device.type == "cpu":
        return fp.pow_static(a, exponent)
    return _pow_static_kernel(a, exponent)


def pow_static_steps(a: torch.Tensor, exponent: int) -> tuple[torch.Tensor, torch.Tensor]:
    """a^exponent (exponent >= 1) in the select form of a witness trace's
    chain, and its steps: (2 * nbits, *a.shape), the square and the product
    with a of each bit after the leading one (fp.pow_static_steps)."""
    if exponent < 1:
        raise ValueError("exponent must be >= 1")
    if a.device.type == "cpu":
        return fp.pow_static_steps(a, exponent)
    return _pow_static_kernel(a, exponent, record=True)


def _pow_static_kernel(a: torch.Tensor, exponent: int, record: bool = False):
    """pow_static_fused's launch, one warp per Fp element; with `record`, the
    recording build's, which also returns the steps."""
    _check(a, (LANES,))
    bits = fp.exponent_bits(exponent)
    arg = _int_arg(("bits", exponent), bits or [0], a.device)
    out = torch.empty_like(a)
    steps = (torch.empty((2 * len(bits), *a.shape), dtype=torch.int32, device=a.device)
             if record else None)
    _call("pow_static", a.device, a.data_ptr(), out.data_ptr(),
          None if steps is None else steps.data_ptr(), a.numel() // LANES, arg.data_ptr(),
          len(bits))
    return (out, steps) if record else out


def _row_operand(t: torch.Tensor, batch: tuple) -> torch.Tensor:
    """A (batch..., LANES) operand the Miller kernels read as contiguous
    (rows, LANES)."""
    _check(t, (LANES,))
    if tuple(t.shape[:-1]) != batch:
        raise ValueError(f"expected shape {(*batch, LANES)}, got {tuple(t.shape)}")
    return t


def miller_run(f0: torch.Tensor, coeffs_stepmajor, py, px, skip,
               do_square_flags) -> torch.Tensor:
    """The Miller accumulation of T >= 1 terms (one ell per term and line
    triple, a square after the steps whose flag is set) from the accumulator
    f0, in one launch for any T. coeffs_stepmajor, py, px, skip: one term's
    tensor each, or lists of T; coeffs (steps, batch..., 3, 2, LANES); py,
    px, skip (batch..., LANES); f0 (batch..., 12, LANES), any row stride; all
    int32. An operand's terms that are views of one buffer at a uniform
    pointer stride (the term slices of one prepare_g2_stepmajor output, or
    one tensor repeated) are read in place; others are stacked on the card
    first. The conjugation for a negative loop parameter is the caller's."""
    flags = tuple(int(bool(v)) for v in do_square_flags)
    terms = [_as_terms(x) for x in (coeffs_stepmajor, py, px, skip)]
    if len({len(x) for x in terms}) != 1 or not terms[0]:
        raise ValueError("one or more terms, each a coefficient tensor, P.y, P.x and "
                         "skip mask")
    if any(c.shape[0] != len(flags) for c in terms[0]):
        raise ValueError("one square flag per step")
    if f0.device.type == "cpu":
        return miller_run_plain(f0, *terms, flags)
    return _miller_run_kernel(f0, terms, flags)


def _term_operand(ts: list, shape: tuple, steps: bool) -> tuple[torch.Tensor, int, int]:
    """One operand's T tensors, each of `shape`, as miller_run's kernel reads
    them: a tensor to keep alive until the launch is enqueued, the step
    stride of the coefficients (steps: each term's tensor is dense but for
    its leading step axis; else it is dense) and the term stride, in int32
    elements. Tensors of one layout at a uniform pointer stride (0 included:
    one tensor repeated) are read in place; any others are stacked on the
    device first."""
    for t in ts:
        _check(t, shape, contiguous=False)
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
    first = ts[0]
    step = first.stride(0) if steps else 0
    dense = all((t[0] if steps and len(t) else t).is_contiguous()
                and (not steps or len(t) < 2 or t.stride(0) == step) for t in ts)
    gap = ts[1].data_ptr() - first.data_ptr() if len(ts) > 1 else 0
    if dense and gap % first.element_size() == 0 and all(
            t.data_ptr() == first.data_ptr() + i * gap for i, t in enumerate(ts)):
        return first, step, gap // first.element_size()
    st = torch.stack(ts)
    return st, st.stride(1) if steps else 0, st.stride(0)


def _miller_run_kernel(f0: torch.Tensor, terms: list, flags: tuple) -> torch.Tensor:
    """miller_run's launch: each operand of the terms goes to the kernel as
    one base pointer and its strides (_term_operand), so that nothing is
    copied to the card for them, a CUDA graph replays the launch as
    captured, and one launch takes any number of terms."""
    batch = tuple(terms[1][0].shape[:-1])
    coeffs, c_step, c_term = _term_operand(terms[0], (len(flags), *batch, 3, 2, LANES),
                                           steps=True)
    rows_ = [_term_operand(ts, (*batch, LANES), steps=False) for ts in terms[1:]]
    f0v, stride = _rows(f0, batch, (12, LANES))
    out = torch.empty((*batch, 12, LANES), dtype=torch.int32, device=f0.device)
    _call("miller_run", f0.device, f0v.data_ptr(), stride, coeffs.data_ptr(), c_step, c_term,
          *(v for t, _, term in rows_ for v in (t.data_ptr(), term)), len(terms[0]),
          _int_arg(("flags", flags), flags, f0.device).data_ptr(), len(flags),
          out.data_ptr(), math.prod(batch))
    return out


def _point_args(batch: tuple, *coords: torch.Tensor) -> tuple[list, list]:
    """Fq2 coordinates (batch..., 2, LANES) as (pointer, row stride) pairs,
    and the views to keep alive until the launch is enqueued."""
    views, args = [], []
    for t in coords:
        if tuple(t.shape[:-2]) != batch:
            raise ValueError(f"expected shape {(*batch, *_FQ2)}, got {tuple(t.shape)}")
        v, stride = _rows(t, batch, _FQ2)
        views.append(v)
        args += [v.data_ptr(), stride]
    return views, args


def miller_fused(f0: torch.Tensor, rx, ry, rz, qx, qy, py, px, skip,
                 step_flags) -> torch.Tensor:
    """The single-term Miller loop with the G2 preparation fused in
    (miller_fused_plain) in one kernel: R = (rx, ry, rz) and Q = (qx, qy)
    (batch..., 2, LANES), py, px, skip (batch..., LANES), f0 (batch..., 12,
    LANES), all int32; step_flags one int per step, bit 0 the square, bit 1
    an addition step. The conjugation for a negative loop parameter is the
    caller's."""
    flags = tuple(int(v) for v in step_flags)
    if f0.device.type == "cpu":
        return miller_fused_plain(f0, rx, ry, rz, qx, qy, py, px, skip, flags)
    return _miller_fused_kernel(f0, rx, ry, rz, qx, qy, py, px, skip, flags)


def _miller_fused_kernel(f0, rx, ry, rz, qx, qy, py, px, skip, flags) -> torch.Tensor:
    batch = tuple(py.shape[:-1])
    rows_ = [_row_operand(t, batch) for t in (py, px, skip)]
    views, pts = _point_args(batch, rx, ry, rz, qx, qy)  # noqa: F841 (kept alive)
    f0v, stride = _rows(f0, batch, (12, LANES))
    out = torch.empty((*batch, 12, LANES), dtype=torch.int32, device=f0.device)
    _call("miller_fused", f0.device, f0v.data_ptr(), stride, *pts,
          *(t.data_ptr() for t in rows_),
          _int_arg(("steps", flags), flags, f0.device).data_ptr(), len(flags),
          out.data_ptr(), math.prod(batch))
    return out


def prepare_g2_lines(rx, ry, rz, qx, qy, is_add) -> torch.Tensor:
    """The raw line triples (steps, batch..., 3, 2, LANES) of the schedule
    from R = (rx, ry, rz) and Q = (qx, qy), (batch..., 2, LANES) int32
    (prepare_g2_lines_plain) in one kernel; is_add one flag per step."""
    flags = tuple(int(bool(v)) for v in is_add)
    if rx.device.type == "cpu":
        return prepare_g2_lines_plain(rx, ry, rz, qx, qy, flags)
    return _prepare_g2_lines_kernel(rx, ry, rz, qx, qy, flags)


def _prepare_g2_lines_kernel(rx, ry, rz, qx, qy, flags) -> torch.Tensor:
    batch = tuple(rx.shape[:-2])
    views, pts = _point_args(batch, rx, ry, rz, qx, qy)  # noqa: F841 (kept alive)
    out = torch.empty((len(flags), *batch, 3, 2, LANES), dtype=torch.int32, device=rx.device)
    _call("prepare_g2_lines", rx.device, *pts,
          _int_arg(("is_add", flags), flags, rx.device).data_ptr(), len(flags),
          out.data_ptr(), math.prod(batch))
    return out


def fq12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b for Fq12 rows (..., 12, LANES) int32 (tower.mul)."""
    if a.device.type == "cpu":
        return tower.mul_plain(a, b)
    return _tower_op("fq12_mul", a, [(b, (12, LANES))])


def fq12_square(a: torch.Tensor) -> torch.Tensor:
    """a^2 (tower.square)."""
    if a.device.type == "cpu":
        return tower.square_plain(a)
    return _tower_op("fq12_square", a)


def fq12_cyclotomic_square(a: torch.Tensor) -> torch.Tensor:
    """a^2 for cyclotomic a (tower.cyclotomic_square)."""
    if a.device.type == "cpu":
        return tower.cyclotomic_square_plain(a)
    return _tower_op("fq12_cyclotomic_square", a)


def fq12_mul_by_014(a: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
                    d4: torch.Tensor) -> torch.Tensor:
    """a * ((d0 + d1 v) + (d4 v) w), d0/d1/d4 stored Fq2 (..., 2, LANES)
    (tower.mul_by_014)."""
    if a.device.type == "cpu":
        return tower.mul_by_014_plain(a, d0, d1, d4)
    return _tower_op("fq12_mul_by_014", a, [(d0, _FQ2), (d1, _FQ2), (d4, _FQ2)])


def fq12_mul_by_014_square(a: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
                           d4: torch.Tensor, skip=None) -> torch.Tensor:
    """square(select(skip, a, mul_by_014(a, d0, d1, d4))), skip a packed lane
    mask (..., LANES) or None (tower.mul_by_014_square)."""
    if a.device.type == "cpu":
        return tower.mul_by_014_square_plain(a, d0, d1, d4, skip)
    return _tower_op("fq12_mul_by_014_square", a,
                     [(d0, _FQ2), (d1, _FQ2), (d4, _FQ2)], skip)
