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
  fq12_frobenius                  <- tower.frobenius_map, XLA fusions in the
                                     JAX package (csrc/tower_ops.cu)
  easy_part(f)                    <- models/pairing_rns.py's easy part of the
                                     final exponentiation, XLA fusions and
                                     fp.inv's tree in the JAX package
                                     (csrc/easy_part.cu: easy_down, a
                                     tree_mul per level of the tree, the
                                     Fermat root pow_static, easy_up)
  g1_aggregate(keys, index, set_off, words, pieces, sets)
                                  new: FastAggregateVerify's key sums, one
                                     projective G1 point per signature set
                                     (csrc/g1_aggregate.cu: g1_sum per piece
                                     of a set's bits, g1_combine per set)
  inv_nonzero(a)                  fp.inv's tree on rows with no zero
                                     (csrc/easy_part.cu's tree_mul and
                                     csrc/pow_static.cu)

Each wrapper runs its plain version for a tensor on the CPU and launches its
kernel for a tensor on a CUDA device; there is no fallback between the two.
`launches` counts kernel launches per wrapper. The plain versions call the
plain tower formulas (tower.<op>_plain), never the dispatching ones, so a
plain run on a card launches none of these kernels, but for easy_part_plain's
Fp inverse: fp.inv's Fermat root, pow_static_fused.

The kernels are built at first use and bound by ops/cuda_build.py, which the
limb tier's kernels (ops/kernels/) share.
"""

from __future__ import annotations

import math

import torch

from ... import rns_constants as RC
from .. import cuda_build
# the shared build and binding under the names this module has always had
from ..cuda_build import build, build_log  # noqa: F401
from ..cuda_build import call as _call
from ..cuda_build import check as _check
from ..cuda_build import row_view as _row_view  # noqa: F401
from ..cuda_build import rows as _rows
from . import fp, g1, lines, tower

LANES = fp.LANES
_FQ2 = (2, LANES)

_PTR, _INT, _STRIDE = cuda_build.PTR, cuda_build.INT, cuda_build.STRIDE
#: kernel name -> (source, C entry point, its argument types). A tensor
#: operand with a row stride is (_PTR, _STRIDE); every entry ends in the
#: output pointer, the row count and the stream, but for the exponentiation
#: and pow kernels, which take (a, out, rows, int array, its length, stream;
#: kara_full a scratch buffer after out and two arrays, pow_static its steps
#: buffer or null after out), the square runs, which take (a, out, rows,
#: n, stream), and easy_down, which writes two outputs.
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
    "fq12_frobenius": ("tower_ops.cu", "fq12_frobenius_launch",
                       [_PTR, _STRIDE, _PTR, _INT, _PTR]),
    "easy_down": ("easy_part.cu", "easy_down_launch", [_PTR, _STRIDE, _PTR, _PTR, _INT, _PTR]),
    "tree_mul": ("easy_part.cu", "tree_mul_launch",
                 [_PTR, _INT, _PTR, _INT, _INT, _PTR, _INT, _PTR]),
    "easy_up": ("easy_part.cu", "easy_up_launch",
                [_PTR, _STRIDE, _PTR, _PTR, _PTR, _INT, _PTR]),
    "g1_sum": ("g1_aggregate.cu", "g1_sum_launch", [_PTR] * 5 + [_INT, _PTR, _PTR]),
    "g1_combine": ("g1_aggregate.cu", "g1_combine_launch", [_PTR, _PTR, _INT, _PTR, _PTR]),
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


def easy_part_plain(f: torch.Tensor) -> torch.Tensor:
    """The final exponentiation's easy part f^((p^6 - 1)(p^2 + 1)) of Fq12
    rows f (..., 12, LANES), which is cyclotomic: frob^2(t) t with t =
    conj(f) inv(f), the plain tower formulas. tower.inv's Fp inverse is
    fp.inv, whose product tree hands its root to pow_static_fused and which,
    while a witness trace records, records its rows."""
    t = tower.mul_plain(tower.conjugate(f), tower.inv(f))
    return tower.mul_plain(tower.frobenius_map_plain(tower.frobenius_map_plain(t)), t)


def _packed(t: torch.Tensor, width: int = LANES) -> torch.Tensor:
    """(n, ...) elements -> (ceil(n / 2), width) packed rows (width LANES for
    slots (n, SUB), PACK for (n,) flags), an odd tail's empty slot filled
    with the last element."""
    if t.shape[0] % RC.PACK:
        t = torch.cat([t, t[-1:]])
    return t.reshape(-1, width)


def _slots(t: torch.Tensor, n: int) -> torch.Tensor:
    """_packed's inverse: the first n slots, (n, SUB)."""
    return t.reshape(-1, RC.SUB)[:n]


def _where(mask: torch.Tensor, a: g1.G1Projective, b: g1.G1Projective) -> g1.G1Projective:
    """a where the (n,) bools mask are set, b elsewhere, for points in
    _packed's rows."""
    m = fp.slot_lanes(_packed(mask, RC.PACK))
    return g1.G1Projective(*(torch.where(m, x, y) for x, y in
                             ((a.x, b.x), (a.y, b.y), (a.z, b.z))))


def g1_sum_plain(keys, index, set_off, words, pieces) -> torch.Tensor:
    """g1_sum's partial sums (n_pieces, 3, SUB) with the plain formulas, all
    pieces at once: per step i, each piece's bit bit0 + i of its set (word
    word + (bit0 + i) / 32, bit (bit0 + i) % 32) picks the key keys[index[
    set_off[set] + bit0 + i]], which Algorithm 8 (g1.madd) adds where the bit
    is set and the step is inside the piece."""
    n = pieces.shape[0]
    pc = pieces.long()
    base = torch.where(pc[:, 3] > 0, set_off.long()[pc[:, 0]], 0)
    acc = g1.G1Projective.identity((n,), keys.device)
    for i in range(int(pc[:, 3].max()) if n else 0):
        pos = pc[:, 2] + i
        live = i < pc[:, 3]
        w = words[torch.where(live, pc[:, 1] + pos // 32, 0)].long()
        bit = live & (((w >> (pos % 32)) & 1) != 0)
        key = keys[index[torch.where(bit, base + pos, 0)].long()]
        acc = _where(bit, g1.madd(acc, _packed(key[:, 0]), _packed(key[:, 1])), acc)
    return torch.stack([_slots(c, n) for c in (acc.x, acc.y, acc.z)], dim=1)


def g1_combine_plain(partial: torch.Tensor, sets: torch.Tensor) -> torch.Tensor:
    """g1_combine's sums (3, n_sets, SUB) with the plain formulas: each set's
    pieces' partial sums (sets: first piece, count) added in order by
    Algorithm 7 (g1.add), all sets at once."""
    n = sets.shape[0]
    first, count = sets[:, 0].long(), sets[:, 1].long()

    def pick(rows: torch.Tensor) -> g1.G1Projective:
        v = partial[rows]
        return g1.G1Projective(*(_packed(v[:, k]) for k in range(3)))

    acc = _where(count > 0, pick(first), g1.G1Projective.identity((n,), partial.device))
    for j in range(1, int(count.max()) if n else 0):
        live = j < count
        acc = _where(live, g1.add(acc, pick(torch.where(live, first + j, 0))), acc)
    return torch.stack([_slots(c, n) for c in (acc.x, acc.y, acc.z)])


def g1_aggregate_plain(keys, index, set_off, words, pieces, sets) -> torch.Tensor:
    """g1_aggregate with the plain formulas: g1_sum_plain, g1_combine_plain."""
    return g1_combine_plain(g1_sum_plain(keys, index, set_off, words, pieces), sets)


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


def easy_part(f: torch.Tensor) -> torch.Tensor:
    """The final exponentiation's easy part of Fq12 rows f (..., 12, LANES)
    int32, any row stride (easy_part_plain): easy_down, the levels of
    fp.inv's product tree (tree_mul) around its Fermat root (pow_static) and
    easy_up."""
    if f.device.type == "cpu":
        return easy_part_plain(f)
    return _easy_part_kernel(f)


#: int32 per lane and packed row that easy_down leaves for easy_up
#: (csrc/easy_part.cu MID)
_EASY_MID = 9


def _easy_part_kernel(f: torch.Tensor) -> torch.Tensor:
    """easy_part's launches: easy_down writes each row's Fp norm (one where
    it is zero), which the tree inverts, and what easy_up reads besides f
    and that inverse."""
    batch = tuple(f.shape[:-2])
    fv, stride = _rows(f, batch, (12, LANES))
    rows = math.prod(batch)
    mid = torch.empty((rows, _EASY_MID, LANES), dtype=torch.int32, device=f.device)
    nrm = torch.empty((rows, LANES), dtype=torch.int32, device=f.device)
    _call("easy_down", f.device, fv.data_ptr(), stride, mid.data_ptr(), nrm.data_ptr(), rows)
    w = _tree_inv(nrm)
    out = torch.empty((*batch, 12, LANES), dtype=torch.int32, device=f.device)
    _call("easy_up", f.device, fv.data_ptr(), stride, mid.data_ptr(), w.data_ptr(),
          out.data_ptr(), rows)
    return out


def _tree_inv(n: torch.Tensor) -> torch.Tensor:
    """The inverses of the rows n (rows, LANES), none zero, by fp.inv's
    product tree with its row pairs: padded with one to a power of two, the
    levels up to fp._TREE_FLOOR rows, the Fermat root, and back down; a
    tree_mul launch per level (the padding read, never written)."""
    rows = n.shape[0]
    size = 1 << max(rows - 1, 0).bit_length()
    levels, cur, cur_rows = [], n, rows
    while size > fp._TREE_FLOOR:
        size //= 2
        nxt = torch.empty((size, LANES), dtype=torch.int32, device=n.device)
        _call("tree_mul", n.device, cur.data_ptr(), -1, cur.data_ptr(), size, cur_rows,
              nxt.data_ptr(), size)
        levels.append((cur, cur_rows, size))
        cur, cur_rows = nxt, size
    invc = pow_static_fused(cur, fp.P - 2)
    for level, level_rows, h in reversed(levels):
        out = torch.empty((level_rows, LANES), dtype=torch.int32, device=n.device)
        _call("tree_mul", n.device, invc.data_ptr(), h - 1, level.data_ptr(), h, level_rows,
              out.data_ptr(), level_rows)
        invc = out
    return invc


def g1_aggregate(keys, index, set_off, words, pieces, sets) -> torch.Tensor:
    """The sums of signature sets' public keys, (3, n_sets, SUB): X, Y, Z of
    set j at [:, j], each an element's slot, so that [k] viewed as
    (n_sets / 2, LANES) is the sets' packed rows. keys: (n, 2, SUB), key i's
    x and y slots (fp.encode_slots); index: (L,) positions into keys; set_off:
    (n_sets,) each set's first position in index; words: the sets' bit words
    (32 bits to a word, bit i of a word at 1 << i); pieces: (n_pieces, 4) runs
    of a set's bits (set, its first word in words, its first bit in the set,
    its bits); sets: (n_sets, 2) each set's first piece and its count of
    pieces, in order; all int32. A set's sum is its pieces' partial sums
    added in order, each piece's from the point at infinity, bit by bit."""
    if keys.device.type == "cpu":
        return g1_aggregate_plain(keys, index, set_off, words, pieces, sets)
    return _g1_aggregate_kernel(keys, index, set_off, words, pieces, sets)


def _g1_aggregate_kernel(keys, index, set_off, words, pieces, sets) -> torch.Tensor:
    """g1_aggregate's two launches: g1_sum into a partial sum per piece, then
    g1_combine."""
    _check(keys, (2, RC.SUB))
    for t in (index, set_off, words):
        _check(t, ())
    _check(pieces, (4,))
    _check(sets, (2,))
    n_pieces, n_sets = pieces.shape[0], sets.shape[0]
    partial = torch.empty((n_pieces, 3, RC.SUB), dtype=torch.int32, device=keys.device)
    _call("g1_sum", keys.device, keys.data_ptr(), index.data_ptr(), set_off.data_ptr(),
          words.data_ptr(), pieces.data_ptr(), n_pieces, partial.data_ptr())
    out = torch.empty((3, n_sets, RC.SUB), dtype=torch.int32, device=keys.device)
    _call("g1_combine", keys.device, partial.data_ptr(), sets.data_ptr(), n_sets,
          out.data_ptr())
    return out


def inv_nonzero(a: torch.Tensor) -> torch.Tensor:
    """The inverses of stored Fp rows a (..., LANES), none of them zero:
    fp.inv's product tree, on a card by its tree_mul and pow_static kernels
    (_tree_inv), on the CPU by fp.inv; the same rows."""
    if a.device.type == "cpu":
        return fp.inv(a)
    return _tree_inv(a.reshape(-1, LANES).contiguous()).reshape(a.shape)


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


def fq12_frobenius(a: torch.Tensor) -> torch.Tensor:
    """a^p (tower.frobenius_map)."""
    if a.device.type == "cpu":
        return tower.frobenius_map_plain(a)
    return _tower_op("fq12_frobenius", a)


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
