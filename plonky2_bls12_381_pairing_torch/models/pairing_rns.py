"""Batched BLS12-381 optimal-ate pairing on the RNS arithmetic tier (the JAX
package's models/pairing_rns.py).

  pairing(P, Q)                   the fused prepare+Miller loop (one
                                  kernel, kernels.miller_fused), then the
                                  final exponentiation;
  multi_pairing / pairing_check   the split form: prepare_g2_stepmajor of
                                  the T terms' G2 points stacked (one
                                  kernel, kernels.prepare_g2_lines), the
                                  Miller loop over the T terms' line
                                  coefficients (one kernel for any T,
                                  kernels.miller_run), one final
                                  exponentiation of the product.

Each loop's plain PyTorch form (prepare_g2_stepmajor_plain,
miller_loop_fused_plain; kernels.miller_run_plain for the split loop) gives
the same rows; only setup (a Q at infinity replaced by the generator,
G2Projective.from_affine) and the final conjugation stay outside the kernels.

The final exponentiation's five exponentiations by |BLS_X| run in the form
the `impl` keyword names (cyclotomic_exp; by default the whole-exponent
Granger-Scott kernel); its easy part, with the one Fq12 inverse, is the
easy-part kernels around the Fermat-pow kernel (kernels.easy_part); the
other Fq12 products and squarings of every path are the tower kernels
(ops/rns/kernels.py).

While utils/spans.py records, multi_pairing, final_exponentiation and
pairing_check mark their phases as spans: pairing.prepare_g2,
pairing.miller_loop, pairing.final_exp.easy, pairing.final_exp.hard (with the
five pairing.final_exp.cyc_exp inside it) and pairing.is_one.

Stored rows are bit-identical to the JAX package's for the same inputs where
the algorithm is the same: the Miller loop, the Granger-Scott exponentiation
(impl "segments", "cond", "runs": the JAX package's fused form) and the
Karabina exponentiation (impl "karabina", "karabina_runs": its default form).
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..ops.rns import fp, kernels, tower
from ..ops.rns.lines import (G1Affine, G2Affine, G2Projective, addition_step, doubling_step,
                             scale_terms)
from ..utils import spans
from .schedule import (_DO_SQUARE, _FUSED_FLAGS, _GS_SEGMENTS, _IS_ADD, _KARA_SEGMENTS,
                       _MILLER_RUNS, _X_SET_BITS, NUM_COEFFS)


# ---------------------------------------------------------------------------
# G2 preparation
# ---------------------------------------------------------------------------


def _g2_start(q: G2Affine) -> tuple[G2Affine, G2Projective]:
    """The line steps' inputs: Q with its infinity inputs replaced by the
    generator (masked out inside the Miller loop), and R = Q projective."""
    qs = G2Affine.generator_like(q).conditional_select(q.infinity, q)
    return qs, G2Projective.from_affine(qs)


def prepare_g2_stepmajor(q: G2Affine) -> torch.Tensor:
    """Line-coefficient tensor in step-major layout (68, ..., 3, 2, LANES),
    the layout the Miller loop reads step by step: the 68 line steps in one
    kernel on a card (kernels.prepare_g2_lines)."""
    qs, r = _g2_start(q)
    return kernels.prepare_g2_lines(r.x, r.y, r.z, qs.x, qs.y, _IS_ADD)


def prepare_g2_stepmajor_plain(q: G2Affine) -> torch.Tensor:
    """prepare_g2_stepmajor's rows in plain PyTorch on any device."""
    qs, r = _g2_start(q)
    out = kernels.prepare_g2_lines_plain(r.x, r.y, r.z, qs.x, qs.y, _IS_ADD)
    assert out.shape[0] == NUM_COEFFS
    return out


def prepare_g2(q: G2Affine) -> torch.Tensor:
    """Batch-major line-coefficient tensor (..., 68, 3, 2, LANES)."""
    return torch.movedim(prepare_g2_stepmajor(q), 0, -4)


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------


def _ell_scaled(f: torch.Tensor, triple: torch.Tensor, py: fp.R, px: fp.R,
                skip: torch.Tensor, square: bool = False) -> torch.Tensor:
    """One term's ell with the coefficient scaling done here (c0*P.y, c1*P.x
    in one 4-row REDC) and the identity-select for infinity terms: f is left
    unchanged where skip is set. With square=True the accumulator is squared
    afterwards, ell and square as one tower op.
    triple: (..., 3, 2, LANES) raw line triple; skip: packed lane mask."""
    sc = fp.redc_cat(scale_terms(triple[..., 0, :, :], triple[..., 1, :, :], py, px))
    # rows 0:2 = c0*P.y, rows 2:4 = c1*P.x
    d0, d1, d4 = triple[..., 2, :, :], sc[..., 2:4, :], sc[..., 0:2, :]
    if square:
        return tower.mul_by_014_square(f, d0, d1, d4, skip)
    return tower.select(skip, f, tower.mul_by_014(f, d0, d1, d4))


def miller_steps_raw(f: torch.Tensor, raw_list: list, pys: list, pxs: list,
                     skips: list) -> torch.Tensor:
    """The Miller accumulation over step-major RAW triples of T terms, scaling
    each step's coefficients inside the step (4 extra REDC rows per term
    instead of a scaled copy of the 68-step tensor). In a uniform step the
    last term's ell and the square are one tower op.

    No path calls it: it is the JAX package's form of the split loop, kept
    (with _ell_scaled and schedule._MILLER_RUNS) only as the reference that
    tests hold kernels.miller_run_plain and miller_loop to, on the CPU."""
    last = len(raw_list) - 1

    def step(f, j, square):
        for t in range(last + 1):
            f = _ell_scaled(f, raw_list[t][j], pys[t], pxs[t], skips[t],
                            square=square and t == last)
        return f

    j = 0
    for n_uniform, has_break in _MILLER_RUNS:
        for _ in range(n_uniform):
            f = step(f, j, True)
            j += 1
        if has_break:
            f = step(f, j, False)
            j += 1
    assert j == NUM_COEFFS
    return f


def miller_loop(ps, prepared_stepmajor, q_infinities=None) -> torch.Tensor:
    """Product of the Miller loops of T terms, in one accumulator.

    ps: G1Affine or list; prepared_stepmajor: matching (68, ..., 3, 2, LANES)
    tensors from prepare_g2_stepmajor; q_infinities: the G2 points' packed
    infinity masks (None: no G2 point at infinity). Returns f:
    (..., 12, LANES). The accumulation is kernels.miller_run (one kernel on a
    card for any number of terms, which reads coefficient tensors that are
    views of one buffer in place); its rows are those of miller_steps_raw."""
    if not isinstance(ps, (list, tuple)):
        ps = [ps]
        prepared_stepmajor = [prepared_stepmajor]
        q_infinities = [q_infinities]
    if q_infinities is None:
        q_infinities = [None] * len(ps)
    skips = []
    for p, qinf in zip(ps, q_infinities):
        inf = p.infinity != 0
        skips.append((inf if qinf is None else inf | (qinf != 0)).to(torch.int32))
    rows = ps[0].infinity.shape[:-1]  # infinity is a packed lane mask
    f = kernels.miller_run(tower.one(rows, ps[0].y.device), list(prepared_stepmajor),
                           [p.y for p in ps], [p.x for p in ps], skips, _DO_SQUARE)
    if C.BLS_X_IS_NEGATIVE:
        f = tower.conjugate(f)
    return f


def _fused_args(p: G1Affine, q: G2Affine) -> tuple:
    """The fused loop's operands: f = one, R and Q from _g2_start, P, the
    packed skip mask (an input at infinity) and the step flags."""
    qs, r = _g2_start(q)
    skip = ((p.infinity != 0) | (q.infinity != 0)).to(torch.int32)
    f0 = tower.one(p.infinity.shape[:-1], p.y.device)
    return f0, r.x, r.y, r.z, qs.x, qs.y, p.y, p.x, skip, _FUSED_FLAGS


def miller_loop_fused(p: G1Affine, q: G2Affine) -> torch.Tensor:
    """Single-term Miller loop with the G2 preparation fused into the
    accumulation: (R, f) run through the 68-step schedule together, so each
    line's coefficients are consumed the step they are produced, in one
    kernel on a card (kernels.miller_fused). The ell coefficient scaling
    rides the line steps' last stacked REDC. Infinity inputs are replaced by
    the generator for the line arithmetic and leave f unchanged
    (identity-select)."""
    f = kernels.miller_fused(*_fused_args(p, q))
    return tower.conjugate(f) if C.BLS_X_IS_NEGATIVE else f


def miller_loop_fused_plain(p: G1Affine, q: G2Affine) -> torch.Tensor:
    """miller_loop_fused's rows in plain PyTorch on any device."""
    f = kernels.miller_fused_plain(*_fused_args(p, q))
    return tower.conjugate(f) if C.BLS_X_IS_NEGATIVE else f


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


#: The forms of the exponentiation by |BLS_X|, each one the JAX package has.
EXP_IMPLS = ("segments", "cond", "runs", "karabina", "karabina_runs", "karabina_full")
#: The form every cyclotomic_exp takes while set, whatever impl its caller
#: passes (set_exp_form); None: the caller's.
_EXP_FORM = None


def set_exp_form(impl: str | None) -> str | None:
    """Make every cyclotomic_exp (and so final_exponentiation and pairing)
    take the form `impl` whatever impl is passed, or the caller's again for
    None; the previous setting. models/witness.py's trace sets "karabina"
    for its duration."""
    global _EXP_FORM
    if impl is not None and impl not in EXP_IMPLS:
        raise ValueError(f"impl must be one of {EXP_IMPLS} or None, got {impl!r}")
    prev, _EXP_FORM = _EXP_FORM, impl
    return prev


def _karabina_exp(f: torch.Tensor, chain) -> torch.Tensor:
    """f^|x| as the product of the snapshots f^(2^e_k) of a compressed
    squaring chain: `chain` maps the compressed element to the stacked
    snapshots, which are decompressed together (one shared inversion) and
    multiplied as a balanced tree of stacked products."""
    cur = tower.decompress_cyclotomic(chain(tower.compress_cyclotomic(f)))
    while cur.shape[0] > 1:
        h = cur.shape[0] // 2
        prod = tower.mul(cur[:h], cur[h:2 * h])
        cur = torch.cat([prod, cur[2 * h:]]) if cur.shape[0] % 2 else prod
    return cur[0]


def _kara_chain_runs(c: torch.Tensor) -> torch.Tensor:
    snaps = []
    for n in _KARA_SEGMENTS:
        if n:
            c = kernels.kara_square_run(c, n)
        snaps.append(c)
    return torch.stack(snaps)


def cyclotomic_exp(f: torch.Tensor, impl: str = "segments") -> torch.Tensor:
    """conj(f^|x|) = f^BLS_X (x < 0) for cyclotomic f, in the form `impl`:
      "segments"       one whole-exponent Granger-Scott square-and-multiply
                       (kernels.cyc_exp);
      "cond"           the same as one loop over the exponent's levels
                       (kernels.cyc_exp_cond);
      "runs"           one kernels.cyc_square_run per run of squarings, the
                       products with f between them;
      "karabina"       compressed squarings with snapshots (kernels.kara_exp),
                       one batched decompression, the snapshots' product tree;
      "karabina_runs"  the same with one kernels.kara_square_run per chain
                       segment;
      "karabina_full"  all of that in one kernel (kernels.kara_full).
    All give the same value; the first three the same rows, and "karabina"
    and "karabina_runs" the same rows. While set_exp_form has set a form,
    that form runs whatever impl is passed: a witness trace
    (models/witness.py) sets "karabina", the JAX package's traced form, whose
    decompressions' inversions are recorded rows."""
    if impl not in EXP_IMPLS:
        raise ValueError(f"impl must be one of {EXP_IMPLS}, got {impl!r}")
    if _EXP_FORM is not None:
        impl = _EXP_FORM
    if impl == "segments":
        out = kernels.cyc_exp(f, _GS_SEGMENTS)
    elif impl == "cond":
        out = kernels.cyc_exp_cond(f, _GS_SEGMENTS)
    elif impl == "runs":
        out = f
        for n, mul_after in _GS_SEGMENTS:
            out = kernels.cyc_square_run(out, n)
            if mul_after:
                out = tower.mul(out, f)
    elif impl == "karabina":
        out = _karabina_exp(f, lambda c: kernels.kara_exp(c, _KARA_SEGMENTS))
    elif impl == "karabina_runs":
        out = _karabina_exp(f, _kara_chain_runs)
    else:
        out = kernels.kara_full(f, _KARA_SEGMENTS)
    return tower.conjugate(out)


#: The hard part's five exponentiations as uniform steps y = exp(a * b * c)
#: (the JAX package's _EXP_STEPS). Flag columns: a_is_t2, a_is_t1pre (else
#: a = previous y), bc_t3_count (how many of b/c are t3, the rest are one).
_EXP_STEPS = (
    (1, 0, 0),  # t3 = exp(t2)
    (0, 1, 1),  # t1 = exp(t1pre * t3);     x -> t5
    (0, 0, 0),  # t0 = exp(t1)
    (0, 0, 0),  # t6 = exp(t0)
    (0, 0, 2),  # t4 = exp(t6 * t3 * t3);   x -> t6m
)


def final_exponentiation(f: torch.Tensor, impl: str = "segments") -> torch.Tensor:
    """Easy part + the zkcrypto hard-part chain (f^(3*(p^12-1)/r)), its five
    exponentiations in the form `impl` (cyclotomic_exp).

    The step loop keeps the JAX package's multiplies by one: each is a REDC
    that changes the stored representative, and keeping them keeps the rows
    identical."""
    with spans.span("pairing.final_exp.easy", f.device):
        t2 = _easy_part(f)
    with spans.span("pairing.final_exp.hard", f.device):
        return _hard_part(t2, impl)


def _easy_part(f: torch.Tensor) -> torch.Tensor:
    """f^((p^6 - 1)(p^2 + 1)), which is cyclotomic: the easy-part kernels on
    a card (kernels.easy_part); their plain version on the CPU and while a
    witness trace records, since the trace's rows are those of fp.inv's
    products and Fermat chain (kernels.easy_part_plain)."""
    if fp.recording():
        return kernels.easy_part_plain(f)
    return kernels.easy_part(f)


def _hard_part(t2: torch.Tensor, impl: str) -> torch.Tensor:
    """The hard part's chain on the cyclotomic t2."""
    t1pre = tower.conjugate(tower.cyclotomic_square(t2))
    one_b = tower.one(t2.shape[:-2], t2.device)

    y, t3 = one_b, one_b
    xs, ys = [], []
    for a_is_t2, a_is_t1pre, bc_t3 in _EXP_STEPS:
        a = t2 if a_is_t2 else (t1pre if a_is_t1pre else y)
        b = t3 if bc_t3 >= 1 else one_b
        c = t3 if bc_t3 >= 2 else one_b
        x = tower.mul(tower.mul(a, b), c)
        with spans.span("pairing.final_exp.cyc_exp", x.device):
            y = cyclotomic_exp(x, impl)
        if a_is_t2:  # t3 is the first step's output
            t3 = y
        xs.append(x)
        ys.append(y)
    t5, t6m = xs[1], xs[4]
    t1, t0, t4 = ys[1], ys[2], ys[4]

    # tail of the chain: four independent muls in one stacked call —
    #   A = conj(t5)*t2 (feeds t4), B = t1*t2 (-> frob^3),
    #   C = t6m*conj(t2) (-> frob^1), D = t3*t0 (-> frob^2)
    # — then the frobenius powers as a peeling stack ([B,C,D] -> [B,D] -> [B])
    m = tower.mul(torch.stack([tower.conjugate(t5), t1, t6m, t3]),
                  torch.stack([t2, t2, tower.conjugate(t2), t0]))
    t4 = tower.mul(t4, m[0])
    s1 = tower.frobenius_map(m[1:])          # [B, C, D] ^p
    t6 = s1[1]
    s2 = tower.frobenius_map(s1[0::2])       # [B, D] ^p^2 (a view: no index tensor)
    t3 = s2[1]
    t1 = tower.frobenius_map(s2[0])          # B ^p^3
    t3 = tower.mul(t3, t1)
    t3 = tower.mul(t3, t6)
    return tower.mul(t3, t4)


# ---------------------------------------------------------------------------
# Top-level API
# ---------------------------------------------------------------------------


def pairing(p: G1Affine, q: G2Affine, impl: str = "segments") -> torch.Tensor:
    """Batched full pairing e(P, Q) -> (rows, 12, LANES) Gt elements, on the
    device the points lie on (G1Affine.encode / G2Affine.encode choose it).
    `impl`: the form of the final exponentiation's powers (cyclotomic_exp)."""
    return final_exponentiation(miller_loop_fused(p, q), impl)


def op_counts(batch: int = 2048) -> dict:
    """Exact RNS Fp-op counts per pairing (fp_mul / redc), composed from the
    counts of each component (fp.count_fp_ops, at one packed row on the CPU)
    times its repetitions in the static schedule, as the JAX package's
    op_counts composes them. `batch` spreads the batched inverse's one
    Fermat power over the batch (fp.inv).

    One difference: the final exponentiation runs one cyclotomic square
    outside its five exponentiations (t1pre), and this counts one; the JAX
    package's op_counts counts two."""
    B = 2  # one packed row
    p = G1Affine.generator((B,), device="cpu")
    q = G2Affine.generator((B,), device="cpu")
    r = G2Projective.from_affine(q)
    f = tower.one((1,), "cpu")
    py, px = fp.wrap(p.y[..., None, :]), fp.wrap(p.x[..., None, :])
    sc2 = torch.zeros((1, 2, fp.LANES), dtype=torch.int32)

    def per(fn, *args):
        return {k: v / B for k, v in fp.count_fp_ops(fn, *args).items()}

    def add_to(total, part, k=1):
        for key, v in part.items():
            total[key] = total.get(key, 0) + k * v

    # the line steps carry the ell scaling in their last stacked REDC
    dbl = per(lambda rr: doubling_step(rr, scale=(py, px)), r)
    addc = per(lambda rr: addition_step(rr, q, scale=(py, px)), r)
    ell = per(tower.mul_by_014, f, sc2, sc2, sc2)
    sq = per(tower.square, f)
    cycsq = per(tower.cyclotomic_square, f)
    mul = per(tower.mul, f, f)
    frob = per(tower.frobenius_map, f)
    # tower.inv's one fp.inv is the product tree whose root Fermat power
    # serves the whole batch: the tower part is counted with fp.inv stubbed,
    # the tree added here (about 3 products and REDCs per element, and the
    # root's power steps over the tree floor's elements, spread over `batch`)
    orig_inv = fp.inv
    try:
        fp.inv = lambda a: a
        inv12 = per(tower.inv, f)
    finally:
        fp.inv = orig_inv
    e = fp.P - 2
    pow_steps = (e.bit_length() - 1) + bin(e).count("1") - 1
    root_elems = min(2 * fp._TREE_FLOOR, batch)
    tree_cost = 3 + pow_steps * root_elems / batch
    pow_counts = {"fp_mul": tree_cost, "redc": tree_cost}

    total: dict = {}
    add_to(total, dbl, 63)          # the doubling steps
    add_to(total, addc, 5)          # the addition steps
    add_to(total, ell, 68)          # the Miller loop's ells
    add_to(total, sq, 62)           # and its squares
    add_to(total, inv12)            # easy part: the Fq12 inverse...
    add_to(total, pow_counts)       # ...ending in the batched Fp inverse
    add_to(total, mul, 2)           # easy part products
    add_to(total, frob, 2)          # easy part frobenius^2
    # five Granger-Scott exponentiations by |x|: 63 cyclotomic squares and
    # 5 products each, and t1pre's one cyclotomic square
    add_to(total, cycsq, 1)
    add_to(total, cycsq, 5 * max(_X_SET_BITS))
    add_to(total, mul, 5 * (len(_X_SET_BITS) - 1))
    # the hard part's products: 5 steps of 2 (8 of them by one) and the
    # tail's 8
    add_to(total, mul, 18)
    add_to(total, frob, 6)          # the hard part's frobenius powers
    return total


def _stack_g2(qs: list) -> G2Affine:
    """The T terms' G2 points along a new leading axis (T, batch...)."""
    return G2Affine(*(torch.stack([getattr(q, k) for q in qs]) for k in ("x", "y", "infinity")))


def multi_pairing(ps: list, qs: list) -> torch.Tensor:
    """prod_t e(P_t, Q_t) per batch element: the T terms' Miller loops share
    one accumulator and one final exponentiation. The T G2 points are
    stacked along a new leading axis and prepared in one call, (68, T,
    batch..., 3, 2, LANES); the Miller loop takes each term's slice of that
    buffer, a view, so no coefficient is copied. A term's rows are those of
    its own preparation: the line steps work row by row."""
    dev = qs[0].x.device
    with spans.span("pairing.prepare_g2", dev):
        prepared = prepare_g2_stepmajor(_stack_g2(qs))
    with spans.span("pairing.miller_loop", dev):
        f = miller_loop(ps, list(prepared.unbind(1)), [q.infinity for q in qs])
    return final_exponentiation(f)


def pairing_check(ps: list, qs: list) -> torch.Tensor:
    """(rows, PACK) bools: prod_t e(P_t, Q_t) == 1 per packed element."""
    f = multi_pairing(ps, qs)
    with spans.span("pairing.is_one", f.device):
        return tower.is_one(f)
