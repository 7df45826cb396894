"""The batched BLS12-381 optimal-ate pairing on the limb tier, the counterpart
of the JAX package's models/pairing.py: G2 line precomputation (68 triples),
the fused multi-Miller loop, and the cyclotomic final exponentiation.

Everything batches over leading instance axes; the Miller accumulator is a
(B, 12, NLIMBS) limb tensor. The JAX package's scans, conds and switches over
the static schedule tables (_IS_ADD, _DO_SQUARE, BLS_X_BITS, _HP_PROG) are
Python loops over the same tables here: the order of operations, and so every
stored row, is unchanged. Line coefficients are pre-scaled by P.x / P.y for all
68 steps in one batched op, and infinity terms are replaced by
multiply-by-one triples, so the Miller body is pure mul_by_014 + square with
no per-step masking.

Which kernels run is fp.set_strategy's choice (ops/fp.py) and the tensors'
device; points are made with ops/curve.py's encode(..., device=).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import fp, fq2, fq12, lines
from ..ops.curve import G1Affine, G2Affine, G2Projective
from .schedule import _DO_SQUARE, _IS_ADD

NUM_COEFFS = C.NUM_LINE_COEFFS  # 68


# ---------------------------------------------------------------------------
# G2 preparation
# ---------------------------------------------------------------------------


def prepare_g2(q: G2Affine) -> torch.Tensor:
    """Line-coefficient tensor (..., 68, 3, 2, NLIMBS) for a batched G2 point.

    An infinity input is substituted with the generator; the pairing masks
    the output to 1 via the coefficient-scaling stage instead.
    """
    batch = q.infinity.shape
    q = G2Affine.generator(batch, q.infinity.device).conditional_select(q.infinity, q)
    r = G2Projective.from_affine(q)
    triples = []
    for is_add in _IS_ADD:
        if is_add:
            r, (c0, c1, c2) = lines.addition_step(r, q)
        else:
            r, (c0, c1, c2) = lines.doubling_step(r)
        triples.append(torch.stack([c0, c1, c2], dim=-3))
    coeffs = torch.stack(triples, dim=-4)  # (..., 68, 3, 2, L)
    assert coeffs.shape[-4] == NUM_COEFFS
    return coeffs


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------


def _scale_coeffs(p: G1Affine, q_infinity: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Scale all 68 line triples by the G1 point in one batched op (ell's
    c0*P.y, c1*P.x: four convolutions formed together), and substitute
    multiply-by-one triples for infinity terms so the Miller body needs no
    masking."""
    c0 = coeffs[..., 0, :, :]  # (..., 68, 2, L)
    c1 = coeffs[..., 1, :, :]
    c2 = coeffs[..., 2, :, :]
    py = p.y[..., None, :]  # broadcast over the 68 steps (a stride-0 view)
    px = p.x[..., None, :]
    c0s, c1s = fq2.mul_group(
        fq2.scale_fp_products(c0, py.expand(c0.shape[:-2] + (fp.NLIMBS,))),
        fq2.scale_fp_products(c1, px.expand(c1.shape[:-2] + (fp.NLIMBS,))))
    scaled = torch.stack([c0s, c1s, c2], dim=-3)  # (..., 68, 3, 2, L)
    # identity triple for mul_by_014(c2=one, c1=0, c0=0): ell multiplies by 1
    ident = torch.zeros_like(scaled)
    ident[..., 2, :, :] = fq2.one((), scaled.device)
    skip = ((p.infinity != 0) | (q_infinity != 0))[..., None, None, None, None]
    return torch.where(skip, ident, scaled)


def _ell(f: torch.Tensor, triple: torch.Tensor) -> torch.Tensor:
    """f * line, with pre-scaled coefficients: mul_by_014(c2, c1, c0)."""
    c0 = triple[..., 0, :, :]
    c1 = triple[..., 1, :, :]
    c2 = triple[..., 2, :, :]
    return fq12.mul_by_014(f, c2, c1, c0)


def scale_all_coeffs(ps, prepared, q_infinities=None):
    """Normalize term arguments and pre-scale all line coefficients by P."""
    if not isinstance(ps, (list, tuple)):
        ps = [ps]
        prepared = [prepared]
        q_infinities = [q_infinities]
    if q_infinities is None:
        q_infinities = [None] * len(ps)
    scaled = []
    for p, coeffs, qinf in zip(ps, prepared, q_infinities):
        if qinf is None:
            qinf = torch.zeros_like(p.infinity)
        scaled.append(_scale_coeffs(p, qinf, coeffs))
    return ps, scaled


def stack_steps(scaled: list) -> torch.Tensor:
    """Pre-scaled coefficient tensors (T of (..., 68, 3, 2, L)) -> per-step
    triples (68, T, ..., 3, 2, L)."""
    return torch.stack([torch.movedim(s, -4, 0) for s in scaled], dim=1)


def miller_steps(f: torch.Tensor, xs: torch.Tensor, do_square) -> torch.Tensor:
    """The Miller accumulation over pre-scaled triples.

    xs: (S, T, ..., 3, 2, L) from stack_steps (S = a contiguous slice of the
    68-step schedule); do_square: S flags from _DO_SQUARE. Per step: T ells,
    then a square where the flag is set.
    """
    for triples, flag in zip(xs, do_square):
        for t in range(xs.shape[1]):
            f = _ell(f, triples[t])
        if flag:
            f = fq12.square(f)
    return f


def miller_loop(ps, prepared, q_infinities=None) -> torch.Tensor:
    """Fused product of Miller loops over T terms, batched over leading axes.

    ps: G1Affine or list of T G1Affine; prepared: matching (..., 68, 3, 2, L)
    tensor(s) from prepare_g2. Returns f: (..., 12, NLIMBS). The final
    doubling triple's ell runs as the last step (its do_square flag is 0) and
    the negative-x conjugate follows.
    """
    ps, scaled = scale_all_coeffs(ps, prepared, q_infinities)
    batch = ps[0].infinity.shape
    f = fq12.one((), ps[0].infinity.device).expand(*batch, 12, fp.NLIMBS)
    f = miller_steps(f, stack_steps(scaled), _DO_SQUARE)
    if C.BLS_X_IS_NEGATIVE:
        f = fq12.conjugate(f)
    return f


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def cyclotomic_exp(f: torch.Tensor) -> torch.Tensor:
    """f^(-BLS_X) = conjugate(f^BLS_X): square-and-multiply over the static
    bit table, a multiply only on the 5 set bits."""
    acc = f
    for bit in C.BLS_X_BITS[1:]:  # MSB-first after the leading 1
        acc = fq12.cyclotomic_square(acc)
        if bit:
            acc = fq12.mul(acc, f)
    return fq12.conjugate(acc)


# The hard part of the final exponentiation runs as a tiny VM: a static
# instruction table (op, dst, src1, src2) over an 8-slot Fq12 register file.
_OP_MUL, _OP_CYCSQ, _OP_CONJ, _OP_FROB, _OP_MOV = range(5)


def _hard_part_program() -> np.ndarray:
    """zkcrypto hard-part addition chain as instructions over registers
    r0..r6 = t0..t6 (r2 holds the easy-part output), r7 scratch.
    Result lands in r3."""
    prog = []

    def emit(op, dst, s1, s2=0):
        prog.append((op, dst, s1, s2))

    def cyc_exp(dst, src):
        # dst = conjugate(src^BLS_X)
        assert dst != src
        emit(_OP_MOV, dst, src)
        for bit in C.BLS_X_BITS[1:]:
            emit(_OP_CYCSQ, dst, dst)
            if bit:
                emit(_OP_MUL, dst, dst, src)
        emit(_OP_CONJ, dst, dst)

    emit(_OP_CYCSQ, 1, 2)
    emit(_OP_CONJ, 1, 1)         # t1 = conj(t2^2)
    cyc_exp(3, 2)                # t3 = cyc_exp(t2)
    emit(_OP_CYCSQ, 4, 3)        # t4 = t3^2
    emit(_OP_MUL, 5, 1, 3)       # t5 = t1*t3
    cyc_exp(1, 5)                # t1 = cyc_exp(t5)
    cyc_exp(0, 1)                # t0 = cyc_exp(t1)
    cyc_exp(6, 0)                # t6 = cyc_exp(t0)
    emit(_OP_MUL, 6, 6, 4)       # t6 *= t4
    cyc_exp(4, 6)                # t4 = cyc_exp(t6)
    emit(_OP_CONJ, 5, 5)         # t5 = conj(t5)
    emit(_OP_MUL, 7, 5, 2)       # r7 = t5*t2
    emit(_OP_MUL, 4, 4, 7)       # t4 *= r7
    emit(_OP_CONJ, 5, 2)         # t5 = conj(t2)
    emit(_OP_MUL, 1, 1, 2)       # t1 *= t2
    emit(_OP_FROB, 1, 1)
    emit(_OP_FROB, 1, 1)
    emit(_OP_FROB, 1, 1)         # t1 = frob^3(t1)
    emit(_OP_MUL, 6, 6, 5)       # t6 *= t5
    emit(_OP_FROB, 6, 6)         # t6 = frob(t6)
    emit(_OP_MUL, 3, 3, 0)       # t3 *= t0
    emit(_OP_FROB, 3, 3)
    emit(_OP_FROB, 3, 3)         # t3 = frob^2(t3)
    emit(_OP_MUL, 3, 3, 1)       # t3 *= t1
    emit(_OP_MUL, 3, 3, 6)       # t3 *= t6
    emit(_OP_MUL, 3, 3, 4)       # t3 *= t4
    return np.asarray(prog, dtype=np.int32)


_HP_PROG = _hard_part_program()


def _run_fq12_program(prog: np.ndarray, init: torch.Tensor, out_reg: int,
                      n_regs: int = 8) -> torch.Tensor:
    """Execute an Fq12 instruction table over a register file seeded with
    `init` in every slot."""
    regs = [init] * n_regs
    for op, dst, s1, s2 in prog.tolist():
        x = regs[s1]
        if op == _OP_MUL:
            out = fq12.mul(x, regs[s2])
        elif op == _OP_CYCSQ:
            out = fq12.cyclotomic_square(x)
        elif op == _OP_CONJ:
            out = fq12.conjugate(x)
        elif op == _OP_FROB:
            out = fq12.frobenius_map(x)
        else:
            out = x
        regs[dst] = out
    return regs[out_reg]


def final_exponentiation(f: torch.Tensor) -> torch.Tensor:
    """Easy part + the zkcrypto hard-part chain, computing f^(3*(p^12-1)/r)
    (see utils/refmodel.py HARD_PART_MULTIPLE)."""
    t0 = fq12.conjugate(f)  # f^(p^6)
    t1 = fq12.inv(f)
    t2 = fq12.mul(t0, t1)
    t1 = t2
    t2 = fq12.frobenius_pow(t2, 2)
    t2 = fq12.mul(t2, t1)  # easy part done; t2 is cyclotomic
    return _run_fq12_program(_HP_PROG, t2, out_reg=3)


# ---------------------------------------------------------------------------
# Top-level pairing API
# ---------------------------------------------------------------------------


def pairing(p: G1Affine, q: G2Affine) -> torch.Tensor:
    """Batched full pairing e(P, Q): (..., 12, NLIMBS) Gt elements."""
    coeffs = prepare_g2(q)
    f = miller_loop(p, coeffs, q.infinity)
    return final_exponentiation(f)


def multi_pairing(ps: list, qs: list) -> torch.Tensor:
    """prod_i e(P_i, Q_i) with one fused Miller loop + one final exponentiation."""
    prepared = [prepare_g2(q) for q in qs]
    f = miller_loop(ps, prepared, [q.infinity for q in qs])
    return final_exponentiation(f)


def pairing_check(ps: list, qs: list) -> torch.Tensor:
    """True iff prod_i e(P_i, Q_i) == 1 (the BLS/KZG verification predicate)."""
    return fq12.is_one(multi_pairing(ps, qs))
