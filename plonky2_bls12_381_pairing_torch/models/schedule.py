"""Static schedule tables of the 68-triple Miller loop and of the
exponentiation by |BLS_X| (the JAX package's models/pairing.py:32-81 and the
schedule helpers of models/pairing_rns.py).

Three independent derivations of the same schedule are cross-checked here
at import: the iteration-level segmentation (_SEGMENTS), the per-triple flag
tables (_IS_ADD/_DO_SQUARE), and the grouped form that the fused Miller loop
runs (_FUSED_RUNS/_FUSED_TAIL). _MILLER_RUNS groups the same flags for the
split Miller loop."""

from __future__ import annotations

import numpy as np

from .. import constants as C

NUM_COEFFS = C.NUM_LINE_COEFFS  # 68


def _miller_segments():
    """Iteration-level segmentation of the 62-iteration schedule:
    (n_doubling_only_iters, has_add) with sum(n) == 62 and 5 adds."""
    segs = []
    run = 0
    for b in C.MILLER_BITS:
        run += 1
        if b:
            segs.append((run, True))
            run = 0
    if run:
        segs.append((run, False))
    assert sum(s[0] for s in segs) == 62 and sum(s[1] for s in segs) == 5
    return segs


_SEGMENTS = _miller_segments()


def _step_flags():
    """Per-triple tables over the 68 line triples (62 dbl + 5 add + 1 final
    dbl): is_add[j] — triple j comes from an addition step; do_square[j] —
    square the accumulator after the ell of triple j (62 squares: the dbl
    triple of an add-carrying iteration and the final doubling triple are
    not followed by a square)."""
    is_add, do_square = [], []
    for b in C.MILLER_BITS:
        is_add.append(0)
        if b:
            do_square.append(0)
            is_add.append(1)
            do_square.append(1)
        else:
            do_square.append(1)
    is_add.append(0)
    do_square.append(0)
    a = np.array(is_add, dtype=np.int32)
    s = np.array(do_square, dtype=np.int32)
    assert len(a) == NUM_COEFFS and a.sum() == 5 and s.sum() == 62
    return a, s


_IS_ADD, _DO_SQUARE = _step_flags()


def _schedule_runs():
    """Runs of doubling steps separated by the 5 addition steps, checked
    against the iteration-level segmentation."""
    runs = []  # (n_doubling_steps, has_addition_after)
    n = 0
    for is_add in _IS_ADD:
        if is_add:
            runs.append((n, True))
            n = 0
        else:
            n += 1
    if n:
        runs.append((n, False))
    assert sum(r[0] for r in runs) + sum(r[1] for r in runs) == NUM_COEFFS
    # add-segments agree one-to-one, and the trailing doubling run differs by
    # exactly the final extra triple
    assert [r for r in runs if r[1]] == [s for s in _SEGMENTS if s[1]]
    assert runs[-1] == (_SEGMENTS[-1][0] + 1, False) or (
        _SEGMENTS[-1][1] and runs[-1] == (1, False))
    return runs


_RUNS = _schedule_runs()


def _fused_groups():
    """Grouped schedule of the fused Miller loop: 5 x (uniform run,
    pre-addition doubling, addition) + a tail run + the final doubling.
    Returns (run_lens[5], tail_len)."""
    runs, pending = [], 0
    for j in range(NUM_COEFFS):
        if _IS_ADD[j]:
            # each addition must be immediately preceded by exactly one
            # squareless (pre-addition) doubling triple
            assert j > 0 and not _IS_ADD[j - 1] and not _DO_SQUARE[j - 1], (
                "addition step not preceded by a squareless doubling")
            runs.append(pending)
            pending = 0
        elif _DO_SQUARE[j]:
            pending += 1
    # the only triples outside uniform runs/additions are the 5 pre-addition
    # doublings and the final doubling, which must be last and squareless
    assert not _IS_ADD[-1] and not _DO_SQUARE[-1], (
        "schedule must end in the squareless final doubling")
    assert len(runs) == 5 and sum(runs) + pending == NUM_COEFFS - 11
    return runs, pending


_FUSED_RUNS, _FUSED_TAIL = _fused_groups()


def _fused_step_flags():
    """The fused loop's grouped schedule as one flag per step, the form the
    miller_fused kernel reads: bit 0 a square after the ell, bit 1 an
    addition step (else a doubling step). Checked against the per-triple
    tables."""
    flags = []
    for n in _FUSED_RUNS:
        # the uniform run, the squareless pre-addition doubling, the addition
        flags += [1] * n + [0, 3]
    flags += [1] * _FUSED_TAIL + [0]  # the tail run and the final doubling
    assert flags == [int(sq) | int(add) << 1 for sq, add in zip(_DO_SQUARE, _IS_ADD)]
    return tuple(flags)


_FUSED_FLAGS = _fused_step_flags()


def _miller_runs():
    """Runs of uniform ell+square steps of the split Miller loop, broken at
    the 6 squareless triples (the 5 pre-addition doubling triples and the
    final doubling; _DO_SQUARE)."""
    runs = []  # (n_uniform_steps, has_squareless_step_after)
    n = 0
    for sq in _DO_SQUARE:
        if sq:
            n += 1
        else:
            runs.append((n, True))
            n = 0
    if n:
        runs.append((n, False))
    assert sum(r[0] for r in runs) + sum(r[1] for r in runs) == NUM_COEFFS
    return runs


_MILLER_RUNS = _miller_runs()

#: Set-bit positions of |BLS_X|, ascending (6 bits incl. the leading one).
_X_SET_BITS = [i for i in range(C.BLS_X.bit_length()) if (C.BLS_X >> i) & 1]

#: MSB-first square-and-multiply segments of |BLS_X| for the whole-exponent
#: Granger-Scott exponentiation: (n_squares, multiply_after) after the
#: leading bit.
_GS_SEGMENTS = tuple(
    [(prev - cur, True) for prev, cur in
     zip(sorted(_X_SET_BITS, reverse=True), sorted(_X_SET_BITS, reverse=True)[1:])]
    + [(min(_X_SET_BITS), False)])
assert sum(n for n, _ in _GS_SEGMENTS) == C.BLS_X.bit_length() - 1

#: Chain lengths of the Karabina exponentiation: compressed squarings between
#: the ascending set bits of |BLS_X|; the state after each run is the
#: snapshot f^(2^e_k), and f^|x| is the product of the snapshots.
_KARA_SEGMENTS = tuple(e - l for e, l in zip(_X_SET_BITS, [0] + _X_SET_BITS[:-1]))
assert sum(_KARA_SEGMENTS) == C.BLS_X.bit_length() - 1
assert len(_KARA_SEGMENTS) == len(_GS_SEGMENTS)
