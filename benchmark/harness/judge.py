"""The comparison that decides `correct`. It reads the answers that the timed
calls gave, as host arrays, and imports nothing of the program; what each
answer must be comes from the traffic's generator (harness/spec.py), which
made the inputs.

Two numbers are compared, each exactly (limit 0):

  wrong_verdicts       answers of the timed calls, every one of them, that
                       differ from the answer their input was built to give
                       (the generator's expected());
  reference_disagrees  of a sample of those answers drawn from the seed (the
                       first of them one of the generator's notable() items,
                       for signature checks one built invalid), those that
                       differ from the plain reference's answer to the same
                       input (the generator's reference(): for signature
                       checks the product of the check's pairings computed
                       in Python integers, reference/bls12_381.py, compared
                       with one).
"""

from __future__ import annotations

import random

import numpy as np

LIMITS = {"wrong_verdicts": 0, "reference_disagrees": 0}


def sample(seed: int, answers: list, traffic, gen, k: int) -> list[tuple[int, int]]:
    """k (call, item) positions among the answers, drawn from the seed; the
    first is one of gen's notable items where a call has one."""
    if not answers or k < 1:
        return []
    rng = random.Random(repr((int(seed), "reference sample")))
    out = []
    calls = list(range(len(answers)))
    rng.shuffle(calls)
    for call in calls:
        picks = gen.notable(traffic, answers[call][0])
        if len(picks):
            out.append((call, int(picks[rng.randrange(len(picks))])))
            break
    while len(out) < k:
        call = rng.randrange(len(answers))
        out.append((call, rng.randrange(len(answers[call][1]))))
    return out


def judge(seed: int, answers: list, traffic, gen, reference_checks: int) -> dict:
    """The compared numbers of a run, each with its limit, and `correct`.
    answers: (batch index, (B,) answers) of every timed call, in order."""
    wrong = sum(int(np.count_nonzero(v != gen.expected(traffic, b))) for b, v in answers)
    picks = sample(seed, answers, traffic, gen, reference_checks)
    disagree = sum(int(not np.array_equal(gen.reference(traffic, answers[call][0], c),
                                          answers[call][1][c])) for call, c in picks)
    numbers = {"wrong_verdicts": wrong, "reference_disagrees": disagree}
    correct = bool(answers) and all(numbers[k] <= LIMITS[k] for k in numbers)
    return {"correct": correct, "numbers": numbers, "sampled": len(picks),
            "answers": sum(len(v) for _, v in answers)}


def lines(result: dict) -> list[str]:
    """The compared numbers beside their limits, one to a line."""
    n = result["numbers"]
    return [f"wrong_verdicts {n['wrong_verdicts']} of {result['answers']} answers "
            f"(limit {LIMITS['wrong_verdicts']})",
            f"reference_disagrees {n['reference_disagrees']} of {result['sampled']} "
            f"sampled (limit {LIMITS['reference_disagrees']})"]
