"""The generator of BLS signature checks: batches of checks, each a product
of T pairings that is one exactly when the check is valid, made from a seed.

A check is T - 1 signature terms (pk, H(m)) and one signature term (-G1,
sigma): prod_{t < T-1} e(pk_t, H(m_t)) * e(-G1, sigma) == 1. With T = 2 it is
one BLS signature (the IETF draft's CoreVerify); with T > 2 it is the random
scalar batch of T - 1 signature sets (blst's verify_multiple_aggregate_
signatures), the scalars folded into the public keys.

Public keys come from a registry of G1 points with known discrete logs,
k_i = k0 + i d, and messages from a pool of G2 points h_j = h0 + j e (hashing
to the curve is outside the system). Check c of a batch takes, for term t,
key c + o_t and message c + u_t, the offsets drawn per batch. Its sigma is
then s_c G2 with s_c = sum_t k_{c+o_t} h_{c+u_t}, a quadratic in c, so the
sigmas of a batch are two chains of additions (finite differences) and three
scalar multiplications: the inputs cost seconds, not a scalar multiplication
per check. The checks of a batch are then shuffled.

A seeded ceil(B / invalid_one_in) checks per batch are made invalid in one
seeded term: a signature term takes the next key of the registry, or sigma
gains one G2. Every other check is valid. Nothing here depends on the program:
it makes affine integer points and the verdicts they must give.

Traffic parameters (benchmark/traffic/<mix>.json): batch (checks per call),
invalid_one_in, distinct_batches (the pool of batches the loop cycles
through). The configuration (benchmark/configs/<config>.json) gives
terms_per_check. The answer of a check is its verdict, a bool.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np

from benchmark.harness import curve
from benchmark.harness.curve import Fp, Fq2
from benchmark.reference import bls12_381 as ref
from benchmark.reference.bls12_381 import R


@dataclass
class Batch:
    """One call's checks. keys, msgs: (T - 1, B) indices into the pools;
    sigma: B affine G2 points; valid: (B,) the verdict each check must give."""

    keys: np.ndarray
    msgs: np.ndarray
    sigma: list
    valid: np.ndarray


@dataclass
class Traffic:
    """The pools and the batches of one seed. keys: affine G1 points (x, y);
    msgs: affine G2 points ((x0, x1), (y0, y1)); neg_g1: -G1, every check's
    last G1 point."""

    terms: int
    keys: list
    msgs: list
    neg_g1: tuple
    batches: list

    def terms_of(self, batch: int, check: int) -> list[tuple]:
        """The (G1, G2) affine points of one check, in term order."""
        b = self.batches[batch]
        out = [(self.keys[b.keys[t, check]], self.msgs[b.msgs[t, check]])
               for t in range(self.terms - 1)]
        return out + [(self.neg_g1, b.sigma[check])]


def _seed_rng(seed: int, *tags) -> random.Random:
    """A generator for one purpose of one seed (any int, of any size)."""
    return random.Random(repr((int(seed),) + tags))


def generate(seed: int, terms: int, batch: int, invalid_one_in: int,
             distinct_batches: int) -> Traffic:
    """The seed's pools and its distinct_batches batches of `batch` checks of
    `terms` pairings each (module docstring)."""
    if terms < 2 or batch < 1 or distinct_batches < 1:
        raise ValueError("a check has at least 2 terms; a batch at least 1 check")
    rng = _seed_rng(seed, "pools")
    span = max(2 * terms, 64)
    n_pool = batch + span + 1
    k0, d, h0, e = (rng.randrange(1, R) for _ in range(4))
    keys = curve.to_affine(Fp, curve.chain(
        Fp, curve.to_affine(Fp, [curve.mul(Fp, curve.G1_GEN, k0)])[0],
        curve.to_affine(Fp, [curve.mul(Fp, curve.G1_GEN, d)])[0], n_pool))
    msgs = curve.to_affine(Fq2, curve.chain(
        Fq2, curve.to_affine(Fq2, [curve.mul(Fq2, curve.G2_GEN, h0)])[0],
        curve.to_affine(Fq2, [curve.mul(Fq2, curve.G2_GEN, e)])[0], n_pool))
    batches = [_batch(_seed_rng(seed, "batch", i), terms, batch, invalid_one_in, span,
                      (k0, d, h0, e)) for i in range(distinct_batches)]
    return Traffic(terms, keys, msgs, curve.neg(Fp, curve.G1_GEN), batches)


def make(seed: int, cell) -> Traffic:
    """The traffic of one run of `cell` (harness/spec.py)."""
    t = cell.traffic
    return generate(seed, int(cell.config["terms_per_check"]), t["batch"],
                    t["invalid_one_in"], t["distinct_batches"])


def expected(traffic: Traffic, batch: int) -> np.ndarray:
    """(B,) the verdicts the batch's checks were built to give."""
    return traffic.batches[batch].valid


def notable(traffic: Traffic, batch: int) -> np.ndarray:
    """The batch's checks built invalid, which the judge samples first."""
    return np.flatnonzero(~traffic.batches[batch].valid)


def reference(traffic: Traffic, batch: int, check: int) -> bool:
    """The plain reference's verdict of one check: whether the product of
    its pairings, computed in Python integers, is one."""
    pts = [(ref.G1Affine(*p), ref.G2Affine(ref.Fq2(*q[0]), ref.Fq2(*q[1])))
           for p, q in traffic.terms_of(batch, check)]
    return ref.multi_pairing(pts) == ref.Fq12.one()


def _g2_scalar(k: int):
    return curve.to_affine(Fq2, [curve.mul(Fq2, curve.G2_GEN, k)])[0]


def _batch(rng: random.Random, terms: int, batch: int, invalid_one_in: int, span: int,
           dlogs: tuple) -> Batch:
    k0, d, h0, e = dlogs
    n = terms - 1
    o = np.array(rng.sample(range(span), n))
    u = np.array(rng.sample(range(span), n))
    # s_c = sum_t (a_t + c d)(b_t + c e) = alpha + beta c + gamma c^2
    a = [(k0 + int(ot) * d) % R for ot in o]
    b = [(h0 + int(ut) * e) % R for ut in u]
    alpha = sum(x * y for x, y in zip(a, b)) % R
    beta = sum(x * e + y * d for x, y in zip(a, b)) % R
    gamma = n * d * e % R
    # sigma_{c+1} = sigma_c + D_c, D_c = (beta + gamma (2c + 1)) G2
    steps = curve.to_affine(Fq2, curve.chain(Fq2, _g2_scalar(beta + gamma),
                                             _g2_scalar(2 * gamma), batch))
    sig = [(*_g2_scalar(alpha), Fq2.one)]
    for c in range(batch - 1):
        sig.append(curve.add_affine(Fq2, sig[-1], steps[c]))
    sigma = curve.to_affine(Fq2, sig)
    keys = np.arange(batch)[None, :] + o[:, None]
    msgs = np.arange(batch)[None, :] + u[:, None]
    valid = np.ones(batch, dtype=bool)
    for c in rng.sample(range(batch), math.ceil(batch / invalid_one_in)):
        t = rng.randrange(terms)
        if t < n:
            keys[t, c] += 1
        else:
            sigma[c] = curve.to_affine(
                Fq2, [curve.add_affine(Fq2, (*sigma[c], Fq2.one), curve.G2_GEN)])[0]
        valid[c] = False
    perm = np.array(rng.sample(range(batch), batch))
    return Batch(keys[:, perm], msgs[:, perm], [sigma[i] for i in perm], valid[perm])
