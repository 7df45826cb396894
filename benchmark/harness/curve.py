"""BLS12-381 G1 and G2 arithmetic in Jacobian coordinates on Python integers,
for making the benchmark's inputs fast: chains of mixed additions, scalar
multiplication, and many points brought back to affine form with one
inversion (Montgomery's trick).

A point is (x, y, z) with affine (x / z^2, y / z^3); z == 0 is the point at
infinity. Field elements are ints mod P (G1) or pairs of ints (G2, Fq2 =
Fp[u] / (u^2 + 1)). The curve constants come from the plain reference.
"""

from __future__ import annotations

from ..reference.bls12_381 import (G1_GENERATOR_X, G1_GENERATOR_Y, G2_GENERATOR_X,
                                   G2_GENERATOR_Y, P, R)


class Fp:
    """Fp operations on ints."""

    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def sqr(a):
        return a * a % P

    @staticmethod
    def small(a, k):
        return a * k % P

    @staticmethod
    def inv(a):
        return pow(a, P - 2, P)

    @staticmethod
    def is_zero(a):
        return a == 0


class Fq2:
    """Fq2 operations on pairs of ints, u^2 = -1."""

    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        t0, t1 = a[0] * b[0], a[1] * b[1]
        return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)

    @staticmethod
    def sqr(a):
        return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)

    @staticmethod
    def small(a, k):
        return (a[0] * k % P, a[1] * k % P)

    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % P, P - 2, P)
        return (a[0] * n % P, -a[1] * n % P)

    @staticmethod
    def is_zero(a):
        return a[0] == 0 and a[1] == 0


G1_GEN = (G1_GENERATOR_X, G1_GENERATOR_Y)
G2_GEN = (tuple(G2_GENERATOR_X), tuple(G2_GENERATOR_Y))


def double(F, p):
    """2p (dbl-2009-l, a = 0)."""
    x, y, z = p
    if F.is_zero(z):
        return p
    a, b = F.sqr(x), F.sqr(y)
    c = F.sqr(b)
    d = F.small(F.sub(F.sub(F.sqr(F.add(x, b)), a), c), 2)
    e = F.small(a, 3)
    x3 = F.sub(F.sqr(e), F.small(d, 2))
    y3 = F.sub(F.mul(e, F.sub(d, x3)), F.small(c, 8))
    return (x3, y3, F.small(F.mul(y, z), 2))


def add_affine(F, p, q):
    """p + q for Jacobian p and affine q (madd-2007-bl); q is never the point
    at infinity."""
    x1, y1, z1 = p
    if F.is_zero(z1):
        return (q[0], q[1], F.one)
    zz = F.sqr(z1)
    u2 = F.mul(q[0], zz)
    s2 = F.mul(q[1], F.mul(z1, zz))
    h = F.sub(u2, x1)
    r = F.small(F.sub(s2, y1), 2)
    if F.is_zero(h):
        return double(F, p) if F.is_zero(r) else (F.one, F.one, F.zero)
    hh = F.sqr(h)
    i = F.small(hh, 4)
    j = F.mul(h, i)
    v = F.mul(x1, i)
    x3 = F.sub(F.sub(F.sqr(r), j), F.small(v, 2))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.small(F.mul(y1, j), 2))
    z3 = F.sub(F.sub(F.sqr(F.add(z1, h)), zz), hh)
    return (x3, y3, z3)


def to_affine(F, points):
    """The affine (x, y) of Jacobian points, none at infinity, with one
    inversion for all of them."""
    prefix, acc = [], F.one
    for p in points:
        prefix.append(acc)
        acc = F.mul(acc, p[2])
    inv = F.inv(acc)
    out = [None] * len(points)
    for k in range(len(points) - 1, -1, -1):
        x, y, z = points[k]
        zinv = F.mul(inv, prefix[k])
        inv = F.mul(inv, z)
        zi2 = F.sqr(zinv)
        out[k] = (F.mul(x, zi2), F.mul(y, F.mul(zi2, zinv)))
    return out


def mul(F, base, k: int):
    """k * base (affine base) in Jacobian form, by double-and-add."""
    k %= R
    acc = (F.one, F.one, F.zero)
    for bit in bin(k)[2:]:
        acc = double(F, acc)
        if bit == "1":
            acc = add_affine(F, acc, base)
    return acc


def chain(F, start, step, n: int):
    """start, start + step, ..., start + (n - 1) step (affine start and step),
    as Jacobian points."""
    out = [(start[0], start[1], F.one)]
    for _ in range(n - 1):
        out.append(add_affine(F, out[-1], step))
    return out


def neg(F, q):
    """-q for an affine q."""
    return (q[0], F.sub(F.zero, q[1]))
