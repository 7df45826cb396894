"""The plain reference of a block checked from the validator registry, in
Python integers: each signature set's public key is the sum of the keys it
names, added point by point (Jacobian coordinates, the mixed addition of
add-2007-bl's affine case, with its doubling and infinity cases), and the
block holds when the product of its sets' pairings and e(-G1, sigma) is one
(bls12_381.multi_pairing). An attestation that names no key fails the block
(is_valid_indexed_attestation); a sync aggregate that names none adds the
point at infinity, whose pairing is one. Independent of the program and of
how the traffic was made: it reads only the keys, the sets and the G2
points."""

from __future__ import annotations

from .bls12_381 import P, Fq2, Fq12, G1Affine, G2Affine, multi_pairing


def _double(x, y, z):
    if z == 0 or y == 0:
        return (1, 1, 0)
    a, b = x * x % P, y * y % P
    c = b * b % P
    d = 2 * ((x + b) ** 2 - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return x3, (e * (d - x3) - 8 * c) % P, 2 * y * z % P


def _add_affine(p, qx, qy):
    """Jacobian p plus the affine point (qx, qy)."""
    x1, y1, z1 = p
    if z1 == 0:
        return (qx, qy, 1)
    zz = z1 * z1 % P
    h = (qx * zz - x1) % P
    r = 2 * (qy * z1 * zz - y1) % P
    if h == 0:
        return _double(*p) if r == 0 else (1, 1, 0)
    hh = h * h % P
    i = 4 * hh % P
    j = h * i % P
    v = x1 * i % P
    x3 = (r * r - j - 2 * v) % P
    return x3, (r * (v - x3) - 2 * y1 * j) % P, ((z1 + h) ** 2 - zz - hh) % P


def key_sum(keys_x: list, keys_y: list, indices) -> G1Affine:
    """The sum of the keys (keys_x[i], keys_y[i]) for i in indices."""
    acc = (1, 1, 0)
    for i in indices:
        acc = _add_affine(acc, keys_x[int(i)], keys_y[int(i)])
    x, y, z = acc
    if z == 0:
        return G1Affine.identity()
    zi = pow(z, P - 2, P)
    zi2 = zi * zi % P
    return G1Affine(x * zi2 % P, y * zi2 * zi % P)


def block_verdict(keys_x: list, keys_y: list, sets: list, attestations: int, msgs: list,
                  sigma) -> bool:
    """A block's verdict: sets[s] the validator indices of set s (its first
    `attestations` sets are attestations), msgs[s] its G2 point r_s H(m_s)
    and sigma the sum of the sets' signatures times their scalars, affine
    G2 points as ((x0, x1), (y0, y1))."""
    if any(len(s) == 0 for s in sets[:attestations]):
        return False

    def g2(q):
        return G2Affine(Fq2(*q[0]), Fq2(*q[1]))

    terms = [(key_sum(keys_x, keys_y, s), g2(q)) for s, q in zip(sets, msgs)]
    terms = [(p, q) for p, q in terms if not p.infinity]
    terms.append((G1Affine.generator().neg(), g2(sigma)))
    return multi_pairing(terms) == Fq12.one()
