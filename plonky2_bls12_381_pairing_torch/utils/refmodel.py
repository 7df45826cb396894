"""Exact-integer reference model for the BLS12-381 optimal-ate pairing.

The port's own copy of the JAX package's oracle (utils/refmodel.py there),
trimmed to what the PyTorch package needs: the Fp/Fq2/Fq6/Fq12 tower, G1/G2
points, the line-evaluation Miller loop, the zkcrypto-chain final
exponentiation (the "cube" convention of tests/vectors/pairing_kat.json
``e_chain``) and the canonical one (``e_canonical``), and the Fp/Fq2 roots,
Legendre symbols and RFC 9380 signs. Pure Python ints, no tensors: it is the
oracle every batched op of the port is held against, and it feeds the
constant tables of rns_constants.py.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Curve constants (BLS12-381, zkcrypto/arkworks conventions)
# ---------------------------------------------------------------------------

#: Base field modulus (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
#: Subgroup order (scalar field modulus, 255 bits).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
#: |x| for the BLS parameter x = -0xd201000000010000
#: (reference: src/utils/constants.rs:1-2, src/global_constants.rs:1-8).
BLS_X = 0xD201_0000_0001_0000
BLS_X_IS_NEGATIVE = True

#: G1 is y^2 = x^3 + 4 over Fp; G2 is y^2 = x^3 + 4(u+1) over Fp2 (M-type twist).
B_G1 = 4
B_G2 = (4, 4)

#: Standard generator coordinates (RFC 9380 / zkcrypto test vectors).
G1_GENERATOR_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GENERATOR_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_GENERATOR_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GENERATOR_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# ---------------------------------------------------------------------------
# Fp (prime field) — plain ints mod P
# ---------------------------------------------------------------------------


def fp_add(a: int, b: int) -> int:
    return (a + b) % P


def fp_sub(a: int, b: int) -> int:
    return (a - b) % P


def fp_mul(a: int, b: int) -> int:
    return (a * b) % P


def fp_neg(a: int) -> int:
    return (-a) % P


def fp_inv(a: int) -> int:
    """Inverse by Fermat (mirrors reference src/fields/bls12_381base.rs:118-125).

    Returns 0 for 0 (the ``inv0`` convention used by the in-circuit gadgets,
    reference src/fields/fq2_target.rs:207-225).
    """
    if a % P == 0:
        return 0
    return pow(a, P - 2, P)


def fp_legendre(a: int) -> int:
    """Legendre symbol a^((p-1)/2) mod p, in {0, 1, p-1}."""
    return pow(a, (P - 1) // 2, P)


def fp_is_square(a: int) -> bool:
    return fp_legendre(a) != P - 1


def fp_sqrt(a: int) -> int | None:
    """Square root via a^((p+1)/4) (p ≡ 3 mod 4). None if a is not a QR."""
    r_ = pow(a, (P + 1) // 4, P)
    return r_ if r_ * r_ % P == a % P else None


def sgn0(a: int) -> int:
    """RFC-9380 sign of an Fp element (reference src/fields/helpers.rs:159-167)."""
    return a % 2


def sgn0_fq2(a: "Fq2") -> int:
    """RFC-9380 sign of an Fp2 element (reference src/fields/helpers.rs:169-174)."""
    sign_0 = a.c0 % 2
    zero_0 = a.c0 == 0
    sign_1 = a.c1 % 2
    return sign_0 | (zero_0 & sign_1)


# ---------------------------------------------------------------------------
# Fq2 = Fp[u] / (u^2 + 1)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Fq2:
    c0: int
    c1: int

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2((self.c0 + o.c0) % P, (self.c1 + o.c1) % P)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2((self.c0 - o.c0) % P, (self.c1 - o.c1) % P)

    def __neg__(self) -> "Fq2":
        return Fq2((-self.c0) % P, (-self.c1) % P)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # (a0 + a1 u)(b0 + b1 u) = (a0b0 - a1b1) + (a0b1 + a1b0) u
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fq2((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)

    def scale(self, k: int) -> "Fq2":
        return Fq2(self.c0 * k % P, self.c1 * k % P)

    def square(self) -> "Fq2":
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        a0, a1 = self.c0, self.c1
        return Fq2((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, (-self.c1) % P)

    frobenius_map = conjugate  # x -> x^p in Fq2 is conjugation

    def mul_by_nonresidue(self) -> "Fq2":
        """Multiply by xi = u + 1 (reference fq2_target_tree.rs:137-142)."""
        return Fq2((self.c0 - self.c1) % P, (self.c0 + self.c1) % P)

    def inv(self) -> "Fq2":
        """(a0 - a1 u) / (a0^2 + a1^2); returns 0 for 0 (inv0 convention)."""
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        ninv = fp_inv(norm)
        return Fq2(self.c0 * ninv % P, -self.c1 * ninv % P)

    def pow(self, e: int) -> "Fq2":
        acc, base = Fq2.one(), self
        while e:
            if e & 1:
                acc = acc * base
            base = base.square()
            e >>= 1
        return acc

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def sqrt(self) -> "Fq2 | None":
        """Square root in Fq2 (p ≡ 3 mod 4 algorithm, RFC 9380 appendix)."""
        if self.is_zero():
            return Fq2.zero()
        a1 = self.pow((P - 3) // 4)
        alpha = a1.square() * self
        x0 = a1 * self
        if alpha == Fq2((P - 1) % P, 0):
            return Fq2((-x0.c1) % P, x0.c0)
        b = (alpha + Fq2.one()).pow((P - 1) // 2)
        cand = b * x0
        return cand if cand.square() == self else None


#: Nonresidue xi = u + 1 used to build Fq6.
XI = Fq2(1, 1)

# Frobenius coefficients, computed exactly from the curve constants:
#   Fq6 frobenius:  gamma6_1 = xi^((p-1)/3),  gamma6_2 = xi^((2p-2)/3)
#   Fq12 frobenius: gamma12  = xi^((p-1)/6)
# (reference hardcodes these at fq6_target_tree.rs:129-169, fq12_target_tree.rs:92-128)
FROB_GAMMA6_1 = [XI.pow(i * (P - 1) // 3) for i in range(12)]  # for c1 of Fq6, power i
FROB_GAMMA6_2 = [XI.pow(i * (2 * P - 2) // 3 % (P * P - 1)) for i in range(12)]
FROB_GAMMA12 = [XI.pow(i * (P - 1) // 6) for i in range(12)]


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Fq6:
    c0: Fq2
    c1: Fq2
    c2: Fq2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        # Interpolation-style product (reference fq6_target_tree.rs:172-214):
        # v^3 = xi reduction of the degree-4 schoolbook product.
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        s0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue()
        s1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        s2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(s0, s1, s2)

    def square(self) -> "Fq6":
        return self * self

    def scale2(self, k: Fq2) -> "Fq6":
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_nonresidue(self) -> "Fq6":
        """Multiply by v (reference fq6_target_tree.rs:219-230)."""
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def mul_by_1(self, b1: Fq2) -> "Fq6":
        """Sparse product with (0 + b1 v + 0 v^2) (reference fq6_target_tree.rs:261-268)."""
        return Fq6((self.c2 * b1).mul_by_nonresidue(), self.c0 * b1, self.c1 * b1)

    def mul_by_01(self, b0: Fq2, b1: Fq2) -> "Fq6":
        """Sparse product with (b0 + b1 v) (reference fq6_target_tree.rs:232-259)."""
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0 * b0
        t1 = a1 * b1
        s0 = ((a1 + a2) * b1 - t1).mul_by_nonresidue() + t0
        s1 = (b0 + b1) * (a0 + a1) - t0 - t1
        s2 = a2 * b0 + t1
        return Fq6(s0, s1, s2)

    def inv(self) -> "Fq6":
        """Closed-form adjugate/norm inverse (reference fq6_target_tree.rs:59-89)."""
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.square().mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        norm = a0 * t0 + (a2 * t1 + a1 * t2).mul_by_nonresidue()
        ninv = norm.inv()
        return Fq6(t0 * ninv, t1 * ninv, t2 * ninv)

    def frobenius_map(self) -> "Fq6":
        """(reference fq6_target_tree.rs:129-169)."""
        return Fq6(
            self.c0.conjugate(),
            self.c1.conjugate() * FROB_GAMMA6_1[1],
            self.c2.conjugate() * FROB_GAMMA6_2[1],
        )


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Fq12:
    c0: Fq6
    c1: Fq6

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        # Karatsuba over Fq6 with w^2 = v (reference fq12_target_tree.rs:130-141).
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq12(
            t0 + t1.mul_by_nonresidue(),
            (a0 + a1) * (b0 + b1) - t0 - t1,
        )

    def square(self) -> "Fq12":
        # Complex squaring (reference fq12_target_tree.rs:143-155).
        a0, a1 = self.c0, self.c1
        ab = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_nonresidue()) - ab - ab.mul_by_nonresidue()
        return Fq12(c0, ab + ab)

    def conjugate(self) -> "Fq12":
        """f^(p^6): negate the w-coefficient (reference fq12_target_tree.rs:53-58)."""
        return Fq12(self.c0, -self.c1)

    def mul_by_014(self, c0: Fq2, c1: Fq2, c4: Fq2) -> "Fq12":
        """Sparse product with (c0 + c1 v) + (c4 v) w (reference fq12_target_tree.rs:157-176)."""
        aa = self.c0.mul_by_01(c0, c1)
        bb = self.c1.mul_by_1(c4)
        t1 = (self.c0 + self.c1).mul_by_01(c0, c1 + c4)
        return Fq12(bb.mul_by_nonresidue() + aa, t1 - aa - bb)

    def inv(self) -> "Fq12":
        """(c0 - c1 w) / (c0^2 - v c1^2) (reference fq12_target_tree.rs:77-90)."""
        t = (self.c0.square() - self.c1.square().mul_by_nonresidue()).inv()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def frobenius_map(self) -> "Fq12":
        """(reference fq12_target_tree.rs:92-128)."""
        c0 = self.c0.frobenius_map()
        c1 = self.c1.frobenius_map()
        c1 = c1.scale2(FROB_GAMMA12[1])
        return Fq12(c0, c1)

    def frobenius_pow(self, n: int) -> "Fq12":
        f = self
        for _ in range(n):
            f = f.frobenius_map()
        return f

    def pow(self, e: int) -> "Fq12":
        acc, base = Fq12.one(), self
        while e:
            if e & 1:
                acc = acc * base
            base = base.square()
            e >>= 1
        return acc

    def coeffs(self) -> list[int]:
        """Flatten to 12 Fp ints in tower order (c0.c0.c0, c0.c0.c1, ..., c1.c2.c1)."""
        out = []
        for c6 in (self.c0, self.c1):
            for c2 in (c6.c0, c6.c1, c6.c2):
                out.extend([c2.c0, c2.c1])
        return out

    @staticmethod
    def from_coeffs(v: list[int]) -> "Fq12":
        assert len(v) == 12
        sixes = []
        for i in (0, 6):
            sixes.append(
                Fq6(Fq2(v[i], v[i + 1]), Fq2(v[i + 2], v[i + 3]), Fq2(v[i + 4], v[i + 5]))
            )
        return Fq12(sixes[0], sixes[1])


# ---------------------------------------------------------------------------
# Curve points
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class G1Affine:
    x: int
    y: int
    infinity: bool = False

    @staticmethod
    def identity() -> "G1Affine":
        return G1Affine(0, 1, True)

    @staticmethod
    def generator() -> "G1Affine":
        return G1Affine(G1_GENERATOR_X, G1_GENERATOR_Y)

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return (self.y * self.y - self.x**3 - B_G1) % P == 0

    def neg(self) -> "G1Affine":
        return G1Affine(self.x, (-self.y) % P, self.infinity)

    def add(self, o: "G1Affine") -> "G1Affine":
        if self.infinity:
            return o
        if o.infinity:
            return self
        if self.x == o.x:
            if (self.y + o.y) % P == 0:
                return G1Affine.identity()
            lam = 3 * self.x * self.x % P * fp_inv(2 * self.y % P) % P
        else:
            lam = (o.y - self.y) * fp_inv((o.x - self.x) % P) % P
        x3 = (lam * lam - self.x - o.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return G1Affine(x3, y3)

    def mul(self, k: int) -> "G1Affine":
        acc, base = G1Affine.identity(), self
        k %= R
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.add(base)
            k >>= 1
        return acc


@dataclass(frozen=True)
class G2Affine:
    x: Fq2
    y: Fq2
    infinity: bool = False

    @staticmethod
    def identity() -> "G2Affine":
        return G2Affine(Fq2.zero(), Fq2.one(), True)

    @staticmethod
    def generator() -> "G2Affine":
        return G2Affine(Fq2(*G2_GENERATOR_X), Fq2(*G2_GENERATOR_Y))

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return self.y.square() == self.x.square() * self.x + Fq2(*B_G2)

    def neg(self) -> "G2Affine":
        return G2Affine(self.x, -self.y, self.infinity)

    def add(self, o: "G2Affine") -> "G2Affine":
        if self.infinity:
            return o
        if o.infinity:
            return self
        if self.x == o.x:
            if (self.y + o.y).is_zero():
                return G2Affine.identity()
            lam = (self.x.square().scale(3)) * (self.y.scale(2)).inv()
        else:
            lam = (o.y - self.y) * (o.x - self.x).inv()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return G2Affine(x3, y3)

    def mul(self, k: int) -> "G2Affine":
        acc, base = G2Affine.identity(), self
        k %= R
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.add(base)
            k >>= 1
        return acc


@dataclass
class G2Projective:
    """Jacobian coordinates (x/z^2, y/z^3) as used by the line-evaluation steps."""

    x: Fq2
    y: Fq2
    z: Fq2

    @staticmethod
    def from_affine(q: G2Affine) -> "G2Projective":
        z = Fq2.zero() if q.infinity else Fq2.one()
        return G2Projective(q.x, q.y, z)


# ---------------------------------------------------------------------------
# Miller loop (zkcrypto-style schedule; reference fields_as_trees/miller_loop.rs)
# ---------------------------------------------------------------------------


def doubling_step(r: G2Projective) -> tuple[Fq2, Fq2, Fq2]:
    """Jacobian doubling + tangent-line coefficients.

    Adaptation of Algorithm 26 of eprint 2010/354 — matches the *native* semantics
    the reference's circuit copy diverges from (SURVEY.md defect #3); mirrors
    reference src/miller_loop_native.rs:27-60 intent and
    src/fields_as_trees/miller_loop.rs:346-389 structure.
    """
    tmp0 = r.x.square()
    tmp1 = r.y.square()
    tmp2 = tmp1.square()
    tmp3 = (tmp1 + r.x).square() - tmp0 - tmp2
    tmp3 = tmp3 + tmp3
    tmp4 = tmp0 + tmp0 + tmp0
    tmp6 = r.x + tmp4
    tmp5 = tmp4.square()
    zsquared = r.z.square()
    r.x = tmp5 - tmp3 - tmp3
    r.z = (r.z + r.y).square() - tmp1 - zsquared
    r.y = (tmp3 - r.x) * tmp4
    tmp2_8 = tmp2 + tmp2
    tmp2_8 = tmp2_8 + tmp2_8
    tmp2_8 = tmp2_8 + tmp2_8
    r.y = r.y - tmp2_8
    tmp3 = tmp4 * zsquared
    tmp3 = tmp3 + tmp3
    tmp3 = -tmp3
    tmp6 = tmp6.square() - tmp0 - tmp5
    tmp1_4 = tmp1 + tmp1
    tmp1_4 = tmp1_4 + tmp1_4
    tmp6 = tmp6 - tmp1_4
    tmp0 = r.z * zsquared
    tmp0 = tmp0 + tmp0
    return (tmp0, tmp3, tmp6)


def addition_step(r: G2Projective, q: G2Affine) -> tuple[Fq2, Fq2, Fq2]:
    """Jacobian mixed addition + chord-line coefficients (Algorithm 27 of 2010/354;
    reference src/miller_loop_native.rs:62-87 /
    src/fields_as_trees/miller_loop.rs:392-439 structure, defect #3 fixed)."""
    zsquared = r.z.square()
    ysquared = q.y.square()
    t0 = zsquared * q.x
    t1 = ((q.y + r.z).square() - ysquared - zsquared) * zsquared
    t2 = t0 - r.x
    t3 = t2.square()
    t4 = t3 + t3
    t4 = t4 + t4
    t5 = t4 * t2
    t6 = t1 - r.y - r.y
    t9 = t6 * q.x
    t7 = t4 * r.x
    r.x = t6.square() - t5 - t7 - t7
    r.z = (r.z + t2).square() - zsquared - t3
    t10 = q.y + r.z
    t8 = (t7 - r.x) * t6
    t0 = r.y * t5
    t0 = t0 + t0
    r.y = t8 - t0
    t10 = t10.square() - ysquared
    ztsquared = r.z.square()
    t10 = t10 - ztsquared
    t9 = t9 + t9
    t9 = t9 - t10
    t10 = r.z + r.z
    t6 = -t6
    t1 = t6 + t6
    return (t10, t1, t9)


#: Number of line-coefficient triples per prepared G2 point
#: (62 doublings + 5 additions + 1 final doubling; asserted by the reference at
#: src/fields_as_trees/miller_loop.rs:228).
NUM_LINE_COEFFS = 68


def prepare_g2(q: G2Affine) -> list[tuple[Fq2, Fq2, Fq2]]:
    """Precompute the 68 line-coefficient triples for a G2 point.

    Mirrors reference G2PreparedTarget::from (fields_as_trees/miller_loop.rs:187-235);
    like the tree-mode reference (and zkcrypto), an infinity input is substituted
    with the generator — callers mask the pairing output to 1 instead.
    """
    if q.infinity:
        q = G2Affine.generator()
    coeffs: list[tuple[Fq2, Fq2, Fq2]] = []
    r_ = G2Projective.from_affine(q)
    found_one = False
    for i in range(63, -1, -1):
        bit = ((BLS_X >> 1) >> i) & 1 == 1
        if not found_one:
            found_one = bit
            continue
        coeffs.append(doubling_step(r_))
        if bit:
            coeffs.append(addition_step(r_, q))
    coeffs.append(doubling_step(r_))
    assert len(coeffs) == NUM_LINE_COEFFS
    return coeffs


def ell(f: Fq12, coeffs: tuple[Fq2, Fq2, Fq2], p: G1Affine) -> Fq12:
    """Evaluate the prepared line at P and fold into f (sparse mul_by_014).

    Reference fields_as_trees/miller_loop.rs:441-457 — with defect #1 fixed:
    the P.y / P.x scalings are actually applied.
    """
    c0 = Fq2(coeffs[0].c0 * p.y % P, coeffs[0].c1 * p.y % P)
    c1 = Fq2(coeffs[1].c0 * p.x % P, coeffs[1].c1 * p.x % P)
    return f.mul_by_014(coeffs[2], c1, c0)


def multi_miller_loop(terms: list[tuple[G1Affine, list[tuple[Fq2, Fq2, Fq2]]]]) -> Fq12:
    """Fused product of Miller loops, one shared schedule for all terms.

    Reference fields_as_trees/miller_loop.rs:247-344. Terms whose G1 point is at
    infinity contribute 1 (handled by skipping the ell update, the select-based
    equivalent of the reference's either_identity mask at :265-268).
    """
    f = Fq12.one()
    idx = 0
    found_one = False
    for i in range(63, -1, -1):
        bit = ((BLS_X >> 1) >> i) & 1 == 1
        if not found_one:
            found_one = bit
            continue
        for p, coeffs in terms:
            if not p.infinity:
                f = ell(f, coeffs[idx], p)
        idx += 1
        if bit:
            for p, coeffs in terms:
                if not p.infinity:
                    f = ell(f, coeffs[idx], p)
            idx += 1
        f = f.square()
    for p, coeffs in terms:
        if not p.infinity:
            f = ell(f, coeffs[idx], p)
    idx += 1
    assert idx == NUM_LINE_COEFFS
    if BLS_X_IS_NEGATIVE:
        f = f.conjugate()
    return f


# ---------------------------------------------------------------------------
# Final exponentiation (reference fields_as_trees/miller_loop.rs:29-178)
# ---------------------------------------------------------------------------


def fp4_square(a: Fq2, b: Fq2) -> tuple[Fq2, Fq2]:
    """Squaring in Fq4 = Fq2[w]/(w^2 - xi) (reference miller_loop.rs:29-44)."""
    t0 = a.square()
    t1 = b.square()
    t2 = (a + b).square() - t0 - t1  # 2ab
    return (t1.mul_by_nonresidue() + t0, t2)


def cyclotomic_square(f: Fq12) -> Fq12:
    """Granger–Scott cyclotomic squaring (reference miller_loop.rs:46-104).

    Valid only for elements of the cyclotomic subgroup (after the easy part).
    """
    z0, z4, z3 = f.c0.c0, f.c0.c1, f.c0.c2
    z2, z1, z5 = f.c1.c0, f.c1.c1, f.c1.c2

    t0, t1 = fp4_square(z0, z1)
    z0 = t0 - z0
    z0 = z0 + z0 + t0
    z1 = t1 + z1
    z1 = z1 + z1 + t1

    t0, t1 = fp4_square(z2, z3)
    t2, t3 = fp4_square(z4, z5)

    z4 = t0 - z4
    z4 = z4 + z4 + t0
    z5 = t1 + z5
    z5 = z5 + z5 + t1
    t0 = t3.mul_by_nonresidue()
    z2 = t0 + z2
    z2 = z2 + z2 + t0
    z3 = t2 - z3
    z3 = z3 + z3 + t2

    return Fq12(Fq6(z0, z4, z3), Fq6(z2, z1, z5))


def cyclotomic_exp(f: Fq12) -> Fq12:
    """f^(-|x|) = conjugate(f^BLS_X) by square-and-multiply over BLS_X bits.

    Reference miller_loop.rs:106-126 ("cycolotomic_exp"), with defect #2 fixed:
    the multiply-by-f actually lands in the accumulator.
    """
    tmp = Fq12.one()
    found_one = False
    for i in range(63, -1, -1):
        if found_one:
            tmp = cyclotomic_square(tmp)
        else:
            found_one = (BLS_X >> i) & 1 == 1
        if (BLS_X >> i) & 1 == 1:
            tmp = tmp * f
    return tmp.conjugate()


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12 - 1)/r) via easy part + zkcrypto hard-part addition chain.

    Reference miller_loop.rs:128-178 (f_conversion + final_exponentiation).
    Cross-checked in tests against raw exponentiation by (p^12-1)/r.
    """
    t0 = f.frobenius_pow(6)
    t1 = f.inv()
    t2 = t0 * t1  # f^(p^6 - 1)
    t1 = t2
    t2 = t2.frobenius_pow(2)
    t2 = t2 * t1  # easy part done: f^((p^6-1)(p^2+1))

    t1 = cyclotomic_square(t2).conjugate()
    t3 = cyclotomic_exp(t2)
    t4 = cyclotomic_square(t3)
    t5 = t1 * t3
    t1 = cyclotomic_exp(t5)
    t0 = cyclotomic_exp(t1)
    t6 = cyclotomic_exp(t0)
    t6 = t6 * t4
    t4 = cyclotomic_exp(t6)
    t5 = t5.conjugate()
    t4 = t4 * t5 * t2
    t5 = t2.conjugate()
    t1 = t1 * t2
    t1 = t1.frobenius_pow(3)
    t6 = t6 * t5
    t6 = t6.frobenius_map()
    t3 = t3 * t0
    t3 = t3.frobenius_pow(2)
    t3 = t3 * t1
    t3 = t3 * t6
    return t3 * t4


#: The hard-part addition chain above computes f^(3·(p^4-p^2+1)/r), i.e. the
#: *cube* of the canonical hard part (the reference/zkcrypto chain structure);
#: since gcd(3, r) = 1 it is a valid, bilinear, non-degenerate pairing.
HARD_PART_MULTIPLE = 3

#: Base-p digits of the canonical hard-part exponent (p^4-p^2+1)/r, used by the
#: provably-canonical final exponentiation: m^h = prod_i frob^i(m^{d_i}).
_H = (P**4 - P**2 + 1) // R
HARD_PART_DIGITS = tuple((_H // P**i) % P for i in range(4))


def final_exponentiation_canonical(f: Fq12) -> Fq12:
    """f^((p^12-1)/r) with the *exact* canonical exponent.

    Easy part as in final_exponentiation; hard part by base-p digit
    decomposition h = d0 + d1 p + d2 p^2 + d3 p^3 (0 <= d_i < p), using
    m^(d_i p^i) = frob^i(m^(d_i)).
    """
    t0 = f.frobenius_pow(6)
    t1 = f.inv()
    t2 = t0 * t1
    t1 = t2
    t2 = t2.frobenius_pow(2)
    m = t2 * t1  # easy part: f^((p^6-1)(p^2+1)), in the cyclotomic subgroup

    out = Fq12.one()
    for i, d in enumerate(HARD_PART_DIGITS):
        acc = Fq12.one()
        started = False
        for b in range(d.bit_length() - 1, -1, -1):
            if started:
                acc = cyclotomic_square(acc)
            if (d >> b) & 1:
                acc = acc * m if started else m
                started = True
        out = out * acc.frobenius_pow(i)
    return out


def pairing(p: G1Affine, q: G2Affine) -> Fq12:
    """Full optimal-ate pairing e(P, Q) (reference miller_loop.rs:459-492 intent)."""
    if p.infinity or q.infinity:
        return Fq12.one()
    return final_exponentiation(multi_miller_loop([(p, prepare_g2(q))]))


def multi_pairing(terms: list[tuple[G1Affine, G2Affine]]) -> Fq12:
    """Product of pairings with one shared Miller loop + one final exponentiation."""
    prepared = [(p, prepare_g2(q)) for p, q in terms if not (p.infinity or q.infinity)]
    if not prepared:
        return Fq12.one()
    return final_exponentiation(multi_miller_loop(prepared))


# ---------------------------------------------------------------------------
# Randomness helpers for tests
# ---------------------------------------------------------------------------


def rand_fp(rng: _random.Random) -> int:
    return rng.randrange(P)


def rand_fq2(rng: _random.Random) -> Fq2:
    return Fq2(rng.randrange(P), rng.randrange(P))


def rand_fq6(rng: _random.Random) -> Fq6:
    return Fq6(rand_fq2(rng), rand_fq2(rng), rand_fq2(rng))


def rand_fq12(rng: _random.Random) -> Fq12:
    return Fq12(rand_fq6(rng), rand_fq6(rng))


def rand_g1(rng: _random.Random) -> G1Affine:
    return G1Affine.generator().mul(rng.randrange(1, R))


def rand_g2(rng: _random.Random) -> G2Affine:
    return G2Affine.generator().mul(rng.randrange(1, R))
