"""The constants.inc text of the port's C++ host oracle (bls12_381.cpp).

Every value derives from the port's exact-integer model (utils/refmodel.py),
so the oracle cannot drift from it: p, -p^-1 mod 2^64 (CIOS), R^2 and R mod p
for the 6 x 64-bit Montgomery domain R = 2^384, the Fq6/Fq12 Frobenius gamma
constants (Montgomery form), the generators and BLS_X. The text is the JAX
package's generator's, but for its first (comment) line.

    python -m plonky2_bls12_381_pairing_torch.native.gen_constants > constants.inc

native.build() writes it beside the library it builds, never into the package.
"""

from __future__ import annotations

from ..utils import refmodel as rm

R64 = 1 << 384


def limbs6(x: int) -> str:
    ls = [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(6)]
    return "{" + ", ".join(f"0x{l:016x}ull" for l in ls) + "}"


def fp_c(name: str, x: int, mont: bool = False) -> str:
    if mont:
        x = x * R64 % rm.P
    return f"static const Fp {name} = {{{{ {limbs6(x)[1:-1]} }}}};"


def fq2_c(name: str, x: "rm.Fq2", mont: bool = True) -> str:
    c0, c1 = (x.c0, x.c1)
    if mont:
        c0, c1 = c0 * R64 % rm.P, c1 * R64 % rm.P
    return (
        f"static const Fq2 {name} = {{{{{{ {limbs6(c0)[1:-1]} }}}}, "
        f"{{{{ {limbs6(c1)[1:-1]} }}}}}};"
    )


def main() -> str:
    pinv = (-pow(rm.P, -1, 1 << 64)) % (1 << 64)
    lines = [
        "// GENERATED by plonky2_bls12_381_pairing_torch/native/gen_constants.py "
        "from the port's utils/refmodel.py — do not edit.",
        fp_c("P_CONST", rm.P),
        f"static const u64 PINV = 0x{pinv:016x}ull;",
        fp_c("R2_CONST", R64 * R64 % rm.P),
        fp_c("ONE_MONT", R64 % rm.P),
        fq2_c("FROB_G6_1", rm.FROB_GAMMA6_1[1]),
        fq2_c("FROB_G6_2", rm.FROB_GAMMA6_2[1]),
        fq2_c("FROB_G12", rm.FROB_GAMMA12[1]),
        fp_c("G1_GEN_X", rm.G1_GENERATOR_X, mont=True),
        fp_c("G1_GEN_Y", rm.G1_GENERATOR_Y, mont=True),
        fq2_c("G2_GEN_X", rm.Fq2(*rm.G2_GENERATOR_X)),
        fq2_c("G2_GEN_Y", rm.Fq2(*rm.G2_GENERATOR_Y)),
        f"static const u64 BLS_X = 0x{rm.BLS_X:016x}ull;",
    ]
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    print(main(), end="")
