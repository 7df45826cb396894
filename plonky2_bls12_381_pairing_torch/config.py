"""Frozen run configuration (the JAX package's config.py): every tunable of a
run is an explicit field, checked against the generated constants.

Resolution order: explicit constructor arguments > environment variables
(BENCH_BATCH / BENCH_REPS / PAIRING_STRATEGY / PAIRING_DP /
PAIRING_CKPT_EVERY) > defaults. `apply()` checks the limb geometry and sets
the limb tier's kernel strategy (ops/fp.py set_strategy).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import constants as C


@dataclass(frozen=True)
class PairingConfig:
    #: limb geometry: must match the generated constants (checked in apply)
    limb_bits: int = C.LIMB_BITS    # 8
    nlimbs: int = C.NLIMBS          # 48
    mont_limbs: int = C.NRED        # 51: R = 2^408

    #: pairings per card (2048 amortizes the final exponentiation's
    #: sequential tail, and keeps the full-batch oracle gate affordable)
    batch_per_chip: int = 2048

    #: kernel strategy: "auto", "kernels", "plain" and "fused" are the limb
    #: tier's (ops/fp.py set_strategy; "fused" also runs the four Fq12 tower
    #: kernels); "rns" selects the RNS tier (ops/rns/, models/pairing_rns.py)
    strategy: str = "auto"

    #: data-parallel size (1 = one card)
    dp: int = 1

    #: benchmark timing repetitions
    bench_reps: int = 5

    #: checkpoint cadence in Miller schedule steps (0 = off)
    checkpoint_every_steps: int = 0

    @staticmethod
    def from_env() -> "PairingConfig":
        return PairingConfig(
            batch_per_chip=int(os.environ.get("BENCH_BATCH", "2048")),
            strategy=os.environ.get("PAIRING_STRATEGY", "auto"),
            dp=int(os.environ.get("PAIRING_DP", "1")),
            bench_reps=int(os.environ.get("BENCH_REPS", "5")),
            checkpoint_every_steps=int(os.environ.get("PAIRING_CKPT_EVERY", "0")),
        )

    def apply(self) -> "PairingConfig":
        """Check the fields against the generated tables and set the limb
        tier's strategy ("auto" under "rns": the limb tier stays at its
        default beneath the RNS tier).

        "rns" switches nothing more: the RNS tier picks its kernels by the
        device its tensors lie on (a CUDA kernel on the card, the plain
        formulas on the CPU), so it has no switch like the JAX package's
        set_fused."""
        for name, want in (("limb_bits", C.LIMB_BITS), ("nlimbs", C.NLIMBS),
                           ("mont_limbs", C.NRED)):
            if getattr(self, name) != want:
                raise ValueError(f"{name} = {getattr(self, name)}, but the generated "
                                 f"constants have {want}")
        for name in ("batch_per_chip", "dp", "bench_reps"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        from .ops import fp

        fp.set_strategy("auto" if self.strategy == "rns" else self.strategy)
        return self


DEFAULT = PairingConfig()
