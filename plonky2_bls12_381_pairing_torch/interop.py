"""What crosses between the JAX package and this one: encoded rows.

Both packages store a field element as the same int32 rows (the RNS tier's
packed residue rows of rns_constants.py, the limb tier's 48 Montgomery limbs
of constants.py), so the JAX package's encoded G1Affine/G2Affine/Fq12 arrays
and line-coefficient tensors, handed over as numpy, become this package's
tensors unchanged, and the two compute the same rows from the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import curve
from .ops.rns import fp
from .ops.rns.lines import G1Affine, G2Affine


def _tensor(arr, device) -> torch.Tensor:
    # a copy: arrays handed over from JAX are read-only
    a = np.array(arr, dtype=np.int32, order="C")
    return torch.from_numpy(a).to(fp.resolve_device(device))


def g1_from_numpy(x, y, infinity, device=None) -> G1Affine:
    """Encoded G1 rows: x, y, infinity (rows..., LANES)."""
    return G1Affine(_tensor(x, device), _tensor(y, device),
                    _tensor(infinity, device))


def g2_from_numpy(x, y, infinity, device=None) -> G2Affine:
    """Encoded G2 rows: x, y (rows..., 2, LANES), infinity (rows..., LANES)."""
    return G2Affine(_tensor(x, device), _tensor(y, device),
                    _tensor(infinity, device))


def fq12_from_numpy(a, device=None) -> torch.Tensor:
    """Encoded Fq12 rows (..., 12, LANES)."""
    return _tensor(a, device)


def coeffs_from_numpy(coeffs, device=None) -> torch.Tensor:
    """Step-major line coefficients (68, rows..., 3, 2, LANES), as
    prepare_g2_stepmajor returns them in either package."""
    return _tensor(coeffs, device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Rows back to numpy int32, for the JAX package or for decoding."""
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The limb tier: plain (..., 48) int32 limb arrays in both packages
# ---------------------------------------------------------------------------


def limbs_from_numpy(a, device=None) -> torch.Tensor:
    """Encoded limb rows (..., 48) of any tower level: Fp, Fq2 (..., 2, 48),
    Fq6, Fq12 (..., 12, 48)."""
    return _tensor(a, device)


def g1_limb_from_numpy(x, y, infinity, device=None):
    """Encoded limb-tier G1 points: x, y (..., 48), infinity (...,)."""
    return curve.G1Affine(_tensor(x, device), _tensor(y, device), _tensor(infinity, device))


def g2_limb_from_numpy(x, y, infinity, device=None):
    """Encoded limb-tier G2 points: x, y (..., 2, 48), infinity (...,)."""
    return curve.G2Affine(_tensor(x, device), _tensor(y, device), _tensor(infinity, device))


def coeffs_limb_from_numpy(coeffs, device=None) -> torch.Tensor:
    """Prepared line coefficients (..., 68, 3, 2, 48), as prepare_g2 returns
    them in either package's limb tier."""
    return _tensor(coeffs, device)


# ---------------------------------------------------------------------------
# Witness rows
# ---------------------------------------------------------------------------


def trace_from_numpy(rows: dict, device=None):
    """The JAX package's WitnessTrace rows ({kind: list of row tuples}, each
    array as numpy) as this package's models/witness.WitnessTrace, so that
    its check_trace and export_rows_u32 run on rows the JAX package
    recorded."""
    from .models.witness import WitnessTrace

    tr = WitnessTrace()
    for op, op_rows in rows.items():
        for r in op_rows:
            tr.add(op, tuple(_tensor(t, device) for t in r))
    return tr
