"""Batched G1/G2 point types on limb vectors, the counterpart of the JAX
package's ops/curve.py: points are dataclasses of limb tensors with an
explicit infinity mask, batched over leading axes. `encode`, `identity` and
`generator` place their tensors on a CUDA device unless the caller names
another (device="cpu").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import refmodel as rm
from . import fp, fq2


def _mask(values, batch_shape, device) -> torch.Tensor:
    return torch.full(tuple(batch_shape), values, dtype=torch.int32,
                      device=fp.resolve_device(device))


_GENERATORS: dict = {}


def _generator(name: str, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The G1 or G2 generator's encoded coordinates on `device`, uploaded
    once per device: a later call (the limb prepare_g2's on every pairing)
    copies nothing from the host, so it also runs under a CUDA graph
    capture."""
    dev = fp.resolve_device(device)
    key = (name, dev)
    if key not in _GENERATORS:
        g = rm.G1Affine.generator() if name == "g1" else rm.G2Affine.generator()
        enc = fp.encode if name == "g1" else fq2.encode
        _GENERATORS[key] = (fp.to_tensor(enc(g.x), dev), fp.to_tensor(enc(g.y), dev))
    return _GENERATORS[key]


@dataclass
class G1Affine:
    """x, y: (..., NLIMBS) Montgomery limbs; infinity: (...,) int32 mask."""

    x: torch.Tensor
    y: torch.Tensor
    infinity: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), device=None) -> "G1Affine":
        return G1Affine(fp.zeros(batch_shape, device), fp.one_mont(batch_shape, device),
                        _mask(1, batch_shape, device))

    @staticmethod
    def generator(batch_shape=(), device=None) -> "G1Affine":
        x, y = _generator("g1", device)
        return G1Affine(x.expand(*batch_shape, fp.NLIMBS), y.expand(*batch_shape, fp.NLIMBS),
                        _mask(0, batch_shape, device))

    @staticmethod
    def encode(points, device=None) -> "G1Affine":
        """refmodel.G1Affine (or nested lists) -> batched G1Affine."""
        arr = np.asarray(points, dtype=object)
        xs = np.empty(arr.shape, dtype=object)
        ys = np.empty(arr.shape, dtype=object)
        inf = np.zeros(arr.shape, dtype=np.int32)
        for idx in np.ndindex(arr.shape):
            p = arr[idx]
            xs[idx], ys[idx], inf[idx] = p.x, p.y, int(p.infinity)
        return G1Affine(fp.to_tensor(fp.encode(xs), device),
                        fp.to_tensor(fp.encode(ys), device), fp.to_tensor(inf, device))

    def decode(self):
        xs = fp.decode(self.x)
        ys = fp.decode(self.y)
        inf = self.infinity.detach().cpu().numpy()
        shape = inf.shape
        out = np.empty(shape, dtype=object)
        for idx in np.ndindex(shape):
            out[idx] = rm.G1Affine(int(xs[idx]), int(ys[idx]), bool(inf[idx]))
        return out if shape else out[()]

    def is_on_curve(self) -> torch.Tensor:
        """y^2 == x^3 + 4 (or infinity)."""
        y2 = fp.mont_square(self.y)
        x3 = fp.mont_mul(fp.mont_square(self.x), self.x)
        b = fp.to_tensor(fp.encode(rm.B_G1), x3.device)
        rhs = fp.add(x3, b.expand_as(x3))
        return fp.is_equal(y2, rhs) | (self.infinity != 0)

    def neg(self) -> "G1Affine":
        return G1Affine(self.x, fp.neg(self.y), self.infinity)

    def conditional_select(self, mask, other: "G1Affine") -> "G1Affine":
        """self where mask else other."""
        return G1Affine(
            fp.select(mask, self.x, other.x),
            fp.select(mask, self.y, other.y),
            torch.where(mask != 0, self.infinity, other.infinity),
        )

    def is_point_equal_to(self, other: "G1Affine") -> torch.Tensor:
        """Predicate incl. infinity handling."""
        both_inf = (self.infinity != 0) & (other.infinity != 0)
        coords = fp.is_equal(self.x, other.x) & fp.is_equal(self.y, other.y)
        neither = (self.infinity == 0) & (other.infinity == 0)
        return both_inf | (neither & coords)


@dataclass
class G2Affine:
    """x, y: (..., 2, NLIMBS) Fq2 limbs; infinity: (...,) int32 mask."""

    x: torch.Tensor
    y: torch.Tensor
    infinity: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), device=None) -> "G2Affine":
        return G2Affine(fq2.zero(batch_shape, device), fq2.one(batch_shape, device),
                        _mask(1, batch_shape, device))

    @staticmethod
    def generator(batch_shape=(), device=None) -> "G2Affine":
        x, y = _generator("g2", device)
        return G2Affine(x.expand(*batch_shape, 2, fp.NLIMBS),
                        y.expand(*batch_shape, 2, fp.NLIMBS), _mask(0, batch_shape, device))

    @staticmethod
    def encode(points, device=None) -> "G2Affine":
        arr = np.asarray(points, dtype=object)
        xs = np.empty(arr.shape, dtype=object)
        ys = np.empty(arr.shape, dtype=object)
        inf = np.zeros(arr.shape, dtype=np.int32)
        for idx in np.ndindex(arr.shape):
            p = arr[idx]
            xs[idx], ys[idx], inf[idx] = p.x, p.y, int(p.infinity)
        return G2Affine(fp.to_tensor(fq2.encode(xs), device),
                        fp.to_tensor(fq2.encode(ys), device), fp.to_tensor(inf, device))

    def decode(self):
        xs = fq2.decode(self.x)
        ys = fq2.decode(self.y)
        inf = self.infinity.detach().cpu().numpy()
        shape = inf.shape
        out = np.empty(shape, dtype=object)
        for idx in np.ndindex(shape):
            out[idx] = rm.G2Affine(xs[idx], ys[idx], bool(inf[idx]))
        return out if shape else out[()]

    def is_on_curve(self) -> torch.Tensor:
        y2 = fq2.square(self.y)
        x3 = fq2.mul(fq2.square(self.x), self.x)
        b = fp.to_tensor(fq2.encode(rm.Fq2(*rm.B_G2)), x3.device)
        rhs = fq2.add(x3, b.expand_as(x3))
        return fq2.is_equal(y2, rhs) | (self.infinity != 0)

    def neg(self) -> "G2Affine":
        return G2Affine(self.x, fq2.neg(self.y), self.infinity)

    def conditional_select(self, mask, other: "G2Affine") -> "G2Affine":
        return G2Affine(
            fq2.select(mask, self.x, other.x),
            fq2.select(mask, self.y, other.y),
            torch.where(mask != 0, self.infinity, other.infinity),
        )

    def is_point_equal_to(self, other: "G2Affine") -> torch.Tensor:
        both_inf = (self.infinity != 0) & (other.infinity != 0)
        coords = fq2.is_equal(self.x, other.x) & fq2.is_equal(self.y, other.y)
        neither = (self.infinity == 0) & (other.infinity == 0)
        return both_inf | (neither & coords)


@dataclass
class G2Projective:
    """Jacobian (x/z^2, y/z^3): x, y, z are (..., 2, NLIMBS) Fq2 limbs."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_affine(q: G2Affine) -> "G2Projective":
        shape, dev = q.infinity.shape, q.infinity.device
        z = fq2.select(q.infinity, fq2.zero(shape, dev), fq2.one(shape, dev))
        return G2Projective(q.x, q.y, z)

    @staticmethod
    def identity(batch_shape=(), device=None) -> "G2Projective":
        """The point at infinity: (0, 1, 0)."""
        return G2Projective(fq2.zero(batch_shape, device), fq2.one(batch_shape, device),
                            fq2.zero(batch_shape, device))

    @staticmethod
    def generator(batch_shape=(), device=None) -> "G2Projective":
        """The subgroup generator with z = 1."""
        return G2Projective.from_affine(G2Affine.generator(batch_shape, device))

    @staticmethod
    def conditional_select(a: "G2Projective", b: "G2Projective",
                           flag: torch.Tensor) -> "G2Projective":
        """flag != 0 selects a, else b, per batch element."""
        return G2Projective(fq2.select(flag, a.x, b.x),
                            fq2.select(flag, a.y, b.y),
                            fq2.select(flag, a.z, b.z))
