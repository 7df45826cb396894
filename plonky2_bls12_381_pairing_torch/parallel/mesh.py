"""Data-parallel distribution of the batched pairing over torch.distributed,
the counterpart of the JAX package's parallel/mesh.py.

The JAX package shards the batch axis over a 1-D device mesh (axis "dp") and
jits one SPMD graph, whose product tree's last folds XLA lowers to
collectives. Here a rank is one process with one device, in a
torch.distributed process group:

  * DP over pairing instances: each rank holds a contiguous block of the
    batch's elements (limb tier) or packed rows (RNS tier, two elements a
    row), the layout of the JAX package's P("dp"), and runs the whole static
    Miller schedule and final exponentiation on it. Field and tower axes stay
    on the rank.
  * The multi-pairing product: each *_sharded call issues ONE collective, an
    all_gather of the ranks' rows (6 KiB per packed RNS row), after which
    every rank runs the single-process product tree on the whole batch, so
    the product's rows are the single-process tree's on the gathered rows.
    The per-instance part issues none.

Rows. fp.inv's product tree (ops/rns/fp.py, _TREE_FLOOR = 128 rows) pairs the
rows of the batch it is given, so once a shard or the batch has more than 128
packed rows a rank's final exponentiation runs other products than the
single-process call: its e values are the same, its rows are not the same by
construction. Where every shard and the whole batch have at most 128, a
rank's e rows are the single-process call's rows bit for bit. The limb tier
inverts per element (mont_pow): its rows never depend on the shard.

Nothing here picks a device or a backend: the mesh's device is the caller's
(the current CUDA device unless named) and the process group is whatever
torch.distributed was initialised with (parallel/multihost.py initialize).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.distributed as dist

from .. import rns_constants as RC
from ..models import pairing as mp
from ..models import pairing_rns as mpr
from ..ops import fq12
from ..ops.curve import G1Affine, G2Affine
from ..ops.rns import fp as rfp
from ..ops.rns import lines as rlines
from ..ops.rns import tower

DP_AXIS = "dp"

#: collectives issued by this module, by kind (reset_collectives sets them
#: to 0): the *_sharded product calls add one all_gather each
collectives = {"all_gather": 0}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh as this rank sees it: the process group
    (None: no torch.distributed group, the trivial world of one rank), this
    rank's index and the world size along DP_AXIS, and the rank's device."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_names: ClassVar[tuple] = (DP_AXIS,)


def make_mesh(group=None, device=None) -> Mesh:
    """The dp mesh over the initialised process group (or `group`): this
    rank and the world size. With no process group initialised, the trivial
    mesh of one rank, as make_mesh over one device is in the JAX package.
    The device is the current CUDA device unless `device` names another."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    elif group is not None:
        raise ValueError("a process group was given, but torch.distributed is "
                         "not initialised")
    else:
        rank, size = 0, 1
    dev = rfp.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, size, dev)


def shard_block(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of `n` batch entries (P(DP_AXIS)).
    Raises ValueError where n does not divide by the world size."""
    if n % mesh.size:
        raise ValueError(f"a batch axis of {n} does not divide over {mesh.size} ranks")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def _shard(pt, n: int, mesh: Mesh):
    block = shard_block(n, mesh)
    return type(pt)(*(getattr(pt, k)[block].to(mesh.device)
                      for k in ("x", "y", "infinity")))


def shard_points(p: G1Affine, q: G2Affine, mesh: Mesh):
    """This rank's block of the elements of batched limb points, on its
    device."""
    n = p.infinity.shape[0]
    return _shard(p, n, mesh), _shard(q, n, mesh)


def shard_points_rns(p: rlines.G1Affine, q: rlines.G2Affine, mesh: Mesh):
    """This rank's block of the packed rows of RNS points (two elements a
    row), on its device."""
    n = p.infinity.shape[0]
    return _shard(p, n, mesh), _shard(q, n, mesh)


def _local(mesh: Mesh, *pts) -> None:
    """Raise unless every tensor of the points lies on the mesh's device."""
    for pt in pts:
        for k in ("x", "y", "infinity"):
            t = getattr(pt, k)
            if t.device != mesh.device:
                raise ValueError(f"a shard on {t.device}, the mesh's device is "
                                 f"{mesh.device}: place it with shard_points")


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `t` (equal shapes), in rank order: the whole
    batch. One collective; none on the trivial mesh with no process group."""
    if mesh.group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    collectives["all_gather"] += 1
    return torch.cat(parts, dim=0)


def _fold(e: torch.Tensor, one: torch.Tensor, mul) -> torch.Tensor:
    """Pad the leading axis with ones to a power of two, then fold it in
    halves, e[:half] * e[half:], down to one row."""
    b = e.shape[0]
    size = 1
    while size < b:
        size *= 2
    if size != b:
        e = torch.cat([e, one.expand(size - b, *e.shape[1:])], dim=0)
    while size > 1:
        half = size // 2
        e = mul(e[:half], e[half:size])
        size = half
    return e


def product_tree(e: torch.Tensor) -> torch.Tensor:
    """Fq12 product over the leading (batch) axis of limb rows, as a
    log-depth fold (non-power-of-two batches padded with ones)."""
    return _fold(e, fq12.one((), e.device), fq12.mul)[0]


def rns_product_tree(e: torch.Tensor) -> torch.Tensor:
    """Fq12 product over all packed instances of RNS rows: the log-depth row
    folds, then one cross-slot fold (a 64-lane roll swaps the two packed
    slots). The product stands in both slots of the (12, LANES) result."""
    row = _fold(e, tower.one((), e.device), tower.mul)[0:1]
    swapped = torch.roll(row, RC.SUB, dims=-1)
    return tower.mul(row, swapped)[0]


# ---------------------------------------------------------------------------
# Limb tier
# ---------------------------------------------------------------------------


def pairing_sharded(mesh: Mesh):
    """The batched pairing on this rank's shard: its e rows (no collective)."""
    def run(p: G1Affine, q: G2Affine) -> torch.Tensor:
        _local(mesh, p, q)
        return mp.pairing(p, q)
    return run


def multi_pairing_product(p: G1Affine, q: G2Affine) -> torch.Tensor:
    """prod_i e(P_i, Q_i) over the batch: per-instance Miller values, their
    product tree, one final exponentiation."""
    f = mp.miller_loop(p, mp.prepare_g2(q), q.infinity)
    return mp.final_exponentiation(product_tree(f))


def multi_pairing_product_sharded(mesh: Mesh):
    """multi_pairing_product over the whole batch from this rank's shard:
    the shard's Miller values, one all_gather, then the tree and the final
    exponentiation on every rank."""
    def run(p: G1Affine, q: G2Affine) -> torch.Tensor:
        _local(mesh, p, q)
        f = mp.miller_loop(p, mp.prepare_g2(q), q.infinity)
        return mp.final_exponentiation(product_tree(_all_gather(mesh, f)))
    return run


def pairing_and_product(p: G1Affine, q: G2Affine):
    """Per-instance pairings and their product from one G2 preparation and
    Miller loop: the final exponentiation is multiplicative, so the product
    tree runs on the finished pairings."""
    e = mp.pairing(p, q)
    return e, product_tree(e)


def pairing_and_product_sharded(mesh: Mesh):
    """(this rank's e shard, the whole batch's product): one all_gather."""
    def run(p: G1Affine, q: G2Affine):
        _local(mesh, p, q)
        e = mp.pairing(p, q)
        return e, product_tree(_all_gather(mesh, e))
    return run


# ---------------------------------------------------------------------------
# RNS tier (the production path): the same plan over packed rows
# ---------------------------------------------------------------------------


def _rns_pairing(p: rlines.G1Affine, q: rlines.G2Affine) -> torch.Tensor:
    coeffs = mpr.prepare_g2_stepmajor(q)
    f = mpr.miller_loop(p, coeffs, q.infinity)
    return mpr.final_exponentiation(f)


def rns_pairing_and_product(p: rlines.G1Affine, q: rlines.G2Affine):
    """The RNS analogue of pairing_and_product: per-instance pairings (the
    split prepare_g2_stepmajor -> miller_loop path) and their product."""
    e = _rns_pairing(p, q)
    return e, rns_product_tree(e)


def rns_pairing_and_product_sharded(mesh: Mesh):
    """(this rank's e rows, the whole batch's product (12, LANES)): the
    shard's pairings, one all_gather of the e rows, the product tree on
    every rank."""
    def run(p: rlines.G1Affine, q: rlines.G2Affine):
        _local(mesh, p, q)
        e = _rns_pairing(p, q)
        return e, rns_product_tree(_all_gather(mesh, e))
    return run
