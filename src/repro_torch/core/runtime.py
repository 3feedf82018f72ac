"""The collective facade of the distributed filter (port of
``repro.core.runtime``), with one backend: an emulated P-shard mesh on
one device.

The reference runs each DRA as a per-shard program under ``shard_map``
(or, in its tier-1 tests, under ``vmap`` with an ``axis_name``:
``tests/emesh.py``).  The port writes the shard axis out: every
per-shard tensor carries a shard dim of size ``P``, the distributed
ensemble is one ``(P, C, ...)`` ensemble on the card, and each collective
below acts on that dim.  A ``FilterBank`` over the mesh puts its member
dims in front of it (``EmulatedMesh.lead``: ``(B, P, C, ...)``, where the
reference ``vmap``s the per-shard program over members), and the
collectives act on the shard dim behind them, for every member at once:

* ``psum``/``pmax`` — a fixed-order reduction over the shard dim (shard 0
  first), broadcast back to every shard;
* ``all_gather`` — every shard receives the ``(P, ...)`` stack;
* ``ppermute`` — shard ``dst`` receives shard ``src``'s block (the ring
  is a roll along the shard dim);
* ``all_to_all`` — shard ``i`` receives block ``i`` of every shard: a
  transpose of the ``(P, P, ...)`` blocks;
* ``axis_index`` is ``arange(P)`` and ``axis_size`` is ``P``.

Each collective gives a member the bits it gives the same values without
the bank.  ``make_mesh`` builds an emulated mesh of named axes (the
bank's 2-D ``(bank, data)`` layout); ``butterfly_schedule`` gives the
butterfly DRA's distance-doubling partner stages, and
``grouped_ppermute`` moves a pytree along one of them.  A
``torch.distributed`` (NCCL) backend, where each card holds one shard,
waits for a later slice (ROADMAP A8b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class EmulatedMesh:
    """``shards`` emulated shards of one mesh axis on one device (the
    port's stand-in for the reference's ``mesh=``).  ``lead`` is the
    shape of the member dims in front of the shard dim of every
    per-shard tensor: ``()`` for one filter, ``(B,)`` for a bank of B
    (``over``)."""

    shards: int
    axis_name: str = "data"
    lead: tuple[int, ...] = ()

    def __post_init__(self):
        if int(self.shards) < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{self.shards}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name to size, as the reference's ``Mesh.shape``."""
        return {self.axis_name: self.shards}

    def axis(self, name: str) -> "EmulatedMesh":
        """The mesh of axis ``name`` (this one)."""
        if name != self.axis_name:
            raise ValueError(f"axis {name!r} not in mesh axes "
                             f"{tuple(self.shape)}")
        return self

    def over(self, lead) -> "EmulatedMesh":
        """The same axis with member dims ``lead`` in front of the shard
        dim."""
        return dataclasses.replace(self, lead=tuple(int(v) for v in lead))


@dataclasses.dataclass(frozen=True)
class EmulatedGrid:
    """An emulated mesh of several named axes on one device (the
    counterpart of the reference's ``make_mesh``), e.g. a FilterBank's 2-D
    ``(bank, data)`` grid: members sharded over one axis, particles over
    the other.  On one card the grid is a layout; ``axis`` gives one
    axis as an ``EmulatedMesh`` for the collectives."""

    axis_shapes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_shapes) != len(self.axis_names) \
                or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis shapes {self.axis_shapes} and names "
                             f"{self.axis_names} do not pair up")
        if any(int(v) < 1 for v in self.axis_shapes):
            raise ValueError(f"every axis needs at least one shard, got "
                             f"{self.axis_shapes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name to size, as the reference's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_shapes))

    def axis(self, name: str) -> EmulatedMesh:
        """The 1-D emulated mesh of axis ``name``."""
        if name not in self.shape:
            raise ValueError(f"axis {name!r} not in mesh axes "
                             f"{self.axis_names}")
        return EmulatedMesh(self.shape[name], name)


def make_mesh(axis_shapes, axis_names) -> EmulatedGrid:
    """An emulated mesh of ``axis_shapes`` shards over ``axis_names``
    (the reference's ``make_mesh``)."""
    return EmulatedGrid(tuple(int(v) for v in axis_shapes),
                        tuple(axis_names))


def host_mesh(n: int | None = None, axis: str = "data") -> EmulatedMesh:
    """An ``n``-shard emulated mesh (the counterpart of the reference's
    ``host_mesh``, which spans ``n`` simulated host devices)."""
    return EmulatedMesh(int(n or 1), axis)


def axis_size(mesh: EmulatedMesh) -> int:
    """Number of shards ``P``."""
    return mesh.shards


def axis_index(mesh: EmulatedMesh, device=None) -> torch.Tensor:
    """Every shard's index: ``arange(P)``."""
    return torch.arange(mesh.shards, device=device)


def _check(x: torch.Tensor, mesh: EmulatedMesh) -> int:
    """Raise unless ``x`` leads with the mesh's member dims and its
    shards; return the shard dim."""
    d = len(mesh.lead)
    if tuple(x.shape[:d + 1]) != tuple(mesh.lead) + (mesh.shards,):
        raise ValueError(f"per-shard tensor needs leading dims "
                         f"{tuple(mesh.lead) + (mesh.shards,)}, got "
                         f"{tuple(x.shape)}")
    return d


def psum(x: torch.Tensor, mesh: EmulatedMesh) -> torch.Tensor:
    """Sum over shards, shard 0 first, broadcast to every shard."""
    d = _check(x, mesh)
    acc = x.select(d, 0)
    for i in range(1, mesh.shards):
        acc = acc + x.select(d, i)
    return acc.unsqueeze(d).expand(x.shape).clone()


def pmax(x: torch.Tensor, mesh: EmulatedMesh) -> torch.Tensor:
    """Max over shards, broadcast to every shard."""
    d = _check(x, mesh)
    return x.amax(d, keepdim=True).expand(x.shape).clone()


def all_gather(x: torch.Tensor, mesh: EmulatedMesh) -> torch.Tensor:
    """``(P, ...)`` per-shard values -> ``(P, P, ...)``: every shard holds
    the stack of all shards' values."""
    d = _check(x, mesh)
    shape = tuple(x.shape)
    return x.unsqueeze(d).expand(shape[:d] + (mesh.shards,)
                                 + shape[d:]).clone()


def ppermute(x: torch.Tensor, mesh: EmulatedMesh,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Shard ``dst`` receives shard ``src``'s block for each ``(src, dst)``
    of ``perm``; a shard that receives nothing gets zeros."""
    d = _check(x, mesh)
    out = torch.zeros_like(x)
    if perm:
        src, dst = (torch.tensor(v, device=x.device) for v in zip(*perm))
        out.index_copy_(d, dst, x.index_select(d, src))
    return out


def ring(mesh: EmulatedMesh) -> list[tuple[int, int]]:
    """The ring ``i -> i + 1 (mod P)``."""
    p = mesh.shards
    return [(i, (i + 1) % p) for i in range(p)]


def butterfly_schedule(p: int) -> list[list[tuple[int, int]]]:
    """The ``log2(p)`` distance-doubling stages: stage ``s`` pairs shard
    ``i`` with ``i XOR 2**s`` (each stage a full ``ppermute``
    permutation).  ``p`` must be a power of two."""
    if p < 1 or (p & (p - 1)):
        raise ValueError(f"butterfly topology needs a power-of-two shard "
                         f"count, got {p}")
    return [[(i, i ^ (1 << s)) for i in range(p)]
            for s in range(p.bit_length() - 1)]


def grouped_ppermute(tree: Any, mesh: EmulatedMesh,
                     perm: Sequence[tuple[int, int]]) -> Any:
    """``ppermute`` every tensor of a tuple/list/dict along one
    permutation (one logical exchange)."""
    if isinstance(tree, torch.Tensor):
        return ppermute(tree, mesh, perm)
    if isinstance(tree, dict):
        return {k: grouped_ppermute(v, mesh, perm) for k, v in tree.items()}
    return type(tree)(grouped_ppermute(v, mesh, perm) for v in tree)


def all_to_all(x: torch.Tensor, mesh: EmulatedMesh) -> torch.Tensor:
    """``(P, P, ...)`` blocks, shard ``i`` sending ``x[i, j]`` to shard
    ``j`` -> shard ``j`` holds ``x[:, j]`` in sender order."""
    d = _check(x, mesh)
    if x.dim() < d + 2 or x.shape[d + 1] != mesh.shards:
        raise ValueError(f"all_to_all needs (P, P, ...) blocks, got "
                         f"{tuple(x.shape)}")
    return x.transpose(d, d + 1).contiguous()


def tree_bytes(tree: Any) -> int:
    """Payload bytes of a tensor or a tuple/list/dict of tensors — the
    unit of the comm-volume accounting (the reference's DESIGN.md
    §14.3)."""
    if isinstance(tree, torch.Tensor):
        return math.prod(tree.shape) * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    raise TypeError(f"tree_bytes of {type(tree).__name__}")
