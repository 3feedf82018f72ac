"""The collective facade of the distributed filter (port of
``repro.core.runtime``), with one backend: an emulated P-shard mesh on
one device.

The reference runs each DRA as a per-shard program under ``shard_map``
(or, in its tier-1 tests, under ``vmap`` with an ``axis_name``:
``tests/emesh.py``).  The port writes the shard axis out: every
per-shard tensor carries a leading dim of size ``P``, the distributed
ensemble is one ``(P, C, ...)`` ensemble on the card, and each collective
below acts on that leading dim:

* ``psum``/``pmax`` — a fixed-order reduction over dim 0 (shard 0 first),
  broadcast back to every shard;
* ``all_gather`` — every shard receives the ``(P, ...)`` stack;
* ``ppermute`` — shard ``dst`` receives shard ``src``'s block (the ring
  is a roll along dim 0);
* ``all_to_all`` — shard ``i`` receives block ``i`` of every shard: a
  transpose of the ``(P, P, ...)`` blocks;
* ``axis_index`` is ``arange(P)`` and ``axis_size`` is ``P``.

``butterfly_schedule`` gives the butterfly DRA's distance-doubling
partner stages, and ``grouped_ppermute`` moves a pytree along one of
them.  A ``torch.distributed`` (NCCL) backend, where each card holds one
shard, waits for a later slice (ROADMAP A8b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class EmulatedMesh:
    """``shards`` emulated shards of one mesh axis on one device (the
    port's stand-in for the reference's ``mesh=``)."""

    shards: int
    axis_name: str = "data"

    def __post_init__(self):
        if int(self.shards) < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{self.shards}")


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


def _check(x: torch.Tensor, mesh: EmulatedMesh) -> None:
    if x.dim() == 0 or x.shape[0] != mesh.shards:
        raise ValueError(f"per-shard tensor needs a leading dim of "
                         f"{mesh.shards} shards, got {tuple(x.shape)}")


def psum(x: torch.Tensor, mesh: EmulatedMesh) -> torch.Tensor:
    """Sum over shards, shard 0 first, broadcast to every shard."""
    _check(x, mesh)
    acc = x[0]
    for i in range(1, mesh.shards):
        acc = acc + x[i]
    return acc.expand(x.shape).clone()


def pmax(x: torch.Tensor, mesh: EmulatedMesh) -> torch.Tensor:
    """Max over shards, broadcast to every shard."""
    _check(x, mesh)
    return x.amax(0, keepdim=True).expand(x.shape).clone()


def all_gather(x: torch.Tensor, mesh: EmulatedMesh) -> torch.Tensor:
    """``(P, ...)`` per-shard values -> ``(P, P, ...)``: every shard holds
    the stack of all shards' values."""
    _check(x, mesh)
    return x.unsqueeze(0).expand((mesh.shards,) + tuple(x.shape)).clone()


def ppermute(x: torch.Tensor, mesh: EmulatedMesh,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Shard ``dst`` receives shard ``src``'s block for each ``(src, dst)``
    of ``perm``; a shard that receives nothing gets zeros."""
    _check(x, mesh)
    out = torch.zeros_like(x)
    if perm:
        src, dst = zip(*perm)
        out[list(dst)] = x[list(src)]
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
    _check(x, mesh)
    if x.dim() < 2 or x.shape[1] != mesh.shards:
        raise ValueError(f"all_to_all needs (P, P, ...) blocks, got "
                         f"{tuple(x.shape)}")
    return x.transpose(0, 1).contiguous()


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
