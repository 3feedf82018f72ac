"""The collective facade of the distributed filter (port of
``repro.core.runtime``), with two backends: an emulated P-shard mesh on
one device, and one process per shard over a ``torch.distributed``
process group.

The reference runs each DRA as a per-shard program under ``shard_map``
(or, in its tier-1 tests, under ``vmap`` with an ``axis_name``:
``tests/emesh.py``).  The port writes the shard axis out: every
per-shard tensor carries a shard dim, and each collective below acts on
that dim.  On an ``EmulatedMesh`` the dim has size ``P``: the
distributed ensemble is one ``(P, C, ...)`` ensemble on the card.  A
``FilterBank`` over the mesh puts its member dims in front of it
(``lead``: ``(B, P, C, ...)``, where the reference ``vmap``s the
per-shard program over members), and the collectives act on the shard
dim behind them, for every member at once:

* ``psum``/``pmax`` — a fixed-order reduction over the shard dim (shard 0
  first), broadcast back to every shard;
* ``all_gather`` — every shard receives the ``(P, ...)`` stack;
* ``ppermute`` — shard ``dst`` receives shard ``src``'s block (the ring
  is a roll along the shard dim);
* ``all_to_all`` — shard ``i`` receives block ``i`` of every shard: a
  transpose of the ``(P, P, ...)`` blocks;
* ``axis_index`` is ``arange(P)`` and ``axis_size`` is ``P``.

On a ``ProcessMesh`` each rank holds one shard, so the shard dim has size
1 (``(lead..., 1, C, ...)``: the DRA code's shapes do not change), and
each verb gives a rank the bits the emulated mesh gives that shard on the
same values.  A float ``psum`` is an all-gather followed by the same
shard-0-first sequence of adds, never a float ``all_reduce``, whose order
depends on the library's algorithm; ``pmax`` takes ``amax`` over the
gathered stack; ``ppermute`` is one batch of point-to-point sends and
receives (a shard that sends to itself copies); ``all_to_all`` is
``all_to_all_single``.  ``axis_size`` stays the global ``P`` and
``axis_index`` is ``[rank]``.  The ``"nccl"`` transport carries CUDA
tensors; ``"gloo"`` carries host tensors, and stages a CUDA tensor
through host memory around each verb, counting the bytes
(``ProcessMesh.staged``).  The backend never changes transport or
device on its own.

Each collective gives a member the bits it gives the same values without
the bank.  ``make_mesh`` builds an emulated mesh of named axes (the
bank's 2-D ``(bank, data)`` layout); ``butterfly_schedule`` gives the
butterfly DRA's distance-doubling partner stages, and
``grouped_ppermute`` moves a pytree along one of them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.distributed as tdist

TRANSPORTS = ("nccl", "gloo")


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


class Staged:
    """Bytes a ``ProcessMesh`` on the gloo transport copied between the
    card and host memory (both directions), shared by every view of the
    mesh (``over``)."""

    def __init__(self):
        self.bytes = 0


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """One mesh axis over the ranks of the initialized default
    ``torch.distributed`` process group, one shard a rank: ``shards`` is
    the world size and ``rank`` this process's shard.
    Every per-shard tensor of a rank keeps a shard dim of size 1 behind
    the member dims ``lead``.  ``transport`` is the group's backend,
    ``"nccl"`` (CUDA tensors, one card a rank) or ``"gloo"`` (host
    tensors; a CUDA tensor is staged through host memory)."""

    transport: str
    axis_name: str = "data"
    lead: tuple[int, ...] = ()
    staged: Staged = dataclasses.field(default_factory=Staged, compare=False,
                                       repr=False)
    shards: int = dataclasses.field(init=False)
    rank: int = dataclasses.field(init=False)

    def __post_init__(self):
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r} "
                             f"({TRANSPORTS})")
        if not (tdist.is_available() and tdist.is_initialized()):
            raise RuntimeError("a ProcessMesh needs an initialized process "
                               "group (repro_torch.launch.mesh."
                               "init_process_mesh)")
        backend = str(tdist.get_backend())
        if backend != self.transport:
            raise ValueError(f"transport {self.transport!r} but the process "
                             f"group's backend is {backend!r}")
        object.__setattr__(self, "shards", tdist.get_world_size())
        object.__setattr__(self, "rank", tdist.get_rank())

    @property
    def shape(self) -> dict[str, int]:
        """Axis name to size, as the reference's ``Mesh.shape``."""
        return {self.axis_name: self.shards}

    def axis(self, name: str) -> "ProcessMesh":
        """The mesh of axis ``name`` (this one)."""
        if name != self.axis_name:
            raise ValueError(f"axis {name!r} not in mesh axes "
                             f"{tuple(self.shape)}")
        return self

    def over(self, lead) -> "ProcessMesh":
        """The same axis with member dims ``lead`` in front of the shard
        dim (the same staging count)."""
        return dataclasses.replace(self, lead=tuple(int(v) for v in lead))


Mesh = EmulatedMesh | ProcessMesh


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


def axis_size(mesh: Mesh) -> int:
    """Number of shards ``P`` (the world size on a ``ProcessMesh``)."""
    return mesh.shards


def shard_range(mesh: Mesh) -> range:
    """The global indices of the shards this process holds: every shard
    of an emulated mesh, ``[rank]`` on a process mesh."""
    if isinstance(mesh, ProcessMesh):
        return range(mesh.rank, mesh.rank + 1)
    return range(mesh.shards)


def axis_index(mesh: Mesh, device=None) -> torch.Tensor:
    """The index of every shard this process holds: ``arange(P)``, or
    ``[rank]``."""
    r = shard_range(mesh)
    return torch.arange(r.start, r.stop, device=device)


def own_shards(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This process's shards of a value that holds every shard's along
    ``dim`` (``(..., P, ...)``, e.g. a replicated schedule's rows): all of
    it on an emulated mesh, the rank's one row (a view) on a process
    mesh."""
    if isinstance(mesh, ProcessMesh):
        return x.narrow(dim, mesh.rank, 1)
    return x


def _check(x: torch.Tensor, mesh: Mesh) -> int:
    """Raise unless ``x`` leads with the mesh's member dims and the shards
    this process holds; return the shard dim."""
    d = len(mesh.lead)
    want = tuple(mesh.lead) + (len(shard_range(mesh)),)
    if tuple(x.shape[:d + 1]) != want:
        raise ValueError(f"per-shard tensor needs leading dims {want}, got "
                         f"{tuple(x.shape)}")
    return d


# ---------------------------------------------------------------------------
# The process-group transport
# ---------------------------------------------------------------------------

def _wire_device(x: torch.Tensor, mesh: ProcessMesh) -> torch.device:
    """Where the transport carries ``x``: the card for nccl (a host tensor
    raises), host memory for gloo."""
    if mesh.transport == "nccl":
        if x.device.type != "cuda":
            raise ValueError(f"the nccl transport carries CUDA tensors, got "
                             f"one on {x.device}")
        return x.device
    return torch.device("cpu")


def _wire(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """``x`` as the transport carries it, contiguous: a CUDA tensor on
    gloo is staged to host memory (counted in ``mesh.staged``)."""
    dev = _wire_device(x, mesh)
    if x.device != dev:
        mesh.staged.bytes += x.numel() * x.element_size()
    return x.to(dev).contiguous()


def _unwire(y: torch.Tensor, like: torch.Tensor,
            mesh: ProcessMesh) -> torch.Tensor:
    """A received ``y`` back on ``like``'s device (staged back from host
    memory on gloo)."""
    if y.device != like.device:
        mesh.staged.bytes += y.numel() * y.element_size()
        return y.to(like.device)
    return y


def _gathered(x: torch.Tensor, mesh: ProcessMesh, d: int) -> torch.Tensor:
    """``(lead..., 1, ...)`` -> ``(lead..., P, ...)``: every rank's shard in
    rank order (one ``all_gather_into_tensor`` of the flat shard)."""
    own = x.select(d, 0)
    wire = _wire(own, mesh).reshape(-1)
    out = wire.new_empty((mesh.shards * wire.numel(),))
    tdist.all_gather_into_tensor(out, wire)
    out = _unwire(out, x, mesh).reshape((mesh.shards,) + tuple(own.shape))
    return out.movedim(0, d)


def gather_shards(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every shard's ``(lead..., P, C, ...)`` values on every process (for
    checks): ``x`` itself on an emulated mesh."""
    d = _check(x, mesh)
    if isinstance(mesh, ProcessMesh):
        return _gathered(x, mesh, d)
    return x


def shard0(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Shard 0's value of a per-shard ``(lead..., P, ...)`` tensor, on
    every shard (``(lead..., ...)``)."""
    return gather_shards(x, mesh).select(len(mesh.lead), 0)


# ---------------------------------------------------------------------------
# The verbs
# ---------------------------------------------------------------------------

def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over shards, shard 0 first, broadcast to every shard."""
    d = len(mesh.lead)
    every = gather_shards(x, mesh)
    acc = every.select(d, 0)
    for i in range(1, mesh.shards):
        acc = acc + every.select(d, i)
    return acc.unsqueeze(d).expand(x.shape).clone()


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Max over shards, broadcast to every shard."""
    d = len(mesh.lead)
    every = gather_shards(x, mesh)
    return every.amax(d, keepdim=True).expand(x.shape).clone()


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(P, ...)`` per-shard values -> ``(P, P, ...)``: every shard holds
    the stack of all shards' values."""
    d = len(mesh.lead)
    every = gather_shards(x, mesh)
    shape = tuple(x.shape)
    return every.unsqueeze(d).expand(shape[:d + 1] + (mesh.shards,)
                                     + shape[d + 1:]).clone()


def ppermute(x: torch.Tensor, mesh: Mesh,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Shard ``dst`` receives shard ``src``'s block for each ``(src, dst)``
    of ``perm``; a shard that receives nothing gets zeros."""
    d = _check(x, mesh)
    out = torch.zeros_like(x)
    if not perm:
        return out
    if not isinstance(mesh, ProcessMesh):
        src, dst = (torch.tensor(v, device=x.device) for v in zip(*perm))
        out.index_copy_(d, dst, x.index_select(d, src))
        return out
    r = mesh.rank
    send = [dst for src, dst in perm if src == r]
    recv = [src for src, dst in perm if dst == r]
    if send == [r]:                       # to itself: no message
        return x.clone()
    ops, buf = [], None
    if send:
        ops.append(tdist.P2POp(tdist.isend, _wire(x, mesh), send[0]))
    if recv:
        buf = torch.empty(x.shape, dtype=x.dtype,
                          device=_wire_device(x, mesh))
        ops.append(tdist.P2POp(tdist.irecv, buf, recv[0]))
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return out if buf is None else _unwire(buf, x, mesh)


def ring(mesh: Mesh) -> list[tuple[int, int]]:
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


def grouped_ppermute(tree: Any, mesh: Mesh,
                     perm: Sequence[tuple[int, int]]) -> Any:
    """``ppermute`` every tensor of a tuple/list/dict along one
    permutation (one logical exchange)."""
    if isinstance(tree, torch.Tensor):
        return ppermute(tree, mesh, perm)
    if isinstance(tree, dict):
        return {k: grouped_ppermute(v, mesh, perm) for k, v in tree.items()}
    return type(tree)(grouped_ppermute(v, mesh, perm) for v in tree)


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(P, P, ...)`` blocks, shard ``i`` sending ``x[i, j]`` to shard
    ``j`` -> shard ``j`` holds ``x[:, j]`` in sender order."""
    d = _check(x, mesh)
    if x.dim() < d + 2 or x.shape[d + 1] != mesh.shards:
        raise ValueError(f"all_to_all needs (P, P, ...) blocks, got "
                         f"{tuple(x.shape)}")
    if not isinstance(mesh, ProcessMesh):
        return x.transpose(d, d + 1).contiguous()
    # rank-major blocks: row j goes to rank j, row i of the result came
    # from rank i
    blocks = _wire(x.select(d, 0).movedim(d, 0), mesh)
    got = torch.empty_like(blocks)
    tdist.all_to_all_single(got, blocks)
    return _unwire(got, x, mesh).movedim(0, d).unsqueeze(d).contiguous()


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
