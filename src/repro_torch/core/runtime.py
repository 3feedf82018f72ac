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

A ``ProcessGrid`` lays the ranks out on a grid of named axes, row-major
(the reference's ``make_mesh``); ``axis(name)`` is the ``ProcessMesh`` of
this rank's line along that axis, whose verbs run on the line's own
process group, with the line's size as ``P`` and the rank's place on the
line as its shard.

The sharded LM (``launch.sharding``) adds tiled verbs and differentiable
forms: ``all_gather_tiled``, ``psum_scatter`` (shard-0-first sums, one
``all_to_all`` on a process mesh) and ``pmean``; ``fsdp_gather`` (its
backward reduce-scatters), Megatron's ``tp_copy`` (``f``: identity, the
gradient summed) and ``tp_reduce`` (``g``: the sum, the gradient as it
is), ``tp_mean``, the ``tp_scatter``/``tp_gather`` pair, and
``all_to_all_grad`` (its own inverse backward).

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


def _need_group(what: str) -> None:
    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError(f"a {what} needs an initialized process group "
                           f"(repro_torch.launch.mesh.init_process_mesh)")


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """One mesh axis over the ranks of a ``torch.distributed`` process
    group, one shard a rank: ``group=None`` is the initialized default
    group, else a sub-group of it (a ``ProcessGrid``'s line).  ``shards``
    is the group's size and ``rank`` this process's rank in it (its
    shard).  Every per-shard tensor of a rank keeps a shard dim of size 1
    behind the member dims ``lead``.  ``transport`` is the group's
    backend, ``"nccl"`` (CUDA tensors, one card a rank) or ``"gloo"``
    (host tensors; a CUDA tensor is staged through host memory)."""

    transport: str
    axis_name: str = "data"
    lead: tuple[int, ...] = ()
    staged: Staged = dataclasses.field(default_factory=Staged, compare=False,
                                       repr=False)
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    shards: int = dataclasses.field(init=False)
    rank: int = dataclasses.field(init=False)

    def __post_init__(self):
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r} "
                             f"({TRANSPORTS})")
        _need_group("ProcessMesh")
        backend = str(tdist.get_backend(self.group))
        if backend != self.transport:
            raise ValueError(f"transport {self.transport!r} but the process "
                             f"group's backend is {backend!r}")
        object.__setattr__(self, "shards", tdist.get_world_size(self.group))
        object.__setattr__(self, "rank", tdist.get_rank(self.group))

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


def _global_rank(mesh: ProcessMesh, shard: int) -> int:
    """The world rank of shard ``shard`` of ``mesh``'s group."""
    if mesh.group is None:
        return shard
    return tdist.get_global_rank(mesh.group, shard)


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


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """The ranks of the initialized default process group on a grid of
    named axes, the process counterpart of ``EmulatedGrid``: rank ``r``
    sits at ``np.unravel_index(r, axis_shapes)`` (row-major, as the
    reference's ``make_mesh`` reshapes its devices), so
    ``prod(axis_shapes)`` must be the world size.  ``axis(name)`` is the
    ``ProcessMesh`` of this rank's line along ``name``: the ranks that
    share every other coordinate, in order along the axis, on a process
    group of their own.  Every line's group is built here, by every rank,
    in one order (axes in order, lines row-major), as
    ``torch.distributed.new_group`` requires.  All the views share one
    staged-byte count."""

    transport: str
    axis_shapes: tuple[int, ...]
    axis_names: tuple[str, ...]
    staged: Staged = dataclasses.field(default_factory=Staged, compare=False,
                                       repr=False)
    rank: int = dataclasses.field(init=False)
    coords: tuple[int, ...] = dataclasses.field(init=False)
    lines: dict = dataclasses.field(init=False, compare=False, repr=False)

    def __post_init__(self):
        shapes = tuple(int(v) for v in self.axis_shapes)
        names = tuple(self.axis_names)
        object.__setattr__(self, "axis_shapes", shapes)
        object.__setattr__(self, "axis_names", names)
        EmulatedGrid(shapes, names)                   # the same validation
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r} "
                             f"({TRANSPORTS})")
        _need_group("ProcessGrid")
        world = tdist.get_world_size()
        if math.prod(shapes) != world:
            raise ValueError(f"grid {dict(zip(names, shapes))} holds "
                             f"{math.prod(shapes)} ranks but the world has "
                             f"{world}")
        rank = tdist.get_rank()
        lines = {}
        for a, name in enumerate(names):
            rest = shapes[:a] + shapes[a + 1:]
            for line in range(math.prod(rest)):
                other = _unravel(line, rest)
                ranks = [_ravel(other[:a] + (i,) + other[a:], shapes)
                         for i in range(shapes[a])]
                group = tdist.new_group(ranks)
                if rank in ranks:
                    lines[name] = ProcessMesh(self.transport, name,
                                              staged=self.staged, group=group)
        object.__setattr__(self, "rank", rank)
        object.__setattr__(self, "coords", _unravel(rank, shapes))
        object.__setattr__(self, "lines", lines)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name to size, as the reference's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_shapes))

    def axis(self, name: str) -> ProcessMesh:
        """The ``ProcessMesh`` of this rank's line along axis ``name``."""
        if name not in self.lines:
            raise ValueError(f"axis {name!r} not in mesh axes "
                             f"{self.axis_names}")
        return self.lines[name]


# every mesh type the entry points take
MESHES = (EmulatedMesh, EmulatedGrid, ProcessMesh, ProcessGrid)


def _unravel(i: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    """Row-major coordinates of flat index ``i`` in ``shape``."""
    out = []
    for n in reversed(shape):
        out.append(i % n)
        i //= n
    return tuple(reversed(out))


def _ravel(coords: tuple[int, ...], shape: tuple[int, ...]) -> int:
    i = 0
    for c, n in zip(coords, shape):
        i = i * n + c
    return i


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
    """Number of shards ``P`` (the group's size on a ``ProcessMesh``)."""
    return mesh.shards


def shard_range(mesh: Mesh) -> range:
    """The indices on the axis of the shards this process holds: every
    shard of an emulated mesh, ``[rank]`` (the rank in the axis's group)
    on a process mesh."""
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


def _host_buffer(shape, dtype, pinned: bool) -> torch.Tensor:
    """An empty host tensor, page-locked when it stages a CUDA tensor
    (its copies to and from the card then run at the DMA engines' rate;
    torch's host allocator caches the pages)."""
    return torch.empty(shape, dtype=dtype, pin_memory=pinned)


def _wire(x: torch.Tensor, mesh: ProcessMesh,
          copy: bool = False) -> torch.Tensor:
    """``x`` as the transport carries it, contiguous (a copy with
    ``copy``): a CUDA tensor on gloo is staged to page-locked host memory
    (counted in ``mesh.staged``)."""
    dev = _wire_device(x, mesh)
    if x.device != dev:
        mesh.staged.bytes += x.numel() * x.element_size()
        return _host_buffer(x.shape, x.dtype, True).copy_(x)
    return x.to(dev, copy=copy).contiguous()


def _unwire(y: torch.Tensor, like: torch.Tensor,
            mesh: ProcessMesh) -> torch.Tensor:
    """A received ``y`` back on ``like``'s device (staged back from host
    memory on gloo)."""
    if y.device != like.device:
        mesh.staged.bytes += y.numel() * y.element_size()
        return y.to(like.device)
    return y


def _exchange(sends: dict, recvs: dict, mesh: ProcessMesh) -> None:
    """One batch of point-to-point messages on the mesh's group: ``sends``
    and ``recvs`` map a shard to the tensor sent to it or received from
    it."""
    ops = [tdist.P2POp(tdist.isend, t, _global_rank(mesh, q), mesh.group)
           for q, t in sends.items()]
    ops += [tdist.P2POp(tdist.irecv, t, _global_rank(mesh, q), mesh.group)
            for q, t in recvs.items()]
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()


def _gathered(x: torch.Tensor, mesh: ProcessMesh, d: int) -> torch.Tensor:
    """``(lead..., 1, ...)`` -> ``(lead..., P, ...)``: every rank's shard in
    rank order: one ``all_gather_into_tensor`` of the flat shard on nccl;
    on gloo, whose all-gather moves a fraction of the bytes a second that
    its point-to-point messages do, one batch of messages to and from
    every other rank."""
    own = x.select(d, 0)
    wire = _wire(own, mesh).reshape(-1)
    out = _host_buffer((mesh.shards, wire.numel()), wire.dtype,
                       x.device.type == "cuda") \
        if mesh.transport == "gloo" else wire.new_empty((mesh.shards,
                                                        wire.numel()))
    if mesh.transport == "gloo":
        out[mesh.rank] = wire
        others = [q for q in range(mesh.shards) if q != mesh.rank]
        _exchange({q: wire for q in others}, {q: out[q] for q in others},
                  mesh)
    else:
        tdist.all_gather_into_tensor(out.view(-1), wire, group=mesh.group)
    out = _unwire(out, x, mesh).reshape((mesh.shards,) + tuple(own.shape))
    return out.movedim(0, d)


def gather_shards(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every shard's ``(lead..., P, C, ...)`` values on every process (for
    checks): ``x`` itself on an emulated mesh."""
    d = _check(x, mesh)
    if isinstance(mesh, ProcessMesh):
        return _gathered(x, mesh, d)
    return x


def from_shard(x: torch.Tensor, mesh: Mesh, src: int) -> torch.Tensor:
    """Shard ``src``'s value of a per-shard ``(lead..., P, ...)`` tensor,
    on every shard (``(lead..., ...)``): one broadcast from shard ``src``
    on a process mesh."""
    d = _check(x, mesh)
    if not isinstance(mesh, ProcessMesh):
        return x.select(d, src)
    own = x.select(d, 0)
    if mesh.rank == src:
        buf = _wire(own, mesh, copy=True)
    else:
        buf = torch.empty(own.shape, dtype=own.dtype,
                          device=_wire_device(own, mesh))
    tdist.broadcast(buf, src=_global_rank(mesh, src), group=mesh.group)
    return _unwire(buf, own, mesh)


def shard0(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Shard 0's value of a per-shard ``(lead..., P, ...)`` tensor, on
    every shard (``(lead..., ...)``)."""
    return from_shard(x, mesh, 0)


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
    # the peers are shards of the axis: the messages go to their world
    # ranks, on the axis's group
    ops, buf = [], None
    if send:
        ops.append(tdist.P2POp(tdist.isend, _wire(x, mesh),
                               _global_rank(mesh, send[0]), mesh.group))
    if recv:
        buf = torch.empty(x.shape, dtype=x.dtype,
                          device=_wire_device(x, mesh))
        ops.append(tdist.P2POp(tdist.irecv, buf,
                               _global_rank(mesh, recv[0]), mesh.group))
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
    got = _host_buffer(blocks.shape, blocks.dtype, x.device.type == "cuda") \
        if mesh.transport == "gloo" else torch.empty_like(blocks)
    tdist.all_to_all_single(got, blocks, group=mesh.group)
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


# ---------------------------------------------------------------------------
# Tiled gathers, reduce-scatter and means (the sharded LM's verbs)
# ---------------------------------------------------------------------------

def _block_dim(x: torch.Tensor, mesh: Mesh, axis: int) -> int:
    """The dim of the shard-stripped value that ``axis`` of the per-shard
    ``x`` names (``axis`` counts ``x``'s dims and lies behind the shard
    dim)."""
    d = _check(x, mesh)
    axis = axis % x.dim()
    if axis <= d:
        raise ValueError(f"axis {axis} is not behind the shard dim {d}")
    return axis - 1


def _summed(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The shard-0-first sum of every shard's value (``psum``'s order),
    without the shard dim."""
    d = len(mesh.lead)
    every = gather_shards(x, mesh)
    acc = every.select(d, 0)
    for i in range(1, mesh.shards):
        acc = acc + every.select(d, i)
    return acc


def _held_blocks(full: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Block ``i`` (of ``P`` equal blocks along ``dim``) of ``full`` for
    every shard ``i`` this process holds, stacked on the shard dim."""
    p = mesh.shards
    if full.shape[dim] % p:
        raise ValueError(f"dim {dim} of size {full.shape[dim]} does not "
                         f"split into {p} blocks")
    n = full.shape[dim] // p
    d = len(mesh.lead)
    return torch.stack([full.narrow(dim, i * n, n)
                        for i in shard_range(mesh)], d)


def all_gather_tiled(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """Every shard's block concatenated along ``axis`` in shard order, on
    every shard (the reference's ``all_gather(..., tiled=True)``)."""
    dim = _block_dim(x, mesh, axis)
    d = len(mesh.lead)
    every = gather_shards(x, mesh)                # (lead..., P, block...)
    # the shard dim beside the one it tiles, shard-major: one reshape
    full = every.movedim(d, dim)
    shape = full.shape[:dim] + (-1,) + full.shape[dim + 2:]
    full = full.reshape(shape).unsqueeze(d)
    if isinstance(mesh, ProcessMesh):
        return full
    return full.expand(x.shape[:d + 1] + full.shape[d + 1:]).clone()


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """Reduce-scatter: the sum over shards (``psum``'s shard-0-first
    order, so every run gives the same bits) split into ``P`` equal
    blocks along ``axis``; shard ``i`` keeps block ``i`` (the reference's
    ``psum_scatter(..., tiled=True)``).  On a process mesh one
    ``all_to_all`` sends block ``j`` of every shard to shard ``j``, which
    adds what it receives in shard order: the emulated mesh's bits at a
    ``P``-th of a gather's traffic."""
    dim = _block_dim(x, mesh, axis)
    if not isinstance(mesh, ProcessMesh):
        return _held_blocks(_summed(x, mesh), mesh, dim)
    d, p = len(mesh.lead), mesh.shards
    own = x.select(d, 0)
    if own.shape[dim] % p:
        raise ValueError(f"dim {dim} of size {own.shape[dim]} does not "
                         f"split into {p} blocks")
    blocks = own.unflatten(dim, (p, own.shape[dim] // p)).movedim(dim, d)
    got = all_to_all(blocks.unsqueeze(d), mesh)
    acc = got.select(d + 1, 0)
    for i in range(1, p):
        acc = acc + got.select(d + 1, i)
    return acc


def pmean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mean over shards: ``psum`` (shard 0 first) divided by ``P``."""
    return psum(x, mesh) / mesh.shards


def _own_blocks(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """Shard ``i``'s own block ``i`` (of ``P`` along ``axis``) of its own
    value: no communication."""
    dim = _block_dim(x, mesh, axis)
    d = len(mesh.lead)
    r = shard_range(mesh)
    n = x.shape[axis] // mesh.shards
    return torch.stack([x.select(d, j).narrow(dim, i * n, n)
                        for j, i in enumerate(r)], d)


# ---------------------------------------------------------------------------
# Differentiable collectives: each verb paired with its backward
# ---------------------------------------------------------------------------
#
# The sharded LM differentiates through its collectives.  Each rank seeds
# its backward with its own loss; the gradients a rank's blocks receive
# are then summed over the ranks that saw different tokens (the batch
# axes) by the FSDP gather's backward, while ranks along ``model`` hold
# the same tokens and compute one loss between them.  Hence two kinds of
# pair: the FSDP gather (blocks in, a copy a rank out, used on different
# tokens) reduce-scatters its gradient, and Megatron's ``f`` (identity,
# then a sum of the partial gradients) and ``g`` (a sum of partial
# products, then the gradient as it is) bracket a tensor-parallel region.

class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_gather_tiled(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return psum_scatter(grad, ctx.mesh, ctx.axis), None, None


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_gather_tiled(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _own_blocks(grad, ctx.mesh, ctx.axis), None, None


class _TpScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return psum_scatter(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_tiled(grad, ctx.mesh, ctx.axis), None, None


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad, ctx.mesh), None


class _TpReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, mean):
        ctx.mean = mean
        return pmean(x, mesh) if mean else psum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_to_all(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad.contiguous(), ctx.mesh), None


def fsdp_gather(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """``all_gather_tiled`` whose backward reduce-scatters (``psum_scatter``
    along ``axis``): each shard's block gathered for use on that shard's
    own tokens, its gradient the sum of every shard's."""
    return _FsdpGather.apply(x, mesh, axis)


def tp_copy(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's ``f``: the identity, whose backward sums the shards'
    partial gradients (``psum``); a replicated tensor entering a
    tensor-parallel region."""
    return _TpCopy.apply(x, mesh)


def tp_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's ``g``: ``psum`` of the shards' partial values, whose
    backward passes the (replicated) gradient on as it is."""
    return _TpReduce.apply(x, mesh, False)


def tp_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``pmean`` whose backward passes the gradient on as it is: a value
    each shard computed on its own tokens, averaged for a loss that every
    shard then counts once between the ranks of a batch line."""
    return _TpReduce.apply(x, mesh, True)


def tp_scatter(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """``psum_scatter`` of partial values whose backward all-gathers the
    blocks' gradients (a reduce-scatter leaving a tensor-parallel
    region, as ``tp_reduce`` does for a whole tensor)."""
    return _TpScatter.apply(x, mesh, axis)


def tp_gather(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """``all_gather_tiled`` of blocks into a replicated tensor whose
    backward keeps each shard's own block of the gradient (the pair of
    ``tp_scatter``)."""
    return _TpGather.apply(x, mesh, axis)


def all_to_all_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``all_to_all`` whose backward is the inverse ``all_to_all`` (itself:
    block ``(i, j)`` goes to shard ``j`` and its gradient comes back)."""
    return _AllToAll.apply(x, mesh)
