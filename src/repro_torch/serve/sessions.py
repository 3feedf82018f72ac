"""Resident filter sessions on the card (port of ``repro.serve.sessions``).

``ParticleSessionServer`` keeps a ``capacity``-slot bank resident and
steps it one frame at a time under churn: a slot allocator hands out
slots of a bank of fixed shape, and a per-slot mask makes idle slots
keep their carry bit for bit.  The step is ``filters.make_bank_step``
called eagerly (the port has no jit); a slot's carry is its rows of the
resident ``(capacity, N, ...)`` ensemble plus its own draws provider.

Lifecycle::

    server = ParticleSessionServer(model=model, sir=SIRConfig(...),
                                   capacity=8)
    h = server.attach(1)                     # a seed or a draws provider
    server.submit(h, frame)                  # copied to the card at once
    server.step()                            # every ready slot, one frame
    res = server.result(h)                   # the trajectory so far
    sus = server.suspend(h, directory=...)   # host-side snapshot, slot freed
    h2 = server.resume(sus)                  # continues bit for bit
    server.detach(h2)

A session stepped through the server reproduces the standalone
``ParallelParticleFilter.run`` trajectory with the same seed (or
provider) and frames **bit for bit**, whatever the other slots do: each
tick gathers the ready slots' rows and providers into the smallest
occupancy tier that holds them, steps that compact bank, and scatters
the rows back, and every sum and kernel of the step gives a row the same
bits in any batch (``particles.invariant_sum``, the port's kernels).  An
idle row in a tier is masked: it receives no draws
(``BankDraws.set_active``), so its stream stays frozen with its carry.

A suspended session holds host arrays only: the ensemble, the output
history and its generator's ``get_state()`` (``generator_state``), so it
resumes on a server of any capacity or mesh, through
``repro_torch.checkpoint.store`` in another process too.

The kernel wrappers keep host-side scratch per device and stream, so
every server of a process launches its device work under one lock
(``DEVICE_LOCK``): the fleet steps its banks from one worker thread
each, all on the one card.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core import filters, runtime, smc
from repro_torch.core.draws import BankDraws, TorchDraws, as_draws
from repro_torch.core.particles import ParticleEnsemble, tree_map

DEVICE_LOCK = threading.RLock()

_ENS_FIELDS = ("state", "log_weights", "counts")
_OUT_FIELDS = ("estimate", "ess", "log_marginal", "resampled", "ancestors")


def host(x) -> Any:
    """A host-side copy of a leaf: a numpy array, or a CPU tensor for
    bfloat16, which numpy cannot hold."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.array(x)


def _ens_map(fn, ens: ParticleEnsemble, *rest) -> ParticleEnsemble:
    """``fn`` leafwise over an ensemble's fields."""
    return ParticleEnsemble(*(tree_map(fn, getattr(ens, f),
                                       *(getattr(r, f) for r in rest))
                              for f in _ENS_FIELDS))


def _tensor(x, device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.array(x))).to(device)


@dataclasses.dataclass(frozen=True)
class SessionHandle:
    """Opaque ticket for one attached session: ``uid`` is server-unique
    (the server validates by it); ``slot`` is informational."""

    uid: int
    slot: int


@dataclasses.dataclass
class SuspendedSession:
    """Host-side snapshot of one session (capacity- and mesh-elastic).

    Attributes:
      generator_state: ``get_state()`` of the session's
        ``torch.Generator`` (uint8); resumed on a generator of the
        server's device.
      state: ensemble state tree, full ``(N, ...)`` host arrays.
      log_weights / counts: ``(N,)``.
      frames_done: frames filtered before suspension.
      estimates / ess / log_marginal / resampled / ancestors: the output
        history so far (leading dim ``frames_done``; ``ancestors`` has
        width 0 unless ``SIRConfig.record_ancestry``).
    """

    generator_state: np.ndarray
    state: Any
    log_weights: np.ndarray
    counts: np.ndarray
    frames_done: int
    estimates: Any
    ess: np.ndarray
    log_marginal: np.ndarray
    resampled: np.ndarray
    ancestors: np.ndarray

    def as_tree(self) -> dict:
        """The checkpointable tree (what ``save``/``load`` round-trip)."""
        return {
            "generator_state": self.generator_state, "state": self.state,
            "log_weights": self.log_weights, "counts": self.counts,
            "frames_done": np.asarray(self.frames_done),
            "estimates": self.estimates, "ess": self.ess,
            "log_marginal": self.log_marginal, "resampled": self.resampled,
            "ancestors": self.ancestors,
        }

    def save(self, directory: str) -> str:
        """Persist atomically through ``checkpoint.store`` (step =
        ``frames_done``); ``directory`` holds this one session's
        checkpoints.  Returns the final path."""
        return store.save_checkpoint(directory, self.frames_done,
                                     self.as_tree())

    @classmethod
    def load(cls, directory: str, like: "SuspendedSession",
             step: int | None = None) -> "SuspendedSession":
        """Restore from ``save``'s directory; ``like``
        (``ParticleSessionServer.blank_suspended()``) gives the tree's
        structure, the shapes come from disk; ``step`` defaults to the
        latest."""
        if step is None:
            step = store.latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {directory}")
        tree = tree_map(host, store.load_checkpoint(directory, step,
                                                    like.as_tree(), "cpu"))
        tree["frames_done"] = int(tree["frames_done"])
        return cls(**tree)


class _Outs:
    """One tick's batched outputs, copied to the host once, when a row is
    first read (``latest``/``result`` read lazily)."""

    def __init__(self, outs: smc.StepOutput):
        self._outs = tuple(getattr(outs, f) for f in _OUT_FIELDS)
        self._host = None

    def row(self, i: int) -> tuple:
        if self._host is None:
            self._host = tree_map(host, self._outs)
            self._outs = None
        return tree_map(lambda x: np.asarray(x[i]), self._host)


class _Session:
    """Server-internal per-session bookkeeping (host side)."""

    def __init__(self, uid: int, slot: int):
        self.uid = uid
        self.slot = slot
        self.queue: list[torch.Tensor] = []   # frames not yet stepped (FIFO)
        self.pending: list[tuple] = []        # (outs, row) not yet folded
        self.stacked: dict | None = None      # ...into this host history
        self.last: tuple | None = None        # most recent (outs, row)
        self.frames_done = 0


class ParticleSessionServer:
    """A resident ``capacity``-slot filter bank stepped under churn.

    Args:
      model: any ``StateSpaceModel`` of the port; every session filters
        with it.
      sir: per-session ``SIRConfig`` (``n_particles`` per slot);
        ``step_backend="fused"`` serves every slot with the fused step.
      capacity: the static slot count of the resident bank.
      mesh: ``None``, or an ``EmulatedMesh``/``EmulatedGrid`` holding
        ``bank_axis``: slots are sharded over that axis, each session
        wholly on one shard.  On one card that is a layout: the server
        runs one full-capacity program every tick (no tiers), as the
        reference's mesh path does.  Any other mesh raises ``TypeError``:
        a server over a ``ProcessMesh`` waits for ROADMAP A8b's rest.
      device: the card unless ``"cpu"`` is given (and raises without one).

    Occupancy tiers: on the single-device path each tick gathers the
    ready slots into the smallest tier (powers of two up to
    ``capacity``) that holds them, steps that compact bank (one launch of
    each kernel for the whole tier) and scatters the rows back.  The
    server builds one step program a tier, so ``step_traces`` is at most
    ``len(tiers)`` after any churn.
    """

    def __init__(self, model, sir: smc.SIRConfig, capacity: int = 8,
                 mesh=None, bank_axis: str = "bank", device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if mesh is not None:
            if not isinstance(mesh, (runtime.EmulatedMesh,
                                     runtime.EmulatedGrid)):
                raise TypeError(f"mesh must be an EmulatedMesh or "
                                f"EmulatedGrid, got {type(mesh).__name__} "
                                f"(a server over a ProcessMesh waits for "
                                f"ROADMAP A8b's rest)")
            if math.prod(mesh.shape.values()) > 1:
                if bank_axis not in mesh.shape:
                    raise ValueError(f"bank_axis={bank_axis!r} not in mesh "
                                     f"axes {tuple(mesh.shape)}")
                if capacity % mesh.shape[bank_axis]:
                    raise ValueError(
                        f"capacity {capacity} not divisible by "
                        f"{mesh.shape[bank_axis]} {bank_axis!r}-axis shards")
            else:
                mesh = None
        self.model = model
        self.sir = sir
        self.capacity = capacity
        self.mesh = mesh
        self.bank_axis = bank_axis
        self.device = filters.resolve_device(device)
        self._uids = itertools.count()
        self._free: list[int] = list(range(capacity))   # min-heap of slots
        self._sessions: dict[int, _Session] = {}
        self._by_slot: dict[int, int] = {}              # slot -> uid
        self._frame_shape: tuple | None = None
        self.tiers = ((capacity,) if mesh is not None else tuple(sorted(
            {min(1 << i, capacity) for i in range(capacity.bit_length() + 1)}
            | {capacity})))
        self.tier_hits: dict[int, int] = {t: 0 for t in self.tiers}
        self._programs: dict[int, Any] = {}      # tier -> its step program
        # device-resident (rows, active) per recurring ready set
        self._route_cache: dict[tuple, tuple] = {}
        self._event = None
        # every slot starts detached: placeholder carries, masked off
        self._providers: list = [TorchDraws.from_seed(0, self.device)
                                 for _ in range(capacity)]
        with DEVICE_LOCK:
            self._ensemble = filters.member_carry(self._providers, model,
                                                  sir).ensemble

    # -- introspection ------------------------------------------------------
    @property
    def step_traces(self) -> int:
        """Step programs the server built: one a tier it ran, at most
        ``len(self.tiers)`` after any churn (1 on a mesh)."""
        return len(self._programs)

    def jit_cache_size(self) -> None:
        """The reference's executable-cache size; the port runs eagerly
        and has none."""
        return None

    @property
    def occupancy(self) -> int:
        """Number of attached sessions (≤ ``capacity``)."""
        return len(self._sessions)

    # -- membership ---------------------------------------------------------
    def attach(self, key=0) -> SessionHandle:
        """Allocate a slot and start a fresh session from ``key`` (an int
        seed, a ``torch.Generator`` or a draws provider): its carry is
        drawn exactly as ``smc.run_sir`` draws it, so the session's
        trajectory is ``ParallelParticleFilter.run(key, frames)``'s bit
        for bit.  Raises ``RuntimeError`` when the bank is full."""
        provider = as_draws(key, self.device)
        slot = self._take_slot()
        with DEVICE_LOCK:
            fresh = filters.member_carry([provider], self.model,
                                         self.sir).ensemble
            self._write_slot(slot, _ens_map(lambda x: x[0], fresh))
        self._providers[slot] = provider
        return self._register(slot)

    def detach(self, handle: SessionHandle) -> None:
        """Release the session's slot; pending frames are discarded (call
        ``result`` or ``suspend`` first to keep them).  The slot's carry
        stays as masked dead weight until the next attach."""
        sess = self._lookup(handle)
        del self._sessions[sess.uid]
        del self._by_slot[sess.slot]
        heapq.heappush(self._free, sess.slot)

    # -- streaming ----------------------------------------------------------
    def submit(self, handle: SessionHandle, frame: Any) -> None:
        """Enqueue one observation frame (FIFO), copied to the server's
        device at once as float32: a caller may reuse its buffer."""
        sess = self._lookup(handle)
        frame = torch.as_tensor(frame).to(self.device, torch.float32,
                                          copy=True)
        shape = tuple(frame.shape)
        if self._frame_shape is None:
            self._frame_shape = shape
        elif self._frame_shape != shape:
            raise ValueError(
                f"frame {shape} does not match the server's "
                f"{self._frame_shape} (one server = one frame shape; start "
                f"another server for a second observation space)")
        sess.queue.append(frame)

    def step(self) -> int:
        """Advance every slot with a pending frame by ONE frame: the
        smallest covering tier (gather, step, scatter), or on a mesh the
        full-capacity program.  Returns the number of sessions stepped (0:
        nothing pending, nothing launched)."""
        ready = sorted((s for s in self._sessions.values() if s.queue),
                       key=lambda s: s.slot)
        if not ready:
            return 0
        with DEVICE_LOCK:
            if self.mesh is not None:
                self._step_full(ready)
            else:
                self._step_tiered(ready)
            if self.device.type == "cuda":
                self._event = torch.cuda.Event()
                self._event.record()
        return len(ready)

    def synchronize(self) -> None:
        """Wait until the last step's work on the card is done (no-op on
        the CPU).  The request plane calls it before results leave the
        stepping thread."""
        if self._event is not None:
            self._event.synchronize()

    def _program(self, tier: int):
        step = self._programs.get(tier)
        if step is None:
            step = self._programs[tier] = filters.make_bank_step(self.model,
                                                                 self.sir)
        return step

    def _step_full(self, ready: list[_Session]) -> None:
        """One full-capacity step: slots stay in place, idleness is the
        mask (the mesh path)."""
        frames = torch.zeros((self.capacity,) + self._frame_shape,
                             device=self.device)
        for sess in ready:
            frames[sess.slot] = sess.queue.pop(0)
        slots = [s.slot for s in ready]
        active = torch.zeros(self.capacity, dtype=torch.bool)
        active[slots] = True
        self.tier_hits[self.capacity] += 1
        carry, outs = self._program(self.capacity)(
            smc.SIRCarry(BankDraws(self._providers), self._ensemble),
            (frames, active.to(self.device)))
        self._ensemble = carry.ensemble
        self._record_outputs(ready, slots, outs)

    def _step_tiered(self, ready: list[_Session]) -> None:
        """Gather the ready rows into the smallest covering tier, step,
        scatter back (padding rows are idle slots, masked: their carry
        comes back unchanged)."""
        tier = next(t for t in self.tiers if t >= len(ready))
        frames = torch.stack([s.queue.pop(0) for s in ready])
        if tier > len(ready):
            frames = torch.cat([frames, frames.new_zeros(
                (tier - len(ready),) + frames.shape[1:])])
        rows, idx, active = self._route(tier, tuple(s.slot for s in ready))
        step = self._program(tier)
        self.tier_hits[tier] += 1
        draws = BankDraws([self._providers[r] for r in rows])
        if tier == self.capacity == len(ready):
            # every slot, in slot order: step the resident bank itself
            carry, outs = step(smc.SIRCarry(draws, self._ensemble),
                               (frames, active))
            self._ensemble = carry.ensemble
        else:
            sub = _ens_map(lambda c: c.index_select(0, idx), self._ensemble)
            carry, outs = step(smc.SIRCarry(draws, sub), (frames, active))
            _ens_map(lambda c, x: c.index_copy_(0, idx, x), self._ensemble,
                     carry.ensemble)
        self._record_outputs(ready, range(len(ready)), outs)

    def _route(self, tier: int, slots: tuple) -> tuple:
        """``(rows, idx, active)`` for this tick's ready set: the ready
        slots, then distinct idle slots as padding (there are always
        enough), with the index and mask tensors kept on the device for
        recurring sets (bounded)."""
        cached = self._route_cache.get((tier, slots))
        if cached is None:
            taken = set(slots)
            pad = [s for s in range(self.capacity) if s not in taken]
            rows = list(slots) + pad[:tier - len(slots)]
            active = torch.zeros(tier, dtype=torch.bool)
            active[:len(slots)] = True
            if len(self._route_cache) >= 256:
                self._route_cache.clear()
            cached = (rows, torch.tensor(rows, device=self.device),
                      active.to(self.device))
            self._route_cache[(tier, slots)] = cached
        return cached

    def _record_outputs(self, ready: list[_Session], rows, outs) -> None:
        # rows are read lazily (``latest``/``result``), one host copy of
        # the tick's outputs for all of its sessions
        held = _Outs(outs)
        for sess, i in zip(ready, rows):
            ref = (held, i)
            sess.pending.append(ref)
            sess.last = ref
            sess.frames_done += 1

    def warm_tiers(self, example_frame: Any) -> None:
        """Run the attach path and every tier once, all rows masked (a
        value-level no-op), so the first client pays no kernel build or
        first-call set-up.  ``example_frame`` fixes the frame shape as a
        first ``submit`` would."""
        shape = tuple(torch.as_tensor(example_frame).shape)
        if self._frame_shape is None:
            self._frame_shape = shape
        elif self._frame_shape != shape:
            raise ValueError(f"frame {shape} does not match the server's "
                             f"{self._frame_shape}")
        with DEVICE_LOCK:
            if self._free:
                slot = self._free[0]
                fresh = filters.member_carry(
                    [TorchDraws.from_seed(0, self.device)], self.model,
                    self.sir).ensemble
                self._write_slot(slot, _ens_map(lambda x: x[0], fresh))
            for tier in self.tiers:
                rows = list(range(tier))
                sub = _ens_map(lambda c: c[:tier].clone(), self._ensemble)
                _, outs = self._program(tier)(
                    smc.SIRCarry(BankDraws([self._providers[r]
                                            for r in rows]), sub),
                    (torch.zeros((tier,) + shape, device=self.device),
                     torch.zeros(tier, dtype=torch.bool,
                                 device=self.device)))
                _Outs(outs).row(0)
            self.synchronize()

    def latest(self, handle: SessionHandle) -> tuple | None:
        """The last stepped frame's ``(estimate, ess, log_marginal,
        resampled, ancestors)`` as host arrays, or None before the first
        step since attach/resume (what the request plane resolves
        futures from)."""
        last = self._lookup(handle).last
        return None if last is None else last[0].row(last[1])

    def result(self, handle: SessionHandle) -> filters.FilterResult:
        """Drain the session's queue and return its trajectory so far:
        the history as host (CPU) tensors with leading dim
        ``frames_done``, bit for bit ``ParallelParticleFilter.run``'s
        over the same frames, and ``final``, a copy of the slot's
        ensemble on the server's device (``diag`` is empty)."""
        sess = self._lookup(handle)
        while sess.queue:
            self.step()
        stacked = self._stack_rows(sess)
        if stacked is None:
            raise ValueError("session has no filtered frames yet")
        hist = tree_map(torch.from_numpy, stacked)
        with DEVICE_LOCK:
            final = _ens_map(lambda c: c[sess.slot].clone(), self._ensemble)
        return filters.FilterResult(
            estimates=hist["estimates"], ess=hist["ess"],
            log_marginal=hist["log_marginal"], resampled=hist["resampled"],
            ancestors=hist["ancestors"], diag={}, final=final)

    # -- suspension ---------------------------------------------------------
    def suspend(self, handle: SessionHandle,
                directory: str | None = None) -> SuspendedSession:
        """Drain, snapshot to host, and free the slot.  With ``directory``
        (this one session's checkpoint stream) the snapshot is also
        persisted through ``checkpoint.store``.  The session's provider
        must be a ``TorchDraws`` (a seed's generator): its state is what
        resumes the stream."""
        sess = self._lookup(handle)
        provider = self._providers[sess.slot]
        if not isinstance(provider, TorchDraws):
            raise TypeError(f"only a session drawing from a torch.Generator "
                            f"can be suspended, not from "
                            f"{type(provider).__name__}")
        while sess.queue:
            self.step()
        with DEVICE_LOCK:
            ens = _ens_map(lambda c: host(c[sess.slot]), self._ensemble)
            gen = provider.generator.get_state().numpy().copy()
        stacked = self._stack_rows(sess)
        if stacked is None:
            blank = self.blank_suspended()
            stacked = {f: getattr(blank, f) for f in (
                "estimates", "ess", "log_marginal", "resampled",
                "ancestors")}
        sus = SuspendedSession(generator_state=gen, state=ens.state,
                               log_weights=ens.log_weights,
                               counts=ens.counts,
                               frames_done=sess.frames_done, **stacked)
        self.detach(handle)
        if directory is not None:
            sus.save(directory)
        return sus

    def resume(self, suspended: SuspendedSession) -> SessionHandle:
        """Attach a suspended session into a free slot and continue it:
        the ensemble and the generator state are restored bit for bit,
        so the continuation is an uninterrupted run's, and the history
        is restored so ``result`` spans the whole stream."""
        n = suspended.log_weights.shape[-1]
        if n != self.sir.n_particles:
            raise ValueError(f"suspended session has {n} particles, server "
                             f"runs {self.sir.n_particles}")
        gen = torch.Generator(device=self.device)
        gen.set_state(torch.from_numpy(
            np.asarray(suspended.generator_state, np.uint8).copy()))
        slot = self._take_slot()
        with DEVICE_LOCK:
            self._write_slot(slot, _ens_map(
                lambda x: _tensor(x, self.device), suspended))
        self._providers[slot] = TorchDraws(gen)
        handle = self._register(slot)
        sess = self._sessions[handle.uid]
        sess.frames_done = suspended.frames_done
        if suspended.frames_done:
            sess.stacked = {
                "estimates": suspended.estimates, "ess": suspended.ess,
                "log_marginal": suspended.log_marginal,
                "resampled": suspended.resampled,
                "ancestors": suspended.ancestors}
        return handle

    def resume_from(self, directory: str,
                    step: int | None = None) -> SessionHandle:
        """``resume(SuspendedSession.load(directory))``."""
        return self.resume(SuspendedSession.load(
            directory, self.blank_suspended(), step=step))

    def blank_suspended(self) -> SuspendedSession:
        """A zero-frame ``SuspendedSession`` with this server's tree
        structure: the ``like`` template ``SuspendedSession.load`` needs.
        Its leaves are read-only zero views (no memory a slot)."""
        def zeros(c):
            return np.broadcast_to(np.zeros((), _np_dtype(c.dtype)),
                                   tuple(c.shape[1:]))

        state = tree_map(zeros, self._ensemble.state)
        est_fn = getattr(self.model, "estimate_state", None)
        est_like = self._ensemble.state if est_fn is None else est_fn(
            self._ensemble.state)
        est = tree_map(lambda c: np.zeros((0,) + tuple(c.shape[2:]),
                                          _np_dtype(c.dtype)), est_like)
        gen = torch.Generator(device=self.device).get_state().numpy()
        return SuspendedSession(
            generator_state=np.zeros_like(gen), state=state,
            log_weights=zeros(self._ensemble.log_weights),
            counts=zeros(self._ensemble.counts), frames_done=0,
            estimates=est, ess=np.zeros((0,), np.float32),
            log_marginal=np.zeros((0,), np.float32),
            resampled=np.zeros((0,), bool),
            ancestors=np.zeros(
                (0, self.sir.n_particles if self.sir.record_ancestry else 0),
                np.int32))

    # -- internals ----------------------------------------------------------
    def _write_slot(self, slot: int, ens: ParticleEnsemble) -> None:
        """Write one slot's ensemble (no slot dim) into the resident bank,
        in place."""
        _ens_map(lambda c, x: c[slot].copy_(x), self._ensemble, ens)

    def _take_slot(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"server full: all {self.capacity} slots attached (detach "
                f"or suspend a session, or start a server with a larger "
                f"capacity)")
        return heapq.heappop(self._free)

    def _register(self, slot: int) -> SessionHandle:
        uid = next(self._uids)
        self._sessions[uid] = _Session(uid, slot)
        self._by_slot[slot] = uid
        return SessionHandle(uid=uid, slot=slot)

    def _lookup(self, handle: SessionHandle) -> _Session:
        sess = self._sessions.get(handle.uid)
        if sess is None:
            raise KeyError(f"unknown or detached session {handle}")
        return sess

    def _stack_rows(self, sess: _Session) -> dict | None:
        """Fold the rows stepped since the last call into the session's
        host history and return it (None: no frames filtered yet)."""
        if sess.pending:
            est, ess, log_z, res, anc = zip(*(held.row(i)
                                              for held, i in sess.pending))
            fresh = {"estimates": tree_map(lambda *xs: np.stack(xs), *est),
                     "ess": np.stack(ess), "log_marginal": np.stack(log_z),
                     "resampled": np.stack(res), "ancestors": np.stack(anc)}
            sess.pending = []
            sess.stacked = fresh if sess.stacked is None else tree_map(
                lambda a, b: np.concatenate((a, b)), sess.stacked, fresh)
        return sess.stacked


def _np_dtype(dtype: torch.dtype):
    """numpy's dtype for a torch dtype (bfloat16's bits as uint16)."""
    if dtype == torch.bfloat16:
        return np.uint16
    return torch.empty((), dtype=dtype).numpy().dtype
