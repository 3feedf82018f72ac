"""Asyncio request plane over the resident session bank (port of
``repro.serve.frontend``).

``ParticleFrontend``: client coroutines ``open()`` streams and
``submit()`` observation frames; a scheduler coroutine coalesces pending
arrivals into bank steps (continuous batching: a step fires when a
batch-size *or* a deadline trigger is met, never on a cadence), and the
``ParticleSessionServer`` runs each step through its smallest covering
occupancy tier.

* **Triggers**: a tick fires when the number of sessions with a pending
  frame reaches ``min(max_batch, live streams)``, or when the oldest
  pending frame has waited ``max_delay`` seconds.
* **Admission / backpressure**: ``open`` always admits; a stream with no
  free slot starts *parked* and is attached by the scheduler.  When
  parked work waits, an idle resident is suspended through
  ``repro_torch.checkpoint.store`` and the parked one resumed;
  ``park_patience`` bounds starvation by force-rotating the
  least-recently-active resident.  ``submit`` awaits while a stream has
  ``max_queue`` undelivered frames.
* **Observability**: counters and series in ``repro_torch.serve.metrics``
  (queue depth, coalesce factor, park/resume events, per-frame latency);
  ``snapshot()`` adds the server's tier hits and step programs.

Threading contract: the frontend owns its server.  Steps and warm-up run
in ONE single-thread executor per frontend, so the event loop accepts
submissions while the card computes; after each step the worker waits
on the step's CUDA event (``server.synchronize()``) before any result
reaches an asyncio future, so no client receives a value whose kernel is
still in flight.  Every other server call (attach/park/resume in the
scheduler, suspend in ``handoff``) runs on the loop thread while no step
is in flight.

Fleet hooks: ``handoff()`` quiesces a stream and extracts it (suspended
state plus undelivered frames) as a ``Handoff``; ``adopt()`` installs
one on another frontend, which resumes it bit for bit.
``repro_torch.serve.fleet`` builds migration and failure recovery from
these two verbs.

Lifecycle::

    server = ParticleSessionServer(model=model, sir=sir, capacity=64)
    async with ParticleFrontend(server, FrontendConfig()) as fe:
        stream = await fe.open(7)                # an int seed
        fut = await fe.submit(stream, frame)     # backpressure-aware
        out = await fut                          # FrameResult
        await fe.close(stream)
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import itertools
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.serve import metrics as metrics_mod
from repro_torch.serve import sessions


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Request-plane knobs (DESIGN.md §15.1/§15.3).

    Attributes:
      max_batch: batch trigger — fire when this many sessions have a
        pending frame (``None`` = the server's slot capacity).  The
        effective trigger is ``min(max_batch, live streams)`` so a
        half-empty frontend never waits for phantom arrivals.
      max_delay: deadline trigger in seconds — the longest any pending
        frame may wait for coalescing before a step fires anyway.  This
        is the latency the scheduler *spends* to buy batch efficiency;
        0 degenerates to step-per-arrival.
      max_queue: per-stream in-flight frame bound; ``submit`` awaits
        (backpressure) while a stream already has this many undelivered
        frames.
      park_patience: seconds a parked stream's work may wait before the
        scheduler force-rotates it in by suspending the least-recently
        active resident session (bounds starvation when every slot is
        busy).
      park_dir: directory for parked-session checkpoints (one
        subdirectory per stream, written via ``checkpoint.store``);
        ``None`` uses a fresh temporary directory.
    """

    max_batch: int | None = None
    max_delay: float = 0.002
    max_queue: int = 64
    park_patience: float = 0.05
    park_dir: str | None = None


@dataclasses.dataclass
class FrameResult:
    """Per-frame filter output delivered to the submitting client.

    Attributes:
      estimate: host-side MMSE state estimate for this frame.
      ess: effective sample size after reweighting.
      log_marginal: this frame's log-marginal-likelihood increment.
      resampled: whether the ESS trigger fired a resampling pass.
      latency: seconds from ``submit`` to result delivery (queueing +
        coalescing + compute — the number BENCH_latency.json quantiles).
    """

    estimate: np.ndarray
    ess: float
    log_marginal: float
    resampled: bool
    latency: float


class StreamHandle:
    """Client-side ticket for one open stream (opaque; all state is
    frontend-internal)."""

    def __init__(self, sid: int, key: Any):
        self.sid = sid
        self._key = key                      # initial seed (pre-attach)
        self._session: Optional[sessions.SessionHandle] = None
        self._sus: Optional[sessions.SuspendedSession] = None
        self._pending: list[tuple] = []      # (frame, future, t_arrive)
        self._wait_since: float | None = None
        self._last_active = 0.0
        self._closed = False
        self._migrating = False              # mid-handoff: scheduler hands off
        self._not_full = asyncio.Event()
        self._not_full.set()

    @property
    def attached(self) -> bool:
        """True while the stream holds a resident bank slot."""
        return self._session is not None

    @property
    def queue_depth(self) -> int:
        """Frames submitted but not yet delivered back."""
        return len(self._pending)


@dataclasses.dataclass
class Handoff:
    """Portable state of one stream in transit between frontends.

    Produced by ``ParticleFrontend.handoff`` (the drain side) and
    consumed by ``ParticleFrontend.adopt`` (the adopting side) — the
    currency of fleet-level session migration (DESIGN.md §16.2).  The
    fleet controller also synthesizes one directly when it re-homes a
    stream off a *dead* bank from that stream's durable checkpoint.

    Attributes:
      key: the stream's initial seed — everything a fresh
        (never-stepped) stream is.
      suspended: host-side filter state through ``frames_done`` frames
        (``None`` for a stream that never filtered a frame).
      pending: undelivered ``(frame, future, t_arrive)`` work, in
        submission order; the adopting frontend delivers these futures.
    """

    key: Any
    suspended: sessions.SuspendedSession | None
    pending: list


class ParticleFrontend:
    """The asyncio request plane: continuous batching + admission control
    over one ``ParticleSessionServer`` (module docstring has the full
    contract; DESIGN.md §15 the design discussion)."""

    def __init__(self, server: sessions.ParticleSessionServer,
                 config: FrontendConfig | None = None,
                 metrics: metrics_mod.Metrics | None = None,
                 executor: concurrent.futures.Executor | None = None):
        self.server = server
        self.config = config or FrontendConfig()
        self.metrics = metrics or metrics_mod.Metrics()
        self._streams: dict[int, StreamHandle] = {}
        self._sids = itertools.count()
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        self._task: asyncio.Task | None = None
        self._park_root = self.config.park_dir
        self._tmpdir: tempfile.TemporaryDirectory | None = None
        # steps and warmup go through one single-thread executor; all
        # other server calls stay on the loop thread between steps (the
        # module-docstring threading contract).  The fleet controller
        # passes a per-bank executor; otherwise the frontend owns one.
        self._owns_executor = executor is None
        self._executor = executor or concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ppf-frontend")
        self._stepping: set[int] = set()     # sids inside the running step
        self._step_complete = asyncio.Event()
        self.last_step_at: float | None = None   # loop-clock end of last step

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        """Spawn the scheduler coroutine (idempotent)."""
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._scheduler())

    async def stop(self) -> None:
        """Drain all pending work, then stop the scheduler."""
        if self._task is not None:
            await self.drain()
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
        if self._owns_executor:
            self._executor.shutdown(wait=True)

    async def __aenter__(self) -> "ParticleFrontend":
        """``async with`` starts the scheduler..."""
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        """...and drains + stops it on exit."""
        await self.stop()

    # -- client surface -----------------------------------------------------
    async def open(self, key: Any) -> StreamHandle:
        """Admit a new client stream seeded by ``key`` (an int seed; a
        draws provider is stateful, so a stream that may be replayed from
        its start needs a seed).

        Always succeeds: with a free slot the stream is attached on the
        next scheduler pass; over capacity it starts parked and competes
        for a slot once it has work (§15.3).  The stream's trajectory is
        bitwise the standalone filter's regardless of how often it gets
        parked and resumed in between.
        """
        stream = StreamHandle(next(self._sids), key)
        self._streams[stream.sid] = stream
        self._wake.set()
        return stream

    async def submit(self, stream: StreamHandle, frame: Any) -> asyncio.Future:
        """Enqueue one observation frame; returns a future ``FrameResult``.

        Awaits while the stream already has ``max_queue`` undelivered
        frames (per-stream backpressure) — so a client that outpaces the
        bank slows down instead of ballooning the queue.
        """
        if stream._closed:
            raise ValueError(f"stream {stream.sid} is closed")
        while stream.queue_depth >= self.config.max_queue:
            self.metrics.inc("backpressure_waits")
            stream._not_full.clear()
            await stream._not_full.wait()
            if stream._closed:
                raise ValueError(f"stream {stream.sid} is closed")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        stream._pending.append((_own(frame), fut, loop.time()))
        if not stream.attached and stream._wait_since is None:
            stream._wait_since = loop.time()
        self._idle.clear()
        self._wake.set()
        return fut

    async def close(self, stream: StreamHandle) -> None:
        """Retire the stream: undelivered frames are cancelled and the
        slot (if any) is released on the next scheduler pass."""
        stream._closed = True
        stream._not_full.set()
        for _, fut, _ in stream._pending:
            if not fut.done():
                fut.cancel()
        stream._pending.clear()
        self._wake.set()

    async def drain(self) -> None:
        """Wait until every submitted frame has been delivered."""
        while True:
            if not any(st._pending for st in self._streams.values()
                       if not st._closed):
                return
            self._idle.clear()
            self._wake.set()
            await self._idle.wait()

    async def warmup(self, example_frame: Any) -> None:
        """Run every occupancy tier once off the event loop
        (``server.warm_tiers``: kernel builds and first-call set-up) so
        no client pays them — call once before opening traffic."""
        await asyncio.get_running_loop().run_in_executor(
            self._executor, self.server.warm_tiers, example_frame)

    # -- fleet handoff hooks (DESIGN.md §16.2) ------------------------------
    async def handoff(self, stream: StreamHandle,
                      directory: str | None = None) -> Handoff:
        """Quiesce ``stream`` and extract it for adoption elsewhere.

        The drain side of a live migration: the stream is first fenced
        off from new scheduling (``_migrating``), then the call waits
        for the bank to be between steps and suspends the session
        through ``checkpoint/store`` *on the loop thread* — the same
        no-awaits critical section the scheduler's own park/resume path
        uses, so no server call ever overlaps a step's donated-buffer
        window.  The stream is then removed from this frontend.
        Undelivered frames travel inside the returned
        ``Handoff`` — their futures are resolved by whichever frontend
        ``adopt``\\ s them, so clients never observe the move except as
        latency.  With ``directory`` the suspended state is also
        persisted there (the controller's durable copy, what a chaos
        kill recovers from).  The old handle is poisoned: further
        ``submit`` calls raise ``ValueError`` so a racing producer
        retries against the adopting frontend.
        """
        if stream.sid not in self._streams:
            raise KeyError(f"unknown stream {stream.sid}")
        stream._migrating = True
        while self._stepping:                    # quiesce: bank between steps
            await self._step_complete.wait()
        # no awaits below until the handle is out of self._streams: the
        # scheduler cannot interleave a step (donating the carry) or a
        # park/resume with this suspend
        sus = stream._sus
        if stream._session is not None:
            session = stream._session
            stream._session = None
            sus = self.server.suspend(session, directory=directory)
        elif sus is not None and directory is not None:
            sus.save(directory)
        pending = list(stream._pending)
        stream._pending = []
        stream._closed = True                # poison: submits must re-route
        stream._not_full.set()
        del self._streams[stream.sid]
        self._wake.set()
        return Handoff(key=stream._key, suspended=sus, pending=pending)

    async def adopt(self, handoff: Handoff) -> StreamHandle:
        """Install a stream extracted by another frontend's ``handoff``.

        The adopting side of a live migration: registers a fresh handle
        whose suspended state resumes (bit-for-bit, the §11.4 contract)
        on this frontend's server at the next scheduler pass, and whose
        carried-over pending frames keep their original futures and
        arrival times — latency accounting spans the migration.
        """
        stream = StreamHandle(next(self._sids), handoff.key)
        stream._sus = handoff.suspended
        stream._pending = list(handoff.pending)
        if stream._pending:
            stream._wait_since = asyncio.get_running_loop().time()
            self._idle.clear()
        self._streams[stream.sid] = stream
        self._wake.set()
        return stream

    def snapshot(self) -> dict:
        """Operational metrics + the server's tier/trace counters."""
        snap = self.metrics.snapshot()
        snap["tier_hits"] = dict(self.server.tier_hits)
        snap["step_traces"] = self.server.step_traces
        snap["occupancy"] = self.server.occupancy
        return snap

    # -- scheduler ----------------------------------------------------------
    async def _scheduler(self) -> None:
        try:
            await self._schedule_forever()
        except asyncio.CancelledError:
            raise
        except BaseException as err:
            # a dying scheduler must not strand awaiting clients: fail
            # every undelivered future, release drain(), then surface
            # the error at stop()/await-task time
            for st in self._streams.values():
                for _, fut, _ in st._pending:
                    if not fut.done():
                        fut.set_exception(err)
                st._pending.clear()
            self._idle.set()
            raise

    async def _schedule_forever(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            now = loop.time()
            self._reap_closed()
            self._rebalance(now)
            ready = [st for st in self._streams.values()
                     if st.attached and st._pending and not st._closed
                     and not st._migrating]
            waiting = [st for st in self._streams.values()
                       if not st.attached and st._pending and not st._closed
                       and not st._migrating]
            if not ready:
                if not waiting:
                    self._idle.set()
                await self._wait_for_wake(None if not waiting
                                          else self.config.park_patience)
                continue
            oldest = min(st._pending[0][2] for st in ready)
            live = sum(1 for st in self._streams.values() if not st._closed)
            target = min(self.config.max_batch or self.server.capacity,
                         self.server.capacity, live)
            deadline = oldest + self.config.max_delay
            if len(ready) < target and now < deadline:
                await self._wait_for_wake(deadline - now)
                continue
            work = []
            for st in ready:
                frame, fut, t_arrive = st._pending.pop(0)
                st._not_full.set()
                work.append((st, frame, fut, t_arrive))
            self.metrics.observe("queue_depth", sum(
                st.queue_depth for st in self._streams.values()))
            self.metrics.observe("coalesce", len(work))
            self._stepping = {st.sid for st, _, _, _ in work}
            t_fire = loop.time()
            try:
                rows = await loop.run_in_executor(
                    self._executor, self._fire, work)
            finally:
                self._stepping = set()
                # wake handoff quiescers even when the step failed —
                # the set-then-clear pulse releases every current waiter
                self._step_complete.set()
                self._step_complete.clear()
            done = loop.time()
            self.last_step_at = done
            self.metrics.inc("steps")
            self.metrics.observe("step_ms", (done - t_fire) * 1e3)
            for (st, _, fut, t_arrive), row in zip(work, rows):
                st._last_active = done
                latency = done - t_arrive
                self.metrics.inc("frames")
                self.metrics.observe("latency", latency)
                self.metrics.observe("ess", row[1])
                if not fut.done():
                    fut.set_result(FrameResult(
                        estimate=row[0], ess=row[1], log_marginal=row[2],
                        resampled=row[3], latency=latency))

    async def _wait_for_wake(self, timeout: float | None) -> None:
        """Sleep until new work arrives or ``timeout`` elapses."""
        try:
            await asyncio.wait_for(self._wake.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        self._wake.clear()

    def _fire(self, work: list[tuple]) -> list[tuple]:
        """(worker thread) Submit one frame per ready stream, run ONE
        bank step, wait for its kernels, and read each stream's freshest
        outputs to the host."""
        for st, frame, _, _ in work:
            self.server.submit(st._session, frame)
        self.server.step()
        self.server.synchronize()
        rows = []
        for st, _, _, _ in work:
            est, ess, log_z, res = self.server.latest(st._session)[:4]
            # est is already a host array (a tree for models whose
            # estimate is structured, e.g. the LM decode adapter)
            rows.append((est, float(ess), float(log_z), bool(res)))
        return rows

    # -- slot management (admission control, §15.3) -------------------------
    def _reap_closed(self) -> None:
        """Release slots of closed streams and forget them."""
        for sid in [s for s, st in self._streams.items() if st._closed]:
            st = self._streams.pop(sid)
            if st.attached:
                self.server.detach(st._session)
                st._session = None

    def _rebalance(self, now: float) -> None:
        """Assign slots: attach/resume waiting streams into free slots,
        park idle residents to make room, and force-rotate when parked
        work has waited past ``park_patience``."""
        waiting = sorted((st for st in self._streams.values()
                          if not st.attached and st._pending
                          and not st._closed and not st._migrating),
                         key=lambda st: st._wait_since or now)
        for st in waiting:
            if self.server.occupancy < self.server.capacity:
                self._give_slot(st, now)
                continue
            victim = self._pick_victim(
                require_idle=(now - (st._wait_since or now)
                              < self.config.park_patience))
            if victim is None:
                break                       # nobody safely evictable yet
            self._park(victim)
            self._give_slot(st, now)
        # spare slots warm up idle (frameless) streams so their first
        # frame skips the attach on the hot path
        for st in self._streams.values():
            if self.server.occupancy >= self.server.capacity:
                break
            if not st.attached and not st._closed and not st._pending \
                    and not st._migrating:
                self._give_slot(st, now)

    def _give_slot(self, st: StreamHandle, now: float) -> None:
        if st._sus is not None:                 # resume a parked session
            st._session = self.server.resume(st._sus)
            st._sus = None
            self.metrics.inc("resume_events")
        else:                                   # first attach
            st._session = self.server.attach(st._key)
        st._wait_since = None
        st._last_active = now

    def _pick_victim(self, require_idle: bool) -> StreamHandle | None:
        """The least-recently-active resident stream; with
        ``require_idle`` only streams with no queued frames qualify (the
        no-thrash default until ``park_patience`` expires)."""
        candidates = [st for st in self._streams.values()
                      if st.attached and not st._closed and not st._migrating
                      and (not require_idle or not st._pending)]
        if not candidates:
            return None
        return min(candidates, key=lambda st: st._last_active)

    def _park(self, st: StreamHandle) -> None:
        """Suspend a resident session through ``checkpoint/store`` (its
        durable copy) and keep the host-side snapshot for the resume."""
        st._sus = self.server.suspend(st._session,
                                      directory=self._park_path(st))
        st._session = None
        self.metrics.inc("park_events")

    def _park_path(self, st: StreamHandle) -> str:
        if self._park_root is None:
            self._tmpdir = self._tmpdir or tempfile.TemporaryDirectory(
                prefix="ppf-park-")
            self._park_root = self._tmpdir.name
        path = os.path.join(self._park_root, f"stream-{st.sid}")
        os.makedirs(path, exist_ok=True)
        return path


def _own(frame: Any) -> Any:
    """An owned copy of a submitted frame: the client may reuse its
    buffer."""
    if isinstance(frame, torch.Tensor):
        return frame.detach().clone()
    return np.array(frame)
