"""Fleet-level elasticity: multi-bank serving with live session
rebalancing (port of ``repro.serve.fleet``).

``FleetController`` runs several banks, each one resident
``ParticleSessionServer`` behind one ``ParticleFrontend``, on a single
asyncio loop with each bank's steps in its own worker thread; on the
card every bank shares the one device (their device work serializes on
``sessions.DEVICE_LOCK``).  The controller:

* **places** new streams on banks through a pluggable policy
  (``repro_torch.launch.registry``: ``LeastLoaded`` default,
  ``CapacityTierAware``), fed by per-bank metrics views;
* **rebalances** live: when residency pressure skews past
  ``imbalance_threshold``, sessions migrate hottest bank → coldest bank
  through suspend → ``checkpoint.store`` → resume (the frontends'
  ``handoff``/``adopt``).  A migrated stream's trajectory is bit for bit
  the standalone filter's;
* **scales**: ``scale_out`` activates standby banks (automatically when
  residency crosses ``scale_out_watermark``), ``scale_in`` drains and
  retires a bank to standby;
* **survives failures**: every submitted frame is logged controller-side
  before a bank sees it (a write-ahead frame log), and every migration
  persists the stream's state through the checkpoint store.  When a bank
  dies (its scheduler raises) or hangs (frames pending, no progress for
  ``fail_timeout``), every affected stream is re-homed on a surviving
  bank from its last durable checkpoint (or its seed) and the logged
  frames after it are replayed: replay is deterministic, so the
  recovered trajectory is the uninterrupted one bit for bit.

Lifecycle::

    registry = FleetRegistry([BankSpec("a", capacity=4),
                              BankSpec("b", capacity=4),
                              BankSpec("spare", capacity=4, standby=True)])
    fleet = FleetController(make_server, registry, FleetConfig())
    async with fleet:
        stream = await fleet.open(7)                        # an int seed
        out = await (await fleet.submit(stream, frame))     # FrameResult
        await fleet.close(stream)
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import itertools
import os
import tempfile
from typing import Any, Callable, Optional

from repro_torch.checkpoint import store
from repro_torch.launch import registry as registry_mod
from repro_torch.serve import frontend as frontend_mod
from repro_torch.serve import metrics as metrics_mod
from repro_torch.serve import sessions


class BankFailure(RuntimeError):
    """A bank worker died or stopped making progress (DESIGN.md §16.3)."""


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet control-plane knobs (DESIGN.md §16).

    Attributes:
      rebalance_interval: seconds between control-loop ticks (health
        check, autoscale, rebalance).
      imbalance_threshold: migrate only when the hottest and coldest
        banks' residency pressure (live streams per slot) differ by
        more than this — the hysteresis band that stops migration
        ping-pong.
      max_migrations_per_tick: rebalance budget per control tick;
        bounds how much step capacity a tick may spend on moves.
      auto_scale: enable watermark-driven scale-out/scale-in (manual
        ``scale_out``/``scale_in`` always work).
      scale_out_watermark: activate a standby bank when fleet residency
        (open streams / total live capacity) exceeds this; the default
        1.0 scales out exactly when streams would otherwise park.
      scale_in_watermark: retire the emptiest bank when fleet residency
        falls below this (never below ``min_banks``, and never when the
        remaining banks would cross ``scale_out_watermark``).
      min_banks: floor on live banks for automatic scale-in.
      fail_timeout: seconds a bank may hold pending frames without
        delivering any before the hang detector declares it dead.
      frontend: per-bank request-plane config (§15); ``park_dir``, when
        set, gets a per-bank subdirectory.
      policy: placement policy instance (``None`` = ``LeastLoaded``).
      state_dir: durable root for per-stream migration checkpoints and
        controller snapshots (``None`` = a private temporary
        directory).
    """

    rebalance_interval: float = 0.05
    imbalance_threshold: float = 0.5
    max_migrations_per_tick: int = 2
    auto_scale: bool = True
    scale_out_watermark: float = 1.0
    scale_in_watermark: float = 0.25
    min_banks: int = 1
    fail_timeout: float = 5.0
    frontend: frontend_mod.FrontendConfig = dataclasses.field(
        default_factory=frontend_mod.FrontendConfig)
    policy: Any = None
    state_dir: str | None = None


class FleetStream:
    """Client-side ticket for one fleet-managed stream.

    The controller owns all routing state: which bank currently hosts
    the stream, the write-ahead frame log (every frame ever submitted,
    the replay source after a bank failure), the per-frame result
    futures, and the durable-checkpoint watermark ``ckpt_frames``
    (frames covered by the newest ``checkpoint/store`` snapshot).
    Clients only ``submit`` against it and await the returned futures.
    """

    def __init__(self, fid: int, key: Any):
        self.id = fid
        self.key = key                       # initial seed (replay root)
        self.bank: str = ""                  # current home bank name
        self.handle: Optional[frontend_mod.StreamHandle] = None
        self.log: list = []                  # write-ahead frame log
        self.results: list[asyncio.Future] = []   # one future per frame
        self.submitted = 0                   # frames handed to a live bank
        self.ckpt_frames = 0                 # frames under durable snapshot
        self.closed = False
        self.pumping = False                 # one pump coroutine at a time
        self.ready = asyncio.Event()         # cleared while migrating
        self.ready.set()
        self.lock = asyncio.Lock()           # serializes pump vs move/rehome
        self.not_full = asyncio.Event()      # controller-level backpressure
        self.not_full.set()

    @property
    def frames_delivered(self) -> int:
        """Frames whose results have been delivered to the client."""
        return sum(1 for f in self.results if f.done())

    @property
    def queue_depth(self) -> int:
        """Frames submitted by the client but not yet delivered."""
        return len(self.log) - self.frames_delivered


@dataclasses.dataclass
class _Bank:
    """Controller-internal runtime record for one live bank."""

    spec: registry_mod.BankSpec
    server: sessions.ParticleSessionServer
    fe: frontend_mod.ParticleFrontend
    executor: concurrent.futures.ThreadPoolExecutor
    started_at: float
    streams: set = dataclasses.field(default_factory=set)   # open fleet ids
    dead: bool = False
    progress_frames: float = 0.0     # hang detector: last seen frame count
    progress_at: float = 0.0         # ...and when it last moved


class FleetController:
    """Runs N banks as one elastic serving fleet (module docstring has
    the full contract; DESIGN.md §16 the design discussion).

    Args:
      make_server: factory ``BankSpec -> ParticleSessionServer`` — the
        controller never builds servers itself, so banks may differ in
        capacity tier or (emulated) mesh as long as they share the
        model, ``n_particles`` and device (migration resumes state across
        any such pair).  Called in the bank's worker thread.
      registry: the ``FleetRegistry`` of bank specs; non-standby specs
        start at boot, standby specs are scale-out capacity.  The
        controller mutates standby flags as banks activate/retire so a
        ``save_state`` snapshot reflects the live fleet.
      config: ``FleetConfig`` knobs.
      metrics: fleet-level ``Metrics`` (migrations, failures, scale
        events); per-bank request metrics live on each frontend.
    """

    def __init__(self, make_server: Callable[
                     [registry_mod.BankSpec], sessions.ParticleSessionServer],
                 registry: registry_mod.FleetRegistry,
                 config: FleetConfig | None = None,
                 metrics: metrics_mod.Metrics | None = None):
        self._make_server = make_server
        self.registry = registry
        self.config = config or FleetConfig()
        self.metrics = metrics or metrics_mod.Metrics()
        self.policy = self.config.policy or registry_mod.LeastLoaded()
        self._banks: dict[str, _Bank] = {}
        self._streams: dict[int, FleetStream] = {}
        self._ids = itertools.count()
        self._respawns = itertools.count()
        self._task: asyncio.Task | None = None
        self._running = False
        self._tmpdir: tempfile.TemporaryDirectory | None = None
        self._state_root: str | None = None
        self._warm_frame = None
        self.last_control_error: BaseException | None = None

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        """Boot every active (non-standby) bank and the control loop."""
        if self._task is not None:
            return
        if self.config.state_dir is not None:
            self._state_root = self.config.state_dir
            os.makedirs(self._state_root, exist_ok=True)
        else:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="ppf-fleet-")
            self._state_root = self._tmpdir.name
        self._running = True
        for spec in self.registry.active():
            await self._start_bank(spec)
        if not self._banks:
            raise ValueError("registry has no active banks")
        self._task = asyncio.get_running_loop().create_task(
            self._control_loop())

    async def stop(self) -> None:
        """Drain all delivered work, then stop every bank and the
        control loop (dead banks are reaped, not drained)."""
        if self._task is not None:
            try:
                await self.drain()
            finally:
                self._running = False
                self._task.cancel()
                try:
                    await self._task
                except asyncio.CancelledError:
                    pass
                self._task = None
        for bank in list(self._banks.values()):
            await self._retire_bank(bank)
        self._banks.clear()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None

    async def __aenter__(self) -> "FleetController":
        """``async with`` boots the fleet..."""
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        """...and drains + stops it on exit."""
        await self.stop()

    async def warmup(self, example_frame: Any) -> None:
        """Pre-compile every live bank's tier programs (§15.4), and
        remember the frame so banks started later (scale-out, failure
        respawn) warm themselves before taking traffic."""
        self._warm_frame = frontend_mod._own(example_frame)
        await asyncio.gather(*(b.fe.warmup(self._warm_frame)
                               for b in self._live_banks()))

    # -- client surface -----------------------------------------------------
    async def open(self, key: Any) -> FleetStream:
        """Admit a stream seeded by ``key`` (an int seed: recovery replays
        a stream from it), placed by the policy over live-bank views."""
        bank = self._banks[self.policy.choose(
            [self._view(b) for b in self._live_banks()])]
        fs = FleetStream(next(self._ids), key)
        fs.handle = await bank.fe.open(key)
        fs.bank = bank.spec.name
        self._streams[fs.id] = fs
        bank.streams.add(fs.id)
        return fs

    async def submit(self, fs: FleetStream, frame: Any) -> asyncio.Future:
        """Log one observation frame and dispatch it to the stream's
        bank; returns a future ``FrameResult``.

        The frame enters the write-ahead log *before* any bank sees it
        — the recovery invariant (§16.3): a frame the client holds a
        future for is always replayable.  Awaits (backpressure) while
        the stream already has ``frontend.max_queue`` undelivered
        frames, mirroring the single-bank contract.
        """
        if fs.closed:
            raise ValueError(f"stream {fs.id} is closed")
        while not fs.closed and fs.queue_depth >= self.config.frontend.max_queue:
            self.metrics.inc("backpressure_waits")
            fs.not_full.clear()
            await fs.not_full.wait()
        if fs.closed:
            raise ValueError(f"stream {fs.id} is closed")
        cfut: asyncio.Future = asyncio.get_running_loop().create_future()
        cfut.add_done_callback(lambda _: fs.not_full.set())
        fs.log.append(frontend_mod._own(frame))
        fs.results.append(cfut)
        self._kick(fs)
        return cfut

    async def close(self, fs: FleetStream) -> None:
        """Retire the stream; undelivered frames are cancelled."""
        if fs.closed:
            return
        fs.closed = True
        fs.not_full.set()
        async with fs.lock:
            bank = self._banks.get(fs.bank)
            if bank is not None:
                bank.streams.discard(fs.id)
                if not bank.dead:
                    await bank.fe.close(fs.handle)
        for fut in fs.results:
            if not fut.done():
                fut.cancel()

    async def drain(self) -> None:
        """Wait until every submitted frame of every open stream has a
        delivered result (recovery replay counts — a drain spanning a
        bank failure completes once the replacements deliver)."""
        while True:
            open_streams = [fs for fs in self._streams.values()
                            if not fs.closed]
            pending = [f for fs in open_streams for f in fs.results
                       if not f.done()]
            if not pending:
                if all(fs.submitted >= len(fs.log) for fs in open_streams):
                    return
                await asyncio.sleep(self.config.rebalance_interval)
                continue
            await asyncio.wait(pending)

    def snapshot(self) -> dict:
        """Fleet metrics + per-bank state and frontend snapshots."""
        snap = self.metrics.snapshot()
        snap["banks"] = {
            name: {
                "dead": b.dead,
                "capacity": b.spec.capacity,
                "live_streams": len([i for i in b.streams
                                     if not self._streams[i].closed]),
                "occupancy": b.server.occupancy,
                "frontend": b.fe.snapshot(),
            } for name, b in self._banks.items()}
        snap["open_streams"] = len([fs for fs in self._streams.values()
                                    if not fs.closed])
        return snap

    # -- durable control plane (DESIGN.md §16.4) ----------------------------
    def save_state(self, directory: str | None = None) -> str:
        """Snapshot the registry and stream placements atomically via
        ``checkpoint.store.save_json`` (default: the fleet's state
        root).  Together with the per-stream filter checkpoints written
        at each migration, this is what a restarted controller needs to
        re-adopt its fleet.  Returns the directory."""
        directory = directory or self._state_root
        assert directory is not None, "fleet not started and no directory"
        self.registry.save(directory)
        store.save_json(directory, "placements", {
            "live_banks": [b.spec.name for b in self._live_banks()],
            "streams": {
                str(fs.id): {"bank": fs.bank,
                             "ckpt_frames": fs.ckpt_frames,
                             "frames_logged": len(fs.log),
                             "closed": fs.closed}
                for fs in self._streams.values()},
        })
        return directory

    @staticmethod
    def load_state(directory: str):
        """Restore a ``save_state`` snapshot: ``(registry, placements)``
        — the registry as a ``FleetRegistry``, placements as the plain
        dict ``save_state`` wrote."""
        return (registry_mod.FleetRegistry.load(directory),
                store.load_json(directory, "placements"))

    # -- migration (DESIGN.md §16.2) ----------------------------------------
    async def migrate(self, fs: FleetStream, dst_name: str) -> None:
        """Live-migrate one stream: suspend → ``checkpoint/store`` →
        resume on ``dst_name``.

        Ordering (§16.2): the stream is fenced on the source (no new
        steps include it), any in-flight step completes, the session is
        suspended with a durable copy under the fleet state root, and
        the ``Handoff`` — suspended state + undelivered frames with
        their original futures — is adopted by the destination.  The
        client observes nothing but latency; the trajectory is bitwise
        unchanged (``tests/test_fleet.py``).
        """
        dst = self._banks[dst_name]
        if dst.dead:
            raise BankFailure(f"cannot migrate to dead bank {dst_name!r}")
        if fs.closed or fs.bank == dst_name:
            return
        loop = asyncio.get_running_loop()
        async with fs.lock:
            if fs.closed or fs.bank == dst_name:
                return
            src = self._banks[fs.bank]
            fs.ready.clear()
            t0 = loop.time()
            try:
                h = await src.fe.handoff(fs.handle,
                                         directory=self._stream_dir(fs))
                if h.suspended is not None:
                    fs.ckpt_frames = int(h.suspended.frames_done)
                fs.handle = await dst.fe.adopt(h)
                src.streams.discard(fs.id)
                dst.streams.add(fs.id)
                fs.bank = dst_name
                self.metrics.inc("migrations")
                self.metrics.observe("migration_ms",
                                     (loop.time() - t0) * 1e3)
                self.metrics.observe("migration_stall_frames",
                                     len(h.pending))
            finally:
                fs.ready.set()
        self._kick(fs)

    # -- elasticity ---------------------------------------------------------
    async def scale_out(self, name: str | None = None) -> str:
        """Start a standby bank (first available, or the named spec);
        returns its name."""
        spec = None
        if name is None:
            for cand in self.registry.standbys():
                if cand.name not in self._banks:
                    spec = cand
                    break
            if spec is None:
                raise RuntimeError("no standby bank spec available")
        else:
            spec = self.registry.get(name)
        if spec.name in self._banks:
            raise ValueError(f"bank {spec.name!r} is already live")
        if spec.standby:
            self.registry.remove(spec.name)
            spec = dataclasses.replace(spec, standby=False)
            self.registry.register(spec)
        await self._start_bank(spec)
        self.metrics.inc("scale_out_events")
        return spec.name

    async def scale_in(self, name: str) -> None:
        """Drain the named bank — migrating every open stream to the
        policy's choice among the others — then retire it to standby."""
        bank = self._banks[name]
        others = [b for b in self._live_banks() if b is not bank]
        open_ids = [i for i in sorted(bank.streams)
                    if not self._streams[i].closed]
        if open_ids and not others:
            raise RuntimeError(f"cannot drain {name!r}: no other live bank")
        for fid in open_ids:
            views = [self._view(b) for b in others]
            await self.migrate(self._streams[fid], self.policy.choose(views))
        await self._retire_bank(bank)
        del self._banks[name]
        self.registry.remove(name)
        self.registry.register(dataclasses.replace(bank.spec, standby=True))
        self.metrics.inc("scale_in_events")

    # -- internals: banks ---------------------------------------------------
    def _live_banks(self) -> list[_Bank]:
        return [b for b in self._banks.values() if not b.dead]

    async def _start_bank(self, spec: registry_mod.BankSpec) -> _Bank:
        loop = asyncio.get_running_loop()
        ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"ppf-bank-{spec.name}")
        server = await loop.run_in_executor(ex, self._make_server, spec)
        fcfg = self.config.frontend
        if fcfg.park_dir is not None:
            fcfg = dataclasses.replace(
                fcfg, park_dir=os.path.join(fcfg.park_dir, spec.name))
        fe = frontend_mod.ParticleFrontend(
            server, fcfg, metrics=metrics_mod.Metrics(), executor=ex)
        await fe.start()
        if self._warm_frame is not None:
            # compile tiers before traffic lands, so the hang detector
            # never mistakes a cold bank's compile for a stall
            await fe.warmup(self._warm_frame)
        bank = _Bank(spec=spec, server=server, fe=fe, executor=ex,
                     started_at=loop.time())
        bank.progress_at = bank.started_at
        self._banks[spec.name] = bank
        fe._task.add_done_callback(
            lambda task, b=bank: self._on_bank_exit(b, task))
        self.metrics.inc("banks_started")
        return bank

    async def _retire_bank(self, bank: _Bank) -> None:
        task = bank.fe._task
        if bank.dead:
            if task is not None and not task.done():
                task.cancel()
        else:
            try:
                await bank.fe.stop()
            except Exception:
                self.metrics.inc("stop_errors")
        bank.executor.shutdown(wait=False, cancel_futures=True)

    def _on_bank_exit(self, bank: _Bank, task: asyncio.Task) -> None:
        """Done-callback on a bank's scheduler task: a non-cancel exit
        is a crash — trigger recovery (DESIGN.md §16.3)."""
        if task.cancelled():
            return
        err = task.exception()
        if err is None or bank.dead or not self._running:
            return

        async def _guarded() -> None:
            try:
                await self._recover_bank(bank, err)
            except Exception as rec_err:     # recovery must never die silent
                self.last_control_error = rec_err
                self.metrics.inc("recovery_errors")

        asyncio.ensure_future(_guarded())

    def _view(self, bank: _Bank) -> registry_mod.BankView:
        """Build the placement-policy load view from the bank's
        metrics snapshot (§16.1)."""
        live = [self._streams[i] for i in bank.streams
                if not self._streams[i].closed]
        series = bank.fe.metrics.snapshot()["series"]
        return registry_mod.BankView(
            name=bank.spec.name, capacity=bank.spec.capacity,
            live_streams=len(live), occupancy=bank.server.occupancy,
            queue_depth=sum(fs.queue_depth for fs in live),
            step_ms_p50=series.get("step_ms", {}).get("p50", 0.0),
            ess_mean=series.get("ess", {}).get("mean", 0.0))

    # -- internals: the frame pump ------------------------------------------
    def _kick(self, fs: FleetStream) -> None:
        """Ensure the stream's pump coroutine is running."""
        if not fs.pumping and not fs.closed:
            asyncio.ensure_future(self._pump(fs))

    async def _pump(self, fs: FleetStream) -> None:
        """Feed logged frames to the stream's current bank, in order.

        One pump per stream.  ``fs.lock`` serializes each dispatch
        against migration/recovery, so a frame is counted as submitted
        only on the bank it actually reached; a handle poisoned mid-call
        (handoff or failure recovery) raises ``ValueError`` and the
        frame retries against the stream's new home.
        """
        if fs.pumping:
            return
        fs.pumping = True
        try:
            while not fs.closed and fs.submitted < len(fs.log):
                await fs.ready.wait()
                bank = self._banks.get(fs.bank)
                if bank is None or bank.dead:
                    await asyncio.sleep(self.config.rebalance_interval)
                    continue                 # recovery re-homes us shortly
                async with fs.lock:
                    if fs.closed or fs.bank != bank.spec.name or bank.dead:
                        continue
                    idx = fs.submitted
                    if idx >= len(fs.log):
                        break
                    try:
                        ffut = await bank.fe.submit(fs.handle, fs.log[idx])
                    except ValueError:
                        continue             # handle poisoned: re-route
                    fs.submitted = idx + 1
                    self._chain(ffut, fs.results[idx])
        finally:
            fs.pumping = False

    @staticmethod
    def _chain(ffut: asyncio.Future, cfut: asyncio.Future) -> None:
        """Forward a frontend result to the client future.  Failures
        and cancellations are swallowed: a frame whose bank died is
        re-delivered by recovery replay, resolving the same ``cfut``."""
        def _done(f: asyncio.Future) -> None:
            # retrieve unconditionally: an orphaned frame's failure must
            # not fire the never-retrieved warning after replay wins
            err = None if f.cancelled() else f.exception()
            if cfut.done() or f.cancelled() or err is not None:
                return                       # recovery re-delivers instead
            cfut.set_result(f.result())
        ffut.add_done_callback(_done)

    # -- internals: failure recovery (DESIGN.md §16.3) ----------------------
    async def _recover_bank(self, bank: _Bank, err: BaseException) -> None:
        """Declare ``bank`` dead and re-home every open stream it held:
        restore each from its newest durable checkpoint (or its initial
        key) and replay the logged frames after it — bitwise the
        uninterrupted trajectory."""
        if bank.dead or not self._running:
            return
        bank.dead = True
        self.last_control_error = err
        self.metrics.inc("bank_failures")
        victims = [self._streams[i] for i in sorted(bank.streams)
                   if not self._streams[i].closed]
        bank.streams.clear()
        for fs in victims:
            # poison the dead bank's handle first: any submit blocked in
            # its backpressure wait raises and releases the stream lock
            fs.handle._closed = True
            fs.handle._not_full.set()
            fs.ready.clear()
        if not self._live_banks():
            await self._emergency_capacity(bank)
        for fs in victims:
            await self._rehome(fs)
        self.metrics.inc("sessions_recovered", len(victims))

    async def _rehome(self, fs: FleetStream) -> None:
        """Move one stream off a dead bank: adopt its durable state on
        a live bank and rewind the pump to replay undelivered frames."""
        async with fs.lock:
            if fs.closed:
                fs.ready.set()
                return
            dst = self._banks[self.policy.choose(
                [self._view(b) for b in self._live_banks()])]
            sus = None
            directory = self._stream_dir(fs)
            step = store.latest_step(directory)
            if step is not None:
                sus = sessions.SuspendedSession.load(
                    directory, dst.server.blank_suspended(), step=step)
                fs.ckpt_frames = int(sus.frames_done)
            else:
                fs.ckpt_frames = 0
            fs.handle = await dst.fe.adopt(frontend_mod.Handoff(
                key=fs.key, suspended=sus, pending=[]))
            dst.streams.add(fs.id)
            fs.bank = dst.spec.name
            fs.submitted = fs.ckpt_frames    # replay everything after
            fs.ready.set()
        self._kick(fs)

    async def _emergency_capacity(self, dead: _Bank) -> None:
        """All banks dead: activate a standby, or respawn a clone of the
        dead bank's spec so recovery always has a destination."""
        for spec in self.registry.standbys():
            if spec.name not in self._banks:
                await self.scale_out(spec.name)
                return
        clone = registry_mod.BankSpec(
            name=f"{dead.spec.name}.r{next(self._respawns)}",
            capacity=dead.spec.capacity)
        self.registry.register(clone)
        await self._start_bank(clone)

    # -- internals: the control loop ----------------------------------------
    async def _control_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.config.rebalance_interval)
            try:
                for bank in self._hang_suspects(loop.time()):
                    await self._recover_bank(bank, BankFailure(
                        f"bank {bank.spec.name!r} held pending frames "
                        f"with no progress for {self.config.fail_timeout}s"))
                if self.config.auto_scale:
                    await self._autoscale()
                await self._rebalance_once()
            except asyncio.CancelledError:
                raise
            except Exception as control_err:       # keep the fleet alive
                self.last_control_error = control_err
                self.metrics.inc("control_errors")

    def _hang_suspects(self, now: float) -> list[_Bank]:
        """Banks holding pending frames whose delivered-frame counter
        has not moved for ``fail_timeout`` seconds."""
        out = []
        for bank in self._live_banks():
            frames = bank.fe.metrics.counter("frames")
            pending = sum(self._streams[i].queue_depth for i in bank.streams
                          if not self._streams[i].closed)
            if frames != bank.progress_frames or pending == 0:
                bank.progress_frames = frames
                bank.progress_at = now
            elif now - bank.progress_at > self.config.fail_timeout:
                out.append(bank)
        return out

    async def _autoscale(self) -> None:
        """Watermark-driven elasticity over fleet residency pressure."""
        live = self._live_banks()
        if not live:
            return
        n_open = len([fs for fs in self._streams.values() if not fs.closed])
        capacity = sum(b.spec.capacity for b in live)
        ratio = n_open / capacity
        if ratio > self.config.scale_out_watermark:
            if any(s.name not in self._banks
                   for s in self.registry.standbys()):
                await self.scale_out()
        elif (len(live) > self.config.min_banks
              and ratio < self.config.scale_in_watermark):
            victim = min(live, key=lambda b: (len(b.streams), b.spec.name))
            rest = capacity - victim.spec.capacity
            if rest and n_open / rest <= self.config.scale_out_watermark:
                await self.scale_in(victim.spec.name)

    async def _rebalance_once(self) -> None:
        """Hottest-to-coldest session migration until the pressure gap
        closes or the per-tick budget runs out (§16.1)."""
        for _ in range(self.config.max_migrations_per_tick):
            live = self._live_banks()
            if len(live) < 2:
                return
            views = [self._view(b) for b in live]
            hot = max(views, key=lambda v: (v.load, v.name))
            cold = min(views, key=lambda v: (v.load, v.name))
            if hot.load - cold.load <= self.config.imbalance_threshold:
                return
            fs = self._pick_migrant(self._banks[hot.name])
            if fs is None:
                return
            await self.migrate(fs, cold.name)

    def _pick_migrant(self, bank: _Bank) -> FleetStream | None:
        """Cheapest stream to move: fewest undelivered frames (each one
        is a frame the move stalls), oldest id breaking ties."""
        cands = [self._streams[i] for i in bank.streams
                 if not self._streams[i].closed
                 and self._streams[i].ready.is_set()]
        if not cands:
            return None
        return min(cands, key=lambda fs: (fs.queue_depth, fs.id))

    def _stream_dir(self, fs: FleetStream) -> str:
        """One durable checkpoint directory per stream (§11.4 rule)."""
        assert self._state_root is not None
        return os.path.join(self._state_root, f"stream-{fs.id}")
