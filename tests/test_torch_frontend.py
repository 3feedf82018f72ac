"""The port's asyncio request plane (``repro_torch.serve.frontend``) on the
CPU: the cases of tests/test_frontend.py and tests/test_frontend_fuzz.py,
written for the port.

* A stream served through the frontend (coalesced, parked, resumed,
  handed off between two frontends) delivers bit for bit the standalone
  ``ParallelParticleFilter`` trajectory with the same seed and frames;
* simultaneous arrivals share bank steps, a lone arrival fires by the
  deadline trigger;
* over-capacity admission parks through the checkpoint store and
  resumes; ``submit`` backpressures at ``max_queue``; closing a stream
  frees its slot; step programs stay within the server's tiers.

No assertion rests on wall-clock speed: counts come from the order of
events (submissions queued before the scheduler runs), and every await
of a result has an ``asyncio.wait_for`` timeout.  The fuzz is a
hypothesis property with ``derandomize=True`` and no example database.
"""
import asyncio
import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_draws import one_torch_thread  # noqa: F401

from repro_torch.core import ParallelParticleFilter, SIRConfig
from repro_torch.launch.serve import lg_demo_model
from repro_torch.serve import (FrontendConfig, Metrics, ParticleFrontend,
                               ParticleSessionServer)

N = 64
WAIT = 60.0          # seconds: a bound on a stuck await, never a speed gate


def frames(seed: int, k: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(k) * 0.8).astype(
        np.float32)


def standalone(seed, zs, n=N):
    return ParallelParticleFilter(
        model=lg_demo_model(), sir=SIRConfig(n_particles=n, ess_frac=0.5),
        device="cpu").run(seed, zs)


def make_server(capacity=4, n=N):
    return ParticleSessionServer(
        model=lg_demo_model(), sir=SIRConfig(n_particles=n, ess_frac=0.5),
        capacity=capacity, device="cpu")


async def within(aw, timeout=WAIT):
    return await asyncio.wait_for(aw, timeout)


def assert_stream_matches_standalone(results, seed, zs, n=N) -> None:
    """Per-frame results == the standalone filter, bit for bit."""
    ref = standalone(seed, zs, n)
    np.testing.assert_array_equal(np.stack([r.estimate for r in results]),
                                  ref.estimates.numpy())
    np.testing.assert_array_equal(
        np.asarray([r.log_marginal for r in results], np.float32),
        ref.log_marginal.numpy())
    np.testing.assert_array_equal(
        np.asarray([r.ess for r in results], np.float32), ref.ess.numpy())
    np.testing.assert_array_equal(np.asarray([r.resampled for r in results]),
                                  ref.resampled.numpy())


# ---------------------------------------------------------------------------
# Correctness through the plane
# ---------------------------------------------------------------------------

def test_single_stream_parity_bitwise():
    zs = frames(3, 12)

    async def main():
        async with ParticleFrontend(make_server()) as fe:
            stream = await fe.open(5)
            results = [await within(await fe.submit(stream, z)) for z in zs]
            await fe.close(stream)
            return results

    assert_stream_matches_standalone(asyncio.run(main()), 5, zs)


def test_interleaved_streams_parity_and_coalescing():
    """Four clients queue every frame before the scheduler runs: each
    tick coalesces all four (10 steps for 40 frames), every stream bit for
    bit."""
    seeds = [10 + i for i in range(4)]
    zss = [frames(20 + i, 10) for i in range(4)]

    async def main():
        fe = ParticleFrontend(make_server(capacity=4),
                              FrontendConfig(max_delay=0.05))
        async with fe:
            streams = [await fe.open(s) for s in seeds]
            futs = [[] for _ in streams]
            for t in range(10):
                for i, s in enumerate(streams):
                    futs[i].append(await fe.submit(s, zss[i][t]))
            results = [await within(asyncio.gather(*f)) for f in futs]
            return results, fe.snapshot()

    results, snap = asyncio.run(main())
    for res, seed, zs in zip(results, seeds, zss):
        assert_stream_matches_standalone(res, seed, zs)
    assert snap["counters"]["frames"] == 40
    assert snap["counters"]["steps"] == 10
    assert snap["series"]["coalesce"]["mean"] == 4.0
    assert snap["tier_hits"] == {1: 0, 2: 0, 4: 10}


def test_deadline_trigger_fires_lone_arrival():
    """With the batch trigger unreachable (3 live streams, 1 submitting)
    the deadline trigger delivers the lone frame."""
    async def main():
        fe = ParticleFrontend(make_server(capacity=4),
                              FrontendConfig(max_delay=0.02))
        async with fe:
            active = await fe.open(0)
            for i in range(2):
                await fe.open(1 + i)                 # idle neighbours
            return await within(await fe.submit(active, np.float32(0.3)))

    res = asyncio.run(main())
    assert np.isfinite(res.log_marginal) and res.latency > 0


def test_metrics_latency_series_recorded():
    async def main():
        metrics = Metrics()
        fe = ParticleFrontend(make_server(capacity=2), metrics=metrics)
        async with fe:
            s = await fe.open(1)
            for z in frames(9, 5):
                await within(await fe.submit(s, z))
        return metrics.snapshot()

    snap = asyncio.run(main())
    assert snap["series"]["latency"]["count"] == 5
    assert snap["series"]["latency"]["p50"] > 0
    assert snap["counters"]["frames"] == 5


def test_torch_frames_are_owned_copies():
    """A client reusing one torch buffer: each queued frame is a copy."""
    zs = frames(14, 6)

    async def main():
        buf = torch.zeros(())
        async with ParticleFrontend(make_server(capacity=1)) as fe:
            s = await fe.open(7)
            futs = []
            for z in zs:
                buf.fill_(float(z))
                futs.append(await fe.submit(s, buf))
            return await within(asyncio.gather(*futs))

    assert_stream_matches_standalone(asyncio.run(main()), 7, zs)


# ---------------------------------------------------------------------------
# Admission control: parking + resume
# ---------------------------------------------------------------------------

def test_over_capacity_parks_and_stays_bitwise(tmp_path):
    """6 streams on a 2-slot bank: parked through the checkpoint store,
    resumed, and every stream still bit for bit."""
    seeds = [40 + i for i in range(6)]
    zss = [frames(50 + i, 8) for i in range(6)]

    async def main():
        fe = ParticleFrontend(
            make_server(capacity=2),
            FrontendConfig(max_delay=0.005, park_patience=0.01,
                           park_dir=str(tmp_path)))
        async with fe:
            streams = [await fe.open(s) for s in seeds]
            futs = [[] for _ in streams]
            for t in range(8):
                for i, s in enumerate(streams):
                    futs[i].append(await fe.submit(s, zss[i][t]))
            results = [await within(asyncio.gather(*f)) for f in futs]
            return results, fe.snapshot()

    results, snap = asyncio.run(main())
    assert snap["counters"]["park_events"] > 0
    assert snap["counters"]["resume_events"] > 0
    for res, seed, zs in zip(results, seeds, zss):
        assert_stream_matches_standalone(res, seed, zs)
    assert any(p.startswith("stream-") for p in os.listdir(tmp_path))


def test_open_always_admits_over_capacity():
    async def main():
        fe = ParticleFrontend(make_server(capacity=2),
                              FrontendConfig(max_delay=0.005,
                                             park_patience=0.01))
        async with fe:
            streams = [await fe.open(i) for i in range(3)]
            return [await within(await fe.submit(s, np.float32(0.1)))
                    for s in streams]

    outs = asyncio.run(main())
    assert len(outs) == 3
    assert all(np.isfinite(o.log_marginal) for o in outs)


# ---------------------------------------------------------------------------
# Backpressure + lifecycle
# ---------------------------------------------------------------------------

def test_submit_backpressures_at_max_queue():
    """Ten frames submitted back to back against max_queue=2: submit
    waits (the third frame cannot queue before a delivery)."""
    async def main():
        fe = ParticleFrontend(make_server(capacity=1),
                              FrontendConfig(max_queue=2, max_delay=0.001))
        async with fe:
            s = await fe.open(0)
            futs = [await within(fe.submit(s, z)) for z in frames(8, 10)]
            await within(asyncio.gather(*futs))
            assert s.queue_depth == 0
            return fe.snapshot()

    snap = asyncio.run(main())
    assert snap["counters"]["backpressure_waits"] > 0
    assert snap["counters"]["frames"] == 10


def test_submit_to_closed_stream_raises():
    async def main():
        async with ParticleFrontend(make_server(capacity=1)) as fe:
            s = await fe.open(0)
            await fe.close(s)
            with pytest.raises(ValueError, match="closed"):
                await fe.submit(s, np.float32(0.0))

    asyncio.run(main())


def test_close_releases_slot_for_waiting_stream():
    async def main():
        fe = ParticleFrontend(make_server(capacity=1),
                              FrontendConfig(max_delay=0.001,
                                             park_patience=10.0))
        async with fe:
            a = await fe.open(0)
            await within(await fe.submit(a, np.float32(0.2)))
            b = await fe.open(1)
            fut = await fe.submit(b, np.float32(0.4))   # waits: a resident
            await fe.close(a)                           # frees the slot
            return await within(fut)

    assert np.isfinite(asyncio.run(main()).log_marginal)


def test_step_programs_bounded_by_tiers_through_frontend():
    async def main():
        server = make_server(capacity=4)
        fe = ParticleFrontend(server, FrontendConfig(max_delay=0.002))
        async with fe:
            await within(fe.warmup(np.float32(0.0)))
            streams = [await fe.open(i) for i in range(4)]
            for t in range(6):                 # ragged traffic: tier churn
                futs = [await fe.submit(s, np.float32(0.1))
                        for s in streams[:1 + (t % 4)]]
                await within(asyncio.gather(*futs))
        return server

    server = asyncio.run(main())
    assert server.step_traces == len(server.tiers)   # warm-up built all


def test_handoff_adopt_between_frontends_bitwise(tmp_path):
    """A stream handed off mid-run (with undelivered frames) to another
    frontend finishes bit for bit; the durable copy lands in the given
    directory."""
    zs = frames(60, 10)

    async def main():
        cfg = FrontendConfig(max_delay=0.002)
        async with ParticleFrontend(make_server(2), cfg) as fa, \
                ParticleFrontend(make_server(4), cfg) as fb:
            s = await fa.open(77)
            futs = [await fa.submit(s, z) for z in zs[:4]]
            await within(asyncio.gather(*futs[:2]))
            h = await within(fa.handoff(s, directory=str(tmp_path)))
            s2 = await fb.adopt(h)
            futs += [await fb.submit(s2, z) for z in zs[4:]]
            with pytest.raises(ValueError, match="closed"):
                await fa.submit(s, zs[0])                # poisoned handle
            return await within(asyncio.gather(*futs))

    assert_stream_matches_standalone(asyncio.run(main()), 77, zs)
    assert os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# Fuzz: arrival / park / resume / migrate schedules across two frontends
# ---------------------------------------------------------------------------

FUZZ_N = 32
_SERVERS: dict = {}


def cached_server(tag: str, capacity: int) -> ParticleSessionServer:
    """Servers live across examples: a slot leak in one example would
    poison the next."""
    key = (tag, capacity)
    if key not in _SERVERS:
        _SERVERS[key] = make_server(capacity, FUZZ_N)
    return _SERVERS[key]


@st.composite
def schedules(draw):
    """(capacity, per-stream frame counts, interleaved submit/migrate ops,
    seed): at most 3 streams of at most 4 frames on capacity <= 2, so 3
    streams always park."""
    n_streams = draw(st.integers(1, 3))
    capacity = draw(st.integers(1, 2))
    counts = [draw(st.integers(1, 4)) for _ in range(n_streams)]
    ops = []
    remaining = list(counts)
    if draw(st.booleans()):
        ops.append(("migrate", draw(st.integers(0, n_streams - 1))))
    while any(remaining):
        i = draw(st.sampled_from([j for j, r in enumerate(remaining) if r]))
        ops.append(("submit", i))
        remaining[i] -= 1
        if draw(st.integers(0, 3)) == 0:
            ops.append(("migrate", draw(st.integers(0, n_streams - 1))))
    return capacity, counts, ops, draw(st.integers(0, 9999))


async def drive(capacity, counts, ops, seed):
    cfg = FrontendConfig(max_delay=0.002, max_queue=2, park_patience=0.01)
    fe_a = ParticleFrontend(cached_server("a", capacity), cfg)
    fe_b = ParticleFrontend(cached_server("b", capacity), cfg)
    seeds = [seed * 13 + i for i in range(len(counts))]
    zss = [frames(seed * 17 + i, counts[i]) for i in range(len(counts))]
    async with fe_a, fe_b:
        where = {i: fe_a for i in range(len(counts))}
        handles = {i: await fe_a.open(seeds[i]) for i in range(len(counts))}
        cursor = {i: 0 for i in range(len(counts))}
        futs = {i: [] for i in range(len(counts))}
        for op, i in ops:
            if op == "submit":
                t = cursor[i]
                cursor[i] += 1
                futs[i].append(await within(
                    where[i].submit(handles[i], zss[i][t])))
            else:
                src = where[i]
                dst = fe_b if src is fe_a else fe_a
                handles[i] = await dst.adopt(
                    await within(src.handoff(handles[i])))
                where[i] = dst
        results = {i: await within(asyncio.gather(*futs[i])) for i in futs}
        for i in handles:
            await where[i].close(handles[i])
        loop = asyncio.get_running_loop()
        deadline = loop.time() + WAIT
        while (cached_server("a", capacity).occupancy
               or cached_server("b", capacity).occupancy):
            assert loop.time() < deadline, "slot leak"
            await asyncio.sleep(0.005)
    return results, zss, seeds


@settings(max_examples=8, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(schedules())
def test_fuzzed_schedules_stay_bitwise(sched):
    """Any bounded arrival/park/resume/migrate interleaving: bit for bit
    per stream, every future resolves, no slot leaks."""
    capacity, counts, ops, seed = sched
    results, zss, seeds = asyncio.run(drive(capacity, counts, ops, seed))
    for i, res in results.items():
        assert len(res) == counts[i]
        assert_stream_matches_standalone(res, seeds[i], zss[i], FUZZ_N)
