"""The port's fleet controller (``repro_torch.serve.fleet``) and registry
(``repro_torch.launch.registry``) on the CPU: the tier-1 cases of
tests/test_fleet.py, written for the port.

* Placement policies are pure functions of ``BankView`` snapshots; the
  registry round-trips through the checkpoint store's JSON documents,
  and a registry written by the reference loads in the port;
* a stream served through the fleet (placed, migrated, rebalanced,
  scaled in) delivers bit for bit the standalone filter's trajectory;
* a bank killed mid-stream (``tests/chaos.py``'s deterministic
  injection, which wraps any server's ``step``) loses no session: its
  stream is re-homed and replayed bit for bit.

No assertion rests on wall-clock speed (ROADMAP C5): the rebalance after
a scale-out is driven by calling the controller's rebalance pass, the
kill by the bank's step count, the hang detector's ``fail_timeout`` is
far beyond any test, and every await has an ``asyncio.wait_for``
timeout.
"""
import asyncio
import os

import numpy as np
import pytest
from test_torch_draws import one_torch_thread  # noqa: F401

import chaos
from repro.launch import registry as ref_registry
from repro_torch.core import ParallelParticleFilter, SIRConfig
from repro_torch.launch.registry import (BankSpec, BankView,
                                         CapacityTierAware, FleetRegistry,
                                         LeastLoaded)
from repro_torch.launch.serve import lg_demo_model
from repro_torch.serve import (FleetConfig, FleetController, FrontendConfig,
                               ParticleSessionServer)

N = 32
WAIT = 60.0          # seconds: a bound on a stuck await, never a speed gate


def frames(seed: int, k: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(k) * 0.8).astype(
        np.float32)


def standalone(seed, zs):
    return ParallelParticleFilter(
        model=lg_demo_model(), sir=SIRConfig(n_particles=N, ess_frac=0.5),
        device="cpu").run(seed, zs)


def server_factory(servers=None):
    """A ``make_server`` factory that records servers by bank name."""
    def make_server(spec):
        server = ParticleSessionServer(
            model=lg_demo_model(), sir=SIRConfig(n_particles=N, ess_frac=0.5),
            capacity=spec.capacity, device="cpu")
        if servers is not None:
            servers[spec.name] = server
        return server
    return make_server


def fast_config(**overrides):
    kw = dict(rebalance_interval=0.02, auto_scale=False, fail_timeout=WAIT,
              frontend=FrontendConfig(max_delay=0.005, park_patience=0.02))
    kw.update(overrides)
    return FleetConfig(**kw)


async def within(aw, timeout=WAIT):
    return await asyncio.wait_for(aw, timeout)


def assert_bitwise(results, seed, zs) -> None:
    ref = standalone(seed, zs)
    np.testing.assert_array_equal(np.stack([r.estimate for r in results]),
                                  ref.estimates.numpy())
    np.testing.assert_array_equal(
        np.asarray([r.log_marginal for r in results], np.float32),
        ref.log_marginal.numpy())
    np.testing.assert_array_equal(np.asarray([r.resampled for r in results]),
                                  ref.resampled.numpy())


async def submit_all(fleet, streams, zss, ts):
    """Submit frames ``ts`` of every stream; returns their futures."""
    futs = [[] for _ in streams]
    for t in ts:
        for i, fs in enumerate(streams):
            futs[i].append(await within(fleet.submit(fs, zss[i][t])))
    return futs


# ---------------------------------------------------------------------------
# Registry + placement policies
# ---------------------------------------------------------------------------

def test_bank_spec_validation():
    with pytest.raises(ValueError, match="capacity"):
        BankSpec("a", capacity=0)
    with pytest.raises(ValueError, match="name"):
        BankSpec("", capacity=4)


def test_registry_roundtrip_and_durability(tmp_path):
    reg = FleetRegistry([BankSpec("a", 4), BankSpec("b", 8),
                         BankSpec("spare", 4, standby=True)])
    assert reg.names() == ["a", "b", "spare"]
    assert [s.name for s in reg.active()] == ["a", "b"]
    assert [s.name for s in reg.standbys()] == ["spare"]
    assert reg.total_capacity() == 12
    assert reg.total_capacity(include_standby=True) == 16
    with pytest.raises(ValueError, match="already registered"):
        reg.register(BankSpec("a", 2))
    reg.save(str(tmp_path))
    back = FleetRegistry.load(str(tmp_path))
    assert back.names() == reg.names()
    assert back.get("spare").standby
    assert back.get("b").capacity == 8
    assert "a" in back and "zz" not in back and len(back) == 3
    assert back.remove("a").capacity == 4
    assert len(back) == 2


def test_registry_crosses_from_the_reference(tmp_path):
    """A registry the reference saved loads in the port, and back."""
    ref_registry.FleetRegistry([ref_registry.BankSpec("a", 4),
                                ref_registry.BankSpec("s", 2, standby=True)]
                               ).save(str(tmp_path / "ref"))
    back = FleetRegistry.load(str(tmp_path / "ref"))
    assert back.to_dict() == {"banks": [
        {"name": "a", "capacity": 4, "standby": False},
        {"name": "s", "capacity": 2, "standby": True}]}
    back.save(str(tmp_path / "port"))
    assert ref_registry.FleetRegistry.load(
        str(tmp_path / "port")).to_dict() == back.to_dict()


def view(name, capacity, live, queue=0, occ=None):
    return BankView(name=name, capacity=capacity, live_streams=live,
                    occupancy=min(live, capacity) if occ is None else occ,
                    queue_depth=queue)


def test_least_loaded_policy():
    pol = LeastLoaded()
    assert pol.choose([view("a", 4, 2), view("b", 4, 1)]) == "b"
    assert pol.choose([view("a", 4, 2, queue=5), view("b", 4, 2)]) == "b"
    assert pol.choose([view("b", 4, 2), view("a", 4, 2)]) == "a"
    with pytest.raises(ValueError, match="no live banks"):
        pol.choose([])


def test_capacity_tier_aware_policy():
    pol = CapacityTierAware()
    assert pol.choose([view("big", 8, 1), view("small", 2, 1)]) == "small"
    assert pol.choose([view("big", 8, 0), view("small", 2, 1)]) == "small"
    assert pol.choose([view("big", 8, 9), view("small", 2, 4)]) == "big"


# ---------------------------------------------------------------------------
# Parity through the fleet
# ---------------------------------------------------------------------------

def test_single_stream_parity_through_fleet():
    zs = frames(3, 8)

    async def main():
        reg = FleetRegistry([BankSpec("a", 2), BankSpec("b", 2)])
        async with FleetController(server_factory(), reg,
                                   fast_config()) as fleet:
            fs = await fleet.open(5)
            futs = [await within(fleet.submit(fs, z)) for z in zs]
            results = await within(asyncio.gather(*futs))
            await fleet.close(fs)
            return results

    assert_bitwise(asyncio.run(main()), 5, zs)


def test_migrate_mid_stream_bitwise():
    seeds = [100 + i for i in range(3)]
    zss = [frames(200 + i, 10) for i in range(3)]

    async def main():
        reg = FleetRegistry([BankSpec("a", 2), BankSpec("b", 2)])
        async with FleetController(server_factory(), reg,
                                   fast_config()) as fleet:
            streams = [await fleet.open(s) for s in seeds]
            futs = await submit_all(fleet, streams, zss, range(5))
            for fs in streams:                       # everyone moves house
                await within(fleet.migrate(fs, "b" if fs.bank == "a"
                                           else "a"))
            more = await submit_all(fleet, streams, zss, range(5, 10))
            results = [await within(asyncio.gather(*(f + g)))
                       for f, g in zip(futs, more)]
            snap = fleet.snapshot()
            for fs in streams:
                await fleet.close(fs)
            return results, snap

    results, snap = asyncio.run(main())
    for res, seed, zs in zip(results, seeds, zss):
        assert_bitwise(res, seed, zs)
    assert snap["counters"]["migrations"] == 3
    assert snap["series"]["migration_ms"]["count"] == 3
    assert snap["series"]["migration_stall_frames"]["count"] == 3


def test_rebalancer_moves_load_after_scale_out():
    """Four streams on one 2-slot bank; after a scale-out the rebalance
    pass moves load onto the new bank, bit for bit throughout."""
    seeds = [300 + i for i in range(4)]
    zss = [frames(400 + i, 8) for i in range(4)]

    async def main():
        reg = FleetRegistry([BankSpec("a", 2),
                             BankSpec("spare", 2, standby=True)])
        async with FleetController(server_factory(), reg,
                                   fast_config()) as fleet:
            streams = [await fleet.open(s) for s in seeds]
            assert all(fs.bank == "a" for fs in streams)
            futs = await submit_all(fleet, streams, zss, range(4))
            await within(fleet.scale_out())          # activates "spare"
            await within(fleet._rebalance_once())    # the control pass
            more = await submit_all(fleet, streams, zss, range(4, 8))
            results = [await within(asyncio.gather(*(f + g)))
                       for f, g in zip(futs, more)]
            snap = fleet.snapshot()
            placements = [fs.bank for fs in streams]
            for fs in streams:
                await fleet.close(fs)
            return results, snap, placements

    results, snap, placements = asyncio.run(main())
    for res, seed, zs in zip(results, seeds, zss):
        assert_bitwise(res, seed, zs)
    assert snap["counters"]["scale_out_events"] == 1
    assert snap["counters"]["migrations"] >= 1
    assert "spare" in placements


def test_scale_in_drains_bitwise():
    seeds = [500 + i for i in range(2)]
    zss = [frames(600 + i, 8) for i in range(2)]

    async def main():
        reg = FleetRegistry([BankSpec("a", 2), BankSpec("b", 2)])
        async with FleetController(server_factory(), reg,
                                   fast_config()) as fleet:
            streams = [await fleet.open(s) for s in seeds]
            futs = await submit_all(fleet, streams, zss, range(4))
            await within(fleet.scale_in("b"))
            assert all(fs.bank == "a" for fs in streams)
            more = await submit_all(fleet, streams, zss, range(4, 8))
            results = [await within(asyncio.gather(*(f + g)))
                       for f, g in zip(futs, more)]
            standby_names = [s.name for s in fleet.registry.standbys()]
            for fs in streams:
                await fleet.close(fs)
            return results, standby_names

    results, standby_names = asyncio.run(main())
    for res, seed, zs in zip(results, seeds, zss):
        assert_bitwise(res, seed, zs)
    assert standby_names == ["b"]


def test_save_state_snapshot(tmp_path):
    zs = frames(11, 6)

    async def main():
        reg = FleetRegistry([BankSpec("a", 2), BankSpec("b", 2)])
        cfg = fast_config(state_dir=str(tmp_path))
        async with FleetController(server_factory(), reg, cfg) as fleet:
            fs = await fleet.open(7)
            futs = [await within(fleet.submit(fs, z)) for z in zs]
            await within(asyncio.gather(*futs))
            await within(fleet.migrate(fs, "b" if fs.bank == "a" else "a"))
            fleet.save_state()
            placed_on = fs.bank
            await fleet.close(fs)
            return fs.id, placed_on

    fid, placed_on = asyncio.run(main())
    reg, placements = FleetController.load_state(str(tmp_path))
    assert set(reg.names()) == {"a", "b"}
    row = placements["streams"][str(fid)]
    assert row["bank"] == placed_on
    assert row["ckpt_frames"] == 6
    assert os.path.isdir(tmp_path / f"stream-{fid}")


# ---------------------------------------------------------------------------
# Failure recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kill_at", [0, 4])
def test_kill_recovery_bitwise_small(kill_at):
    """A bank that dies (at its first step, or mid-stream) loses nothing:
    its stream is re-homed on the survivor and replayed bit for bit from
    the frame log."""
    seeds = [700 + i for i in range(2)]
    zss = [frames(800 + i, 8) for i in range(2)]
    plan = chaos.FailurePlan(kill_at_step=kill_at)

    async def main():
        def make_server(spec):
            server = server_factory()(spec)
            if spec.name == "a":
                chaos.arm(server, plan)
            return server

        reg = FleetRegistry([BankSpec("a", 2), BankSpec("b", 2)])
        async with FleetController(make_server, reg,
                                   fast_config()) as fleet:
            streams = [await fleet.open(s) for s in seeds]
            assert {fs.bank for fs in streams} == {"a", "b"}
            futs = [[await within(fleet.submit(fs, z)) for z in zs]
                    for fs, zs in zip(streams, zss)]
            results = [await within(asyncio.gather(*f)) for f in futs]
            snap = fleet.snapshot()
            placements = [fs.bank for fs in streams]
            for fs in streams:
                await fleet.close(fs)
            return results, snap, placements

    results, snap, placements = asyncio.run(main())
    assert plan.fired
    for res, seed, zs in zip(results, seeds, zss):
        assert_bitwise(res, seed, zs)
    assert snap["counters"]["bank_failures"] == 1
    assert snap["counters"]["sessions_recovered"] == 1
    assert snap["banks"]["a"]["dead"] is True
    assert all(b == "b" for b in placements)
