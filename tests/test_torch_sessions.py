"""The port's resident sessions (``repro_torch.serve.sessions``) on the CPU.

The cases of tests/test_sessions.py that do not read its golden (C1),
written for the port, on the reference's 1-D linear-Gaussian model
(``repro_torch.launch.serve.lg_demo_model``, the reference's
``lg_model``):

* parity under churn, bit for bit against the port's standalone
  ``ParallelParticleFilter`` with the same seed and frames, also as a
  hypothesis property over churn schedules (``derandomize=True``, no
  example database);
* suspend/resume on the same server, through a directory onto another
  capacity, and onto an ``EmulatedGrid`` server (the full-capacity
  program, one step program);
* the host-side payload, a wrong N rejected, the masked step freezing its
  carry and its draws, a step with nothing pending, the allocator, the
  buffer copy, a frame shape mismatch, tiers and their step programs;
* a server over a world-size-1 gloo group (a ``ProcessMesh`` and a ``(1,
  1)`` ``ProcessGrid``) is the single-device server, bit for bit under
  churn, suspend and resume (the server over several ranks is
  ``tests/test_torch_process_grid.py``'s);
* against the reference: a port session fed ``ReplayDraws`` from the JAX
  key stream (``test_torch_draws``'s streams) against the reference's
  ``ParticleSessionServer`` on the same frames, fused and composed,
  estimates and log-marginals at atol 1e-5 (tests/test_parity.py's
  bound), ESS at rtol 1e-5, ``resampled`` exactly.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
import test_torch_draws as draws_mod
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.serve import ParticleSessionServer as RefServer
from repro_torch.core import ParallelParticleFilter, SIRConfig
from repro_torch.core import filters, smc
from repro_torch.core.draws import ReplayDraws, TorchDraws
from repro_torch.core.runtime import (EmulatedMesh, ProcessGrid, ProcessMesh,
                                     make_mesh)
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.serve import lg_demo_model
from repro_torch.serve import ParticleSessionServer, SuspendedSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests", "golden"))
try:
    from generate_session import lg_model as ref_lg_model
finally:
    sys.path.pop(0)

CPU = "cpu"


def frames(seed: int, k: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(k) * 0.8).astype(
        np.float32)


def sir(n=64, ess_frac=0.5, backend="composed"):
    return SIRConfig(n_particles=n, ess_frac=ess_frac, step_backend=backend)


def server(capacity, n=64, ess_frac=0.5, **kw):
    return ParticleSessionServer(model=lg_demo_model(), sir=sir(n, ess_frac),
                                 capacity=capacity, device=CPU, **kw)


def standalone(seed, zs, n=64, ess_frac=0.5, backend="composed"):
    return ParallelParticleFilter(model=lg_demo_model(),
                                  sir=sir(n, ess_frac, backend),
                                  device=CPU).run(seed, zs)


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(res, ref) -> None:
    """Every trajectory field and the final ensemble, to the last bit."""
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        got, want = getattr(res, f), getattr(ref, f).cpu()
        assert got.shape == want.shape, f
        assert torch.equal(bits(got), bits(want)), f
    for f in ("state", "log_weights", "counts"):
        assert torch.equal(bits(getattr(res.final, f)),
                           bits(getattr(ref.final, f))), f


# ---------------------------------------------------------------------------
# Parity under churn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_session_parity_under_churn_bitwise(backend):
    """A session streamed one frame at a time, while neighbours attach,
    stream, detach and a slot is recycled, is bit for bit the standalone
    filter."""
    zs = frames(7, 24)
    ref = standalone(42, zs, n=128, ess_frac=0.6, backend=backend)
    srv = ParticleSessionServer(model=lg_demo_model(),
                                sir=sir(128, 0.6, backend), capacity=4,
                                device=CPU)
    h = srv.attach(42)
    other = srv.attach(5)
    for t in range(24):
        srv.submit(h, zs[t])
        if other is not None:
            srv.submit(other, np.float32(0.1))
        if t == 10:
            srv.detach(other)
            other = None
        if t == 15:                      # recycles the freed slot
            other = srv.attach(9)
        srv.step()
    assert_bitwise(srv.result(h), ref)


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 2),
                          st.integers(0, 2 ** 20)),
                min_size=10, max_size=10))
def test_churn_schedules_property(schedule):
    """Any churn schedule on the other slots (attach, detach, bursts of
    0-2 frames each) leaves the pinned session bit for bit the
    standalone filter, and builds at most one step program a tier."""
    zs = frames(100, len(schedule))
    ref = standalone(2000, zs)
    srv = server(3)
    h = srv.attach(2000)
    others = []
    for t, (action, burst, seed) in enumerate(schedule):
        srv.submit(h, zs[t])
        if action == 0 and len(others) < 2:
            others.append(srv.attach(seed))
        elif action == 1 and others:
            srv.detach(others.pop(seed % len(others)))
        for o in others:
            for _ in range(burst):
                srv.submit(o, np.float32(0.3))
        srv.step()
    assert_bitwise(srv.result(h), ref)
    assert 1 <= srv.step_traces <= len(srv.tiers)


def test_interleaved_sessions_both_match():
    """Two sessions stepped in one program both reproduce their
    standalone runs (no coupling through the bank)."""
    za, zb = frames(1, 10), frames(2, 10)
    srv = server(2)
    ha, hb = srv.attach(11), srv.attach(22)
    for t in range(10):
        srv.submit(ha, za[t])
        srv.submit(hb, zb[t])
        srv.step()
    assert_bitwise(srv.result(ha), standalone(11, za))
    assert_bitwise(srv.result(hb), standalone(22, zb))


# ---------------------------------------------------------------------------
# Tiers, step programs, slot lifecycle
# ---------------------------------------------------------------------------

def test_step_programs_bounded_by_tiers_under_churn():
    """Churn builds at most one step program a tier, every tick hits a
    tier, and there is no executable cache to report."""
    srv = server(4, n=32)
    assert srv.tiers == (1, 2, 4)
    handles = [srv.attach(i) for i in range(4)]
    for t in range(20):
        for i, h in enumerate(handles):
            if h is not None and (t + i) % 3:      # ragged submission
                srv.submit(h, np.float32(0.1 * i))
        if t == 5:
            srv.detach(handles[1])
            handles[1] = None
        if t == 9:
            srv.detach(handles[3])
            handles[3] = None
        if t == 12:
            handles[1] = srv.attach(100)
        srv.step()
    assert 1 <= srv.step_traces <= len(srv.tiers)
    assert srv.jit_cache_size() is None
    assert set(srv.tier_hits) == set(srv.tiers)
    assert sum(srv.tier_hits.values()) == 20


def test_fixed_occupancy_builds_one_program():
    """Three ready sessions every tick stay in tier 4: one program."""
    srv = server(8, n=32)
    handles = [srv.attach(i) for i in range(3)]
    for _ in range(10):
        for h in handles:
            srv.submit(h, np.float32(0.2))
        srv.step()
    assert srv.step_traces == 1
    assert srv.tier_hits[4] == 10


def test_step_with_nothing_pending_is_free():
    srv = server(2, n=16)
    assert srv.step() == 0
    assert srv.step_traces == 0
    srv.synchronize()                  # nothing stepped: a no-op


def test_slot_allocator_full_and_recycle():
    srv = server(2, n=16)
    a = srv.attach(0)
    b = srv.attach(1)
    with pytest.raises(RuntimeError, match="server full"):
        srv.attach(2)
    srv.detach(a)
    c = srv.attach(3)
    assert c.slot == a.slot            # lowest freed slot is reused
    with pytest.raises(KeyError):
        srv.submit(a, np.float32(0.0))     # stale handle rejected
    assert srv.occupancy == 2
    srv.detach(b)
    srv.detach(c)
    assert srv.occupancy == 0


def test_submit_copies_reused_capture_buffer():
    """Queued frames do not alias the client's reused buffer, numpy or
    torch."""
    zs = frames(5, 8)
    ref = standalone(21, zs)
    for buf in (np.zeros((), np.float32), torch.zeros(())):
        srv = server(1)
        h = srv.attach(21)
        for t in range(8):
            buf[...] = float(zs[t])
            srv.submit(h, buf)
        assert_bitwise(srv.result(h), ref)


def test_frame_shape_mismatch_rejected():
    srv = server(1, n=16)
    h = srv.attach(0)
    srv.submit(h, np.float32(0.0))
    with pytest.raises(ValueError, match="does not match"):
        srv.submit(h, np.zeros((3,), np.float32))


def test_result_before_any_frame_raises_and_latest_is_none():
    srv = server(1, n=16)
    h = srv.attach(0)
    assert srv.latest(h) is None
    with pytest.raises(ValueError, match="no filtered frames"):
        srv.result(h)


def test_latest_reads_the_last_row():
    zs = frames(8, 3)
    ref = standalone(4, zs)
    srv = server(2)
    h = srv.attach(4)
    for z in zs:
        srv.submit(h, z)
        srv.step()
    est, ess, log_z, res, anc = srv.latest(h)
    assert isinstance(est, np.ndarray) and anc.shape == (0,)
    np.testing.assert_array_equal(est, ref.estimates[-1].numpy())
    assert float(ess) == float(ref.ess[-1])
    assert bool(res) == bool(ref.resampled[-1])


def test_warm_tiers_is_a_value_level_no_op():
    """Warming every tier between frames changes no bit."""
    zs = frames(9, 6)
    srv = server(4)
    h = srv.attach(31)
    for t, z in enumerate(zs):
        srv.submit(h, z)
        srv.step()
        if t == 2:
            srv.warm_tiers(np.float32(0.0))
    assert_bitwise(srv.result(h), standalone(31, zs))
    with pytest.raises(ValueError, match="does not match"):
        srv.warm_tiers(np.zeros(2, np.float32))


# ---------------------------------------------------------------------------
# Suspend / resume
# ---------------------------------------------------------------------------

def test_suspend_resume_same_server_bitwise():
    zs = frames(3, 20)
    ref = standalone(8, zs)
    srv = server(2)
    h = srv.attach(8)
    for t in range(9):
        srv.submit(h, zs[t])
    sus = srv.suspend(h)               # drains the queue first
    assert sus.frames_done == 9
    assert srv.occupancy == 0
    h2 = srv.resume(sus)
    for t in range(9, 20):
        srv.submit(h2, zs[t])
    res = srv.result(h2)
    assert res.estimates.shape[0] == 20
    assert_bitwise(res, ref)


def test_suspend_to_directory_resume_other_capacity_bitwise(tmp_path):
    """The ensemble and the generator state round-trip through
    checkpoint.store onto a server of another capacity."""
    zs = frames(4, 16)
    ref = standalone(9, zs)
    srv = server(4)
    h = srv.attach(9)
    other = srv.attach(10)
    for t in range(7):
        srv.submit(h, zs[t])
        srv.submit(other, np.float32(0.5))
    srv.suspend(h, directory=str(tmp_path))
    srv2 = server(1)
    h2 = srv2.resume_from(str(tmp_path))
    for t in range(7, 16):
        srv2.submit(h2, zs[t])
    assert_bitwise(srv2.result(h2), ref)


def test_suspend_resume_across_grid_sizes_bitwise():
    """Suspend on the single-device server, resume on servers whose bank
    is sharded over an emulated grid's bank axis (the full-capacity
    program, one step program for life) with churn beside it."""
    zs = frames(6, 12)
    ref = standalone(13, zs)
    for mesh, capacity in ((make_mesh((8,), ("bank",)), 8),
                           (make_mesh((2, 4), ("bank", "data")), 4),
                           (EmulatedMesh(2, "bank"), 2)):
        srv = server(2)
        h = srv.attach(13)
        for t in range(6):
            srv.submit(h, zs[t])
        sus = srv.suspend(h)
        big = server(capacity, mesh=mesh)
        assert big.tiers == (capacity,)
        h2 = big.resume(sus)
        other = None
        for t in range(6, 12):
            big.submit(h2, zs[t])
            if other is None:
                other = big.attach(1000 + t)
            else:
                big.detach(other)
                other = None
            if other is not None:
                big.submit(other, np.float32(0.5))
            big.step()
        assert_bitwise(big.result(h2), ref)
        assert big.step_traces == 1
        assert big.tier_hits == {capacity: 6}


def test_suspended_payload_is_host_side(tmp_path):
    """The payload is host arrays only, the generator state included, and
    survives the store."""
    srv = server(1, n=32)
    h = srv.attach(0)
    srv.submit(h, np.float32(0.3))
    sus = srv.suspend(h, directory=str(tmp_path))
    leaves = [sus.generator_state, sus.state, sus.log_weights, sus.counts,
              sus.estimates, sus.ess, sus.log_marginal, sus.resampled,
              sus.ancestors]
    assert all(isinstance(x, np.ndarray) for x in leaves)
    assert sus.generator_state.dtype == np.uint8
    back = SuspendedSession.load(str(tmp_path), srv.blank_suspended())
    for f in ("generator_state", "state", "log_weights", "counts",
              "estimates", "ess", "log_marginal", "resampled", "ancestors"):
        np.testing.assert_array_equal(getattr(back, f), getattr(sus, f))
    assert back.frames_done == 1


def test_suspend_without_frames_and_resume():
    zs = frames(12, 4)
    srv = server(1)
    h = srv.attach(17)
    sus = srv.suspend(h)
    assert sus.frames_done == 0 and sus.ess.shape == (0,)
    h2 = srv.resume(sus)
    for z in zs:
        srv.submit(h2, z)
    assert_bitwise(srv.result(h2), standalone(17, zs))


def test_resume_wrong_particle_count_rejected():
    srv = server(1, n=32)
    h = srv.attach(0)
    srv.submit(h, np.float32(0.0))
    sus = srv.suspend(h)
    with pytest.raises(ValueError, match="particles"):
        server(1, n=64).resume(sus)


def test_suspend_needs_a_generator():
    srv = server(1, n=4)
    h = srv.attach(ReplayDraws([("normal", np.zeros((4, 1)))]))
    with pytest.raises(TypeError, match="torch.Generator"):
        srv.suspend(h)


def test_meshes_and_capacity_validated():
    with pytest.raises(TypeError, match="ProcessMesh or ProcessGrid"):
        server(2, mesh=object())
    with pytest.raises(ValueError, match="not in mesh"):
        server(2, mesh=EmulatedMesh(2, "data"))
    with pytest.raises(ValueError, match="not divisible"):
        server(3, mesh=EmulatedMesh(2, "bank"))
    with pytest.raises(ValueError, match="capacity"):
        server(0)
    assert server(2, mesh=EmulatedMesh(1, "bank")).tiers == (1, 2)


def test_world_one_process_server_matches_single_device(tmp_path):
    """A server over a world-size-1 gloo group (a ``ProcessMesh`` on the
    bank axis, and a ``(1, 1)`` ``ProcessGrid``) is the single-device
    server: the same tiers, and under churn with a suspend and a resume
    the same bits as the standalone filter."""
    zs = frames(21, 10)
    ref = standalone(31, zs)
    mesh = launch_mesh.init_process_mesh(
        "gloo", rank=0, world=1, init_method=f"file://{tmp_path}/rdv")
    try:
        grid = ProcessGrid("gloo", (1, 1), ("bank", "data"))
        for m in (ProcessMesh("gloo", "bank"), grid):
            srv = server(4, mesh=m)
            assert srv.mesh is None and srv.tiers == server(4).tiers
            h = srv.attach(31)
            other = srv.attach(7)
            for t in range(5):
                srv.submit(h, zs[t])
                srv.submit(other, np.float32(0.2))
                srv.step()
            srv.detach(other)
            h = srv.resume(srv.suspend(h))
            for t in range(5, 10):
                srv.submit(h, zs[t])
            assert_bitwise(srv.result(h), ref)
        assert mesh.shards == 1
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The masked step the server rides on
# ---------------------------------------------------------------------------

def test_masked_step_freezes_carry_and_zeroes_outputs():
    model = lg_demo_model()
    cfg = sir(32)
    step = smc.make_masked_step(smc.make_sir_step(model, cfg))
    gen = TorchDraws.from_seed(0, CPU)
    carry = filters.member_carry([gen], model, cfg)
    before = gen.generator.get_state()
    obs = torch.tensor([0.7])
    off, off_out = step(carry, (obs, torch.tensor([False])))
    assert torch.equal(gen.generator.get_state(), before)   # no draws
    for f in ("state", "log_weights", "counts"):
        assert torch.equal(getattr(off.ensemble, f),
                           getattr(carry.ensemble, f))
    for x in (off_out.estimate, off_out.ess, off_out.log_marginal,
              off_out.resampled):
        assert not x.any()
    gen2 = TorchDraws.from_seed(0, CPU)
    carry2 = filters.member_carry([gen2], model, cfg)
    on, on_out = step(carry2, (obs, torch.tensor([True])))
    plain_gen = TorchDraws.from_seed(0, CPU)
    plain = filters.member_carry([plain_gen], model, cfg)
    ref, ref_out = smc.make_sir_step(model, cfg)(plain, obs)
    assert torch.equal(on_out.estimate, ref_out.estimate)
    assert torch.equal(on.ensemble.log_weights, ref.ensemble.log_weights)
    assert int(on.ensemble.counts.sum()) == 32


# ---------------------------------------------------------------------------
# Against the reference's server on replayed draws
# ---------------------------------------------------------------------------

def session_draws(key, n, n_frames):
    """Every draw of a reference session attached with ``key``: its
    ``member_carry`` is ``run_sir``'s (init and run streams), the LG init
    one ``normal (n, 1)``, then each step's dynamics and comb."""
    return draws_mod.run_sir_draws(
        key, n, 1, n_frames,
        init=lambda k, m: draws_mod.normal_init_draws(k, m, 1))


@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_session_matches_reference_server(backend):
    """A port session on replayed JAX draws against the reference's
    ``ParticleSessionServer`` on the same frames, with churn on both."""
    n, n_frames = 128, 12
    zs = frames(31, n_frames)
    key = jax.random.key(42)
    ref_srv = RefServer(model=ref_lg_model(), sir=RefSIR(
        n_particles=n, ess_frac=0.6, step_backend=backend), capacity=4)
    rh = ref_srv.attach(key)
    ro = ref_srv.attach(jax.random.key(5))
    srv = ParticleSessionServer(model=lg_demo_model(),
                                sir=sir(n, 0.6, backend), capacity=4,
                                device=CPU)
    replay = ReplayDraws(session_draws(key, n, n_frames))
    h = srv.attach(replay)
    o = srv.attach(5)
    for t in range(n_frames):
        ref_srv.submit(rh, zs[t])
        srv.submit(h, zs[t])
        if t < 6:
            ref_srv.submit(ro, np.float32(0.2))
            srv.submit(o, np.float32(0.2))
        if t == 6:
            ref_srv.detach(ro)
            srv.detach(o)
        ref_srv.step()
        srv.step()
    assert replay.remaining == 0
    ref = ref_srv.result(rh)
    got = srv.result(h)
    np.testing.assert_allclose(got.estimates.numpy(),
                               np.asarray(ref.estimates), atol=1e-5)
    np.testing.assert_allclose(got.log_marginal.numpy(),
                               np.asarray(ref.log_marginal), atol=1e-5)
    np.testing.assert_allclose(got.ess.numpy(), np.asarray(ref.ess),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.resampled.numpy(),
                                  np.asarray(ref.resampled))
    assert int(got.resampled.sum()) > 0, "the run must resample"


def test_servers_stepped_from_many_threads_stay_bitwise():
    """Servers stepped concurrently from more threads than cores, with a
    short switch interval (the fleet steps each bank from its own
    thread): every session still bit for bit its standalone filter."""
    import concurrent.futures

    zs = [frames(300 + i, 8) for i in range(8)]

    def drive(i):
        srv = server(2, n=32)
        h = srv.attach(400 + i)
        other = srv.attach(500 + i)
        for z in zs[i]:
            srv.submit(h, z)
            srv.submit(other, np.float32(0.2))
            srv.step()
            srv.synchronize()
        return srv.result(h)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = max(8, 2 * (os.cpu_count() or 1))
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            futs = [pool.submit(drive, i) for i in range(8)]
            done, _ = concurrent.futures.wait(futs, timeout=120)
            assert len(done) == 8, "threads did not finish"
            results = [f.result() for f in futs]
    finally:
        sys.setswitchinterval(before)
    for i, res in enumerate(results):
        assert_bitwise(res, standalone(400 + i, zs[i], n=32))
