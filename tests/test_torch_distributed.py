"""The port's distributed filter — the emulated mesh's collectives, DLB,
the compressed verbs and the MPF/RNA/RPA filter — against the reference.

* Collectives over the port's leading shard dim against the reference's
  own emulation (``jax.vmap`` with an ``axis_name``, ``tests/emesh.py``):
  exactly equal on integers, at rtol = atol = 1e-6 on float reductions.
* The DLB schedulers, proportional allocation and the routing executor
  against ``repro.core.dlb`` on fixed count vectors and ensembles: ints
  exactly equal.
* ``permute``/``resample_compressed``/``materialize`` against
  ``repro.core.particles`` with the reference's draws replayed.
* ``ParallelParticleFilter(mesh=EmulatedMesh(4), dra=DRAConfig(kind))``
  for MPF, RNA and RPA against ``tests/emesh.py::run_filter`` with every
  shard's draws replayed: estimates and log-marginals at atol 1e-5
  (tests/test_parity.py), ESS at rtol 1e-5, ``resampled``, the DRA
  diagnostics and the comm accounting exactly, the final ensemble within
  1e-4 (tests/test_torch_smc.py), counts exactly: the port's local
  resample (B1's plain comb) and the reference's (the jnp comb) build
  their CDFs in different orders, so a comb point on a 1-ulp CDF tie
  could flip an ancestor; these inputs have none, and the test allows
  none.
* The port's own RNG: each DRA tracks at tests/test_tracking.py's SNR-2
  bound.
"""
import dataclasses

import emesh
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_draws as draws_mod
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.core import distributed as jdist
from repro.core import dlb as jdlb
from repro.core import particles as jparticles
from repro.core import runtime as jruntime
from repro.data.synthetic_movie import generate_movie as ref_movie
from repro.models import tracking as jtracking
from repro_torch import convert
from repro_torch.core import ParallelParticleFilter, SIRConfig
from repro_torch.core import distributed as tdist
from repro_torch.core import dlb as tdlb
from repro_torch.core import particles as tparticles
from repro_torch.core import runtime as truntime
from repro_torch.core.distributed import DRAConfig
from repro_torch.core.draws import BankDraws, ReplayDraws, TorchDraws
from repro_torch.core.runtime import EmulatedMesh
from repro_torch.data.synthetic_movie import generate_movie, tracking_rmse
from repro_torch.models.tracking import TrackingConfig, TrackingSSM

P = 4
MESH = EmulatedMesh(P)
TOL = dict(rtol=1e-6, atol=1e-6)
ATOL = 1e-5


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype))


def _vmap(fn, *args):
    """Run a per-shard reference function over the emulated mesh."""
    return jax.jit(jax.vmap(fn, axis_name=emesh.AXIS))(*args)


def _shard_weights(seed, c=48, dead=0.2):
    rng = np.random.default_rng(seed)
    lw = (2.0 * rng.standard_normal((P, c))).astype(np.float32)
    lw[rng.random((P, c)) < dead] = -np.inf
    return lw


# ---------------------------------------------------------------------------
# The emulated collectives
# ---------------------------------------------------------------------------

def test_collectives_match_the_reference_emulation():
    x = np.random.default_rng(0).standard_normal((P, 3, 2)).astype(np.float32)
    blocks = np.arange(P * P * 2, dtype=np.int32).reshape(P, P, 2)
    ring = truntime.ring(MESH)

    def shard(x, b):
        return (jruntime.psum(x, emesh.AXIS), jruntime.pmax(x, emesh.AXIS),
                jruntime.all_gather(x, emesh.AXIS),
                jruntime.ppermute(x, emesh.AXIS, ring),
                jruntime.all_to_all(b, emesh.AXIS, 0, 0),
                jruntime.axis_index(emesh.AXIS))

    want = _vmap(shard, jnp.asarray(x), jnp.asarray(blocks))
    got = (truntime.psum(_t(x), MESH), truntime.pmax(_t(x), MESH),
           truntime.all_gather(_t(x), MESH),
           truntime.ppermute(_t(x), MESH, ring),
           truntime.all_to_all(_t(blocks, np.int32), MESH),
           truntime.axis_index(MESH))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert truntime.axis_size(MESH) == P
    assert truntime.host_mesh(P) == MESH
    # a shard that receives nothing gets zeros
    part = truntime.ppermute(_t(x), MESH, ring[:2])
    assert torch.equal(part[1:3], _t(x)[0:2]) and not part[0].any()
    assert truntime.tree_bytes((_t(x), {"c": _t(blocks, np.int32)})) == \
        jruntime.tree_bytes((jnp.asarray(x), {"c": jnp.asarray(blocks)}))


@pytest.mark.parametrize("dead", [0.0, 0.3])
def test_global_statistics_match_reference(dead):
    lw = _shard_weights(1, dead=dead)

    def shard(lw):
        return (jdist.global_log_z(lw, emesh.AXIS),
                jdist.global_ess(lw, emesh.AXIS),
                jdist.effective_processes(lw, emesh.AXIS))

    want = _vmap(shard, jnp.asarray(lw))
    got = (tdist.global_log_z(_t(lw), MESH), tdist.global_ess(_t(lw), MESH),
           tdist.effective_processes(_t(lw), MESH))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# DLB
# ---------------------------------------------------------------------------

def _count_vectors():
    """Fixed count vectors: random splits of a total over 3, 8 and 24
    shards (few shapes, so the reference compiles few programs), plus
    the all-on-one and already-balanced corners."""
    rng = np.random.default_rng(5)
    out = []
    for p in (3, 8, 24) * 4:
        total = int(rng.integers(p, 4097))
        cuts = np.sort(rng.integers(0, total + 1, p - 1))
        out.append(np.diff(np.concatenate([[0], cuts, [total]])))
    out.append(np.array([0, 0, 100, 0, 0, 0, 0, 0]))
    out.append(np.full(8, 25))
    return [c.astype(np.int32) for c in out]


@pytest.mark.parametrize("sched", ["gs", "sgs", "lgs"])
def test_schedulers_match_reference(sched):
    for counts in _count_vectors():
        p = counts.shape[0]
        want_t = jdlb.balanced_targets(jnp.sum(jnp.asarray(counts)), p)
        targets = tdlb.balanced_targets(int(counts.sum()), p)
        np.testing.assert_array_equal(targets.numpy(), np.asarray(want_t))
        want = jdlb.SCHEDULERS[sched](jnp.asarray(counts), want_t)
        got = tdlb.SCHEDULERS[sched](_t(counts, np.int32), targets)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for k, v in tdlb.schedule_stats(got).items():
            assert int(v) == int(jdlb.schedule_stats(want)[k]), k


def test_proportional_allocation_matches_reference():
    for i, counts in enumerate(_count_vectors()):
        p = counts.shape[0]
        lw = np.log(counts.astype(np.float32) + 1.0)
        total = int(counts.sum())
        for frac in (1.0, 1.5, 3.0):
            cap = max(int(frac * total / p), 1)
            want = jdlb.proportional_allocation(jnp.asarray(lw), total, cap)
            got = tdlb.proportional_allocation(_t(lw), total, cap)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            if cap * p >= total:
                assert int(got.sum()) == total


def _compressed(seed, c=24, d=3):
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((P, c, d)).astype(np.float32)
    counts = rng.integers(0, 5, (P, c)).astype(np.int32)
    lw = np.where(counts > 0, rng.standard_normal((P, c)), -np.inf).astype(
        np.float32)
    return state, lw, counts


@pytest.mark.parametrize("k_cap", [2, 8])
def test_routing_matches_reference(k_cap):
    """pack_windows → all_to_all → merge_routed → materialize on a
    compressed ensemble, against the reference's per-shard program."""
    state, lw, counts = _compressed(7)
    alloc = counts.sum(1)
    targets = np.asarray(jdlb.balanced_targets(jnp.sum(alloc), P))
    sched = np.asarray(jdlb.schedule_gs(jnp.asarray(alloc),
                                        jnp.asarray(targets)))

    def shard(s, lw, c, row):
        ens = jparticles.ParticleEnsemble(s, lw, c)
        route = jdlb.route_compressed(ens, row, k_cap=k_cap,
                                      axis_name=emesh.AXIS)
        merged = jdlb.merge_routed(ens, route)
        return route, merged, jparticles.materialize(merged, 24)

    want_route, want_merged, want_mat = _vmap(
        shard, jnp.asarray(state), jnp.asarray(lw), jnp.asarray(counts),
        jnp.asarray(sched))
    ens = tparticles.ParticleEnsemble(_t(state), _t(lw),
                                      _t(counts, np.int32))
    route = tdlb.route_compressed(ens, _t(sched, np.int32), k_cap=k_cap,
                                  mesh=MESH)
    merged = tdlb.merge_routed(ens, route)
    mat = tparticles.materialize(merged, 24)
    for g, w in zip(route, want_route):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip((merged, mat), (want_merged, want_mat)):
        for f in ("state", "log_weights", "counts"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)))
    # conservation: every unit kept, received or counted as overflow
    before = int(counts.sum())
    after = int(merged.counts.sum())
    assert after == before


# ---------------------------------------------------------------------------
# The compressed / DRA verbs
# ---------------------------------------------------------------------------

def test_permute_and_materialize_match_reference():
    state, lw, counts = _compressed(3)
    order = np.stack([np.random.default_rng(i).permutation(24)
                      for i in range(P)])
    ens = tparticles.ParticleEnsemble(_t(state), _t(lw),
                                      _t(counts, np.int32))
    for i in range(P):
        ref = jparticles.ParticleEnsemble(jnp.asarray(state[i]),
                                          jnp.asarray(lw[i]),
                                          jnp.asarray(counts[i]))
        perm = jparticles.permute(ref, jnp.asarray(order[i]))
        got = tparticles.permute(ens, _t(order, np.int64))
        for cap in (24, 40, 16):
            want = jparticles.materialize(ref, cap)
            mat = tparticles.materialize(ens, cap)
            for f in ("state", "log_weights", "counts"):
                np.testing.assert_array_equal(getattr(mat, f)[i].numpy(),
                                              np.asarray(getattr(want, f)))
        for f in ("state", "log_weights", "counts"):
            np.testing.assert_array_equal(getattr(got, f)[i].numpy(),
                                          np.asarray(getattr(perm, f)))


@pytest.mark.parametrize("scheme", ["systematic", "metropolis"])
def test_resample_compressed_matches_reference(scheme):
    """Per-shard ``n_out`` (RPA's allocation) over a comb of ``capacity``
    lanes, the fill weight given and defaulted."""
    state, lw, counts = _compressed(9)
    n_outs = np.array([30, 0, 48, 17])
    keys = [jax.random.key(60 + i) for i in range(P)]
    for fill in (None, -3.5):
        replays = []
        for key in keys:
            if scheme == "systematic":
                replays.append(ReplayDraws([("uniform", np.asarray(
                    jax.random.uniform(key, ())))]))
            else:
                kp, ku = jax.random.split(key)
                replays.append(ReplayDraws([
                    ("randint", np.asarray(jax.random.randint(
                        kp, (48, 32), 0, 24, jnp.int32))),
                    ("uniform", np.asarray(jax.random.uniform(
                        ku, (48, 32))))]))
        ens = tparticles.ParticleEnsemble(_t(state), _t(lw),
                                          _t(counts, np.int32))
        got = tparticles.resample_compressed(
            BankDraws(replays), ens, torch.tensor(n_outs), scheme=scheme,
            capacity=48, fill_log_weight=fill)
        for i, key in enumerate(keys):
            ref = jparticles.ParticleEnsemble(jnp.asarray(state[i]),
                                              jnp.asarray(lw[i]),
                                              jnp.asarray(counts[i]))
            want = jparticles.resample_compressed(
                key, ref, jnp.asarray(n_outs[i]), scheme=scheme,
                capacity=48, fill_log_weight=fill)
            np.testing.assert_array_equal(got.counts[i].numpy(),
                                          np.asarray(want.counts))
            np.testing.assert_array_equal(got.log_weights[i].numpy(),
                                          np.asarray(want.log_weights))


# ---------------------------------------------------------------------------
# The distributed filter against tests/emesh.py
# ---------------------------------------------------------------------------

C, FRAMES = 64, 4


def shard_stream(key, shard, kind, c, n_frames):
    """Every draw shard ``shard`` takes in the reference's distributed
    run: ``fold_in(key, shard)`` split into init and run streams, the
    tracking init, then per frame ``split(k_run, 3)`` into (carry,
    dynamics, resample): the dynamics normals and the DRA's draws — one
    comb uniform, and for RNA first ``split(k_res)`` into the comb's
    uniform and the shuffle's permutation."""
    k_init, k_run = jax.random.split(jax.random.fold_in(key, shard))
    draws = draws_mod.tracking_init_draws(k_init, c)
    for _ in range(n_frames):
        k_run, k_dyn, k_res = jax.random.split(k_run, 3)
        draws.append(("normal", np.asarray(jax.random.normal(k_dyn, (c, 5)))))
        if kind == "rna":
            k_res, k_perm = jax.random.split(k_res)
        draws.append(("uniform", np.asarray(jax.random.uniform(k_res, ()))))
        if kind == "rna":
            draws.append(("permutation",
                          np.asarray(jax.random.permutation(k_perm, c))))
    return draws


DRA_CASES = {"mpf": dict(kind="mpf"), "rna": dict(kind="rna"),
             "rpa": dict(kind="rpa", k_cap=8),
             "rpa-gs": dict(kind="rpa", scheduler="gs", k_cap=8)}


@pytest.mark.parametrize("case", list(DRA_CASES))
def test_dra_filter_matches_emulated_reference(case):
    fields = DRA_CASES[case]
    n = P * C
    cfg = jtracking.TrackingConfig(img_size=(32, 32), v_init=1.5)
    frames = np.array(ref_movie(jax.random.key(0), cfg,
                                n_frames=FRAMES).frames)
    key = jax.random.key(7)
    outs, final = emesh.run_filter(
        jtracking.TrackingSSM(cfg), RefSIR(n_particles=n),
        jdist.DRAConfig(**fields), key, jnp.asarray(frames), P)
    draws = BankDraws([ReplayDraws(shard_stream(key, i, fields["kind"], C,
                                                FRAMES)) for i in range(P)])
    res = ParallelParticleFilter(
        TrackingSSM(draws_mod.port_config(cfg)), SIRConfig(n_particles=n),
        device="cpu", mesh=MESH, dra=DRAConfig(**fields)).run(draws, frames)
    assert all(m.remaining == 0 for m in draws.members)
    np.testing.assert_allclose(res.estimates.numpy(), outs.estimate[0],
                               atol=ATOL)
    np.testing.assert_allclose(res.log_marginal.numpy(),
                               outs.log_marginal[0], atol=ATOL)
    np.testing.assert_allclose(res.ess.numpy(), outs.ess[0], rtol=1e-5)
    np.testing.assert_array_equal(res.resampled.numpy(), outs.resampled[0])
    assert set(res.diag) == set(outs.diag)
    for k, v in res.diag.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(outs.diag[k][0]),
                                      err_msg=k)
    ref_final = jax.tree_util.tree_map(
        lambda x: np.asarray(x).reshape((P, C) + x.shape[2:]), final)
    np.testing.assert_array_equal(res.final.counts.numpy(), ref_final.counts)
    np.testing.assert_allclose(res.final.state.numpy(), ref_final.state,
                               atol=1e-4)
    np.testing.assert_allclose(res.final.log_weights.numpy(),
                               ref_final.log_weights, atol=ATOL)


def test_one_shard_mesh_takes_the_local_path():
    """A 1-shard mesh runs the single-device filter, as the reference's
    1-device mesh does."""
    cfg = TrackingConfig(img_size=(24, 24))
    frames = torch.randn(3, 24, 24, generator=torch.Generator().manual_seed(1))
    model = TrackingSSM(cfg)
    sir = SIRConfig(n_particles=64)
    local = ParallelParticleFilter(model, sir, device="cpu").run(3, frames)
    one = ParallelParticleFilter(model, sir, device="cpu",
                                 mesh=EmulatedMesh(1),
                                 dra=DRAConfig(kind="rpa")).run(3, frames)
    for a, b in zip(local[:5], one[:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["mpf", "rna", "rpa"])
def test_port_dra_tracks_at_snr2(kind):
    """tests/test_tracking.py's SNR-2 bound (1.5 px after 10 frames,
    64×64, N = 8192) for each DRA with the port's own RNG: 4 shards of
    2048, one seeded stream per shard."""
    cfg = TrackingConfig(img_size=(64, 64), v_init=1.5)
    movie = generate_movie(TorchDraws.from_seed(0, "cpu"), cfg, n_frames=40)
    pf = ParallelParticleFilter(TrackingSSM(cfg), SIRConfig(
        n_particles=8192, ess_frac=0.5), device="cpu", mesh=MESH,
        dra=DRAConfig(kind=kind))
    res = pf.run(1, movie.frames)
    rmse = float(tracking_rmse(res.estimates, movie.trajectories[:, 0],
                               warmup=10))
    assert rmse < 1.5, rmse
    assert bool(torch.isfinite(res.log_marginal).all())
    assert bool(torch.isfinite(res.ess).all())
    assert res.final.state.shape == (P, 2048, 5)
    again = pf.run(1, movie.frames)
    assert torch.equal(again.estimates, res.estimates)


# ---------------------------------------------------------------------------
# Configs and the ensemble layout across the packages
# ---------------------------------------------------------------------------

def test_dra_config_converter_carries_reference_fields():
    ref = jdist.DRAConfig(kind="rpa", scheduler="sgs", k_cap=16, slack=1.5,
                          exchange_ratio=0.3)
    want = dataclasses.asdict(ref)
    assert want.pop("resample_backend") == "auto"
    assert dataclasses.asdict(convert.dra_config(
        dataclasses.asdict(ref))) == want
    with pytest.raises(ValueError, match="resample_backend"):
        convert.dra_config(dataclasses.asdict(dataclasses.replace(
            ref, resample_backend="jnp")))
    for kind in ("arna", "butterfly"):
        other = dataclasses.replace(ref, kind=kind, q_min=0.1,
                                    butterfly_cap=8)
        want = dataclasses.asdict(other)
        want.pop("resample_backend")
        assert dataclasses.asdict(convert.dra_config(
            dataclasses.asdict(other))) == want


def test_shard_ensemble_layout_round_trips():
    """The reference's sharded leaves are ``(P·C, ...)``, shard-major; the
    port's are ``(P, C, ...)``."""
    rng = np.random.default_rng(4)
    state = rng.standard_normal((P * 6, 5)).astype(np.float32)
    lw = rng.standard_normal(P * 6).astype(np.float32)
    counts = rng.integers(0, 3, P * 6).astype(np.int32)
    ens = convert.shard_ensemble_from_numpy(state, lw, counts, P)
    assert ens.state.shape == (P, 6, 5) and ens.counts.dtype == torch.int32
    np.testing.assert_array_equal(ens.state[2].numpy(), state[12:18])
    back = convert.ensemble_to_numpy(ens)
    for got, want in zip(back, (state, lw, counts)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="shards"):
        convert.shard_ensemble_from_numpy(state[:-1], lw[:-1], counts[:-1], P)


def test_mesh_needs_divisible_particles_and_a_dra_config():
    model = TrackingSSM(TrackingConfig(img_size=(16, 16)))
    pf = ParallelParticleFilter(model, SIRConfig(n_particles=10),
                                device="cpu", mesh=MESH)
    with pytest.raises(ValueError, match="divisible"):
        pf.run(0, torch.zeros(2, 16, 16))
    with pytest.raises(TypeError, match="DRAConfig"):
        ParallelParticleFilter(model, SIRConfig(n_particles=8),
                               device="cpu", mesh=MESH, dra="rna")
