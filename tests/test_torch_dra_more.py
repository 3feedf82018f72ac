"""The port's ARNA and butterfly DRAs and their collectives against the
reference.

* ``butterfly_schedule``, ``grouped_ppermute`` and ``dlb.pack_slab``
  against ``repro.core.runtime``/``repro.core.dlb`` (the latter per shard
  under ``jax.vmap``): exactly equal.
* ARNA's exchange, the ring and the lost-mode all_to_all shuffle, against
  the reference's ``_ring_exchange`` on the same slots: exactly equal.
* ``ParallelParticleFilter(mesh=EmulatedMesh(P), dra=DRAConfig(kind))``
  for ARNA (tracking, and lost mode forced by a high ``lost_log_lik``)
  and butterfly at P = 2, 4 and 8 against ``tests/emesh.py::run_filter``
  with every shard's draws replayed from the reference's key streams:
  estimates and log-marginals at atol 1e-5 (tests/test_parity.py), ESS
  at rtol 1e-5, ``resampled``, every diagnostic (the comm accounting
  included) and the final counts exactly, the final state within 1e-4.
* The comm accounting against the reference's formulas, and the port's
  own RNG tracking at tests/test_tracking.py's SNR-2 bound.

Butterfly's tests use fixed seeds (the reference's log-Z property test
flakes on fresh hypothesis examples).
"""
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

ATOL = 1e-5


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype))


def _vmap(fn, *args):
    return jax.jit(jax.vmap(fn, axis_name=emesh.AXIS))(*args)


def dra_stream(key, shard, kind, c, n_frames, p):
    """Every draw shard ``shard`` takes in the reference's distributed run
    of a DRA ``kind``: ``fold_in(key, shard)`` split into init and run
    streams, the tracking init, then per frame ``split(k_run, 3)`` into
    (carry, dynamics, resample): the dynamics normals, then the DRA's
    draws from ``k_res`` — MPF one comb uniform; RNA and ARNA
    ``split(k_res)`` into the comb's uniform and the shuffle's
    permutation; butterfly ``split(k_res, log2 P)``, one comb uniform a
    stage; RPA one comb uniform."""
    k_init, k_run = jax.random.split(jax.random.fold_in(key, shard))
    draws = draws_mod.tracking_init_draws(k_init, c)
    stages = p.bit_length() - 1
    for _ in range(n_frames):
        k_run, k_dyn, k_res = jax.random.split(k_run, 3)
        draws.append(("normal", np.asarray(jax.random.normal(k_dyn, (c, 5)))))
        if kind in ("rna", "arna"):
            k_res, k_perm = jax.random.split(k_res)
            draws.append(("uniform",
                          np.asarray(jax.random.uniform(k_res, ()))))
            draws.append(("permutation",
                          np.asarray(jax.random.permutation(k_perm, c))))
        elif kind == "butterfly" and stages:
            for k_s in jax.random.split(k_res, stages):
                draws.append(("uniform",
                              np.asarray(jax.random.uniform(k_s, ()))))
        else:
            draws.append(("uniform",
                          np.asarray(jax.random.uniform(k_res, ()))))
    return draws


def replayed(key, kind, c, n_frames, p):
    """One replay per shard, stacked for the port's distributed filter."""
    return BankDraws([ReplayDraws(dra_stream(key, i, kind, c, n_frames, p))
                      for i in range(p)])


def assert_filter_matches(res, outs, final, p, c, draws=None):
    """The port's ``FilterResult`` against the reference's emulated run
    (shard 0's replicated outputs and the shard-major final ensemble)."""
    if draws is not None:
        assert all(m.remaining == 0 for m in draws.members)
    np.testing.assert_allclose(res.estimates.numpy(), outs.estimate[0],
                               atol=ATOL)
    np.testing.assert_allclose(res.log_marginal.numpy(),
                               outs.log_marginal[0], atol=ATOL)
    np.testing.assert_allclose(res.ess.numpy(), outs.ess[0], rtol=1e-5)
    np.testing.assert_array_equal(res.resampled.numpy(), outs.resampled[0])
    assert set(res.diag) == set(outs.diag)
    for k, v in res.diag.items():
        want = np.asarray(outs.diag[k][0])
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    ref_final = jax.tree_util.tree_map(
        lambda x: np.asarray(x).reshape((p, c) + x.shape[2:]), final)
    np.testing.assert_array_equal(res.final.counts.numpy(), ref_final.counts)
    np.testing.assert_allclose(res.final.state.numpy(), ref_final.state,
                               atol=1e-4)
    np.testing.assert_allclose(res.final.log_weights.numpy(),
                               ref_final.log_weights, atol=ATOL)


# ---------------------------------------------------------------------------
# Collectives and the slab packer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
def test_butterfly_schedule_matches_reference(p):
    assert truntime.butterfly_schedule(p) == jruntime.butterfly_schedule(p)


@pytest.mark.parametrize("p", [0, 3, 6, 12])
def test_butterfly_schedule_needs_a_power_of_two(p):
    with pytest.raises(ValueError, match="power-of-two"):
        truntime.butterfly_schedule(p)
    with pytest.raises(ValueError, match="power-of-two"):
        jruntime.butterfly_schedule(p)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_grouped_ppermute_matches_reference(p):
    rng = np.random.default_rng(p)
    a = rng.standard_normal((p, 3, 2)).astype(np.float32)
    b = rng.integers(0, 9, (p, 5)).astype(np.int32)
    mesh = EmulatedMesh(p)
    for perm in truntime.butterfly_schedule(p):
        want = _vmap(lambda x, y: jruntime.grouped_ppermute(
            (x, {"b": y}), emesh.AXIS, perm), jnp.asarray(a), jnp.asarray(b))
        got = truntime.grouped_ppermute((_t(a), {"b": _t(b, np.int32)}),
                                        mesh, perm)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1]["b"].numpy(),
                                      np.asarray(want[1]["b"]))


def _slab_ensemble(seed, p=4, c=40):
    """Compressed ensembles with count-0 slots interleaved through the
    unit line."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, (p, c)).astype(np.int32)
    counts[rng.random((p, c)) < 0.3] = 0
    lw = np.where(counts > 0, rng.standard_normal((p, c)),
                  -np.inf).astype(np.float32)
    state = rng.standard_normal((p, c, 3)).astype(np.float32)
    return state, lw, counts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k_cap", [1, 8, 32])
def test_pack_slab_matches_reference(seed, k_cap):
    state, lw, counts = _slab_ensemble(seed)
    totals = counts.sum(1)
    # windows under, at and over the slot budget, and past the total
    m = np.array([0, k_cap, 3 * k_cap, totals[3] + 5], np.int32)

    def shard(s, l, c_, m_):
        return jdlb.pack_slab(jparticles.ParticleEnsemble(s, l, c_), m_,
                              k_cap=k_cap)

    want = _vmap(shard, jnp.asarray(state), jnp.asarray(lw),
                 jnp.asarray(counts), jnp.asarray(m))
    got = tdlb.pack_slab(tparticles.ParticleEnsemble(
        _t(state), _t(lw), _t(counts, np.int32)), _t(m, np.int32),
        k_cap=k_cap)
    for f in tdlb.SlabPack._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    # conservation: kept + shipped == every shard's units
    np.testing.assert_array_equal(
        got.kept_counts.sum(1).numpy() + got.shipped_units.numpy(), totals)
    assert (got.overflow_units.numpy()[m <= k_cap] == 0).all()


@pytest.mark.parametrize("shuffle", [False, True])
def test_arna_exchange_matches_reference(shuffle):
    """The ring exchange and the lost-mode all_to_all shuffle of ARNA's
    ``m_buf``-slot head, with ``m_valid`` below it."""
    p, c, m_buf, m_valid = 4, 24, 12, 7
    rng = np.random.default_rng(3)
    state = rng.standard_normal((p, c, 5)).astype(np.float32)
    lw = rng.standard_normal((p, c)).astype(np.float32)

    def shard(s, l):
        return jdist._ring_exchange(s, l, m_buf, jnp.asarray(m_valid),
                                    emesh.AXIS,
                                    shuffle=jnp.asarray(shuffle))

    want = _vmap(shard, jnp.asarray(state), jnp.asarray(lw))
    got = tdist._ring_exchange(_t(state), _t(lw), m_buf,
                               torch.full((p,), m_valid), EmulatedMesh(p),
                               shuffle=torch.full((p,), shuffle))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# ARNA and butterfly filters against tests/emesh.py
# ---------------------------------------------------------------------------

FRAMES = 4


def _run_both(fields, p, c, *, img=32, seed=7):
    n = p * c
    cfg = jtracking.TrackingConfig(img_size=(img, img), v_init=1.5)
    frames = np.array(ref_movie(jax.random.key(0), cfg,
                                n_frames=FRAMES).frames)
    key = jax.random.key(seed)
    outs, final = emesh.run_filter(
        jtracking.TrackingSSM(cfg), RefSIR(n_particles=n),
        jdist.DRAConfig(**fields), key, jnp.asarray(frames), p)
    draws = replayed(key, fields["kind"], c, FRAMES, p)
    res = ParallelParticleFilter(
        TrackingSSM(draws_mod.port_config(cfg)), SIRConfig(n_particles=n),
        device="cpu", mesh=EmulatedMesh(p),
        dra=DRAConfig(**fields)).run(draws, frames)
    return res, outs, final, draws


@pytest.mark.parametrize("lost", [False, True])
def test_arna_filter_matches_emulated_reference(lost):
    """Both ARNA branches: tracking (the adaptive ring) and, with
    ``lost_log_lik`` above every likelihood, the all_to_all shuffle on
    every frame."""
    fields = dict(kind="arna", lost_log_lik=1e9 if lost else -1e4)
    p, c = 4, 64
    res, outs, final, draws = _run_both(fields, p, c)
    assert_filter_matches(res, outs, final, p, c, draws)
    assert bool((res.diag["lost"] == int(lost)).all())


@pytest.mark.parametrize("p", [2, 4, 8])
def test_butterfly_filter_matches_emulated_reference(p):
    fields = dict(kind="butterfly", butterfly_cap=8)
    c = 256 // p
    res, outs, final, draws = _run_both(fields, p, c)
    assert_filter_matches(res, outs, final, p, c, draws)
    assert int(res.diag["truncated"].sum()) == 0


def test_butterfly_one_shard_is_a_local_resample():
    """P = 1 has no stage: one local resample, no draws past the comb's,
    zero comm."""
    ens = tparticles.ParticleEnsemble(
        torch.randn(1, 16, 5, generator=torch.Generator().manual_seed(0)),
        torch.zeros(1, 16), torch.ones(1, 16, dtype=torch.int32))
    draws = BankDraws([ReplayDraws([("uniform", np.float32(0.25))])])
    out, diag = tdist.butterfly_resample(draws, ens, DRAConfig(
        kind="butterfly"), EmulatedMesh(1))
    assert draws.members[0].remaining == 0
    assert int(diag["comm_bytes"]) == 0 and int(diag["comm_stages"]) == 0
    np.testing.assert_allclose(out.log_weights.numpy(),
                               np.full((1, 16), -np.log(16.0), np.float32))


# ---------------------------------------------------------------------------
# Comm accounting and the port's own RNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("kind", ["arna", "butterfly"])
def test_comm_accounting_matches_the_formulas(kind, p):
    """``comm_bytes``/``comm_stages`` of one DRA call: ARNA ``12 +
    m_buf·(pp+4)`` B in 4 rounds, ``m_buf = max(round(q_max·C)//P·P, P)``;
    butterfly ``log2 P · (8 + cap·(pp+8))`` B in ``2·log2 P`` rounds."""
    c, cap = 48, 8
    cfg = DRAConfig(kind=kind, q_max=0.4, butterfly_cap=cap)
    ens = tparticles.ParticleEnsemble(
        torch.rand(p, c, 5, generator=torch.Generator().manual_seed(p)),
        torch.zeros(p, c), torch.ones(p, c, dtype=torch.int32))
    draws = BankDraws([TorchDraws.from_seed(i, "cpu") for i in range(p)])
    pp = 5 * 4
    stages = p.bit_length() - 1
    if kind == "arna":
        _, diag = tdist.arna_resample(draws, ens, cfg, EmulatedMesh(p),
                                      torch.zeros(p))
        m_buf = max(int(round(0.4 * c)) // p * p, p)
        want = (12 + m_buf * (pp + 4), 4)
    else:
        _, diag = tdist.butterfly_resample(draws, ens, cfg, EmulatedMesh(p))
        want = (stages * (8 + cap * (pp + 8)), 2 * stages)
    assert (int(diag["comm_bytes"]), int(diag["comm_stages"])) == want


@pytest.mark.parametrize("kind", ["arna", "butterfly"])
def test_port_dra_tracks_at_snr2(kind):
    """tests/test_tracking.py's SNR-2 bound (1.5 px after 10 frames,
    64×64, N = 8192) with the port's own RNG: 4 shards of 2048."""
    cfg = TrackingConfig(img_size=(64, 64), v_init=1.5)
    movie = generate_movie(TorchDraws.from_seed(0, "cpu"), cfg, n_frames=40)
    pf = ParallelParticleFilter(TrackingSSM(cfg), SIRConfig(
        n_particles=8192, ess_frac=0.5), device="cpu", mesh=EmulatedMesh(4),
        dra=DRAConfig(kind=kind))
    res = pf.run(1, movie.frames)
    rmse = float(tracking_rmse(res.estimates, movie.trajectories[:, 0],
                               warmup=10))
    assert rmse < 1.5, rmse
    assert bool(torch.isfinite(res.log_marginal).all())
    assert bool(torch.isfinite(res.ess).all())
    again = pf.run(1, movie.frames)
    assert torch.equal(again.estimates, res.estimates)
