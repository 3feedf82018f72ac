"""The port's SIR step, tracking filter and FilterBank against the
reference, and the port's own-RNG runs against the statistical gates.

* One step, then a 5-frame tracking run (N = 1024, 32×32 frames), with
  the reference's draws replayed, against ``make_sir_step``/``run_sir``
  computed live (not the committed goldens; see ROADMAP C1): estimates
  and log-marginals at atol 1e-5 (tests/test_parity.py), ``resampled``
  exactly, the final ensemble within 1e-4 (positions up to 32 px carry
  a few float32 ulp per frame).  The comb must pick the same ancestors on
  both sides; the inputs are fixed, and ``_comb_margin`` shows how far
  the closest comb point sits from a CDF boundary, far beyond the ~1e-7
  by which the two f32 CDFs disagree.
* FilterBank member i equals a standalone run with the same draws, bit
  for bit on the CPU; a masked slot keeps its carry and draws and emits
  zeros.
* With the port's own torch RNG: the Kalman-oracle gates of
  tests/test_ssm_oracle.py (same data, slacks and N) and the SNR-2
  tracking bound of tests/test_tracking.py.
"""
import math

import jax
import numpy as np
import pytest
import stats
import test_torch_draws as draws_mod
import torch
from test_torch_draws import one_torch_thread  # noqa: F401
from test_ssm_oracle import N_STEPS, SEEDS, SLACKS

from repro.core import SIRConfig as RefSIR
from repro.core import particles as jparticles
from repro.core import smc as jsmc
from repro.core.filters import FilterBank as RefBank
from repro.data.synthetic_movie import generate_movie as ref_movie
from repro.models import ssm as jssm
from repro.models import tracking as jtracking
from repro_torch import convert
from repro_torch.core import (FilterBank, ParallelParticleFilter, SIRConfig,
                              make_bank_step, member_carry, run_sir)
from repro_torch.core import smc as tsmc
from repro_torch.core.draws import ReplayDraws, TorchDraws
from repro_torch.data.synthetic_movie import generate_movie, tracking_rmse
from repro_torch.models import ssm as tssm
from repro_torch.models.tracking import TrackingConfig, TrackingSSM

N, IMG, FRAMES = 1024, (32, 32), 5
ATOL = 1e-5
BACKENDS = ["composed", "fused"]


def _np(t):
    return t.detach().cpu().numpy()


def _setup(n_frames=FRAMES, seed=0):
    cfg = jtracking.TrackingConfig(img_size=IMG, v_init=1.5)
    movie = ref_movie(jax.random.key(seed), cfg, n_frames=n_frames)
    return cfg, movie, torch.from_numpy(np.array(movie.frames))


def _comb_margin(lw_post: np.ndarray, u: float) -> float:
    """Distance from the closest comb point to a float64 CDF boundary."""
    lw = lw_post.astype(np.float64)
    w = np.exp(lw - lw.max())
    cdf = np.cumsum(w / w.sum())
    n = lw.shape[0]
    pos = (np.arange(n) + u) / n
    k = np.clip(np.searchsorted(cdf, pos), 1, n - 1)
    return float(np.min(np.minimum(np.abs(cdf[k] - pos),
                                   np.abs(cdf[k - 1] - pos))))


@pytest.mark.parametrize("backend", BACKENDS)
def test_sir_step_matches_reference(backend):
    cfg, movie, frames = _setup()
    jmodel = jtracking.TrackingSSM(cfg)
    tmodel = TrackingSSM(draws_mod.port_config(cfg))
    ens = jparticles.init_ensemble(jax.random.key(3), jmodel.init, N)
    key = jax.random.key(4)
    ref_carry, ref_out = jsmc.make_sir_step(
        jmodel, RefSIR(n_particles=N, step_backend=backend))(
        jsmc.SIRCarry(key, ens), movie.frames[0])
    _, step = draws_mod.sir_step_draws(key, N, 5)
    port_ens = convert.ensemble_from_numpy(
        np.asarray(ens.state), np.asarray(ens.log_weights),
        np.asarray(ens.counts))
    carry, out = tsmc.make_sir_step(
        tmodel, SIRConfig(n_particles=N, step_backend=backend))(
        tsmc.SIRCarry(ReplayDraws(step), port_ens), frames[0])
    # the comb point nearest a CDF boundary sits far outside the f32 noise
    moved = tmodel.transition_sample(ReplayDraws(step[:1]), port_ens.state)
    lw_post = _np(port_ens.log_weights + tmodel.observation_log_prob(
        moved, frames[0]))
    assert _comb_margin(lw_post, float(step[1][1])) > 1e-6
    np.testing.assert_allclose(_np(out.estimate), ref_out.estimate,
                               atol=ATOL)
    np.testing.assert_allclose(float(out.log_marginal),
                               float(ref_out.log_marginal), atol=ATOL)
    np.testing.assert_allclose(float(out.ess), float(ref_out.ess),
                               rtol=1e-5)
    assert bool(out.resampled) == bool(ref_out.resampled)
    np.testing.assert_allclose(_np(carry.ensemble.state),
                               ref_carry.ensemble.state, atol=1e-4)
    np.testing.assert_allclose(_np(carry.ensemble.log_weights),
                               ref_carry.ensemble.log_weights, atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tracking_run_matches_reference(backend):
    cfg, movie, frames = _setup()
    key = jax.random.key(1)
    ref_carry, ref_outs = jsmc.run_sir(
        key, jtracking.TrackingSSM(cfg),
        RefSIR(n_particles=N, step_backend=backend), movie.frames)
    draws = ReplayDraws(draws_mod.run_sir_draws(key, N, 5, FRAMES))
    carry, outs = run_sir(draws, TrackingSSM(draws_mod.port_config(cfg)),
                          SIRConfig(n_particles=N, step_backend=backend),
                          frames)
    assert draws.remaining == 0
    np.testing.assert_allclose(_np(outs.estimate), ref_outs.estimate,
                               atol=ATOL)
    np.testing.assert_allclose(_np(outs.log_marginal),
                               ref_outs.log_marginal, atol=ATOL)
    np.testing.assert_allclose(_np(outs.ess), ref_outs.ess, rtol=1e-5)
    np.testing.assert_array_equal(_np(outs.resampled), ref_outs.resampled)
    np.testing.assert_allclose(_np(outs.diag["weight_skew"]),
                               ref_outs.diag["weight_skew"], rtol=1e-5)
    np.testing.assert_allclose(_np(carry.ensemble.state),
                               ref_carry.ensemble.state, atol=1e-4)
    np.testing.assert_allclose(_np(carry.ensemble.log_weights),
                               ref_carry.ensemble.log_weights, atol=ATOL)


def _bank_inputs(b, n_frames):
    cfg = jtracking.TrackingConfig(img_size=IMG, v_init=1.5)
    movies = [ref_movie(jax.random.key(10 + i), cfg, n_frames=n_frames)
              for i in range(b)]
    frames = np.stack([np.asarray(m.frames) for m in movies])
    keys = [jax.random.key(100 + i) for i in range(b)]
    return cfg, frames, keys


@pytest.mark.parametrize("backend", BACKENDS)
def test_bank_member_equals_standalone(backend):
    """Bitwise against the port's standalone filter, within tolerance of
    the reference's FilterBank."""
    b, n, k = 3, 256, 6
    cfg, frames, keys = _bank_inputs(b, k)
    model = TrackingSSM(draws_mod.port_config(cfg))
    sir = SIRConfig(n_particles=n, step_backend=backend)

    def replay(key):
        return ReplayDraws(draws_mod.run_sir_draws(key, n, 5, k))

    res = FilterBank(model, sir, device="cpu").run(
        [replay(key) for key in keys], frames)
    assert res.estimates.shape == (b, k, 5) and res.ess.shape == (b, k)
    ref = RefBank(model=jtracking.TrackingSSM(cfg),
                  sir=RefSIR(n_particles=n, step_backend=backend)).run(
        jax.numpy.stack(keys), frames)
    for i in range(b):
        solo = ParallelParticleFilter(model, sir, device="cpu").run(
            replay(keys[i]), frames[i])
        for field in ("estimates", "ess", "log_marginal", "resampled"):
            assert torch.equal(getattr(res, field)[i], getattr(solo, field))
        assert torch.equal(res.final.state[i], solo.final.state)
        assert torch.equal(res.final.log_weights[i], solo.final.log_weights)
        np.testing.assert_allclose(_np(res.estimates[i]), ref.estimates[i],
                                   atol=ATOL)
        np.testing.assert_allclose(_np(res.log_marginal[i]),
                                   ref.log_marginal[i], atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_masked_slot_keeps_its_carry(backend):
    b, n = 3, 128
    cfg, frames, keys = _bank_inputs(b, 2)
    model = TrackingSSM(draws_mod.port_config(cfg))
    sir = SIRConfig(n_particles=n, step_backend=backend)
    members = [ReplayDraws(draws_mod.run_sir_draws(key, n, 5, 2))
               for key in keys]
    carry = member_carry(members, model, sir)
    before = carry.ensemble
    left = [m.remaining for m in members]
    active = torch.tensor([True, False, True])
    carry, out = make_bank_step(model, sir)(
        carry, (torch.from_numpy(frames[:, 0]), active))
    assert torch.equal(carry.ensemble.state[1], before.state[1])
    assert torch.equal(carry.ensemble.log_weights[1], before.log_weights[1])
    assert members[1].remaining == left[1]
    assert members[0].remaining == left[0] - 2
    for field in ("estimate", "ess", "log_marginal", "resampled"):
        assert not getattr(out, field)[1].any()
    assert not out.diag["weight_skew"][1].any()
    solo = ParallelParticleFilter(model, sir, device="cpu").run(
        ReplayDraws(draws_mod.run_sir_draws(keys[2], n, 5, 2)), frames[2, :1])
    assert torch.equal(out.estimate[2], solo.estimates[0])
    assert torch.equal(carry.ensemble.state[2], solo.final.state)


def test_record_ancestry_on_the_composed_path():
    cfg, _, frames = _setup(n_frames=3)
    model = TrackingSSM(draws_mod.port_config(cfg))
    res = ParallelParticleFilter(
        model, SIRConfig(n_particles=256, record_ancestry=True,
                         step_backend="fused"), device="cpu").run(0, frames)
    assert res.ancestors.shape == (3, 256)
    assert res.diag["emission"].shape == (3, 256, 5)
    plain = ParallelParticleFilter(model, SIRConfig(n_particles=256),
                                   device="cpu").run(0, frames)
    assert plain.ancestors.shape == (3, 0)
    assert torch.equal(plain.estimates, res.estimates)


# ---------------------------------------------------------------------------
# The port's own RNG against the statistical gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SEEDS))
def test_port_tracks_kalman_posterior(name, backend):
    """tests/test_ssm_oracle.py's gates (same data, slacks, N = 4096)
    on the port's filter driven by its own torch generator; the port's
    copy of the Kalman oracle equals the reference's."""
    n = 4096
    jmodel = jssm.oracle_configs()[name]
    k_sim, _ = jax.random.split(jax.random.key(SEEDS[name]))
    _, zs = jssm.simulate(k_sim, jmodel, N_STEPS)
    zs = np.array(zs)
    oracle = jssm.kalman_filter(jmodel, zs)
    model = tssm.oracle_configs()[name]
    mine = tssm.kalman_filter(model, zs)
    for a, b_ in zip(mine, oracle):
        np.testing.assert_allclose(a, b_, rtol=1e-9, atol=1e-12)
    carry, outs = run_sir(TorchDraws.from_seed(SEEDS[name], "cpu"), model,
                          SIRConfig(n_particles=n, step_backend=backend),
                          torch.from_numpy(zs))
    mean_slack, lz_slack = SLACKS[name]
    bound = stats.pf_mean_bound(oracle.covs, n, slack=mean_slack)
    err = stats.rmse(_np(outs.estimate), oracle.means)
    assert err <= bound, (name, err, bound)
    lz_err = abs(float(_np(outs.log_marginal).astype(np.float64).sum())
                 - float(oracle.log_marginals.sum()))
    assert lz_err <= stats.log_marginal_bound(N_STEPS, n, slack=lz_slack)
    _, pf_cov = stats.weighted_mean_cov(_np(carry.ensemble.state),
                                        _np(carry.ensemble.log_weights))
    ratio = np.trace(pf_cov) / np.trace(oracle.covs[-1])
    assert 0.5 < ratio < 2.0, ratio
    stats.ess_sane(_np(outs.ess), n)


def test_lgssm_matches_reference_on_shared_draws():
    """The port's LinearGaussianSSM methods equal the reference's on the
    same particles and draws."""
    jmodel = jssm.oracle_configs()["cv2d"]
    model = tssm.oracle_configs()["cv2d"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    eps = rng.standard_normal((64, 4)).astype(np.float32)
    z = rng.standard_normal(2).astype(np.float32)
    np.testing.assert_allclose(
        _np(model.observation_log_prob(torch.from_numpy(x),
                                       torch.from_numpy(z))),
        jmodel.observation_log_prob(x, z), rtol=1e-5, atol=1e-5)
    key = jax.random.key(1)
    eps = np.asarray(jax.random.normal(key, (64, 4)))
    np.testing.assert_allclose(
        _np(model.transition_sample(ReplayDraws([("normal", eps)]),
                                    torch.from_numpy(x))),
        jmodel.transition_sample(key, x), rtol=1e-5, atol=1e-5)
    fields = {f: np.asarray(getattr(jmodel, f)) for f in (
        "transition_matrix", "observation_matrix", "init_mean",
        "transition_chol", "observation_chol", "init_chol")}
    converted = convert.lgssm(fields)
    for f, v in fields.items():
        np.testing.assert_array_equal(_np(getattr(converted, f)), v)


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_snr2_tracking_converges(backend):
    """tests/test_tracking.py's SNR-2 bound with the port's own RNG."""
    cfg = TrackingConfig(img_size=(64, 64), v_init=1.5)
    movie = generate_movie(TorchDraws.from_seed(0, "cpu"), cfg, n_frames=40)
    res = ParallelParticleFilter(
        TrackingSSM(cfg), SIRConfig(n_particles=8192, ess_frac=0.5,
                                    step_backend=backend),
        device="cpu").run(1, movie.frames)
    rmse = float(tracking_rmse(res.estimates, movie.trajectories[:, 0],
                               warmup=10))
    assert rmse < 1.5, rmse
    assert bool(torch.isfinite(res.log_marginal).all())
    assert math.isfinite(float(res.ess.mean()))
