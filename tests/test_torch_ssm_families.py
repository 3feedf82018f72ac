"""The port's stochastic-volatility and Lorenz-96 families, the closure
``StateSpaceModel`` bundle and ``kalman_smoother`` against the reference.

* Every protocol method of ``StochasticVolatilitySSM`` and ``Lorenz96SSM``
  on the same particles and the reference's draws replayed: within 1e-6
  relative (and 1e-6 absolute about zero).
* ``run_sir`` on the reference's draws replayed, composed and fused
  backends, against ``repro.core.smc.run_sir`` computed live: estimates
  at atol 1e-5 (tests/test_parity.py), log-marginals at atol 1e-5 or 4
  float32 ulp of the value, whichever is larger, ESS at rtol 1e-4,
  ``resampled`` exactly.  Lorenz-96's log-marginals reach -80, where one
  ulp is 7.6e-6: the reference's jitted RK4 fuses its multiply-adds (its
  eager ``flow`` equals the port's bit for bit), the port rounds every
  op, and the chaotic flow carries those few ulp of state on into the
  likelihood.
* The counterparts of tests/test_ssm_contract.py's family validation and
  bundle delegation, and of tests/test_ssm_prop.py's weight
  normalization on the port's own RNG, for all three families.
* ``kalman_smoother`` equal to the reference's within 1e-10 on the three
  ``oracle_configs``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import stats
import test_torch_draws as draws_mod
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.core import smc as jsmc
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.core import SIRConfig, StateSpaceModel, run_sir
from repro_torch.core.draws import ReplayDraws, TorchDraws
from repro_torch.models import ssm as tssm

ATOL = 1e-5
FAMILIES = {
    "stochvol": (lambda m: m.StochasticVolatilitySSM(), convert.stochvol),
    "lorenz96": (lambda m: m.Lorenz96SSM(), convert.lorenz96),
    "lorenz96-d12-s3": (lambda m: m.Lorenz96SSM(dim=12, obs_stride=3,
                                                forcing=6.0),
                        convert.lorenz96),
}


def _pair(name):
    make, conv = FAMILIES[name]
    ref = make(jssm)
    port = conv(dataclasses.asdict(ref))
    assert port == make(tssm)
    return ref, port


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_protocol_methods_match_reference(name):
    ref, port = _pair(name)
    n, d = 64, ref.state_dim
    k_init, k_dyn, k_obs = jax.random.split(jax.random.key(3), 3)
    x0_ref = ref.init(k_init, n)
    x0 = port.init(ReplayDraws([("normal", np.asarray(
        jax.random.normal(k_init, (n, d))))]), n)
    _close(x0, x0_ref)
    x0 = torch.from_numpy(np.array(x0_ref))
    x1_ref = ref.transition_sample(k_dyn, x0_ref)
    x1 = port.transition_sample(ReplayDraws([("normal", np.asarray(
        jax.random.normal(k_dyn, (n, d))))]), x0)
    _close(x1, x1_ref)
    x1 = torch.from_numpy(np.array(x1_ref))
    z_ref = ref.observation_sample(k_obs, x1_ref)
    z = port.observation_sample(ReplayDraws([("normal", np.asarray(
        jax.random.normal(k_obs, z_ref.shape)))]), x1)
    _close(z, z_ref)
    obs = np.asarray(z_ref)[0]
    _close(port.observation_log_prob(x1, torch.tensor(obs)),
           ref.observation_log_prob(x1_ref, obs))
    _close(port.transition_log_prob(x0, x1),
           ref.transition_log_prob(x0_ref, x1_ref))
    assert port.state_dim == ref.state_dim
    if name.startswith("lorenz96"):
        assert port.obs_dim == ref.obs_dim
        _close(port.flow(x0), ref.flow(x0_ref))
        _close(port.drift(x0), ref.drift(x0_ref))


def _simulated(ref, seed, steps):
    k_sim, k_run = jax.random.split(jax.random.key(seed))
    _, zs = jssm.simulate(k_sim, ref, steps)
    return k_run, np.asarray(zs)


@pytest.mark.parametrize("backend", ["composed", "fused"])
@pytest.mark.parametrize("name", ["stochvol", "lorenz96"])
def test_run_sir_matches_reference(name, backend):
    ref, port = _pair(name)
    n, steps, d = 512, 8, ref.state_dim
    k_run, zs = _simulated(ref, 5, steps)
    ref_carry, ref_outs = jsmc.run_sir(
        k_run, ref, RefSIR(n_particles=n, step_backend=backend), zs)
    draws = ReplayDraws(draws_mod.run_sir_draws(
        k_run, n, d, steps,
        init=lambda k, m: draws_mod.normal_init_draws(k, m, d)))
    carry, outs = run_sir(draws, port, SIRConfig(n_particles=n,
                                                 step_backend=backend),
                          torch.from_numpy(zs))
    assert draws.remaining == 0
    np.testing.assert_allclose(_np(outs.estimate), ref_outs.estimate,
                               atol=ATOL)
    want = np.asarray(ref_outs.log_marginal)
    diff = np.abs(_np(outs.log_marginal) - want)
    assert (diff <= np.maximum(ATOL, 4 * np.spacing(np.abs(want)))).all(), \
        (diff, want)
    np.testing.assert_allclose(_np(outs.ess), ref_outs.ess, rtol=1e-4)
    np.testing.assert_array_equal(_np(outs.resampled), ref_outs.resampled)
    np.testing.assert_allclose(_np(carry.ensemble.log_weights),
                               ref_carry.ensemble.log_weights, atol=ATOL)


def test_family_validation_errors():
    with pytest.raises(ValueError, match="phi"):
        tssm.StochasticVolatilitySSM(phi=1.1)
    with pytest.raises(ValueError, match="dim"):
        tssm.Lorenz96SSM(dim=3)
    with pytest.raises(ValueError, match="obs_stride"):
        tssm.Lorenz96SSM(dim=8, obs_stride=9)
    with pytest.raises(ValueError, match="Q"):
        tssm.make_lgssm(np.eye(2), np.ones((3, 3)), np.eye(2), 1.0)


def test_families_satisfy_the_protocol_and_have_no_domain_hooks():
    for m in (tssm.oracle_configs()["ar1"], tssm.StochasticVolatilitySSM(),
              tssm.Lorenz96SSM()):
        assert isinstance(m, tssm.StateSpaceModel)
        assert tssm.domain_hooks(m) == (None, None)
    bundle = StateSpaceModel(lambda k, n: None, lambda k, s: s,
                             lambda s, z: z, positions=lambda s: s,
                             tile_log_likelihood=lambda s, z, o: z)
    assert isinstance(bundle, tssm.StateSpaceModel)
    pos, tile = tssm.domain_hooks(bundle)
    assert callable(pos) and callable(tile)


def test_bundle_model_delegates_protocol_methods():
    bundle = StateSpaceModel(
        lambda dr, n: dr.normal((n, 2)), lambda dr, s: s * 2.0,
        lambda s, z: -((s - z) ** 2).sum(-1), state_dim=2)
    x = bundle.init(TorchDraws.from_seed(0, "cpu"), 5)
    assert torch.equal(x, bundle.init_sampler(TorchDraws.from_seed(0, "cpu"),
                                              5))
    assert torch.equal(bundle.transition_sample(None, x),
                       bundle.dynamics_sample(None, x))
    assert torch.equal(bundle.observation_log_prob(x, 1.0),
                       bundle.log_likelihood(x, 1.0))
    with pytest.raises(ValueError, match="observation_sample"):
        tssm.simulate(TorchDraws.from_seed(0, "cpu"), bundle, 4)


@pytest.mark.parametrize("family", ["lgssm", "stochvol", "lorenz96"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generic_step_weight_normalization(family, seed):
    """After every step the carried weights are normalized (logsumexp ==
    0), ESS lies in [1, N] and the carry stays materialized, for every
    family (tests/test_ssm_prop.py's invariant, on the port's RNG)."""
    rng = np.random.default_rng(seed)
    if family == "lgssm":
        dx = int(rng.integers(1, 5))
        a = rng.normal(size=(dx, dx))
        a *= 0.9 / max(np.abs(np.linalg.eigvals(a)).max(), 1e-6)
        model = tssm.make_lgssm(a, 0.5, rng.normal(size=(1, dx)), 0.4)
    elif family == "stochvol":
        model = tssm.StochasticVolatilitySSM(mu=float(rng.uniform(-2, 0)),
                                             phi=float(rng.uniform(.5, .99)),
                                             sigma=float(rng.uniform(.05, .6)))
    else:
        model = tssm.Lorenz96SSM(dim=int(rng.integers(4, 13)),
                                 forcing=float(rng.uniform(4, 8)),
                                 obs_stride=int(rng.integers(1, 4)))
    n = 128
    _, zs = tssm.simulate(TorchDraws.from_seed(seed, "cpu"), model, 6)
    for backend in ("composed", "fused"):
        carry, outs = run_sir(TorchDraws.from_seed(seed + 10, "cpu"), model,
                              SIRConfig(n_particles=n, step_backend=backend),
                              zs)
        lse = torch.logsumexp(carry.ensemble.log_weights, -1)
        assert abs(float(lse)) < 1e-4
        assert bool(torch.isfinite(outs.estimate).all())
        stats.ess_sane(_np(outs.ess), n)
        assert int(carry.ensemble.counts.sum()) == n


@pytest.mark.parametrize("name", ["ar1", "cv2d", "spiral"])
def test_kalman_smoother_matches_reference(name):
    ref = jssm.oracle_configs()[name]
    port = tssm.oracle_configs()[name]
    _, zs = jssm.simulate(jax.random.key(21), ref, 30)
    zs = np.asarray(zs)
    want = jssm.kalman_smoother(ref, zs)
    got = tssm.kalman_smoother(port, torch.from_numpy(zs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10, atol=1e-10)
    filt = tssm.kalman_filter(port, zs)
    # the last frame's smoothed moments are the filtered ones
    np.testing.assert_array_equal(got.means[-1], filt.means[-1])
    np.testing.assert_array_equal(got.covs[-1], filt.covs[-1])
