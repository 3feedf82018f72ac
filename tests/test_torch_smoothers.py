"""The port's genealogy smoothers (``filter_smoother_mean``,
``fixed_lag_smoother_mean``) against ``repro.core.genealogy``.

* Both smoothers on the same recorded ``(T, N)`` ancestors, emissions
  and log-weights (a reference run's, numpy in) against the reference's:
  atol 1e-6 or 4 float32 ulp of the largest emission, whichever is
  larger.  A smoothed mean is a float32 sum of N weighted emissions that
  cancel (|e| reaches 5 in ``ar1``, where an ulp is 4.8e-7), and XLA and
  torch add them in different orders: they differ by up to ~3.5 such
  ulp.
* The endpoint identities of tests/test_genealogy.py on a port run:
  lag 0 gives the filtering means, lag ≥ T−1 the filter-smoother, T = 1
  the filtering means; a negative lag raises.
* The reference's oracle gates (tests/test_genealogy.py) at N = 4096,
  T = 24 on the port's own RNG: the filter-smoother within the CLT bound
  of the float64 ``kalman_smoother`` with the reference's slacks (ar1
  14, spiral 16, copied here), smoothing beats filtering against the
  smoothed oracle, and lag 8 beats filtering.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.core import genealogy as jgen
from repro.core import run_sir as ref_run_sir
from repro.models import ssm as jssm
from repro_torch.core import SIRConfig, run_sir
from repro_torch.core import genealogy as tgen
from repro_torch.core.draws import TorchDraws
from repro_torch.models import ssm as tssm

N_STEPS = 24
SEEDS = {"ar1": 11, "spiral": 13}
# tests/test_genealogy.py's SMOOTH_SLACKS: the filter calibration plus
# headroom for path-degeneracy variance inflation at T = 24
SMOOTH_SLACKS = {"ar1": 14.0, "spiral": 16.0}


def _ref_recorded(name, n, ess_frac=0.9, steps=N_STEPS):
    model = jssm.oracle_configs()[name]
    k_sim, k_run = jax.random.split(jax.random.key(SEEDS[name]))
    _, zs = jssm.simulate(k_sim, model, steps)
    _, outs = ref_run_sir(k_run, model, RefSIR(
        n_particles=n, ess_frac=ess_frac, record_ancestry=True),
        np.asarray(zs))
    return outs


def _port_recorded(name, n, ess_frac=0.9, steps=N_STEPS):
    model = tssm.oracle_configs()[name]
    _, zs = tssm.simulate(TorchDraws.from_seed(SEEDS[name], "cpu"), model,
                          steps)
    _, outs = run_sir(TorchDraws.from_seed(SEEDS[name] + 100, "cpu"), model,
                      SIRConfig(n_particles=n, ess_frac=ess_frac,
                                record_ancestry=True), zs)
    return model, zs, outs


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_smoothers_match_reference_on_the_same_record(name):
    outs = _ref_recorded(name, 256)
    anc = np.asarray(outs.ancestors)
    emis = np.asarray(outs.diag["emission"])
    lws = np.asarray(outs.diag["log_weights"])
    assert int(np.sum(anc != np.arange(anc.shape[1]))) > 0
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         (("anc", anc), ("emis", emis), ("lws", lws))}
    atol = max(1e-6, 4 * float(np.spacing(np.abs(emis).max())))
    np.testing.assert_allclose(
        tgen.filter_smoother_mean(t["anc"], t["emis"], t["lws"][-1]).numpy(),
        np.asarray(jgen.filter_smoother_mean(anc, emis, lws[-1])), atol=atol)
    for lag in (0, 1, 5, N_STEPS - 1, N_STEPS + 3):
        np.testing.assert_allclose(
            tgen.fixed_lag_smoother_mean(t["anc"], t["emis"], t["lws"],
                                         lag).numpy(),
            np.asarray(jgen.fixed_lag_smoother_mean(anc, emis, lws, lag)),
            atol=atol, err_msg=f"lag {lag}")


def test_fixed_lag_endpoint_identities():
    _, _, outs = _port_recorded("spiral", 256)
    emis, lws = outs.diag["emission"], outs.diag["log_weights"]
    lag0 = tgen.fixed_lag_smoother_mean(outs.ancestors, emis, lws, 0)
    np.testing.assert_allclose(lag0.numpy(), outs.estimate.numpy(),
                               rtol=1e-5, atol=1e-5)
    full = tgen.filter_smoother_mean(outs.ancestors, emis, lws[-1])
    for lag in (N_STEPS - 1, N_STEPS + 5):
        lagged = tgen.fixed_lag_smoother_mean(outs.ancestors, emis, lws, lag)
        np.testing.assert_allclose(lagged.numpy(), full.numpy(), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError):
        tgen.fixed_lag_smoother_mean(outs.ancestors, emis, lws, -1)


def test_single_frame_degenerates_to_filtering():
    _, _, outs = _port_recorded("ar1", 32, steps=1)
    rows = tgen.smoothing_lineage(outs.ancestors)
    assert torch.equal(rows.long(), torch.arange(32)[None])
    sm = tgen.filter_smoother_mean(outs.ancestors, outs.diag["emission"],
                                   outs.diag["log_weights"][-1])
    np.testing.assert_allclose(sm.numpy(), outs.estimate.numpy(), rtol=1e-5,
                               atol=1e-5)


def _rmse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_smoother_tracks_kalman_smoother(name):
    n = 4096
    model, zs, outs = _port_recorded(name, n)
    oracle = tssm.kalman_smoother(model, zs)
    tr = np.trace(oracle.covs, axis1=-2, axis2=-1)
    bound = SMOOTH_SLACKS[name] * float(np.sqrt(tr.mean() / n))
    assert bound < float(np.sqrt(tr.mean())), "vacuous bound: raise N"
    sm = tgen.filter_smoother_mean(outs.ancestors, outs.diag["emission"],
                                   outs.diag["log_weights"][-1])
    err = _rmse(sm.numpy(), oracle.means)
    # tests/stats.py's smoother_mean_bound: slack · sqrt(mean tr P / N)
    assert err <= bound, (name, err, bound)
    filt_err = _rmse(outs.estimate.numpy(), oracle.means)
    assert err < filt_err, (name, err, filt_err)
    lag = tgen.fixed_lag_smoother_mean(outs.ancestors, outs.diag["emission"],
                                       outs.diag["log_weights"], 8)
    lag_err = _rmse(lag.numpy(), oracle.means)
    assert lag_err < filt_err, (name, lag_err, filt_err)
