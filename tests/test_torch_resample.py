"""The port's resampling kernels' plain versions and the chain schemes
against the reference.

* B1/B4/B5 plain versions (``repro_torch.kernels.resample`` and
  ``kernels.ref``) against ``repro.kernels.resample``'s Pallas kernels in
  interpret mode and against ``repro.core.resampling``'s
  ``*_from_draws``, on numpy-seeded weights and the same draws: the
  chains' ancestors exactly equal (the test is one float subtraction and
  a compare, so there is nothing to round differently); B1's exactly
  equal except at a comb point within ``TIE_DELTA`` of the float64 CDF
  (tests/test_torch_kernels.py's rule), and the ties are counted.
* ``metropolis_counts``/``rejection_counts`` and ``resampling_draws``
  against the reference on replayed draws, batched members equal to solo
  calls.
* The fused and the composed SIR step with ``metropolis``/``rejection``
  against the reference step with its draws replayed: estimates and
  log-marginals at atol 1e-5 (tests/test_parity.py), ``resampled``
  exactly, the final ensemble within 1e-4 (tests/test_torch_smc.py).
* The CUDA wrappers refuse CPU tensors; the dispatcher picks the plain
  version for them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_draws as draws_mod
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.core import particles as jparticles
from repro.core import resampling as jresampling
from repro.core import smc as jsmc
from repro.data.synthetic_movie import generate_movie as ref_movie
from repro.kernels import resample as jkernels
from repro.models import tracking as jtracking
from repro_torch import convert
from repro_torch.core import SIRConfig, run_sir
from repro_torch.core import resampling as tresampling
from repro_torch.core import smc as tsmc
from repro_torch.core.draws import BankDraws, ReplayDraws
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import resample as tkernels
from repro_torch.models.tracking import TrackingSSM

TIE_DELTA = 1e-5
ATOL = 1e-5
CHAINS = ["metropolis", "rejection"]
PROFILES = ["normal", "some_dead", "all_dead", "one_hot"]


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype))


def _log_weights(profile, n, seed):
    rng = np.random.default_rng(seed)
    lw = (3.0 * rng.standard_normal(n)).astype(np.float32)
    if profile == "some_dead":
        lw[rng.random(n) < 0.5] = -np.inf
    elif profile == "all_dead":
        lw[:] = -np.inf
    elif profile == "one_hot":
        lw[:] = -np.inf
        lw[n // 3] = 0.0
    return lw


def _chain_draws(seed, n_in, lanes, iters=32):
    key = jax.random.key(seed)
    prop, log_us = jresampling.resampling_draws(key, n_in, lanes, iters)
    return np.asarray(prop), np.asarray(log_us)


def _port_chain(scheme):
    return (tkernels.metropolis_ancestors_ref if scheme == "metropolis"
            else tkernels.rejection_ancestors_ref)


def _ref_chain(scheme):
    return (jresampling.metropolis_ancestors_from_draws
            if scheme == "metropolis"
            else jresampling.rejection_ancestors_from_draws)


# ---------------------------------------------------------------------------
# B4 / B5 plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("scheme", CHAINS)
def test_chain_ref_matches_reference_and_pallas(scheme, profile):
    """Bitwise: plain B4/B5 == ``*_from_draws`` == the Pallas kernel in
    interpret mode, with the dead-slot guard hit (dead slots, all dead,
    all mass on one slot)."""
    n_in, lanes = 200, 256
    lw = _log_weights(profile, n_in, 11)
    prop, log_us = _chain_draws(3, n_in, lanes)
    got = _port_chain(scheme)(_t(lw), _t(prop, np.int32), _t(log_us))
    want = np.asarray(_ref_chain(scheme)(jnp.asarray(lw), jnp.asarray(prop),
                                         jnp.asarray(log_us)))
    pallas = np.asarray(jkernels.COLLECTIVE_FREE_KERNELS[scheme](
        jnp.asarray(lw), jnp.asarray(prop), jnp.asarray(log_us), block=128,
        interpret=True))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    if profile == "one_hot":
        assert (got.numpy() == n_in // 3).all()
    if profile == "all_dead":
        assert (got.numpy() == 0).all()


@pytest.mark.parametrize("scheme", CHAINS)
def test_chain_ref_batched_members_equal_solo(scheme):
    """The leading member dim is a batch: member i of a batched call ==
    the solo call, bit for bit, for members of different profiles."""
    n_in, lanes = 96, 160
    lws = np.stack([_log_weights(p, n_in, 20 + i)
                    for i, p in enumerate(PROFILES)])
    draws = [_chain_draws(30 + i, n_in, lanes, 12) for i in range(4)]
    prop = np.stack([d[0] for d in draws])
    log_us = np.stack([d[1] for d in draws])
    fn = _port_chain(scheme)
    got = fn(_t(lws), _t(prop, np.int32), _t(log_us))
    for i in range(4):
        solo = fn(_t(lws[i]), _t(prop[i], np.int32), _t(log_us[i]))
        np.testing.assert_array_equal(got[i].numpy(), solo.numpy())
        want = _ref_chain(scheme)(jnp.asarray(lws[i]),
                                  jnp.asarray(prop[i]),
                                  jnp.asarray(log_us[i]))
        np.testing.assert_array_equal(solo.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# B1 plain version
# ---------------------------------------------------------------------------

def _comb_ties(got, want, lw, u, n_out):
    """Lanes where the two ancestors differ; each must be a comb point
    within TIE_DELTA of the float64 CDF at both boundaries."""
    w = np.exp(lw.astype(np.float64) - lw.max())
    cdf = np.cumsum(w / w.sum())
    pos = (np.arange(n_out) + u) / n_out
    lanes = np.nonzero(got != want)[0]
    for i in lanes:
        lo, hi = sorted((int(got[i]), int(want[i])))
        assert abs(cdf[lo] - pos[i]) <= TIE_DELTA
        assert abs(cdf[hi - 1] - pos[i]) <= TIE_DELTA
    return len(lanes)


@pytest.mark.parametrize("n_in,n_out", [(256, 256), (1024, 512),
                                         (512, 1024)])
def test_systematic_ref_matches_pallas(n_in, n_out):
    """Plain B1 against the Pallas kernel in interpret mode and the jnp
    comb of ``resampling.systematic_counts``: the same ancestors, with
    no tie at these sizes."""
    lw = (2.0 * np.random.default_rng(n_in).standard_normal(n_in)).astype(
        np.float32)
    u = np.float32(np.random.default_rng(n_out).random())
    got = tref.systematic_ancestors_ref(_t(lw), torch.tensor(u), n_out)
    pallas = np.asarray(jkernels.systematic_ancestors_kernel(
        jnp.asarray(lw), jnp.asarray(u), n_out=n_out, block=256,
        interpret=True))
    counts = jresampling._comb_counts(
        jparticles.normalized_weights(jnp.asarray(lw)), jnp.asarray(u),
        n_out, n_out)
    jnp_anc = np.asarray(jresampling.counts_to_ancestors(counts, n_out))
    assert _comb_ties(got.numpy(), pallas, lw, u, n_out) == 0
    assert _comb_ties(got.numpy(), jnp_anc, lw, u, n_out) == 0
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        ops.systematic_ancestors(_t(lw), torch.tensor(u), n_out).numpy(),
        got.numpy())


# ---------------------------------------------------------------------------
# Counts forms and draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", CHAINS)
def test_chain_counts_match_reference(scheme):
    """``*_counts`` take ``resampling_draws`` in the reference's order
    (proposals, then uniforms) and drop lanes past a per-member
    ``n_out``; a batched call equals the solo calls."""
    n_in, capacity, n_outs = 80, 120, [120, 77]
    lws = np.stack([_log_weights("normal", n_in, 5),
                    _log_weights("some_dead", n_in, 6)])
    keys = [jax.random.key(40 + i) for i in range(2)]
    replays = []
    for i, key in enumerate(keys):
        kp, ku = jax.random.split(key)
        replays.append(ReplayDraws([
            ("randint", np.asarray(jax.random.randint(
                kp, (capacity, 32), 0, n_in, jnp.int32))),
            ("uniform", np.asarray(jax.random.uniform(ku, (capacity, 32))))]))
    got = tresampling.RESAMPLERS[scheme](BankDraws(replays), _t(lws),
                                         torch.tensor(n_outs),
                                         capacity=capacity)
    for i, key in enumerate(keys):
        want = jresampling.RESAMPLERS[scheme](key, jnp.asarray(lws[i]),
                                              n_outs[i], capacity=capacity)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        assert int(got[i].sum()) == n_outs[i]
        assert replays[i].remaining == 0


@pytest.mark.parametrize("scheme", CHAINS)
def test_chain_ancestor_wrappers_match_reference(scheme):
    n = 64
    lw = _log_weights("normal", n, 8)
    key = jax.random.key(9)
    kp, ku = jax.random.split(key)
    replay = ReplayDraws([
        ("randint", np.asarray(jax.random.randint(kp, (n, 32), 0, n,
                                                  jnp.int32))),
        ("uniform", np.asarray(jax.random.uniform(ku, (n, 32))))])
    fn = getattr(tresampling, f"{scheme}_ancestors")
    want = getattr(jresampling, f"{scheme}_ancestors")(key, jnp.asarray(lw),
                                                       n)
    np.testing.assert_array_equal(fn(replay, _t(lw), n).numpy(),
                                  np.asarray(want))


def test_resampling_draws_take_the_reference_stream():
    key = jax.random.key(12)
    prop, log_us = jresampling.resampling_draws(key, 50, 30, 8)
    kp, ku = jax.random.split(key)
    replay = ReplayDraws([
        ("randint", np.asarray(jax.random.randint(kp, (30, 8), 0, 50,
                                                  jnp.int32))),
        ("uniform", np.asarray(jax.random.uniform(ku, (30, 8))))])
    got_p, got_u = tresampling.resampling_draws(replay, 50, 30, 8)
    assert got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(prop))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(log_us), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The SIR step with the chain schemes
# ---------------------------------------------------------------------------

N, IMG = 512, (32, 32)


def chain_step_draws(key, n, d, iters=32):
    """One chain-scheme SIR step: ``split(key, 3)`` into (carry,
    dynamics, resample); the dynamics take ``normal (n, d)``, the chain
    ``resampling_draws(k_res, n, n, iters)``: ``split(k_res)`` into a
    ``randint (n, iters)`` and a ``uniform (n, iters)``."""
    key, k_dyn, k_res = jax.random.split(key, 3)
    kp, ku = jax.random.split(k_res)
    return key, [
        ("normal", np.asarray(jax.random.normal(k_dyn, (n, d)))),
        ("randint", np.asarray(jax.random.randint(kp, (n, iters), 0, n,
                                                  jnp.int32))),
        ("uniform", np.asarray(jax.random.uniform(ku, (n, iters))))]


def _run_draws(key, n, n_frames):
    k_init, k_run = jax.random.split(key)
    draws = draws_mod.tracking_init_draws(k_init, n)
    for _ in range(n_frames):
        k_run, step = chain_step_draws(k_run, n, 5)
        draws += step
    return draws


@pytest.mark.parametrize("backend", ["composed", "fused"])
@pytest.mark.parametrize("scheme", CHAINS)
def test_chain_sir_step_matches_reference(scheme, backend):
    """One step from a shared ensemble, always resampling, with the
    reference's draws replayed."""
    cfg = jtracking.TrackingConfig(img_size=IMG, v_init=1.5)
    movie = ref_movie(jax.random.key(0), cfg, n_frames=1)
    jmodel = jtracking.TrackingSSM(cfg)
    ens = jparticles.init_ensemble(jax.random.key(3), jmodel.init, N)
    key = jax.random.key(4)
    sir = dict(n_particles=N, resampler=scheme, step_backend=backend,
               always_resample=True)
    ref_carry, ref_out = jsmc.make_sir_step(jmodel, RefSIR(**sir))(
        jsmc.SIRCarry(key, ens), movie.frames[0])
    _, step = chain_step_draws(key, N, 5)
    draws = ReplayDraws(step)
    port_ens = convert.ensemble_from_numpy(
        np.asarray(ens.state), np.asarray(ens.log_weights),
        np.asarray(ens.counts))
    carry, out = tsmc.make_sir_step(
        TrackingSSM(draws_mod.port_config(cfg)), SIRConfig(**sir))(
        tsmc.SIRCarry(draws, port_ens),
        torch.from_numpy(np.array(movie.frames[0])))
    assert draws.remaining == 0
    np.testing.assert_allclose(out.estimate.numpy(), ref_out.estimate,
                               atol=ATOL)
    np.testing.assert_allclose(float(out.log_marginal),
                               float(ref_out.log_marginal), atol=ATOL)
    np.testing.assert_allclose(float(out.ess), float(ref_out.ess), rtol=1e-5)
    assert bool(out.resampled) and bool(ref_out.resampled)
    np.testing.assert_allclose(carry.ensemble.state.numpy(),
                               ref_carry.ensemble.state, atol=1e-4)
    np.testing.assert_allclose(carry.ensemble.log_weights.numpy(),
                               ref_carry.ensemble.log_weights, atol=ATOL)


@pytest.mark.parametrize("backend", ["composed", "fused"])
@pytest.mark.parametrize("scheme", CHAINS)
def test_chain_tracking_run_matches_reference(scheme, backend):
    """A 4-frame tracking run: every draw of the reference's run replayed
    and consumed."""
    cfg = jtracking.TrackingConfig(img_size=IMG, v_init=1.5)
    movie = ref_movie(jax.random.key(1), cfg, n_frames=4)
    key = jax.random.key(2)
    sir = dict(n_particles=N, resampler=scheme, step_backend=backend)
    ref_carry, ref_outs = jsmc.run_sir(key, jtracking.TrackingSSM(cfg),
                                       RefSIR(**sir), movie.frames)
    draws = ReplayDraws(_run_draws(key, N, 4))
    carry, outs = run_sir(draws, TrackingSSM(draws_mod.port_config(cfg)),
                          SIRConfig(**sir),
                          torch.from_numpy(np.array(movie.frames)))
    assert draws.remaining == 0
    np.testing.assert_allclose(outs.estimate.numpy(), ref_outs.estimate,
                               atol=ATOL)
    np.testing.assert_allclose(outs.log_marginal.numpy(),
                               ref_outs.log_marginal, atol=ATOL)
    np.testing.assert_array_equal(outs.resampled.numpy(), ref_outs.resampled)
    assert outs.resampled.any()
    np.testing.assert_allclose(carry.ensemble.state.numpy(),
                               ref_carry.ensemble.state, atol=1e-4)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def test_resample_kernel_wrappers_take_cuda_tensors_only():
    """No silent fallback: each CUDA wrapper refuses a CPU tensor before
    building anything; the dispatcher picks the plain versions."""
    lw = torch.zeros(2, 16)
    prop = torch.zeros(2, 16, 32, dtype=torch.int32)
    log_us = torch.zeros(2, 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tkernels.systematic_ancestors_kernel(lw, torch.zeros(2), 16)
    for fn in (tkernels.metropolis_ancestors_kernel,
               tkernels.rejection_ancestors_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(lw, prop, log_us)
        with pytest.raises(ValueError, match="expected"):
            fn(lw[0], prop, log_us)
    assert torch.equal(ops.metropolis_ancestors(lw, prop, log_us),
                       tkernels.metropolis_ancestors_ref(lw, prop, log_us))
    assert torch.equal(ops.rejection_ancestors(lw, prop, log_us),
                       tkernels.rejection_ancestors_ref(lw, prop, log_us))
