"""The port's particle algebra and comb resamplers against the reference.

Float statistics at rtol = atol = 1e-6 (float32 reductions in a different
order); integer outputs (counts, ancestors) exactly, with the reference's
own draws replayed.  Every case also runs batched (a leading bank dim)
and must equal the per-member calls bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import particles as jparticles
from repro.core import resampling as jresampling
from repro_torch.core import particles as tparticles
from repro_torch.core import resampling as tresampling
from repro_torch.core.draws import ReplayDraws

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype))


def _weights(seed, n, dead=0.0):
    rng = np.random.default_rng(seed)
    lw = (3.0 * rng.standard_normal(n)).astype(np.float32)
    lw[rng.random(n) < dead] = -np.inf
    counts = rng.integers(0, 3, n).astype(np.int32)
    return lw, counts


@pytest.mark.parametrize("dead", [0.0, 0.4, 1.0])
def test_weight_algebra_matches_reference(dead):
    lw, counts = _weights(1, 300, dead)
    state = np.random.default_rng(2).standard_normal((300, 3)).astype(
        np.float32)
    for c in (None, counts):
        tc = None if c is None else _t(c, np.int32)
        np.testing.assert_allclose(
            tparticles.normalized_weights(_t(lw), tc).numpy(),
            jparticles.normalized_weights(jnp.asarray(lw), c), **TOL)
        np.testing.assert_allclose(
            float(tparticles.effective_sample_size(_t(lw), tc)),
            float(jparticles.effective_sample_size(jnp.asarray(lw), c)),
            **TOL)
        np.testing.assert_allclose(
            float(tparticles.log_sum_weights(_t(lw), tc)),
            float(jparticles.log_sum_weights(jnp.asarray(lw), c)), **TOL)
    ens_c = np.ones(300, np.int32) if dead < 1 else counts
    ref = jparticles.ParticleEnsemble(jnp.asarray(state), jnp.asarray(lw),
                                      jnp.asarray(ens_c))
    port = tparticles.ParticleEnsemble(_t(state), _t(lw), _t(ens_c, np.int32))
    np.testing.assert_allclose(tparticles.weighted_mean(port).numpy(),
                               jparticles.weighted_mean(ref), **TOL)
    assert int(tparticles.logical_size(port)) == int(
        jparticles.logical_size(ref))


def test_reweight_keeps_dead_slots_dead():
    lw = np.asarray([0.0, -np.inf, -1.0], np.float32)
    ens = tparticles.ParticleEnsemble(torch.zeros(3, 1), _t(lw),
                                      torch.ones(3, dtype=torch.int32))
    out = tparticles.reweight(ens, _t([1.0, 5.0, 2.0]))
    np.testing.assert_array_equal(out.log_weights.numpy(),
                                  [1.0, -np.inf, 1.0])


@pytest.mark.parametrize("total", ["exact", "short", "long"])
def test_counts_to_ancestors_matches_repeat(total):
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 4, 64).astype(np.int32)
    n_out = {"exact": int(counts.sum()), "short": int(counts.sum()) + 9,
             "long": int(counts.sum()) - 9}[total]
    got = tresampling.counts_to_ancestors(_t(counts, np.int32), n_out)
    want = jresampling.counts_to_ancestors(jnp.asarray(counts), n_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tresampling.ancestors_to_counts(got, 64)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jresampling.ancestors_to_counts(want, 64)))


def _scheme_draws(scheme, key, capacity):
    """The one draw each scheme takes from ``key``, as the reference."""
    if scheme == "systematic":
        return [("uniform", np.asarray(jax.random.uniform(key, ())))]
    if scheme == "stratified":
        return [("uniform", np.asarray(jax.random.uniform(key,
                                                          (capacity,))))]
    return [("exponential", np.asarray(jax.random.exponential(
        key, (capacity + 1,))))]


@pytest.mark.parametrize("scheme", ["systematic", "stratified",
                                    "multinomial", "residual"])
@pytest.mark.parametrize("n_out", [512, 300])
def test_comb_counts_match_reference(scheme, n_out):
    n = 512
    lw, _ = _weights(7, n, dead=0.1)
    key = jax.random.key(11)
    want = jresampling.RESAMPLERS[scheme](key, jnp.asarray(lw), n_out,
                                          capacity=n)
    got = tresampling.RESAMPLERS[scheme](
        ReplayDraws(_scheme_draws(scheme, key, n)), _t(lw), n_out,
        capacity=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == n_out


@pytest.mark.parametrize("scheme", ["systematic", "stratified",
                                    "multinomial", "residual"])
def test_comb_counts_batched_equal_members(scheme):
    """A bank of members with per-member ``n_out`` equals member-wise
    calls bitwise."""
    n, b = 256, 3
    lws = np.stack([_weights(20 + i, n, dead=0.2)[0] for i in range(b)])
    n_outs = [256, 200, 17]
    keys = [jax.random.key(30 + i) for i in range(b)]
    draws = [_scheme_draws(scheme, k, n)[0] for k in keys]
    stacked = [(draws[0][0], np.stack([d[1] for d in draws]))]
    got = tresampling.RESAMPLERS[scheme](
        _BatchedReplay(stacked), _t(lws), torch.tensor(n_outs), capacity=n)
    for i in range(b):
        solo = tresampling.RESAMPLERS[scheme](
            ReplayDraws([draws[i]]), _t(lws[i]), n_outs[i], capacity=n)
        np.testing.assert_array_equal(got[i].numpy(), solo.numpy())
        assert int(got[i].sum()) == n_outs[i]


class _BatchedReplay(ReplayDraws):
    """Replays ``(B,) + shape`` arrays for per-member ``shape`` asks."""

    def _next(self, kind, shape):
        arr = self._draws[self._pos][1]
        return super()._next(kind, arr.shape) if arr.shape[1:] == tuple(
            shape) else super()._next(kind, shape)


@pytest.mark.parametrize("scheme", ["metropolis", "rejection"])
def test_chain_resamplers_wait_for_their_kernels(scheme, monkeypatch):
    """On a CUDA tensor the chain schemes take their kernel through
    ``kernels.ops`` and never the plain version (the kernel is stood in
    for here, so the routing is checked on the CPU)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import resample as tkernels
    plain = getattr(tkernels, f"{scheme}_ancestors_ref")
    calls = []

    def kernel(lw, prop, log_us):
        calls.append(tuple(lw.shape))
        return plain(lw, prop, log_us)

    def refuse(*args):
        raise AssertionError("plain version reached for a CUDA tensor")

    monkeypatch.setattr(ops, "on_cuda", lambda t: True)
    monkeypatch.setattr(tkernels, f"{scheme}_ancestors_kernel", kernel)
    monkeypatch.setattr(tkernels, f"{scheme}_ancestors_ref", refuse)
    lw = torch.randn(3, 8, generator=torch.Generator().manual_seed(2))
    draws = [("randint", np.random.default_rng(0).integers(
                  0, 8, (3, 8, 32)).astype(np.int32)),
             ("uniform", np.random.default_rng(1).random((3, 8, 32)))]
    counts = tresampling.RESAMPLERS[scheme](_BatchedReplay(draws), lw, 8)
    assert calls == [(3, 8)]
    assert counts.shape == (3, 8) and bool((counts.sum(-1) == 8).all())


def test_gather_particles_batched():
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    anc = torch.tensor([[4, 4, 0, 1, 2], [0, 0, 0, 3, 3]], dtype=torch.int32)
    got = tparticles.gather_particles(x, anc)
    for i in range(2):
        assert torch.equal(got[i], x[i][anc[i].long()])
    assert torch.equal(tparticles.gather_particles(x[0], anc[0]),
                       x[0][anc[0].long()])


def test_simulate_matches_reference_on_replayed_draws():
    """``simulate`` takes the init draw, then per step the transition and
    observation draws — the reference's key splits, replayed."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    jmodel = jssm.oracle_configs()["cv2d"]
    key, n_steps = jax.random.key(7), 6
    want_x, want_z = jssm.simulate(key, jmodel, n_steps)
    k_init, k_scan = jax.random.split(key)
    draws = [("normal", np.asarray(jax.random.normal(k_init, (1, 4))))]
    for k in jax.random.split(k_scan, n_steps):
        k_dyn, k_obs = jax.random.split(k)
        draws += [("normal", np.asarray(jax.random.normal(k_dyn, (1, 4)))),
                  ("normal", np.asarray(jax.random.normal(k_obs, (1, 2))))]
    got_x, got_z = tssm.simulate(ReplayDraws(draws),
                                 tssm.oracle_configs()["cv2d"], n_steps)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_z.numpy(), want_z, rtol=1e-5, atol=1e-5)


def test_domain_hooks_resolve_like_the_reference():
    from repro_torch.models.ssm import domain_hooks
    from repro_torch.models.tracking import TrackingConfig, TrackingSSM

    class Legacy:
        def positions(self, s):
            return s

        def tile_log_likelihood(self, s, slab, origin):
            return s

    pos, tile = domain_hooks(Legacy())
    assert callable(pos) and callable(tile)
    model = TrackingSSM(TrackingConfig())
    pos, tile = domain_hooks(model)
    assert pos == model.positions
    assert tile == model.tile_observation_log_prob
    assert domain_hooks(object()) == (None, None)
