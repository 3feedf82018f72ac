"""The port's plain kernel versions against the JAX reference.

Patch likelihood: ``repro_torch.kernels.ref.patch_log_likelihood_ref`` and
``repro_torch.models.tracking.patch_log_likelihood`` against
``repro.kernels.ref``, ``repro.models.tracking`` and the Pallas kernel in
interpret mode, at rtol = atol = 3e-5 (the reference's own kernel bound,
tests/test_kernels.py).

Fused weight phase: ``repro_torch.kernels.sir_fused.fused_weight_step_ref``
against the Pallas megakernel in interpret mode and the reference's jnp
version, with the comb uniform drawn from the reference's key.  Scalars,
estimate and new log-weights at rtol = atol = 2e-6 (the reference's
kernel bound).  Ancestors exactly, except at a comb point that lies
within ``TIE_DELTA`` of a boundary of the float64 CDF: the three
implementations build their f32 CDFs in different orders (torch's CPU
cumsum accumulates in double, JAX's and the Pallas scan in f32), so they
differ by a few ulp of 1 — about 1e-7 here — and a comb point that close
to a boundary may land on either side.  ``TIE_DELTA`` = 1e-5 covers that
with two orders of margin and, at these sizes (n ≤ 2048), stays 20x below
the comb spacing 1/n.

The CUDA kernels themselves run only on the card; chip_smoke.py holds
them against these plain versions there.  At the card's sizes (n up to
2^22) 1e-5 spans dozens of strata, so there the kernel's ancestors are
also held directly against the float64 CDF's comb.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.kernels import ref as jref
from repro.kernels import sir_fused as jfused
from repro.kernels.patch_likelihood import patch_log_likelihood_kernel
from repro.models import tracking as jtracking
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sir_fused as tfused
from repro_torch.models import tracking as ttracking

PATCH_TOL = 3e-5
FUSED_TOL = 2e-6
TIE_DELTA = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _patch_inputs(seed, n, h, w):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) * h).astype(np.float32)
    x = (rng.random(n) * w).astype(np.float32)
    i0 = (rng.random(n) * 3).astype(np.float32)
    img = rng.standard_normal((h, w)).astype(np.float32)
    return y, x, i0, img


@pytest.mark.parametrize("n,h,w,radius,block", [
    (512, 64, 64, 3, 128), (1024, 96, 128, 4, 256), (256, 80, 80, 5, 256)])
@pytest.mark.parametrize("matched", [True, False])
def test_patch_ref_matches_reference(n, h, w, radius, block, matched):
    y, x, i0, img = _patch_inputs(n + h + radius, n, h, w)
    got = tref.patch_log_likelihood_ref(_t(y), _t(x), _t(i0), _t(img),
                                        radius=radius, matched=matched)
    want = jref.patch_log_likelihood_ref(y, x, i0, img, radius=radius,
                                         matched=matched)
    np.testing.assert_allclose(got.numpy(), want, rtol=PATCH_TOL,
                               atol=PATCH_TOL)
    if radius == 4:     # the slice's radius; interpret mode is slow
        pallas = patch_log_likelihood_kernel(y, x, i0, img, radius=radius,
                                             matched=matched, block_n=block,
                                             interpret=True)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=PATCH_TOL,
                                   atol=PATCH_TOL)


@pytest.mark.parametrize("matched", [True, False])
def test_patch_edge_of_frame(matched):
    """Centres within R of the border clamp into ``[R, dim-1-R]`` in the
    port's two plain versions and the reference's two (the positions of
    tests/test_kernels.py, which also pins the Pallas kernel there)."""
    radius, h, w = 4, 48, 64
    form = "matched" if matched else "eq4"
    jcfg = jtracking.TrackingConfig(img_size=(h, w), likelihood_form=form)
    tcfg = ttracking.TrackingConfig(img_size=(h, w), likelihood_form=form)
    img = np.random.default_rng(5).standard_normal((h, w)).astype(np.float32)
    y = np.asarray([0.0, 0.49, 3.5, 3.99, 4.0, 47.0, 46.51, 44.0, 43.99, 23.5,
                    0.0, 47.0, 24.0, 1.7, 45.2, 20.0], np.float32)
    x = np.asarray([0.0, 63.0, 0.7, 62.3, 59.0, 0.0, 63.0, 59.99, 60.0, 31.5,
                    63.0, 0.0, 24.0, 61.8, 2.2, 30.0], np.float32)
    i0 = np.full(16, 2.0, np.float32)
    state = np.stack([y, x, np.zeros(16), np.zeros(16), i0], 1).astype(
        np.float32)
    got = ttracking.patch_log_likelihood(_t(state), _t(img), tcfg)
    via_ops = ops.patch_log_likelihood(_t(state), _t(img), radius=radius,
                                       matched=matched)
    want = jtracking.patch_log_likelihood(jnp.asarray(state), img, jcfg)
    oracle = jref.patch_log_likelihood_ref(y, x, i0, img, radius=radius,
                                           matched=matched)
    np.testing.assert_array_equal(got.numpy(), via_ops.numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=PATCH_TOL,
                               atol=PATCH_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=PATCH_TOL,
                               atol=PATCH_TOL)


def test_patch_center_bounds_and_frame_origin():
    """A halo slab with (center_bounds, frame_origin) equals the full
    frame for particles owned by the slab's tile — bitwise in the port,
    and within tolerance of the reference and the Pallas kernel."""
    radius, h, w = 3, 40, 40
    img = np.random.default_rng(9).standard_normal((h, w)).astype(np.float32)
    oy = ox = 8 - radius
    slab = img[oy:32 + radius, ox:32 + radius]
    bounds, origin = (8, 31, 8, 31), (oy, ox)
    rng = np.random.default_rng(11)
    y = (8.0 + rng.random(64) * 23.0).astype(np.float32)
    x = (8.0 + rng.random(64) * 23.0).astype(np.float32)
    i0 = (rng.random(64) * 3).astype(np.float32)
    full = tref.patch_log_likelihood_ref(_t(y), _t(x), _t(i0), _t(img),
                                         radius=radius)
    got = tref.patch_log_likelihood_ref(_t(y), _t(x), _t(i0), _t(slab),
                                        radius=radius, center_bounds=bounds,
                                        frame_origin=origin)
    pallas = patch_log_likelihood_kernel(
        y, x, i0, slab, radius=radius, block_n=64,
        center_bounds=jnp.asarray(bounds, jnp.int32),
        frame_origin=jnp.asarray(origin, jnp.int32), interpret=True)
    want = jref.patch_log_likelihood_ref(y, x, i0, img, radius=radius)
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    np.testing.assert_allclose(got.numpy(), pallas, rtol=PATCH_TOL,
                               atol=PATCH_TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=PATCH_TOL,
                               atol=PATCH_TOL)


def test_patch_batched_members_match_reference():
    """B > 1: a ``(B, N)`` batch against ``(B, H, W)`` frames equals the
    reference member by member, and the port's own per-member calls
    bitwise."""
    b, n, h, w = 3, 256, 48, 56
    ins = [_patch_inputs(40 + i, n, h, w) for i in range(b)]
    y, x, i0, img = (np.stack([c[k] for c in ins]) for k in range(4))
    got = tref.patch_log_likelihood_ref(_t(y), _t(x), _t(i0), _t(img))
    assert got.shape == (b, n)
    for i in range(b):
        want = jref.patch_log_likelihood_ref(y[i], x[i], i0[i], img[i])
        np.testing.assert_allclose(got[i].numpy(), want, rtol=PATCH_TOL,
                                   atol=PATCH_TOL)
        solo = tref.patch_log_likelihood_ref(_t(y[i]), _t(x[i]), _t(i0[i]),
                                             _t(img[i]))
        np.testing.assert_array_equal(got[i].numpy(), solo.numpy())


def test_patch_rounds_half_to_even():
    """At exact .5 positions ``jnp.round`` rounds half to even, so the
    centre of y = 2k + 0.5 is 2k, where round-half-away-from-zero would
    take 2k + 1.  The port follows the reference there, and the test is
    sharp: moving the centre by that one pixel (the next float up rounds
    to 2k + 1) changes every result far beyond the tolerance."""
    h = w = 64
    radius = 2
    rng = np.random.default_rng(3)
    img = rng.standard_normal((h, w)).astype(np.float32)
    y = (np.arange(8, 56, 2) + 0.5).astype(np.float32)        # even + .5
    x = rng.integers(8, 56, y.shape).astype(np.float32)
    i0 = np.full(y.shape, 2.0, np.float32)
    got = tref.patch_log_likelihood_ref(_t(y), _t(x), _t(i0), _t(img),
                                        radius=radius)
    want = jref.patch_log_likelihood_ref(y, x, i0, img, radius=radius)
    np.testing.assert_allclose(got.numpy(), want, rtol=PATCH_TOL,
                               atol=PATCH_TOL)
    away = tref.patch_log_likelihood_ref(
        _t(np.nextafter(y, np.float32(99))), _t(x), _t(i0), _t(img),
        radius=radius)
    assert np.abs((got - away).numpy()).min() > 10 * PATCH_TOL


@pytest.mark.parametrize("n_in,n_out", [(256, 256), (1000, 2048),
                                         (4096, 1024)])
@pytest.mark.parametrize("u", [0.0, 0.37, 0.999])
def test_systematic_ancestors_ref_matches_reference(n_in, n_out, u):
    """The plain version of the DRA local resample (B1's ground truth):
    exact ancestors, up to comb points within TIE_DELTA of a CDF
    boundary (the rule of the fused tests below)."""
    lw = (3.0 * np.random.default_rng(n_in + n_out).standard_normal(
        n_in)).astype(np.float32)
    got = tref.systematic_ancestors_ref(_t(lw), torch.tensor(u), n_out)
    want = np.asarray(jref.systematic_ancestors_ref(
        jnp.asarray(lw), jnp.asarray(u, jnp.float32), n_out))
    w = np.exp(lw.astype(np.float64) - lw.max())
    cdf = np.cumsum(w / w.sum())
    pos = (np.arange(n_out) + u) / n_out
    for i in np.nonzero(got.numpy() != want)[0]:
        lo, hi = sorted((int(got[i]), int(want[i])))
        assert abs(cdf[lo] - pos[i]) <= TIE_DELTA
        assert abs(cdf[hi - 1] - pos[i]) <= TIE_DELTA


def test_patch_kernel_wrapper_takes_cuda_tensors_only():
    """No silent fallback: the CUDA wrapper refuses a CPU tensor (the
    dispatcher is what picks the plain version for CPU tensors)."""
    from repro_torch.kernels.patch_likelihood import \
        patch_log_likelihood_kernel as cuda_kernel
    with pytest.raises(ValueError):
        cuda_kernel(torch.zeros(1, 8, 5), torch.zeros(1, 16, 16))


# ---------------------------------------------------------------------------
# Fused weight phase
# ---------------------------------------------------------------------------

def _fused_case(seed, n, d, kind):
    rng = np.random.default_rng(seed)
    lw = (np.full(n, -np.log(n)) + 0.1 * rng.standard_normal(n)).astype(
        np.float32)
    ll = (2.0 * rng.standard_normal(n)).astype(np.float32)
    if kind == "dead":
        lw[:] = -np.inf
    elif kind == "flat":
        ll = (1e-3 * ll).astype(np.float32)
    elif kind == "some_dead":
        lw[rng.random(n) < 0.3] = -np.inf
    state = (rng.random((n, d)) * 64).astype(np.float32)
    return lw, ll, state


def _comb_ties(anc_got, anc_want, lw, ll, u):
    """Lanes whose ancestors differ must sit within TIE_DELTA of the
    float64 CDF at both disagreeing boundaries."""
    lwp = np.where(np.isfinite(lw), lw.astype(np.float64) + ll, -np.inf)
    m = lwp.max()
    w = (np.exp(lwp - m) / np.exp(lwp - m).sum() if np.isfinite(m)
         else np.full(lw.shape, 1.0 / lw.shape[0]))
    cdf = np.cumsum(w)
    n = lw.shape[0]
    for i in np.nonzero(anc_got != anc_want)[0]:
        lo, hi = sorted((int(anc_got[i]), int(anc_want[i])))
        pos = (i + float(u)) / n
        assert abs(cdf[lo] - pos) <= TIE_DELTA, (i, lo, hi)
        assert abs(cdf[hi - 1] - pos) <= TIE_DELTA, (i, lo, hi)
    return int((anc_got != anc_want).sum())


def _check_fused(got, lw, ll, state, key, ess_frac, always):
    """One member of the port's decision against the Pallas kernel
    (interpret mode) and the reference's jnp version."""
    u = jax.random.uniform(key, ())
    n, d = state.shape
    anc, new_lw, est, stats = jfused.fused_weight_step_kernel(
        jnp.asarray(lw), jnp.asarray(ll), jnp.asarray(state), u,
        block=min(1024, n), ess_frac=ess_frac, always=always,
        interpret=True)
    ref = jfused.fused_weight_step_ref(jnp.asarray(lw), jnp.asarray(ll),
                                       jnp.asarray(state), key,
                                       ess_frac=ess_frac, always=always)
    tol = dict(rtol=FUSED_TOL, atol=FUSED_TOL)
    for want_anc, want in ((np.asarray(anc), (stats[0], stats[1], stats[5],
                                              est[0], new_lw, stats[2] > 0)),
                           (np.asarray(ref.ancestors),
                            (ref.ess, ref.log_z, ref.weight_skew,
                             ref.estimate, ref.new_log_weights,
                             ref.resampled))):
        ess, log_z, skew, estimate, nlw, resampled = want
        assert bool(got.resampled) == bool(resampled)
        np.testing.assert_allclose(float(got.ess), float(ess), **tol)
        np.testing.assert_allclose(float(got.log_z), float(log_z), **tol)
        np.testing.assert_allclose(float(got.weight_skew), float(skew), **tol)
        np.testing.assert_allclose(got.estimate.numpy(), estimate, **tol)
        np.testing.assert_allclose(got.new_log_weights.numpy(), nlw, **tol)
        _comb_ties(got.ancestors.numpy(), want_anc, lw, ll, float(u))


@pytest.mark.parametrize("kind,ess_frac,always", [
    ("normal", 0.9, False), ("normal", 0.5, True), ("flat", 0.5, False),
    ("dead", 0.5, False), ("some_dead", 0.9, False)])
def test_fused_ref_matches_reference(kind, ess_frac, always):
    n, d = 2048, 5
    lw, ll, state = _fused_case(7, n, d, kind)
    key = jax.random.key(33)
    u = _t(jax.random.uniform(key, ()))
    got = tfused.fused_weight_step_ref(_t(lw), _t(ll), _t(state), u,
                                       ess_frac=ess_frac, always=always)
    if kind == "flat":
        assert not bool(got.resampled)
        np.testing.assert_array_equal(got.ancestors.numpy(), np.arange(n))
    if kind == "dead":
        assert float(got.ess) == n and np.isneginf(float(got.log_z))
    _check_fused(got, lw, ll, state, key, ess_frac, always)


def test_fused_ref_batched_members_match_reference():
    """B > 1 with an all -inf member, a member that does not resample
    and resampling members: each equals the reference alone, and the
    port's batched call equals its per-member calls bitwise."""
    n, d = 1024, 5
    kinds = ["normal", "dead", "flat", "some_dead"]
    cases = [_fused_case(20 + i, n, d, k) for i, k in enumerate(kinds)]
    lw, ll, state = (np.stack([c[j] for c in cases]) for j in range(3))
    keys = [jax.random.key(50 + i) for i in range(len(kinds))]
    u = torch.stack([_t(jax.random.uniform(k, ())) for k in keys])
    got = tfused.fused_weight_step_ref(_t(lw), _t(ll), _t(state), u,
                                       ess_frac=0.6)
    for i, key in enumerate(keys):
        member = tfused.FusedDecision(*(f[i] for f in got))
        solo = tfused.fused_weight_step_ref(_t(lw[i]), _t(ll[i]),
                                            _t(state[i]), u[i], ess_frac=0.6)
        for a, b in zip(member, solo):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        _check_fused(member, lw[i], ll[i], state[i], key, 0.6, False)


def test_fused_comb_false_is_identity():
    n = 512
    lw, ll, state = _fused_case(3, n, 2, "normal")
    got = tfused.fused_weight_step_ref(_t(lw), _t(ll), _t(state),
                                       torch.tensor(0.3), always=True,
                                       comb=False)
    assert bool(got.resampled)
    np.testing.assert_array_equal(got.ancestors.numpy(), np.arange(n))


def test_fused_dispatch_raises_for_unported_chains():
    """The fused dispatch refuses every scheme it does not commit on the
    card (the SIR step falls back to the composed path for those), and
    takes each chain's draws in the chain's order — proposals, then
    uniforms — with no comb uniform."""
    from repro_torch.core.draws import ReplayDraws
    n = 64
    lw, ll, state = _fused_case(3, n, 5, "normal")
    for scheme in ("stratified", "residual", "gibbs"):
        with pytest.raises(ValueError, match="does not support"):
            tfused.fused_weight_step(_t(lw), _t(ll), _t(state),
                                     ReplayDraws([]), resampler=scheme)
    rng = np.random.default_rng(4)
    for scheme in ("metropolis", "rejection"):
        draws = ReplayDraws([
            ("randint", rng.integers(0, n, (n, 32)).astype(np.int32)),
            ("uniform", rng.random((n, 32)))])
        dec = tfused.fused_weight_step(_t(lw), _t(ll), _t(state), draws,
                                       resampler=scheme, always=True)
        assert draws.remaining == 0 and bool(dec.resampled)


def test_fused_state_matrix_round_trip():
    state = torch.arange(2 * 6 * 3 * 2, dtype=torch.float32).reshape(
        2, 6, 3, 2)
    mat, unflatten = tfused.state_matrix(state, lead_dims=1)
    assert mat.shape == (2, 6, 6)
    row = mat.sum(1)
    assert torch.equal(unflatten(row), state.sum(1))
