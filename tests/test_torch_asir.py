"""The port's ASIR (``repro_torch.core.asir``, paper §VI.F) against the
reference's ``repro.core.asir``.

* The lattice: its cell-centre states against the reference's
  construction, and the table (the likelihood read at every cell
  centre) against ``make_asir_model``'s on one frame within PATCH_TOL
  (rtol = atol = 3e-5, the reference's kernel bound).
* Piecewise constancy (tests/test_asir.py), and the cell lookup's
  truncation at the cell edges and outside the frame.
* ``run_sir`` at 64×64, N = 512, on the reference's draws replayed,
  against the reference computed live: estimates and log-marginals at
  atol 1e-5 (tests/test_parity.py), ``resampled`` exactly.
* The reference's quality bound (RMSE ≤ exact + 2.5 px after 10 frames,
  64×64, N = 8192, grid 32) on the port's own RNG.
* The wrapped model has no domain hooks: ``domain=`` raises the step's
  missing-hooks error; and it builds its lattice on the CUDA device
  unless given ``device="cpu"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_draws as draws_mod
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.core import asir as jasir
from repro.core import smc as jsmc
from repro.data.synthetic_movie import generate_movie as ref_movie
from repro.models import tracking as jtracking
from repro_torch import convert
from repro_torch.core import ParallelParticleFilter, SIRConfig, run_sir
from repro_torch.core.asir import ASIRConfig, lattice_states, make_asir_model
from repro_torch.core.distributed import DRAConfig
from repro_torch.core.draws import ReplayDraws, TorchDraws
from repro_torch.core.runtime import EmulatedMesh
from repro_torch.data.synthetic_movie import generate_movie, tracking_rmse
from repro_torch.models.tracking import (TrackingConfig, TrackingSSM,
                                         make_domain_spec)

PATCH_TOL = 3e-5
ATOL = 1e-5


def _models(img, grid, bins=4):
    jcfg = jtracking.TrackingConfig(img_size=(img, img), v_init=1.0)
    jasir_cfg = jasir.ASIRConfig(grid=grid, intensity_bins=bins)
    ref = jasir.make_asir_model(jtracking.TrackingSSM(jcfg), jcfg, jasir_cfg)
    cfg = draws_mod.port_config(jcfg)
    acfg = convert.asir_config(jasir_cfg.__dict__)
    port = make_asir_model(TrackingSSM(cfg), cfg, acfg, device="cpu")
    return jcfg, cfg, acfg, ref, port


@pytest.mark.parametrize("grid,bins", [(16, 4), (32, 3)])
def test_lattice_table_matches_reference(grid, bins):
    jcfg, cfg, acfg, ref, port = _models(64, grid, bins)
    lattice = lattice_states(cfg, acfg, "cpu")
    g = np.arange(grid, dtype=np.float32)
    ys = (g + 0.5) * np.float32(64 / grid)
    ii = (np.arange(bins, dtype=np.float32) + 0.5) * np.float32(4.0 / bins)
    yy, xx, bb = np.meshgrid(ys, ys, ii, indexing="ij")
    want = np.stack([yy.ravel(), xx.ravel(), 0 * yy.ravel(), 0 * yy.ravel(),
                     bb.ravel()], -1)
    np.testing.assert_array_equal(lattice.numpy(), want)
    frame = np.array(ref_movie(jax.random.key(3), jcfg, n_frames=1).frames[0])
    got = port.log_likelihood(lattice, torch.from_numpy(frame))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref.log_likelihood(jnp.asarray(want), jnp.asarray(frame))),
        rtol=PATCH_TOL, atol=PATCH_TOL)


def test_asir_likelihood_is_piecewise_constant():
    _, cfg, _, _, port = _models(64, 16)
    frame = generate_movie(TorchDraws.from_seed(2, "cpu"), cfg,
                           n_frames=1).frames[0]
    # two states in the same 4px cell → identical ASIR log-lik
    s = torch.tensor([[10.1, 10.2, 0, 0, 2.0], [10.9, 10.8, 0, 0, 2.0]])
    ll = port.log_likelihood(s, frame)
    assert float((ll[0] - ll[1]).abs()) < 1e-6


def test_cell_lookup_truncates_like_the_reference():
    """Cell edges, the last cell, and states outside the frame (negative
    coordinates truncate toward zero, as ``astype(int32)`` does; beyond
    the frame they clamp to the last cell)."""
    jcfg, cfg, _, ref, port = _models(64, 16)
    frame = np.array(ref_movie(jax.random.key(5), jcfg, n_frames=1).frames[0])
    pts = np.array([[0.0, 0.0, 0, 0, 0.0], [3.999, 4.0, 0, 0, 0.999],
                    [-0.9, -3.5, 0, 0, -0.5], [63.99, 70.0, 0, 0, 3.99],
                    [-4.5, 12.0, 0, 0, 9.0], [31.5, 32.49, 1, 1, 2.0]],
                   np.float32)
    got = port.log_likelihood(torch.from_numpy(pts), torch.from_numpy(frame))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.log_likelihood(
        jnp.asarray(pts), jnp.asarray(frame))), rtol=PATCH_TOL,
        atol=PATCH_TOL)


@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_run_sir_matches_reference(backend):
    jcfg, cfg, acfg, ref, port = _models(64, 32)
    n, frames = 512, 6
    movie = ref_movie(jax.random.key(0), jcfg, n_frames=frames)
    key = jax.random.key(1)
    _, ref_outs = jsmc.run_sir(key, ref, RefSIR(
        n_particles=n, ess_frac=0.5, step_backend=backend), movie.frames)
    draws = ReplayDraws(draws_mod.run_sir_draws(key, n, 5, frames))
    _, outs = run_sir(draws, port, SIRConfig(
        n_particles=n, ess_frac=0.5, step_backend=backend),
        torch.from_numpy(np.array(movie.frames)))
    assert draws.remaining == 0
    np.testing.assert_allclose(outs.estimate.numpy(), ref_outs.estimate,
                               atol=ATOL)
    np.testing.assert_allclose(outs.log_marginal.numpy(),
                               ref_outs.log_marginal, atol=ATOL)
    np.testing.assert_array_equal(outs.resampled.numpy(), ref_outs.resampled)


def test_asir_tracks_with_bounded_quality_loss():
    cfg = TrackingConfig(img_size=(64, 64), v_init=1.0)
    exact = TrackingSSM(cfg)
    movie = generate_movie(TorchDraws.from_seed(0, "cpu"), cfg, n_frames=30)
    sir = SIRConfig(n_particles=8192, ess_frac=0.5)
    asir = make_asir_model(exact, cfg, ASIRConfig(grid=32), device="cpu")
    rmse = []
    for model in (exact, asir):
        _, outs = run_sir(TorchDraws.from_seed(1, "cpu"), model, sir,
                          movie.frames)
        rmse.append(float(tracking_rmse(outs.estimate,
                                        movie.trajectories[:, 0],
                                        warmup=10)))
    # quantization cell is 2px: ASIR should stay within ~a cell of exact
    assert rmse[1] < rmse[0] + 2.5, rmse


def test_asir_has_no_domain_hooks():
    cfg = TrackingConfig(img_size=(16, 16))
    asir = make_asir_model(TrackingSSM(cfg), cfg, ASIRConfig(grid=8),
                           device="cpu")
    assert asir.positions is None and asir.tile_log_likelihood is None
    pf = ParallelParticleFilter(asir, SIRConfig(n_particles=16),
                                device="cpu", mesh=EmulatedMesh(2),
                                dra=DRAConfig(kind="rna"),
                                domain=make_domain_spec(cfg, 2))
    with pytest.raises(ValueError, match="tile_observation_log_prob"):
        pf.run(0, torch.zeros(2, 16, 16))


def test_asir_on_a_bank_over_a_mesh_is_one_table_a_member():
    """Over a mesh the lattice is read against the shared frame once; in a
    bank over a mesh against each member's frame (``(B, 1, H, W)``)."""
    _, cfg, acfg, _, port = _models(32, 8)
    frames = torch.randn(2, 1, 32, 32, generator=torch.Generator()
                         .manual_seed(0))
    state = torch.rand(2, 3, 10, 5, generator=torch.Generator()
                       .manual_seed(1)) * 32
    got = port.log_likelihood(state, frames)
    for i in range(2):
        assert torch.equal(got[i], port.log_likelihood(state[i], frames[i, 0]))


def test_lattice_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrackingConfig(img_size=(16, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_asir_model(TrackingSSM(cfg), cfg, ASIRConfig(grid=8))
