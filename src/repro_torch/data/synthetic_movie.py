"""Synthetic fluorescence-microscopy movies (port of
``repro.data.synthetic_movie``).

Spots move with near-constant velocity toward a random far point and are
rendered with the Gaussian-PSF model plus Gaussian noise.  Draws, in the
reference's order: ``uniform (M, 2)`` start, ``uniform (M, 2)`` target,
``normal (K, H, W)`` noise.  The movie is made on the draws' device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.tracking import TrackingConfig, render_spot


class Movie(NamedTuple):
    """A noisy movie with its ground truth."""

    frames: torch.Tensor        # (K, H, W)
    trajectories: torch.Tensor  # (K, M, 2) (y, x) per spot
    intensities: torch.Tensor   # (M,)


def generate_movie(draws, cfg: TrackingConfig, n_frames: int = 50,
                   n_spots: int = 1) -> Movie:
    """Make a ``n_frames`` movie of ``n_spots`` spots from ``draws``."""
    h, w = cfg.img_size
    dev = draws.device
    margin = 8.0 * cfg.sigma_psf
    lo = torch.full((2,), margin, dtype=torch.float32, device=dev)
    hi = torch.tensor([h - margin, w - margin], dtype=torch.float32,
                      device=dev)
    pos = lo + draws.uniform((n_spots, 2)) * (hi - lo)
    target = lo + draws.uniform((n_spots, 2)) * (hi - lo)
    heading = target - pos
    dist = torch.linalg.norm(heading, dim=-1, keepdim=True)
    speed = torch.clamp(dist / n_frames, max=cfg.v_init)
    vel = heading / dist.clamp(min=1e-6) * speed
    traj = []
    for _ in range(n_frames):
        pos = torch.minimum(torch.maximum(pos + vel, lo), hi)
        traj.append(pos)
    traj = torch.stack(traj)                                   # (K, M, 2)
    inten = torch.full((n_spots,), cfg.i_peak, dtype=torch.float32,
                       device=dev)
    clean = torch.stack([
        sum(render_spot(traj[k, m], inten[m], cfg, (h, w))
            for m in range(n_spots)) + cfg.i_bg
        for k in range(n_frames)])
    noise = cfg.sigma_noise * draws.normal(clean.shape)
    return Movie(frames=clean + noise, trajectories=traj, intensities=inten)


def tile_shard_frames(frames: torch.Tensor, spec) -> torch.Tensor:
    """``(K, H, W)`` frames -> ``(K, P, sh, sw)`` halo slabs of the
    ``repro_torch.core.domain.DomainSpec`` ``spec``: dim 1 is the shard
    dim, so each shard reads its own tile and halo ring, about 1/P of the
    frame's bytes."""
    from repro_torch.core.domain import tile_frames
    return tile_frames(spec, frames)


def tracking_rmse(estimates: torch.Tensor, trajectory: torch.Tensor,
                  warmup: int = 5) -> torch.Tensor:
    """Positional RMSE in pixels after ``warmup`` frames."""
    err = estimates[warmup:, :2] - trajectory[warmup:]
    return torch.sqrt(torch.mean(torch.sum(err ** 2, dim=-1)))
