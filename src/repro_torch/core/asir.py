"""Approximate Sequential Importance Resampling, paper §VI.F (port of
``repro.core.asir``).

ASIR replaces the per-particle likelihood with a piecewise-constant
approximation: the likelihood is evaluated once per cell of a G×G
lattice over the frame (and per intensity bin), and every particle reads
its weight from the cell it falls into.  Cost drops from O(N · patch²)
to O(G² · patch² + N), at the price of a quantized likelihood.

The lattice is evaluated by the same patch likelihood as exact SIR: one
B3 launch a frame on the card (``kernels.ops.patch_log_likelihood``),
for every member of a bank at once, against each member's frame, with
the lattice's rows shared by every member (a stride-0 view, no copy).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.filters import resolve_device
from repro_torch.core.smc import StateSpaceModel
from repro_torch.kernels import ops
from repro_torch.models.tracking import TrackingConfig, _likelihood_kwargs


@dataclasses.dataclass(frozen=True)
class ASIRConfig:
    """The piecewise-constant likelihood lattice (paper §VI.F): ``grid``
    cells an axis, ``intensity_bins`` bins of ``I_0`` over ``[0,
    i_max)``."""

    grid: int = 64
    intensity_bins: int = 4
    i_max: float = 4.0


def lattice_states(cfg: TrackingConfig, asir: ASIRConfig,
                   device) -> torch.Tensor:
    """``(G·G·bins, 5)`` cell-centre states (y, x, 0, 0, I_0), row-major
    over (cell y, cell x, intensity bin)."""
    h, w = cfg.img_size
    g, nb = asir.grid, asir.intensity_bins
    f32 = torch.float32
    ys = (torch.arange(g, dtype=f32, device=device) + 0.5) * (h / g)
    xs = (torch.arange(g, dtype=f32, device=device) + 0.5) * (w / g)
    ii = (torch.arange(nb, dtype=f32, device=device) + 0.5) * (
        asir.i_max / nb)
    yy, xx, bb = torch.meshgrid(ys, xs, ii, indexing="ij")
    zero = torch.zeros_like(yy)
    return torch.stack([yy, xx, zero, zero, bb], -1).reshape(-1, 5)


def make_asir_model(base, cfg: TrackingConfig, asir: ASIRConfig,
                    device=None) -> StateSpaceModel:
    """Wrap a tracking model (the ``(y, x, v_y, v_x, I_0)`` state layout)
    with the piecewise-constant likelihood: ``base``'s init and dynamics,
    the lattice's likelihood.  The lattice is built here, once, on
    ``device`` (the CUDA device unless given ``device="cpu"``).

    The wrapped model carries no domain-decomposition hooks, whatever
    ``base`` has: the lattice is evaluated against the full frame and has
    no tile-local form, so ``ParallelParticleFilter(domain=...)`` raises
    the step's missing-hooks error instead of reweighting with the exact
    tile likelihood."""
    h, w = cfg.img_size
    g, nb = asir.grid, asir.intensity_bins
    cell_y, cell_x, bin_i = h / g, w / g, asir.i_max / nb
    grid = lattice_states(cfg, asir, resolve_device(device))
    kw = _likelihood_kwargs(cfg)

    def log_likelihood(state: torch.Tensor,
                       frame: torch.Tensor) -> torch.Tensor:
        # one table a frame (each member's, in one launch), read by cell
        lead = frame.shape[:-2]
        table = ops.patch_log_likelihood(grid.expand(lead + grid.shape),
                                         frame, **kw)
        # the reference's astype(int32): truncation toward zero
        iy = (state[..., 0] / cell_y).to(torch.int32).clamp(0, g - 1)
        ix = (state[..., 1] / cell_x).to(torch.int32).clamp(0, g - 1)
        ib = (state[..., 4] / bin_i).to(torch.int32).clamp(0, nb - 1)
        cell = ((iy * g + ix) * nb + ib).long()
        return table.expand(cell.shape[:-1] + table.shape[-1:]).gather(
            -1, cell)

    return StateSpaceModel(init_sampler=base.init,
                           dynamics_sample=base.transition_sample,
                           log_likelihood=log_likelihood,
                           state_dim=base.state_dim)
