"""The paper's §VII application: fluorescence-microscopy tracking with
near-constant-velocity dynamics and a Gaussian-PSF observation model
(port of ``repro.models.tracking``).

State ``(..., N, 5)`` = (y, x, v_y, v_x, I_0).  ``TrackingSSM``'s
likelihood goes through ``repro_torch.kernels.ops``: the Hopper patch
kernel on the card, the plain version on the CPU.  The tile/domain hooks
wait for ROADMAP A9.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Paper §VII.C defaults: 512×512 frames, σ_PSF = 1.16 px, SNR 2.
    Field for field the reference's config (see there for each knob)."""

    img_size: tuple[int, int] = (512, 512)
    sigma_psf: float = 1.16
    sigma_noise: float = 1.0
    sigma_like: float = 2.0
    i_peak: float = 2.0
    i_bg: float = 0.0
    likelihood_form: str = "matched"   # "matched" | "eq4"
    sigma_pos: float = 0.5
    sigma_vel: float = 0.5
    sigma_int: float = 0.05
    v_init: float = 2.0
    patch_radius: int = 4


def render_spot(yx: torch.Tensor, intensity, cfg: TrackingConfig,
                shape: tuple[int, int]) -> torch.Tensor:
    """Render one Gaussian-PSF spot into a full ``(H, W)`` frame."""
    h, w = shape
    yy = torch.arange(h, dtype=torch.float32, device=yx.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=yx.device)[None, :]
    d2 = (yy - yx[0]) ** 2 + (xx - yx[1]) ** 2
    return intensity * torch.exp(-d2 / (2.0 * cfg.sigma_psf ** 2))


def _likelihood_kwargs(cfg: TrackingConfig) -> dict:
    return dict(radius=cfg.patch_radius, sigma_psf=cfg.sigma_psf,
                sigma_like=cfg.sigma_like, i_bg=cfg.i_bg,
                matched=cfg.likelihood_form != "eq4")


def patch_log_likelihood(state: torch.Tensor, frame: torch.Tensor,
                         cfg: TrackingConfig, *, center_bounds=None,
                         frame_origin=None) -> torch.Tensor:
    """Plain torch patch log-likelihood (paper Eq. 4 or the matched
    form) of ``(..., N, 5)`` particles against ``(..., H, W)`` frames.
    ``center_bounds``/``frame_origin`` are the reference's geometry:
    frame coordinates throughout, only the gather offset."""
    return ref.patch_log_likelihood_ref(
        state[..., 0], state[..., 1], state[..., 4], frame,
        center_bounds=center_bounds, frame_origin=frame_origin,
        **_likelihood_kwargs(cfg))


@dataclasses.dataclass(frozen=True)
class TrackingSSM:
    """The tracking application as a ``StateSpaceModel``."""

    cfg: TrackingConfig

    @property
    def state_dim(self) -> int:
        """Length of the (y, x, v_y, v_x, I_0) state vector."""
        return 5

    def init(self, draws, n: int) -> torch.Tensor:
        """Uniform positions over the frame, Gaussian velocities and
        intensities: draws ``uniform (n, 2)``, ``normal (n, 2)``,
        ``normal (n, 1)`` in the reference's order."""
        cfg = self.cfg
        h, w = cfg.img_size
        u = draws.uniform((n, 2))
        pos = u * torch.tensor([h, w], dtype=torch.float32, device=u.device)
        vel = draws.normal((n, 2)) * cfg.v_init
        inten = torch.abs(cfg.i_peak + 0.5 * draws.normal((n, 1)))
        return torch.cat([pos, vel, inten], dim=-1)

    def transition_sample(self, draws, state: torch.Tensor) -> torch.Tensor:
        """Near-constant velocity: ``pos += vel + ε_p``; ``vel += ε_v``;
        one ``normal (n, 5)`` draw."""
        cfg = self.cfg
        h, w = cfg.img_size
        eps = draws.normal((state.shape[-2], 5))
        pos = state[..., 0:2] + state[..., 2:4] + cfg.sigma_pos * eps[..., 0:2]
        vel = state[..., 2:4] + cfg.sigma_vel * eps[..., 2:4]
        inten = torch.abs(state[..., 4:5] + cfg.sigma_int * eps[..., 4:5])
        pos = torch.minimum(pos.clamp(min=0.0), torch.tensor(
            [h - 1.0, w - 1.0], dtype=pos.dtype, device=pos.device))
        return torch.cat([pos, vel, inten], dim=-1)

    def observation_log_prob(self, state: torch.Tensor,
                             frame: torch.Tensor) -> torch.Tensor:
        """Per-particle patch likelihood against one frame per member —
        the Hopper kernel for CUDA tensors."""
        return ops.patch_log_likelihood(state, frame,
                                        **_likelihood_kwargs(self.cfg))
