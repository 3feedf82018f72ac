"""The paper's §VII application: fluorescence-microscopy tracking with
near-constant-velocity dynamics and a Gaussian-PSF observation model
(port of ``repro.models.tracking``).

State ``(..., N, 5)`` = (y, x, v_y, v_x, I_0).  ``TrackingSSM``'s
likelihood goes through ``repro_torch.kernels.ops``: the Hopper patch
kernel on the card, the plain version on the CPU.  Its spatial hooks
(``positions``, ``tile_observation_log_prob``) let the distributed filter
decompose the input space (``repro_torch.core.domain``): the tile
likelihood of every shard's halo slab is one patch-kernel launch, each
slab with its own geometry.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.domain import DomainSpec
from repro_torch.kernels import ops, patch_likelihood, ref


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


def _tile_bounds(cfg: TrackingConfig, slab_shape: tuple[int, int],
                 origin: tuple[int, int]) -> tuple[int, ...]:
    """The ``(lo_y, hi_y, lo_x, hi_x, oy, ox)`` geometry of one halo slab:
    the centre clamp is the frame interior intersected with "the patch
    fits in the slab"."""
    oy, ox = (int(v) for v in origin)
    h, w = cfg.img_size
    r = cfg.patch_radius
    sh, sw = slab_shape
    return (max(r, oy + r), min(h - 1 - r, oy + sh - 1 - r),
            max(r, ox + r), min(w - 1 - r, ox + sw - 1 - r), oy, ox)


@functools.lru_cache(maxsize=64)
def tile_geometry(cfg: TrackingConfig, slab_shape: tuple[int, int],
                  origins: tuple, device: torch.device) -> torch.Tensor:
    """The ``(P, 6)`` geometry table of P slabs, checked once on the host
    and kept on ``device`` (a frame then costs no check and no sync)."""
    return patch_likelihood.member_geometry(
        [_tile_bounds(cfg, slab_shape, o) for o in origins],
        cfg.patch_radius, *slab_shape, device)


def tile_patch_log_likelihood(state: torch.Tensor, slab: torch.Tensor,
                              origin_yx, cfg: TrackingConfig
                              ) -> torch.Tensor:
    """Tile-local likelihood against halo slabs.

    ``slab`` is one ``(sh, sw)`` slab whose ``[0, 0]`` pixel sits at frame
    coordinates ``origin_yx`` (two ints, possibly negative at a frame
    edge) for ``(N, 5)`` particles, or a ``(P, sh, sw)`` slab stack with
    one origin per slab (a sequence of ``P`` pairs) for ``(P, M, 5)``
    particles: then every slab's geometry goes into one kernel launch.
    All float arithmetic stays in frame coordinates; the centre clamp is
    the frame interior intersected with "the patch fits in the slab".
    For a particle its slab's tile owns (``domain.owner_of``) the slab
    constraint is a no-op, and the value is the full frame's, bit for
    bit."""
    kw = _likelihood_kwargs(cfg)
    sh, sw = slab.shape[-2:]
    if slab.dim() == 2:
        geom = _tile_bounds(cfg, (sh, sw), origin_yx)
        return ops.patch_log_likelihood(state, slab, center_bounds=geom[:4],
                                        frame_origin=geom[4:], **kw)
    origins = tuple((int(oy), int(ox)) for oy, ox in origin_yx)
    if len(origins) != slab.shape[0]:
        raise ValueError(f"{len(origins)} origins for {slab.shape[0]} "
                         f"slabs")
    table = tile_geometry(cfg, (sh, sw), origins, state.device)
    return ops.patch_log_likelihood(state, slab, geometry=table, **kw)


def make_domain_spec(cfg: TrackingConfig, tiles: int, *,
                     k_cap: int | None = None) -> DomainSpec:
    """The domain decomposition of this imaging model: halo = patch
    radius, the squarest tile grid that divides the frame."""
    return DomainSpec.for_mesh(cfg.img_size, tiles, cfg.patch_radius,
                               k_cap=k_cap)


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

    def positions(self, state: torch.Tensor) -> torch.Tensor:
        """Frame-coordinate ``(y, x)`` of every particle (domain hook)."""
        return state[..., 0:2]

    def tile_observation_log_prob(self, state: torch.Tensor,
                                  slab: torch.Tensor,
                                  origin_yx) -> torch.Tensor:
        """Tile-local patch likelihood against halo slabs (domain hook;
        ``tile_patch_log_likelihood``)."""
        return tile_patch_log_likelihood(state, slab, origin_yx, self.cfg)
