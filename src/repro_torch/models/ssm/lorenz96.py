"""Lorenz-96 SSM, a chaotic stress model of any dimension (port of
``repro.models.ssm.lorenz96``).

``D`` coupled variables on a ring,

    dx_i/dt = (x_{i+1} − x_{i−2}) x_{i−1} − x_i + F,

integrated with one classical RK4 step of length ``dt`` a frame, plus
additive Gaussian process noise; every ``obs_stride``-th coordinate is
observed with Gaussian noise.  State is ``(..., n, dim)``, an
observation ``(..., ceil(dim / obs_stride))`` per member; draws come
from a provider (``repro_torch.core.draws``) in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Lorenz96SSM:
    """Lorenz-96 with an RK4 flow and additive process noise ``sigma_x``;
    ``sigma_obs`` is the observation-noise std and ``obs_stride``
    observes coordinates ``0, s, 2s, …``."""

    dim: int = 8
    forcing: float = 8.0
    dt: float = 0.05
    sigma_x: float = 0.2
    sigma_obs: float = 1.0
    obs_stride: int = 2
    init_spread: float = 3.0    # prior std around the resting point F

    def __post_init__(self):
        if self.dim < 4:
            raise ValueError(f"Lorenz-96 needs dim >= 4, got {self.dim}")
        if not 1 <= self.obs_stride <= self.dim:
            raise ValueError(f"obs_stride must be in [1, dim], "
                             f"got {self.obs_stride}")

    @property
    def state_dim(self) -> int:
        """Number of ring variables ``D``."""
        return self.dim

    @property
    def obs_dim(self) -> int:
        """Number of observed coordinates."""
        return -(-self.dim // self.obs_stride)

    def drift(self, state: torch.Tensor) -> torch.Tensor:
        """The Lorenz-96 vector field, batched over particles."""
        xp1 = torch.roll(state, -1, dims=-1)
        xm1 = torch.roll(state, 1, dims=-1)
        xm2 = torch.roll(state, 2, dims=-1)
        return (xp1 - xm2) * xm1 - state + self.forcing

    def flow(self, state: torch.Tensor) -> torch.Tensor:
        """One deterministic RK4 step of length ``dt``."""
        f, h = self.drift, self.dt
        k1 = f(state)
        k2 = f(state + 0.5 * h * k1)
        k3 = f(state + 0.5 * h * k2)
        k4 = f(state + h * k3)
        return state + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def init(self, draws, n: int) -> torch.Tensor:
        """``(..., n, dim)`` Gaussian cloud around the resting point
        ``x ≡ F`` (one ``normal (n, dim)`` draw)."""
        return self.forcing + self.init_spread * draws.normal((n, self.dim))

    def transition_sample(self, draws, state: torch.Tensor) -> torch.Tensor:
        """RK4 flow + additive ``N(0, sigma_x²)`` process noise."""
        eps = draws.normal(state.shape[-2:])
        return self.flow(state) + self.sigma_x * eps

    def observation_log_prob(self, state: torch.Tensor,
                             observation: torch.Tensor) -> torch.Tensor:
        """``(..., n)`` Gaussian log-density of the strided observation."""
        z = torch.as_tensor(observation, dtype=state.dtype,
                            device=state.device)
        resid = z[..., None, :] - state[..., ::self.obs_stride]
        return torch.sum(
            -0.5 * torch.square(resid / self.sigma_obs)
            - 0.5 * _LOG_2PI - math.log(self.sigma_obs), dim=-1)

    def transition_log_prob(self, prev: torch.Tensor,
                            new: torch.Tensor) -> torch.Tensor:
        """``(..., n)`` exact Gaussian density around the RK4 image."""
        resid = new - self.flow(prev)
        return torch.sum(
            -0.5 * torch.square(resid / self.sigma_x)
            - 0.5 * _LOG_2PI - math.log(self.sigma_x), dim=-1)

    def observation_sample(self, draws, state: torch.Tensor) -> torch.Tensor:
        """Per-particle ``(..., n, obs_dim)`` noisy strided observations."""
        obs = state[..., ::self.obs_stride]
        return obs + self.sigma_obs * draws.normal(obs.shape[-2:])
