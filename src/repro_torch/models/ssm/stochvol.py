"""Stochastic-volatility SSM, the canonical nonlinear PF benchmark (port
of ``repro.models.ssm.stochvol``).

    x_k = μ + φ (x_{k-1} − μ) + σ w_k,   w_k ~ N(0, 1)
    z_k = exp(x_k / 2) v_k,              v_k ~ N(0, 1)
    x_0 ~ N(μ, σ² / (1 − φ²))            (the stationary law)

No closed-form posterior exists: the family exercises the model-agnostic
SIR path with a likelihood that shares no code with the tracking
application.  State is ``(..., n, 1)``, an observation one return per
member (``(...)``); draws come from a provider
(``repro_torch.core.draws``) in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class StochasticVolatilitySSM:
    """SV model with latent mean ``mu``, persistence ``phi`` (|φ| < 1)
    and vol-of-vol ``sigma``."""

    mu: float = -1.0
    phi: float = 0.97
    sigma: float = 0.3

    def __post_init__(self):
        if not abs(self.phi) < 1.0:
            raise ValueError(f"phi must satisfy |phi| < 1 for a "
                             f"stationary latent, got {self.phi}")

    @property
    def state_dim(self) -> int:
        """Latent dimension (the scalar log-volatility)."""
        return 1

    @property
    def stationary_std(self) -> float:
        """Standard deviation of the stationary latent law."""
        return self.sigma / math.sqrt(1.0 - self.phi ** 2)

    def init(self, draws, n: int) -> torch.Tensor:
        """``(..., n, 1)`` log-volatilities from the stationary law (one
        ``normal (n, 1)`` draw)."""
        return self.mu + self.stationary_std * draws.normal((n, 1))

    def transition_sample(self, draws, state: torch.Tensor) -> torch.Tensor:
        """Mean-reverting AR(1) step on the log-volatility (one ``normal``
        draw of a member's state shape)."""
        eps = draws.normal(state.shape[-2:])
        return self.mu + self.phi * (state - self.mu) + self.sigma * eps

    def observation_log_prob(self, state: torch.Tensor,
                             observation: torch.Tensor) -> torch.Tensor:
        """``(..., n)`` log N(z; 0, exp(x)), heteroskedastic Gaussian."""
        x = state[..., 0]
        z = torch.as_tensor(observation, dtype=x.dtype, device=x.device)
        return -0.5 * (_LOG_2PI + x + torch.square(z[..., None])
                       * torch.exp(-x))

    def transition_log_prob(self, prev: torch.Tensor,
                            new: torch.Tensor) -> torch.Tensor:
        """``(..., n)`` exact Gaussian transition density."""
        resid = (new - self.mu - self.phi * (prev - self.mu))[..., 0]
        return (-0.5 * torch.square(resid / self.sigma)
                - 0.5 * _LOG_2PI - math.log(self.sigma))

    def observation_sample(self, draws, state: torch.Tensor) -> torch.Tensor:
        """Per-particle ``(..., n)`` return draws ``z ~ N(0, exp(x))`` (one
        ``normal (n,)`` draw)."""
        v = draws.normal(state.shape[-2:-1])
        return torch.exp(0.5 * state[..., 0]) * v
