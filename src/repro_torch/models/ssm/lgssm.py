"""Linear-Gaussian state-space models and their Kalman oracle (port of
``repro.models.ssm.lgssm``).

    x_k = A x_{k-1} + w_k,   w_k ~ N(0, Q)
    z_k = H x_k     + v_k,   v_k ~ N(0, R)
    x_0 ~ N(m0, P0)

``LinearGaussianSSM`` runs in float32 torch like the rest of the particle
stack.  ``kalman_filter`` and ``kalman_smoother`` (its RTS backward pass)
are the package's own copies of the reference's float64 NumPy oracle —
independent of the torch numerics under test.
Timing convention: predict-then-update from ``(m0, P0)`` on every step,
matching the SIR step (advance, then reweight).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _gaussian_log_prob(resid: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """``(..., n)`` log N(resid; 0, chol cholᵀ) for ``(..., n, d)``
    residuals, by one triangular solve."""
    d = resid.shape[-1]
    sol = torch.linalg.solve_triangular(chol, resid.transpose(-1, -2),
                                        upper=False)
    log_det = torch.log(torch.diagonal(chol)).sum()
    return -0.5 * ((sol * sol).sum(-2) + d * _LOG_2PI) - log_det


@dataclasses.dataclass(frozen=True)
class LinearGaussianSSM:
    """A linear-Gaussian SSM (build one with ``make_lgssm``).  Matrices
    are float32 tensors; each method moves them to the state's device."""

    transition_matrix: torch.Tensor      # A  (dx, dx)
    observation_matrix: torch.Tensor     # H  (dz, dx)
    init_mean: torch.Tensor              # m0 (dx,)
    transition_chol: torch.Tensor        # chol(Q) lower
    observation_chol: torch.Tensor       # chol(R) lower
    init_chol: torch.Tensor              # chol(P0) lower

    @property
    def state_dim(self) -> int:
        """Latent dimension ``dx``."""
        return self.transition_matrix.shape[0]

    @property
    def obs_dim(self) -> int:
        """Observation dimension ``dz``."""
        return self.observation_matrix.shape[0]

    def init(self, draws, n: int) -> torch.Tensor:
        """Draw ``(..., n, dx)`` particles from ``N(m0, P0)``."""
        eps = draws.normal((n, self.state_dim))
        dev = eps.device
        return self.init_mean.to(dev) + eps @ self.init_chol.to(dev).T

    def transition_sample(self, draws, state: torch.Tensor) -> torch.Tensor:
        """``A x + chol(Q) ε`` for every particle."""
        eps = draws.normal(state.shape[-2:])
        dev = state.device
        return (state @ self.transition_matrix.to(dev).T
                + eps @ self.transition_chol.to(dev).T)

    def observation_log_prob(self, state: torch.Tensor,
                             observation: torch.Tensor) -> torch.Tensor:
        """``(..., n)`` exact Gaussian log-density of one observation
        (``(..., dz)``, one per leading index)."""
        dev = state.device
        obs = torch.as_tensor(observation, dtype=torch.float32, device=dev)
        obs = obs.reshape(obs.shape[:state.dim() - 2] + (1, self.obs_dim))
        resid = obs - state @ self.observation_matrix.to(dev).T
        return _gaussian_log_prob(resid, self.observation_chol.to(dev))

    def observation_sample(self, draws, state: torch.Tensor) -> torch.Tensor:
        """Per-particle ``(..., n, dz)`` draws of ``z ~ N(Hx, R)``."""
        eps = draws.normal((state.shape[-2], self.obs_dim))
        dev = state.device
        return (state @ self.observation_matrix.to(dev).T
                + eps @ self.observation_chol.to(dev).T)


def make_lgssm(a, q, h, r, m0=None, p0=None) -> LinearGaussianSSM:
    """Build a ``LinearGaussianSSM`` from ``(A, Q, H, R, m0, P0)``;
    scalars and vectors are promoted, ``m0`` defaults to 0 and ``P0`` to
    ``Q``.  Cholesky factors are taken in float64, stored as float32."""
    a = np.atleast_2d(np.asarray(a, np.float64))
    h = np.atleast_2d(np.asarray(h, np.float64))
    dx, dz = a.shape[0], h.shape[0]
    q = _as_cov(q, dx, "Q")
    r = _as_cov(r, dz, "R")
    m0 = np.zeros(dx) if m0 is None else np.asarray(m0, np.float64).reshape(dx)
    p0 = q if p0 is None else _as_cov(p0, dx, "P0")

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    return LinearGaussianSSM(
        transition_matrix=f32(a), observation_matrix=f32(h), init_mean=f32(m0),
        transition_chol=f32(np.linalg.cholesky(q)),
        observation_chol=f32(np.linalg.cholesky(r)),
        init_chol=f32(np.linalg.cholesky(p0)))


def _as_cov(x, d: int, name: str) -> np.ndarray:
    """Promote a scalar / diagonal / full input to a (d, d) matrix."""
    x = np.asarray(x, np.float64)
    if x.ndim == 0:
        x = np.eye(d) * x
    elif x.ndim == 1:
        x = np.diag(x)
    if x.shape != (d, d):
        raise ValueError(f"{name} must be scalar, ({d},) or ({d},{d}); "
                         f"got shape {x.shape}")
    return x


class KalmanResult(NamedTuple):
    """Exact filtering (or smoothing) moments and, for the filter, the
    per-step log-marginal increments (zeros for the smoother)."""

    means: np.ndarray          # (T, dx)
    covs: np.ndarray           # (T, dx, dx)
    log_marginals: np.ndarray  # (T,)


def _np(t) -> np.ndarray:
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t,
                      np.float64)


def kalman_filter(model: LinearGaussianSSM, observations) -> KalmanResult:
    """Exact ``p(x_k | z_{0..k})`` for every step, in float64 NumPy, with
    the log-marginal increments ``log p(z_k | z_{<k})``."""
    a = _np(model.transition_matrix)
    h = _np(model.observation_matrix)
    lq = _np(model.transition_chol)
    lr = _np(model.observation_chol)
    q, r = lq @ lq.T, lr @ lr.T
    m = _np(model.init_mean)
    lp0 = _np(model.init_chol)
    p = lp0 @ lp0.T
    obs = _np(observations)
    zs = np.atleast_2d(obs.reshape(len(obs), -1))
    means, covs, logz = [], [], []
    for z in zs:
        m = a @ m
        p = a @ p @ a.T + q
        s = h @ p @ h.T + r
        resid = z - h @ m
        sol = np.linalg.solve(s, resid)
        logz.append(-0.5 * (resid @ sol + len(z) * _LOG_2PI
                            + np.linalg.slogdet(s)[1]))
        k = p @ h.T @ np.linalg.inv(s)
        m = m + k @ resid
        ikh = np.eye(len(m)) - k @ h
        p = ikh @ p @ ikh.T + k @ r @ k.T
        means.append(m)
        covs.append(p)
    return KalmanResult(np.asarray(means), np.asarray(covs),
                        np.asarray(logz))


def kalman_smoother(model: LinearGaussianSSM, observations) -> KalmanResult:
    """Exact smoothing ``p(x_k | z_{0..T-1})`` (the RTS backward pass over
    ``kalman_filter``'s output, float64 NumPy); ``log_marginals`` are
    zeros."""
    a = _np(model.transition_matrix)
    lq = _np(model.transition_chol)
    q = lq @ lq.T
    filt = kalman_filter(model, observations)
    t = len(filt.means)
    means, covs = list(filt.means), list(filt.covs)
    for k in range(t - 2, -1, -1):
        m_pred = a @ filt.means[k]
        p_pred = a @ filt.covs[k] @ a.T + q
        g = filt.covs[k] @ a.T @ np.linalg.inv(p_pred)
        means[k] = filt.means[k] + g @ (means[k + 1] - m_pred)
        covs[k] = filt.covs[k] + g @ (covs[k + 1] - p_pred) @ g.T
    return KalmanResult(np.asarray(means), np.asarray(covs), np.zeros(t))


def oracle_configs() -> dict[str, LinearGaussianSSM]:
    """The three seeded linear-Gaussian configs of the statistical
    gates: scalar AR(1), 2-D constant velocity observed in position, and
    a damped spiral observed in one coordinate."""
    theta = 0.4
    rot = 0.97 * np.array([[np.cos(theta), -np.sin(theta)],
                           [np.sin(theta), np.cos(theta)]])
    return {
        "ar1": make_lgssm(0.9, 0.5, 1.0, 0.4, p0=4.0),
        "cv2d": make_lgssm(
            np.block([[np.eye(2), np.eye(2)], [np.zeros((2, 2)), np.eye(2)]]),
            np.diag([0.02, 0.02, 0.05, 0.05]),
            np.concatenate([np.eye(2), np.zeros((2, 2))], axis=1),
            0.25, p0=np.diag([1.0, 1.0, 0.5, 0.5])),
        "spiral": make_lgssm(rot, 0.05, np.array([[1.0, 0.0]]), 0.3,
                             p0=1.0),
    }
