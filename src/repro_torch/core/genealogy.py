"""Ancestral genealogy, the lineage part (port of
``repro.core.genealogy``): trajectory reconstruction from a run's
recorded ancestors.

A SIR run with ``SIRConfig(record_ancestry=True)`` emits, per frame
``t``, ``ancestors[t]`` ``(N,)`` (post-step slot ``j`` was copied from
pre-resample particle ``ancestors[t][j]``; the identity where the ESS
trigger did not fire) and ``diag["emission"][t]``, the emissions indexed
by the same pre-resample slots.  Everything here is index algebra on
those stacks.  ``ancestral_lineage`` walks the final *post*-resample
slots back, which is what an in-state history buffer gathered at every
resample holds: ``reconstruct_trajectories`` is the oracle that SMC
decoding's sequences are root-to-leaf paths.  ``smoothing_lineage``
walks the final *pre*-resample particles back, the pairing the
filter-smoother needs: ``filter_smoother_mean`` weights every surviving
path by its terminal filtering weight (Kitagawa's smoother by
genealogy), and ``fixed_lag_smoother_mean`` walks each frame's paths
back only from ``lag`` frames later, against path degeneracy.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.particles import invariant_logsumexp, tree_map


def _walk_back(ancestors: torch.Tensor,
               rows_last: torch.Tensor) -> torch.Tensor:
    """``(T, N)`` rows with ``rows[T-1] = ancestors[T-1][rows_last]`` and
    ``rows[t] = ancestors[t][rows[t+1]]``."""
    idx = rows_last.long()
    rows = []
    for t in range(ancestors.shape[0] - 1, -1, -1):
        idx = ancestors[t].long()[idx]
        rows.append(idx)
    return torch.stack(rows[::-1]).to(ancestors.dtype)


def ancestral_lineage(ancestors: torch.Tensor) -> torch.Tensor:
    """Lineage rows of the final post-resample slots: ``rows[t][j]`` is
    the pre-resample index at frame ``t`` of the trajectory that
    survives in slot ``j``.  ``ancestors`` is ``(T, N)``."""
    n = ancestors.shape[1]
    return _walk_back(ancestors, torch.arange(n, device=ancestors.device))


def smoothing_lineage(ancestors: torch.Tensor) -> torch.Tensor:
    """Lineage rows of the final pre-resample particles: ``rows[T-1]`` is
    the identity and ``rows[t] = ancestors[t][rows[t+1]]`` below it."""
    t_steps, n = ancestors.shape
    ident = torch.arange(n, dtype=ancestors.dtype, device=ancestors.device)
    if t_steps == 1:
        return ident[None]
    rows = _walk_back(ancestors[:-1], ident)
    return torch.cat([rows, ident[None]], dim=0)


def reconstruct_trajectories(ancestors: torch.Tensor, emissions: Any) -> Any:
    """The surviving root-to-leaf trajectories: for ``(T, N)``
    ``ancestors`` and emissions with ``(T, N, ...)`` leaves, leaves of
    ``(N, T, ...)`` whose ``[j, t]`` is the frame-``t`` emission of the
    trajectory in final slot ``j``."""
    rows = ancestral_lineage(ancestors).long()

    def gather(e):
        picked = torch.stack([e[t][rows[t]] for t in range(e.shape[0])])
        return picked.transpose(0, 1)

    return tree_map(gather, emissions)


def _softmax(log_weights: torch.Tensor) -> torch.Tensor:
    return torch.exp(log_weights - invariant_logsumexp(log_weights, -1))


def _path_mean(rows: torch.Tensor, emissions: Any,
               log_weights: torch.Tensor) -> Any:
    """Weighted mean over lineage paths: ``Σ_i w_i · e[t][rows[t][i]]``
    per frame, with ``w = softmax(log_weights)``."""
    n = rows.shape[1]
    w = _softmax(log_weights)
    idx = rows.long()

    def mean(e):
        g = torch.stack([e[t][idx[t]] for t in range(e.shape[0])])
        wx = w.reshape((1, n) + (1,) * (g.dim() - 2)).to(g.dtype)
        return (wx * g).sum(1)

    return tree_map(mean, emissions)


def filter_smoother_mean(ancestors: torch.Tensor, emissions: Any,
                         last_log_weights: torch.Tensor) -> Any:
    """Genealogy filter-smoother: ``E[x_t | z_{1:T}]`` for every ``t``.

    Path ``i`` follows ``smoothing_lineage`` back from pre-resample
    particle ``i`` at the last frame, weighted by
    ``softmax(last_log_weights)[i]``.  Exact as N → ∞; at finite N early
    frames degrade with path degeneracy.  ``ancestors`` is ``(T, N)``,
    ``emissions`` has ``(T, N, ...)`` leaves
    (``FilterResult.diag["emission"]``) and ``last_log_weights`` is the
    final frame's ``(N,)`` normalized log-weights
    (``diag["log_weights"][-1]``); the result has ``(T, ...)`` leaves."""
    return _path_mean(smoothing_lineage(ancestors), emissions,
                      last_log_weights)


def fixed_lag_smoother_mean(ancestors: torch.Tensor, emissions: Any,
                            log_weights: torch.Tensor, lag: int) -> Any:
    """Fixed-lag smoothing: ``E[x_t | z_{1:min(t+lag, T)}]`` per frame.

    Frame ``t``'s paths are walked back from frame ``s = min(t + lag,
    T-1)`` and weighted by frame ``s``'s filtering weights (``(T, N)``
    ``log_weights``, ``diag["log_weights"]``).  ``lag=0`` gives the
    filtering means, ``lag >= T-1`` ``filter_smoother_mean``."""
    if lag < 0:
        raise ValueError(f"lag must be non-negative, got {lag}")
    t_steps, n = ancestors.shape
    anc = ancestors.long()
    per_frame = []
    for t in range(t_steps):
        s = min(t + lag, t_steps - 1)
        idx = torch.arange(n, device=ancestors.device)
        # pre-resample particles at frame u descend through ancestors[u-1]
        for u in range(s, t, -1):
            idx = anc[u - 1][idx]
        w = _softmax(log_weights[s])

        def mean(e, idx=idx, w=w):
            g = e[t][idx]
            wx = w.reshape((n,) + (1,) * (g.dim() - 1)).to(g.dtype)
            return (wx * g).sum(0)

        per_frame.append(tree_map(mean, emissions))
    return tree_map(lambda *xs: torch.stack(xs), *per_frame)
