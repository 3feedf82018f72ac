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
filter-smoother needs; the smoothers themselves wait for ROADMAP A10.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.particles import tree_map


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
