"""The ``StateSpaceModel`` protocol (port of ``repro.models.ssm.base``).

Every filter in ``repro_torch.core`` is parameterized by any object with
the three required methods, batched over a leading particle axis and any
dims before it (a ``FilterBank`` passes a leading slot dim):

* ``init(draws, n)`` — the initial particle cloud;
* ``transition_sample(draws, state)`` — one bootstrap-proposal step;
* ``observation_log_prob(state, observation)`` — ``(..., n)``
  per-particle ``log p(z | x)``.

Randomness comes from a draws provider (``repro_torch.core.draws``)
where the reference takes a PRNG key.  The optional hooks
(``estimate_state``, ``emission``, ``gather_state``,
``observation_sample``, the spatial ``positions`` /
``tile_observation_log_prob`` pair) are discovered with ``getattr`` as in
the reference.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch


@runtime_checkable
class StateSpaceModel(Protocol):
    """Structural type of a particle-filterable model."""

    state_dim: int

    def init(self, draws, n: int) -> Any:
        """Draw ``n`` initial particles."""
        ...

    def transition_sample(self, draws, state: Any) -> Any:
        """Propagate every particle one step through the dynamics."""
        ...

    def observation_log_prob(self, state: Any, observation: Any) -> torch.Tensor:
        """Per-particle ``(..., n)`` log-likelihood of one observation."""
        ...


def domain_hooks(model: Any):
    """Resolve the optional spatial hooks: ``(positions,
    tile_observation_log_prob)`` or ``(None, None)``.  The legacy
    spelling ``tile_log_likelihood`` is accepted too."""
    pos = getattr(model, "positions", None)
    tile = getattr(model, "tile_observation_log_prob", None)
    if tile is None:
        tile = getattr(model, "tile_log_likelihood", None)
    if not (callable(pos) and callable(tile)):
        return None, None
    return pos, tile


def simulate(draws, model: Any, n_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one latent trajectory and its observations.

    Same timing as the SIR step (advance, then observe): a prior draw is
    transitioned before the first observation.  Draw order: the init
    draw, then per step the transition draw and the observation draw.
    Returns ``(states, observations)`` with leading time dim ``n_steps``.
    """
    if not callable(getattr(model, "observation_sample", None)):
        raise ValueError(f"{type(model).__name__} has no "
                         "observation_sample; cannot simulate")
    x = model.init(draws, 1)
    xs, zs = [], []
    for _ in range(n_steps):
        x = model.transition_sample(draws, x)
        z = model.observation_sample(draws, x)
        xs.append(x[0])
        zs.append(z[0])
    return torch.stack(xs), torch.stack(zs)
