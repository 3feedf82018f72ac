"""Particle ensembles and weight algebra (port of ``repro.core.particles``).

A ``ParticleEnsemble`` holds ``state`` ``(..., N, *S)``, ``log_weights``
``(..., N)`` and ``counts`` ``(..., N)``.  The leading dims ``...`` are
empty for one filter and ``(B,)`` for a ``FilterBank`` — the bank dim is
written out where the reference ``vmap``s.  Every function here reduces
over the particle axis (the last axis of ``log_weights``) and broadcasts
over the leading dims.  The state is one tensor or, as in the reference,
a pytree of tensors (nested dicts, lists and tuples; ``tree_map``) whose
leaves all lead with the ensemble's dims — the LM decode state holds its
KV caches, tokens and positions that way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.kernels import ops


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over matching pytrees (dicts, lists and plain
    tuples; any other object is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class ParticleEnsemble:
    """A weighted particle ensemble with static capacity.

    Attributes:
      state: ``(..., N, *S)`` particle states.
      log_weights: ``(..., N)`` unnormalized log-weights; empty slots
        carry ``-inf``.
      counts: ``(..., N)`` int32 multiplicities (``1`` on every live slot
        of a materialized ensemble).
    """

    state: torch.Tensor
    log_weights: torch.Tensor
    counts: torch.Tensor

    @property
    def capacity(self) -> int:
        """Static slot count ``N``."""
        return self.log_weights.shape[-1]

    def replace(self, **kw) -> "ParticleEnsemble":
        """Functional field update (``dataclasses.replace`` shorthand)."""
        return dataclasses.replace(self, **kw)


def init_ensemble(draws, sampler: Callable, n: int, *,
                  log_weight: float | None = None) -> ParticleEnsemble:
    """Draw ``n`` particles from ``sampler(draws, n)``, uniformly weighted
    (``-log n`` by default, rounded once to float32)."""
    state = sampler(draws, n)
    if log_weight is None:
        log_weight = -math.log(n)
    lead = tuple(draws.batch_shape) + (n,)
    leaves = []
    tree_map(leaves.append, state)
    dev = leaves[0].device        # a pytree state's first leaf
    return ParticleEnsemble(
        state=state,
        log_weights=torch.full(lead, log_weight, dtype=torch.float32,
                               device=dev),
        counts=torch.ones(lead, dtype=torch.int32, device=dev))


def _per_particle(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View ``(..., N)`` weights against ``(..., N, *S)`` state."""
    return w.reshape(w.shape + (1,) * (x.dim() - w.dim()))


# ---------------------------------------------------------------------------
# Weight algebra (counts-aware)
# ---------------------------------------------------------------------------

def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x``'s sums take the row-sum kernel (a CUDA tensor)."""
    return x.device.type == "cuda"


def _row_sum(x: torch.Tensor, dim: int, keepdim: bool,
             shift: torch.Tensor | None = None) -> torch.Tensor:
    """``ops.row_sum`` over ``dim`` of ``x`` viewed as ``(outer, n,
    inner)``; ``shift`` is shaped like the sum with ``keepdim``."""
    lead, n, tail = x.shape[:dim], x.shape[dim], x.shape[dim + 1:]
    outer, inner = math.prod(lead), math.prod(tail)
    out = ops.row_sum(x.reshape(outer, n, inner),
                      None if shift is None else shift.reshape(outer, inner))
    return out.reshape(lead + (1,) + tail if keepdim else lead + tail)


def invariant_sum(x: torch.Tensor, dim: int = -1,
                  keepdim: bool = False) -> torch.Tensor:
    """Float sum over ``dim`` whose bits for one row do not depend on the
    member or shard dims in front of it, so a bank member sums exactly as
    the standalone filter does.  On the card every such sum, a lone row
    or a batched one, is one launch of the row-sum kernel
    (``ops.row_sum``), whose order of additions depends on the row's
    length alone (torch's own CUDA reduction of a long row splits it by
    the whole tensor's shape).  On the CPU it is torch's sum, which
    reduces each row by itself below its parallel grain (the sizes the
    CPU runs)."""
    dim %= max(x.dim(), 1)
    if not _on_card(x):
        return x.sum(dim, keepdim=keepdim)
    return _row_sum(x, dim, keepdim)


def invariant_logsumexp(x: torch.Tensor, dim: int = -1,
                        keepdim: bool = False) -> torch.Tensor:
    """``torch.logsumexp`` with ``invariant_sum``'s order on the card (the
    max is exact in any order; the kernel sums ``exp(x - max)`` in the
    same pass); torch's own on the CPU."""
    dim %= max(x.dim(), 1)
    if not _on_card(x):
        return torch.logsumexp(x, dim, keepdim=keepdim)
    m = x.amax(dim, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    out = torch.log(_row_sum(x, dim, True, shift=m)) + m
    return out if keepdim else out.squeeze(dim)


def effective_log_weights(log_weights: torch.Tensor,
                          counts: torch.Tensor | None) -> torch.Tensor:
    """Per-slot log-weight with multiplicity folded in (count 0 → -inf)."""
    if counts is None:
        return log_weights
    logc = torch.log(counts.clamp(min=1).to(log_weights.dtype))
    return log_weights + torch.where(counts > 0, logc,
                                     torch.full_like(logc, -math.inf))


def normalized_weights(log_weights: torch.Tensor,
                       counts: torch.Tensor | None = None) -> torch.Tensor:
    """Linear normalized weights; the all ``-inf`` corner gives uniform."""
    lw = effective_log_weights(log_weights, counts)
    m = lw.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lw - m)
    s = invariant_sum(w, -1, keepdim=True)
    return torch.where(s > 0, w / s, torch.ones_like(w) / w.shape[-1])


def log_sum_weights(log_weights: torch.Tensor,
                    counts: torch.Tensor | None = None) -> torch.Tensor:
    """``log Σ w`` over the particle axis."""
    return invariant_logsumexp(effective_log_weights(log_weights, counts),
                               -1)


def effective_sample_size(log_weights: torch.Tensor,
                          counts: torch.Tensor | None = None) -> torch.Tensor:
    """``N_eff = 1 / Σ w²`` (Alg. 1 line 15), weight-normalized."""
    w = normalized_weights(log_weights, counts)
    return 1.0 / invariant_sum(torch.square(w), -1)


def weighted_mean(ensemble: ParticleEnsemble) -> Any:
    """MMSE estimate ``Σ w·x`` over the particle axis, as an explicit
    multiply and sum (the reference's form), leafwise over a pytree
    state."""
    w = normalized_weights(ensemble.log_weights, ensemble.counts)
    axis = ensemble.log_weights.dim() - 1
    return tree_map(lambda x: invariant_sum(_per_particle(w.to(x.dtype), x)
                                            * x, axis), ensemble.state)


def logical_size(ensemble: ParticleEnsemble) -> torch.Tensor:
    """Number of logical (multiplicity-expanded) particles."""
    valid = torch.isfinite(ensemble.log_weights)
    return torch.where(valid, ensemble.counts,
                       torch.zeros_like(ensemble.counts)).sum(-1)


# ---------------------------------------------------------------------------
# The SIR verbs
# ---------------------------------------------------------------------------

def gather_particles(x: torch.Tensor, ancestors: torch.Tensor) -> torch.Tensor:
    """``x[..., ancestors[...], :]``: gather ``(..., N, *S)`` slots by
    ``(..., M)`` ancestor indices, batched over the leading dims."""
    lead = ancestors.shape[:-1]
    b = math.prod(lead)
    n = x.shape[len(lead)]
    feat = x.shape[len(lead) + 1:]
    xf = x.reshape((b, n) + feat)
    af = ancestors.reshape(b, -1).long()
    rows = torch.arange(b, device=x.device)[:, None]
    return xf[rows, af].reshape(lead + (ancestors.shape[-1],) + feat)


def advance(ensemble: ParticleEnsemble, draws,
            dynamics_sample: Callable) -> ParticleEnsemble:
    """Propagate every particle through the dynamics (proposal) kernel."""
    return ensemble.replace(state=dynamics_sample(draws, ensemble.state))


def permute(ensemble: ParticleEnsemble,
            order: torch.Tensor) -> ParticleEnsemble:
    """Reorder slots by ``order`` ``(..., C)``, a permutation of
    ``arange(C)`` per member: a pure relabeling (RNA's travel shuffle)."""
    idx = order.long()
    return ParticleEnsemble(
        state=gather_particles(ensemble.state, idx),
        log_weights=ensemble.log_weights.gather(-1, idx),
        counts=ensemble.counts.gather(-1, idx))


def resample_compressed(draws, ensemble: ParticleEnsemble, n_out, *,
                        scheme: str = "systematic",
                        capacity: int | None = None,
                        fill_log_weight=None) -> ParticleEnsemble:
    """Resample ``n_out`` offspring (an int or a per-member tensor) in
    compressed (counts) form (paper §V): the state is untouched, the
    counts are the offspring numbers, and every slot with offspring
    carries ``fill_log_weight`` (default ``-log n_out`` in float32),
    ``-inf`` elsewhere.  ``capacity`` sizes the comb (default ``C``)."""
    # function-level: resampling imports this module
    from repro_torch.core import resampling

    cap = capacity if capacity is not None else ensemble.capacity
    lw = ensemble.log_weights
    eff = effective_log_weights(lw, ensemble.counts)
    counts = resampling.RESAMPLERS[scheme](draws, eff, n_out, capacity=cap)
    if fill_log_weight is None:
        n = torch.as_tensor(n_out, dtype=torch.float32, device=lw.device)
        fill_log_weight = -torch.log(n.clamp(min=1.0))
    fill = torch.as_tensor(fill_log_weight, dtype=torch.float32,
                           device=lw.device)
    fill = fill.reshape(fill.shape + (1,) * (lw.dim() - fill.dim()))
    return ensemble.replace(log_weights=torch.where(
        counts > 0, fill, torch.full_like(lw, -math.inf)), counts=counts)


def materialize(ensemble: ParticleEnsemble,
                capacity: int | None = None) -> ParticleEnsemble:
    """Expand multiplicities into replicas (the deferred replica creation
    of paper §V.B): ``capacity`` slots (default ``C``), the slots past
    the logical size empty (``-inf``, count 0); a logical size above
    ``capacity`` is truncated."""
    from repro_torch.core import resampling

    cap = capacity if capacity is not None else ensemble.capacity
    lw = ensemble.log_weights
    counts = torch.where(torch.isfinite(lw), ensemble.counts,
                         torch.zeros_like(ensemble.counts)).to(torch.int32)
    total = counts.sum(-1, keepdim=True)
    anc = resampling.counts_to_ancestors(counts, cap).long()
    valid = torch.arange(cap, device=lw.device) < total
    return ParticleEnsemble(
        state=gather_particles(ensemble.state, anc),
        log_weights=torch.where(valid, lw.gather(-1, anc),
                                torch.full(valid.shape, -math.inf,
                                           device=lw.device)),
        counts=valid.to(torch.int32))


def reweight(ensemble: ParticleEnsemble,
             log_lik: torch.Tensor) -> ParticleEnsemble:
    """Multiply the likelihood into the weights (Alg. 1 line 9); a dead
    (``-inf``) slot stays dead."""
    lw = ensemble.log_weights
    return ensemble.replace(log_weights=torch.where(
        torch.isfinite(lw), lw + log_lik, torch.full_like(lw, -math.inf)))
