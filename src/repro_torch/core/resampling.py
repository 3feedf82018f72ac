"""Local resampling schemes (port of ``repro.core.resampling``).

The four comb/CDF schemes — systematic, stratified, multinomial and
residual — and the two collective-free chains — Metropolis and
rejection — as ``(..., n_in)`` multiplicities (``counts_to_ancestors``
expands them to indices), batched over leading dims.  Randomness comes
from a draws provider (``repro_torch.core.draws``) in the reference's
order: systematic takes one ``uniform(())``, stratified
``uniform((capacity,))``, multinomial ``exponential((capacity + 1,))``,
and the chains ``resampling_draws``: ``randint((lanes, iters))`` then
``uniform((lanes, iters))``.

The float scans of the comb schemes (their CDFs and the multinomial
comb's exponential spacings) and the chains' ``*_from_draws`` functions
go through ``repro_torch.kernels.ops``: a CUDA tensor launches the Hopper
kernel (``csrc/comb_scan.cu``, ``csrc/resample.cu``), a CPU tensor runs
the plain version (``torch.cumsum``; ``repro_torch.kernels.resample``).
"""
from __future__ import annotations

import torch

from repro_torch.core.particles import invariant_sum, normalized_weights
from repro_torch.kernels import ops
from repro_torch.kernels.resample import \
    dead_slot_guard as _dead_slot_guard  # noqa: F401  (the reference's name)

COLLECTIVE_FREE = ("metropolis", "rejection")
# draw budget per lane (chain length / tries), as in the reference: the
# (lanes, 32) proposal and log-u tables are the memory knob
METROPOLIS_ITERS = 32
REJECTION_TRIES = 32


def _lead_vector(v, lead_dims: int, device) -> torch.Tensor:
    """A scalar or per-member value as a ``(..., 1)`` tensor."""
    v = torch.as_tensor(v, device=device)
    return v.reshape(v.shape + (1,) * (lead_dims + 1 - v.dim()))


# ---------------------------------------------------------------------------
# Representation conversions
# ---------------------------------------------------------------------------

def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumsum of integer ``x`` along its last dim, as one
    scan of the flattened rows minus each row's start: exact for
    integers, and on the card one device-wide scan instead of torch's
    one block per row (a few rows of millions of slots take ms there)."""
    flat = torch.cumsum(x.reshape(-1).to(torch.int64), 0).reshape(x.shape)
    if x.dim() < 2 or x.shape[-1] == 0:
        return flat
    ends = flat[..., -1:]
    start = torch.cat([torch.zeros_like(ends.reshape(-1)[:1]),
                       ends.reshape(-1)[:-1]]).reshape(ends.shape)
    return flat - start


def counts_to_ancestors(counts: torch.Tensor, n_out: int) -> torch.Tensor:
    """Expand ``(..., n_in)`` multiplicities to ``(..., n_out)`` ancestor
    indices — ``jnp.repeat(arange, counts, total_repeat_length=n_out)``
    written as a search, so it batches: a short total is padded with the
    last index ``n_in - 1``, a long one truncated."""
    n_in = counts.shape[-1]
    cum = row_cumsum(counts)
    slots = torch.arange(n_out, device=counts.device, dtype=cum.dtype)
    slots = slots.expand(counts.shape[:-1] + (n_out,)).contiguous()
    anc = torch.searchsorted(cum.contiguous(), slots, right=True)
    return anc.clamp(max=n_in - 1).to(torch.int32)


def ancestors_to_counts(ancestors: torch.Tensor, n_in: int) -> torch.Tensor:
    """Histogram ``(..., n_out)`` ancestor indices back to multiplicities."""
    counts = torch.zeros(ancestors.shape[:-1] + (n_in,), dtype=torch.int32,
                         device=ancestors.device)
    return counts.scatter_add_(-1, ancestors.long(),
                               torch.ones_like(ancestors, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Comb-based schemes
# ---------------------------------------------------------------------------

def _spread(valid: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` where ``valid``, else the lane's own slot ``lane % n``: the
    dropped lanes add 0, and spread over the slots they do not queue on
    one address in the CUDA scatter (RPA's comb drops half its lanes)."""
    lanes = torch.arange(idx.shape[-1], device=idx.device) % n
    return torch.where(valid, idx, lanes.expand(idx.shape))


def _searchsorted_counts(cdf: torch.Tensor, pts: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Counts of comb points per CDF bin; invalid points are dropped."""
    n = cdf.shape[-1]
    pts = torch.where(valid, pts, torch.full_like(pts, 2.0))
    anc = torch.searchsorted(cdf.contiguous(), pts.contiguous(), right=True)
    idx = _spread(valid, anc.clamp(0, n - 1), n)
    counts = torch.zeros(cdf.shape, dtype=torch.int32, device=cdf.device)
    return counts.scatter_add_(-1, idx, valid.to(torch.int32))


def _comb_counts(weights: torch.Tensor, u: torch.Tensor, n_out,
                 capacity: int) -> torch.Tensor:
    """Offspring counts for a comb of ``n_out`` points with offsets ``u``
    (one per member for systematic, ``(..., capacity)`` for stratified);
    ``n_out`` may be a per-member tensor ``≤ capacity``."""
    lead = weights.dim() - 1
    w = weights / invariant_sum(weights, -1, keepdim=True).clamp(min=1e-38)
    cdf = ops.prefix_sum(w)
    if u.dim() == lead:
        u = u[..., None]
    n_out_t = _lead_vector(n_out, lead, weights.device)
    lanes = torch.arange(capacity, device=weights.device)
    pts = (lanes.to(torch.float32) + u) / n_out_t.to(torch.float32).clamp(
        min=1.0)
    valid = (lanes < n_out_t).expand(pts.shape)
    return _searchsorted_counts(cdf, pts.expand(
        weights.shape[:-1] + (capacity,)), valid)


def systematic_counts(draws, log_weights: torch.Tensor, n_out,
                      capacity: int | None = None) -> torch.Tensor:
    """Systematic resampling — a single shared uniform offset."""
    capacity = capacity or log_weights.shape[-1]
    w = normalized_weights(log_weights)
    u = draws.uniform(())
    return _comb_counts(w, u, n_out, capacity)


def stratified_counts(draws, log_weights: torch.Tensor, n_out,
                      capacity: int | None = None) -> torch.Tensor:
    """Stratified resampling — one uniform per stratum."""
    capacity = capacity or log_weights.shape[-1]
    w = normalized_weights(log_weights)
    u = draws.uniform((capacity,))
    return _comb_counts(w, u, n_out, capacity)


def multinomial_counts(draws, log_weights: torch.Tensor, n_out,
                       capacity: int | None = None) -> torch.Tensor:
    """Multinomial resampling by the inverse CDF of sorted uniforms made
    from exponential spacings, normalized by the first ``n_out + 1``
    spacings."""
    capacity = capacity or log_weights.shape[-1]
    lead = log_weights.dim() - 1
    w = normalized_weights(log_weights)
    e = draws.exponential((capacity + 1,))
    cs = ops.prefix_sum(e)
    n_out_t = _lead_vector(n_out, lead, log_weights.device)
    pick = n_out_t.to(torch.int64).clamp(1, capacity)
    denom = torch.gather(cs, -1, pick.expand(cs.shape[:-1] + (1,)))
    sorted_u = cs[..., :-1] / denom
    return _multinomial_from_sorted(w, sorted_u, n_out_t, capacity)


def _multinomial_from_sorted(w: torch.Tensor, sorted_u: torch.Tensor,
                             n_out_t: torch.Tensor,
                             capacity: int) -> torch.Tensor:
    cdf = ops.prefix_sum(w / invariant_sum(w, -1, keepdim=True).clamp(
        min=1e-38))
    lanes = torch.arange(capacity, device=w.device)
    valid = (lanes < n_out_t).expand(sorted_u.shape)
    return _searchsorted_counts(cdf, sorted_u, valid)


def residual_counts(draws, log_weights: torch.Tensor, n_out,
                    capacity: int | None = None) -> torch.Tensor:
    """Residual resampling: ``floor(n·w)`` copies plus a multinomial
    draw of the rest."""
    capacity = capacity or log_weights.shape[-1]
    lead = log_weights.dim() - 1
    w = normalized_weights(log_weights)
    n_out_t = _lead_vector(n_out, lead, log_weights.device)
    n_out_f = n_out_t.to(torch.float32)
    det = torch.floor(n_out_f * w).to(torch.int32)
    n_det = det.sum(-1, keepdim=True)
    resid = n_out_f * w - det.to(torch.float32)
    resid_lw = torch.log(resid.clamp(min=1e-38))
    rest = multinomial_counts(draws, resid_lw,
                              (n_out_t.to(torch.int32) - n_det)[..., 0],
                              capacity)
    return det + rest


# ---------------------------------------------------------------------------
# Collective-free schemes (Metropolis / rejection) — no prefix sum
# ---------------------------------------------------------------------------

def metropolis_ancestors_from_draws(log_weights: torch.Tensor,
                                    proposals: torch.Tensor,
                                    log_us: torch.Tensor) -> torch.Tensor:
    """Metropolis-chain ancestors ``(..., lanes)`` from the
    ``(..., lanes, iters)`` draws: lane ``l`` starts at ``l % n_in`` and
    accepts proposal ``j`` over ``a`` iff ``log u < lw[j] - lw[a]``; a
    lane that ends on a ``-inf`` slot takes the member's argmax."""
    return ops.metropolis_ancestors(log_weights, proposals, log_us)


def rejection_ancestors_from_draws(log_weights: torch.Tensor,
                                   proposals: torch.Tensor,
                                   log_us: torch.Tensor) -> torch.Tensor:
    """Rejection-sampling ancestors ``(..., lanes)``: the first half of
    the draws is rejection against ``max lw`` (first accept kept), the
    rest a Metropolis fallback chain from ``l % n_in`` for lanes that
    found none; dead final slots take the argmax."""
    return ops.rejection_ancestors(log_weights, proposals, log_us)


def resampling_draws(draws, n_in: int, lanes: int,
                     iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(proposals, log_us)`` pair of the collective-free schemes:
    ``(..., lanes, iters)`` int32 slot indices in ``[0, n_in)`` and
    log-uniforms, drawn in the reference's order (proposals first)."""
    proposals = draws.randint((lanes, iters), n_in)
    log_us = torch.log(draws.uniform((lanes, iters)))
    return proposals, log_us


def _lanes_to_counts(ancestors: torch.Tensor, n_in: int, n_out,
                     capacity: int) -> torch.Tensor:
    """Histogram ``(..., capacity)`` per-lane ancestors into ``(...,
    n_in)`` counts, dropping lanes ``≥ n_out`` (a per-member tensor or
    an int)."""
    lead = ancestors.dim() - 1
    n_out_t = _lead_vector(n_out, lead, ancestors.device)
    lanes = torch.arange(capacity, device=ancestors.device)
    valid = (lanes < n_out_t).expand(ancestors.shape)
    idx = _spread(valid, ancestors.long(), n_in)
    counts = torch.zeros(ancestors.shape[:-1] + (n_in,), dtype=torch.int32,
                         device=ancestors.device)
    return counts.scatter_add_(-1, idx, valid.to(torch.int32))


def metropolis_counts(draws, log_weights: torch.Tensor, n_out,
                      capacity: int | None = None, *,
                      iters: int = METROPOLIS_ITERS) -> torch.Tensor:
    """Metropolis resampling (collective-free, arXiv:1212.1639 §3): no
    CDF, no prefix sum, no normalization."""
    n_in = log_weights.shape[-1]
    capacity = capacity or n_in
    proposals, log_us = resampling_draws(draws, n_in, capacity, iters)
    anc = metropolis_ancestors_from_draws(log_weights, proposals, log_us)
    return _lanes_to_counts(anc, n_in, n_out, capacity)


def rejection_counts(draws, log_weights: torch.Tensor, n_out,
                     capacity: int | None = None, *,
                     tries: int = REJECTION_TRIES) -> torch.Tensor:
    """Rejection resampling (collective-free, arXiv:1301.4019 §4): needs
    only ``max lw``, never a prefix sum."""
    n_in = log_weights.shape[-1]
    capacity = capacity or n_in
    proposals, log_us = resampling_draws(draws, n_in, capacity, tries)
    anc = rejection_ancestors_from_draws(log_weights, proposals, log_us)
    return _lanes_to_counts(anc, n_in, n_out, capacity)


RESAMPLERS = {
    "systematic": systematic_counts,
    "stratified": stratified_counts,
    "multinomial": multinomial_counts,
    "residual": residual_counts,
    "metropolis": metropolis_counts,
    "rejection": rejection_counts,
}


def _as_ancestors(counts_fn):
    def f(draws, log_weights: torch.Tensor, n_out: int) -> torch.Tensor:
        counts = counts_fn(draws, log_weights, n_out,
                           capacity=max(n_out, log_weights.shape[-1]))
        return counts_to_ancestors(counts, n_out)

    f.__name__ = counts_fn.__name__.replace("_counts", "_ancestors")
    f.__doc__ = (f"``(..., n_out)`` ancestor form of "
                 f"``{counts_fn.__name__}``.")
    return f


systematic_ancestors = _as_ancestors(systematic_counts)
stratified_ancestors = _as_ancestors(stratified_counts)
multinomial_ancestors = _as_ancestors(multinomial_counts)
residual_ancestors = _as_ancestors(residual_counts)
metropolis_ancestors = _as_ancestors(metropolis_counts)
rejection_ancestors = _as_ancestors(rejection_counts)
