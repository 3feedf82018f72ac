"""Local resampling schemes (port of ``repro.core.resampling``).

The four comb/CDF schemes — systematic, stratified, multinomial and
residual — as ``(..., n_in)`` multiplicities (``counts_to_ancestors``
expands them to indices), batched over leading dims.  Randomness comes
from a draws provider (``repro_torch.core.draws``) in the reference's
order: systematic takes one ``uniform(())``, stratified
``uniform((capacity,))``, multinomial ``exponential((capacity + 1,))``.

The collective-free Metropolis and rejection schemes wait for their
Hopper kernels (ROADMAP B4/B5); asking for them raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.particles import normalized_weights

COLLECTIVE_FREE = ("metropolis", "rejection")


def _lead_vector(v, lead_dims: int, device) -> torch.Tensor:
    """A scalar or per-member value as a ``(..., 1)`` tensor."""
    v = torch.as_tensor(v, device=device)
    return v.reshape(v.shape + (1,) * (lead_dims + 1 - v.dim()))


# ---------------------------------------------------------------------------
# Representation conversions
# ---------------------------------------------------------------------------

def counts_to_ancestors(counts: torch.Tensor, n_out: int) -> torch.Tensor:
    """Expand ``(..., n_in)`` multiplicities to ``(..., n_out)`` ancestor
    indices — ``jnp.repeat(arange, counts, total_repeat_length=n_out)``
    written as a search, so it batches: a short total is padded with the
    last index ``n_in - 1``, a long one truncated."""
    n_in = counts.shape[-1]
    cum = torch.cumsum(counts, -1)
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

def _searchsorted_counts(cdf: torch.Tensor, pts: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Counts of comb points per CDF bin; invalid points are dropped."""
    n = cdf.shape[-1]
    pts = torch.where(valid, pts, torch.full_like(pts, 2.0))
    anc = torch.searchsorted(cdf.contiguous(), pts.contiguous(), right=True)
    anc = anc.clamp(0, n - 1)
    idx = torch.where(valid, anc, torch.full_like(anc, n - 1))
    counts = torch.zeros(cdf.shape, dtype=torch.int32, device=cdf.device)
    return counts.scatter_add_(-1, idx, valid.to(torch.int32))


def _comb_counts(weights: torch.Tensor, u: torch.Tensor, n_out,
                 capacity: int) -> torch.Tensor:
    """Offspring counts for a comb of ``n_out`` points with offsets ``u``
    (one per member for systematic, ``(..., capacity)`` for stratified);
    ``n_out`` may be a per-member tensor ``≤ capacity``."""
    lead = weights.dim() - 1
    w = weights / weights.sum(-1, keepdim=True).clamp(min=1e-38)
    cdf = torch.cumsum(w, -1)
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
    cs = torch.cumsum(e, -1)
    n_out_t = _lead_vector(n_out, lead, log_weights.device)
    pick = n_out_t.to(torch.int64).clamp(1, capacity)
    denom = torch.gather(cs, -1, pick.expand(cs.shape[:-1] + (1,)))
    sorted_u = cs[..., :-1] / denom
    return _multinomial_from_sorted(w, sorted_u, n_out_t, capacity)


def _multinomial_from_sorted(w: torch.Tensor, sorted_u: torch.Tensor,
                             n_out_t: torch.Tensor,
                             capacity: int) -> torch.Tensor:
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True).clamp(min=1e-38), -1)
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


def _unported(name: str):
    def f(*args, **kwargs):
        raise NotImplementedError(
            f"resampler {name!r} waits for its Hopper kernel "
            f"(ROADMAP B4/B5)")
    return f


RESAMPLERS = {
    "systematic": systematic_counts,
    "stratified": stratified_counts,
    "multinomial": multinomial_counts,
    "residual": residual_counts,
    "metropolis": _unported("metropolis"),
    "rejection": _unported("rejection"),
}
