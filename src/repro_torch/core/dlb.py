"""Dynamic load balancing for RPA (paper §IV) and the routing of
compressed particles (port of ``repro.core.dlb``).

The schedulers (GS, SGS, LGS) decide, from the ``(P,)`` vector of
per-shard particle counts that every shard knows, how many units each
sender ships to each receiver: greedy matching of ordered senders to
ordered receivers is the interval intersection of their cumulative
surplus and deficit ranges.  They are plain functions of that vector;
the emulated mesh computes them once for all shards, and a bank's
``(B, P)`` vectors in one pass (every function here batches over
leading member dims).

The routing executor packs, per destination, a window of ``k_cap``
(state, count, per-replica log-weight) triples and moves all windows with
one ``all_to_all``; units that do not fit stay local.  Here it acts on the
whole ``(P, C, ...)`` ensemble: shard ``i``'s windows are row ``i``
(a bank's ``(B, P, C, ...)`` ensemble packs its ``B·P`` rows at once).
``pack_slab`` packs the butterfly DRA's one-destination slab.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import runtime
from repro_torch.core.particles import (ParticleEnsemble, gather_particles,
                                        invariant_logsumexp)
from repro_torch.core.resampling import row_cumsum


# ---------------------------------------------------------------------------
# Targets and surplus/deficit labeling (paper §IV)
# ---------------------------------------------------------------------------

def balanced_targets(total, p: int) -> torch.Tensor:
    """Integer target counts per shard: ``total`` split as evenly as
    possible (the first ``total mod p`` shards take one more)."""
    total = torch.as_tensor(total)
    base = total // p
    rem = total - base * p
    return base + (torch.arange(p, device=total.device) < rem).to(base.dtype)


def surplus_deficit(counts: torch.Tensor, targets: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard (surplus, deficit) against the balanced targets."""
    return (torch.clamp(counts - targets, min=0),
            torch.clamp(targets - counts, min=0))


def _interval_overlap_matrix(s: torch.Tensor, d: torch.Tensor
                             ) -> torch.Tensor:
    """``M[..., i, j]``: overlap of sender ``i``'s surplus interval with
    receiver ``j``'s deficit interval on the shared unit line."""
    s_hi = torch.cumsum(s, -1)
    s_lo = s_hi - s
    d_hi = torch.cumsum(d, -1)
    d_lo = d_hi - d
    lo = torch.maximum(s_lo[..., :, None], d_lo[..., None, :])
    hi = torch.minimum(s_hi[..., :, None], d_hi[..., None, :])
    return torch.clamp(hi - lo, min=0).to(torch.int32)


def _descending(v: torch.Tensor) -> torch.Tensor:
    """``argsort(-v)`` over the last dim, stable as ``jnp.argsort``: ties
    in index order."""
    return torch.argsort(-v, dim=-1, stable=True)


def schedule_gs(counts: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Greedy Scheduler (paper Alg. 2): index-order interval
    intersection."""
    return _interval_overlap_matrix(*surplus_deficit(counts, targets))


def schedule_sgs(counts: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
    """Sorted Greedy Scheduler (paper Alg. 3): senders and receivers in
    descending order of magnitude first."""
    s, d = surplus_deficit(counts, targets)
    order_s, order_d = _descending(s), _descending(d)
    m_sorted = _interval_overlap_matrix(s.gather(-1, order_s),
                                        d.gather(-1, order_d))
    # m[order_s[i], order_d[j]] = m_sorted[i, j]: read through the inverse
    # orders
    inv_s, inv_d = torch.argsort(order_s, -1), torch.argsort(order_d, -1)
    rows = m_sorted.gather(-2, inv_s[..., :, None].expand(m_sorted.shape))
    return rows.gather(-1, inv_d[..., None, :].expand(m_sorted.shape))


def schedule_lgs(counts: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
    """Largest Gradient Scheduler (paper Alg. 4): the rank-k sender ships
    ``min(surplus, deficit)`` to the rank-k receiver."""
    s, d = surplus_deficit(counts, targets)
    order_s, order_d = _descending(s), _descending(d)
    p = counts.shape[-1]
    units = torch.minimum(s.gather(-1, order_s), d.gather(-1, order_d))
    m = torch.zeros(counts.shape[:-1] + (p * p,), dtype=torch.int32,
                    device=counts.device)
    m.scatter_(-1, order_s * p + order_d, units.to(torch.int32))
    return m.reshape(counts.shape[:-1] + (p, p))


SCHEDULERS = {"gs": schedule_gs, "sgs": schedule_sgs, "lgs": schedule_lgs}


def schedule_stats(m: torch.Tensor) -> dict[str, torch.Tensor]:
    """The paper's latency and bandwidth criteria of a ``(..., P, P)``
    schedule, per member."""
    return {"links": (m > 0).sum((-2, -1)), "units_moved": m.sum((-2, -1)),
            "max_message_units": m.amax((-2, -1))}


# ---------------------------------------------------------------------------
# Proportional allocation (RPA, paper §III) with capacity clamping
# ---------------------------------------------------------------------------

def proportional_allocation(shard_log_weights: torch.Tensor, total: int,
                            cap: int) -> torch.Tensor:
    """Integer allocation ``n_i ∝ exp(shard_log_weights)`` over the last
    dim with ``Σ n_i == total``: largest-remainder apportionment, then
    the units clipped by the per-shard ``cap`` refill the remaining room
    in shard order."""
    lw = shard_log_weights - invariant_logsumexp(shard_log_weights, -1,
                                                 keepdim=True)
    quota = torch.exp(lw) * total
    n = torch.floor(quota).to(torch.int32)
    rem = total - n.sum(-1, keepdim=True)
    order = _descending(quota - torch.floor(quota))
    p = n.shape[-1]
    bump = torch.zeros_like(n).scatter_(
        -1, order, (torch.arange(p, device=n.device) < rem).to(torch.int32))
    n = n + bump
    lost = torch.clamp(n - cap, min=0).sum(-1, keepdim=True)
    n = torch.clamp(n, max=cap)
    room = torch.clamp(cap - n, min=0)
    room_before = torch.cumsum(room, -1) - room
    add = torch.minimum(torch.clamp(lost - room_before, min=0), room)
    return (n + add).to(torch.int32)


# ---------------------------------------------------------------------------
# Routing executor: compressed particles over one all_to_all
# ---------------------------------------------------------------------------

class PackResult(NamedTuple):
    """Every shard's outbound windows, before any collective."""

    kept_counts: torch.Tensor        # (P, C) multiplicities staying local
    send_state: torch.Tensor         # (P, P, K, ...) outbound particles
    send_counts: torch.Tensor        # (P, P, K) outbound multiplicities
    send_log_weights: torch.Tensor   # (P, P, K) per-replica log-weights
    send_slots: torch.Tensor         # (P, P, K) local slot of each entry
    overflow_units: torch.Tensor     # (P,) units that could not be packed


class RouteResult(NamedTuple):
    """What ``route_compressed`` leaves on each shard."""

    kept_counts: torch.Tensor        # (P, C)
    recv_state: torch.Tensor         # (P, P, K, ...) received particles
    recv_counts: torch.Tensor        # (P, P, K)
    recv_log_weights: torch.Tensor   # (P, P, K)
    overflow_units: torch.Tensor     # (P,)
    send_slots: torch.Tensor         # (P, P, K)
    send_units: torch.Tensor         # (P, P, K)


def _rows(ensemble: ParticleEnsemble) -> ParticleEnsemble:
    """A bank's ``(..., P, C, ...)`` ensemble as ``(B·P, C, ...)`` rows (a
    view): packing is per shard, so the member dims fold into rows."""
    d = ensemble.counts.dim() - 1
    return ParticleEnsemble(*(x.reshape((-1,) + x.shape[d:]) for x in (
        ensemble.state, ensemble.log_weights, ensemble.counts)))


def _window_overlap(u_lo, u_hi, a, b):
    return torch.clamp(torch.minimum(u_hi, b) - torch.maximum(u_lo, a),
                       min=0)


def pack_windows(ensemble: ParticleEnsemble, row_send: torch.Tensor, *,
                 k_cap: int) -> PackResult:
    """Pack every shard's outbound destination windows (no collective).

    ``ensemble`` is the compressed ``(P, C, ...)`` ensemble and
    ``row_send`` ``(P, P)`` the units shard ``i`` sends to shard ``j``.
    Particle ``k`` owns ``[u_lo_k, u_hi_k)`` on its shard's unit line;
    the kept units come first, then one interval per destination, and
    each window takes up to ``k_cap`` consecutive slots from the first
    particle overlapping its interval.
    """
    lead = ensemble.counts.shape[:-1]          # (..., P): one row a shard
    if len(lead) > 1:
        pack = pack_windows(_rows(ensemble), row_send.reshape(
            (-1,) + row_send.shape[-1:]), k_cap=k_cap)
        return PackResult(*(x.reshape(lead + x.shape[1:]) for x in pack))
    counts = ensemble.counts.to(torch.int64)
    p, c = counts.shape
    u_hi = row_cumsum(counts)
    u_lo = u_hi - counts
    keep_n = u_hi[:, -1] - row_send.sum(-1)
    d_hi = keep_n[:, None] + torch.cumsum(row_send.to(torch.int64), -1)
    d_lo = d_hi - row_send                                     # (P, P)
    k0 = torch.searchsorted(u_hi.contiguous(), d_lo.contiguous(),
                            right=True)
    raw = k0[..., None] + torch.arange(k_cap, device=counts.device)
    idx = raw.clamp(max=c - 1)                                 # (P, P, K)
    flat = idx.reshape(p, -1)
    sent = _window_overlap(u_lo.gather(-1, flat).reshape(idx.shape),
                           u_hi.gather(-1, flat).reshape(idx.shape),
                           d_lo[..., None], d_hi[..., None])
    # entries clipped to C-1 are padding, not repeats of the last slot
    sent = torch.where(raw < c, sent, torch.zeros_like(sent))
    overflow = torch.clamp(row_send - sent.sum(-1), min=0).sum(-1)
    send_state = gather_particles(ensemble.state, flat).reshape(
        idx.shape + ensemble.state.shape[2:])
    send_lw = ensemble.log_weights.gather(-1, flat).reshape(idx.shape)
    # the entries that ship nothing (a window's padding, all on slot C-1)
    # add their 0 at spread slots: on one address the CUDA scatter queues
    # them all (at k_cap = C that is most of 2^28 entries)
    sent_flat = sent.reshape(p, -1)
    lanes = torch.arange(flat.shape[-1], device=counts.device) % c
    shipped = torch.zeros_like(counts).scatter_add_(
        -1, torch.where(sent_flat > 0, flat, lanes.expand_as(flat)),
        sent_flat)
    return PackResult((counts - shipped).to(torch.int32), send_state,
                      sent.to(torch.int32), send_lw, idx.to(torch.int32),
                      overflow.to(torch.int32))


def route_compressed(ensemble: ParticleEnsemble, row_send: torch.Tensor, *,
                     k_cap: int, mesh: runtime.EmulatedMesh) -> RouteResult:
    """Pack every shard's windows and deliver them with one
    ``all_to_all``; the per-replica log-weights travel with the
    particles."""
    pack = pack_windows(ensemble, row_send, k_cap=k_cap)
    return RouteResult(pack.kept_counts,
                       runtime.all_to_all(pack.send_state, mesh),
                       runtime.all_to_all(pack.send_counts, mesh),
                       runtime.all_to_all(pack.send_log_weights, mesh),
                       overflow_units=pack.overflow_units,
                       send_slots=pack.send_slots,
                       send_units=pack.send_counts)


def merge_routed(ensemble: ParticleEnsemble,
                 route: RouteResult) -> ParticleEnsemble:
    """Kept plus received compressed particles, still compressed:
    capacity ``C + P·K`` (``particles.materialize`` expands them)."""
    d = route.recv_counts.dim() - 2            # the slot dim

    def flat(x):
        return x.reshape(x.shape[:d - 1] + (x.shape[d - 1], -1)
                         + x.shape[d + 2:])

    return ParticleEnsemble(
        state=torch.cat([ensemble.state, flat(route.recv_state)], d),
        log_weights=torch.cat([ensemble.log_weights,
                               flat(route.recv_log_weights)], d),
        counts=torch.cat([route.kept_counts.to(torch.int32),
                          flat(route.recv_counts)], d))


class SlabPack(NamedTuple):
    """Every shard's outbound slab to its one stage partner."""

    kept_counts: torch.Tensor        # (P, C) multiplicities staying local
    slab_state: torch.Tensor         # (P, K, ...) outbound particles
    slab_counts: torch.Tensor        # (P, K) outbound multiplicities
    slab_log_weights: torch.Tensor   # (P, K) per-replica log-weights
    shipped_units: torch.Tensor      # (P,) units packed
    overflow_units: torch.Tensor     # (P,) units that did not fit


def pack_slab(ensemble: ParticleEnsemble, m_units: torch.Tensor, *,
              k_cap: int) -> SlabPack:
    """Pack the last ``m_units`` (per shard) units of each shard's unit
    line into one ``k_cap``-slot slab (no collective).  The slab takes
    the slots with a positive overlap of the suffix window, in slot order,
    and pads with slot ``C - 1`` carrying 0 units (the reference's
    ``nonzero(..., size=k_cap, fill_value=C-1)``, as a fixed-size
    selection with no host sync): a window of ``m ≤ k_cap`` units
    overlaps at most ``m`` such slots, so it never overflows.  Units that
    do not fit stay in ``kept_counts``."""
    lead = ensemble.counts.shape[:-1]          # (..., P): one row a shard
    if len(lead) > 1:
        pack = pack_slab(_rows(ensemble), torch.as_tensor(m_units).reshape(
            -1), k_cap=k_cap)
        return SlabPack(*(x.reshape(lead + x.shape[1:]) for x in pack))
    counts = ensemble.counts.to(torch.int32)
    p, c = counts.shape
    u_hi = row_cumsum(counts)
    u_lo = u_hi - counts
    total = u_hi[:, -1:]
    m = torch.minimum(torch.as_tensor(m_units, device=counts.device)
                      .to(torch.int64).reshape(p, 1).clamp(min=0), total)
    sent_all = _window_overlap(u_lo, u_hi, total - m, total)    # (P, C)
    pos = sent_all > 0
    rank = row_cumsum(pos.to(torch.int32)) - 1
    # the k-th positive slot goes to column k; the rest to a spare column
    dest = torch.where(pos & (rank < k_cap), rank,
                       torch.full_like(rank, k_cap))
    lanes = torch.arange(c, device=counts.device).expand(p, c)
    idx = torch.full((p, k_cap + 1), c - 1, dtype=torch.int64,
                     device=counts.device).scatter_(-1, dest, lanes)
    idx = idx[:, :k_cap]
    valid = torch.arange(k_cap, device=counts.device) < pos.sum(
        -1, keepdim=True)
    sent = torch.where(valid, sent_all.gather(-1, idx),
                       torch.zeros_like(idx)).to(torch.int32)
    shipped = sent.sum(-1)
    slab_lw = torch.where(sent > 0, ensemble.log_weights.gather(-1, idx),
                          torch.full(sent.shape, -math.inf,
                                     device=counts.device))
    kept = counts.scatter_add(-1, idx, -sent)
    return SlabPack(kept, gather_particles(ensemble.state, idx), sent,
                    slab_lw, shipped, m[:, 0].to(torch.int32) - shipped)
