"""Distributed resampling algorithms, paper §III (port of
``repro.core.distributed``).

Each DRA takes the ``(P, C, ...)`` ensemble of the shards this process
holds — all ``P`` on an emulated mesh, one (``(1, C, ...)``) on a
process mesh (``repro_torch.core.runtime``) — and returns the resampled
one; every collective goes through the runtime facade, so each shard's
row sees exactly what the reference's per-shard program sees, and a
shard gets the same bits on either backend.  A bank's
``(B, P, C, ...)`` ensemble (any member dims in front of the shard dim)
goes through the same code in one pass: each member gets the bits it
gets alone, and its diagnostics are per member, as the reference's
``vmap`` over members gives them:

* **MPF** — independent local resampling; each shard keeps its aggregate
  weight (one scalar all-gather of the shard log-normalizers);
* **RNA** — local resample to C, a random slot shuffle, then a static
  ring exchange of a fixed fraction of the particles;
* **ARNA** — RNA with the exchanged fraction adapted from the effective
  number of processes, and an all_to_all shuffle in place of the ring
  when the target is lost (both computed, one picked per frame on the
  device);
* **RPA** — proportional allocation of the N offspring over shards,
  local resampling in compressed (counts) form, DLB routing of the
  compressed particles (``repro_torch.core.dlb``) and a local
  materialize;
* **butterfly** — ``log2 P`` pairwise mix stages on distance-doubling
  partners, each shipping one capped compressed slab to the partner,
  with a scalar butterfly carrying the global normalizer.

The local resample of MPF/RNA/ARNA with the systematic scheme takes its
ancestors from the B1 kernel on the card
(``kernels.ops.systematic_ancestors``); RPA's and butterfly's compressed
resamples comb the comb scan's CDF.  Every DRA reports the reference's
analytic comm-volume accounting (``comm_bytes``, ``comm_stages``: the
reference's DESIGN.md §14.3).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import dlb, particles, resampling, runtime
from repro_torch.core.particles import (ParticleEnsemble, invariant_logsumexp,
                                        invariant_sum, log_sum_weights)
from repro_torch.kernels import ops

KINDS = ("mpf", "rna", "arna", "rpa", "butterfly")


@dataclasses.dataclass(frozen=True)
class DRAConfig:
    """Distributed-resampling knobs (paper §III–§V), field for field the
    reference's config except ``resample_backend``: the device chooses
    between the B1 kernel and its plain version."""

    kind: str = "rna"                # mpf | rna | arna | rpa | butterfly
    resampler: str = "systematic"
    ess_frac: float = 0.5
    exchange_ratio: float = 0.10     # RNA: the paper's 10%-50%
    q_min: float = 0.05              # ARNA adaptive range
    q_max: float = 0.50
    lost_log_lik: float = -1e4       # ARNA "target lost" floor
    scheduler: str = "lgs"           # RPA: gs | sgs | lgs
    k_cap: int = 64                  # RPA routing window per destination
    slack: float = 2.0               # RPA per-shard allocation cap = slack·C
    butterfly_cap: int = 32          # butterfly: slab slots per stage

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown DRA kind {self.kind!r} ({KINDS})")
        if self.scheduler not in dlb.SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if self.resampler not in resampling.RESAMPLERS:
            raise ValueError(f"unknown resampler {self.resampler!r}")
        if self.butterfly_cap < 1:
            raise ValueError(f"butterfly_cap {self.butterfly_cap} < 1")


def log_f32(x: float) -> float:
    """``log x`` computed in float32, as the reference's ``jnp.log`` of a
    Python number."""
    return float(torch.log(torch.tensor(float(x), dtype=torch.float32)))


def _per_particle_bytes(state: torch.Tensor, slot_dim: int) -> int:
    """Payload bytes of one particle's state (one shard's slot)."""
    return math.prod(state.shape[slot_dim + 1:]) * state.element_size()


def _comm_diag(bytes_per_frame: int, stages: int, device) -> dict:
    """The reference's comm-volume entries: payload bytes one shard
    injects into collectives per frame, and sequential collective
    rounds on the critical path."""
    return {"comm_bytes": torch.tensor(bytes_per_frame, dtype=torch.int32,
                                       device=device),
            "comm_stages": torch.tensor(stages, dtype=torch.int32,
                                        device=device)}


def _over(log_weights: torch.Tensor,
          mesh: runtime.Mesh) -> tuple[runtime.Mesh, int]:
    """The mesh with the member dims of ``(..., P, C)`` log-weights, and
    the shard dim."""
    lead = log_weights.shape[:-2]
    return mesh.over(lead), len(lead)


def _replicated(x: torch.Tensor, d: int) -> torch.Tensor:
    """The one value of a per-shard tensor that every shard already holds
    (a ``psum``'s, an all-gather's): this process's first copy, with no
    collective.  A value that differs across shards needs
    ``runtime.shard0``."""
    return x.select(d, 0)


def _shard_log_z(log_weights: torch.Tensor, mesh: runtime.Mesh
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(..., P)`` local log-normalizers and their ``(..., P, P)``
    all-gather."""
    mesh, _ = _over(log_weights, mesh)
    local = log_sum_weights(log_weights)
    return local, runtime.all_gather(local, mesh)


def global_log_z(log_weights: torch.Tensor,
                 mesh: runtime.Mesh) -> torch.Tensor:
    """``(..., P)``: logsumexp of all shards' weights on every shard."""
    _, gathered = _shard_log_z(log_weights, mesh)
    return invariant_logsumexp(gathered, -1)


def global_ess(log_weights: torch.Tensor,
               mesh: runtime.Mesh) -> torch.Tensor:
    """``(..., P)``: the global N_eff (Alg. 1 line 15) with one psum."""
    glz = global_log_z(log_weights, mesh)
    sq = torch.exp(2.0 * (log_weights - glz[..., None]))
    sq = invariant_sum(torch.where(torch.isfinite(log_weights), sq,
                                   torch.zeros_like(sq)), -1)
    return 1.0 / runtime.psum(sq, _over(log_weights, mesh)[0]).clamp(
        min=1e-38)


def effective_processes(log_weights: torch.Tensor,
                        mesh: runtime.Mesh) -> torch.Tensor:
    """``(..., P)``: P_eff = (Σ W_i)² / Σ W_i² over the shard weights."""
    _, gathered = _shard_log_z(log_weights, mesh)
    w = torch.exp(gathered - invariant_logsumexp(gathered, -1, keepdim=True))
    return 1.0 / invariant_sum(torch.square(w), -1).clamp(min=1e-38)


# ---------------------------------------------------------------------------
# Local resample (shared by the DRAs)
# ---------------------------------------------------------------------------

def _local_resample_materialize(draws, state: torch.Tensor,
                                log_weights: torch.Tensor, n_out: int,
                                cfg: DRAConfig) -> torch.Tensor:
    """Resample ``n_out`` offspring per shard and materialize ``C`` slots
    of state.  The systematic scheme with ``n_out == C`` takes its
    ancestors from B1 (the kernel on the card, its plain version on the
    CPU) on the same one-uniform comb, one launch for every shard of
    every member; the other schemes take the counts path.  (The
    reference also returns the counts, which no caller reads.)"""
    c = log_weights.shape[-1]
    if n_out == c and cfg.resampler == "systematic":
        ancestors = ops.systematic_ancestors(log_weights, draws.uniform(()),
                                             n_out)
    else:
        counts = resampling.RESAMPLERS[cfg.resampler](
            draws, log_weights, n_out, capacity=c)
        ancestors = resampling.counts_to_ancestors(counts, c)
    return particles.gather_particles(state, ancestors)


def _local_resample_ensemble(draws, ensemble: ParticleEnsemble,
                             log_weight: torch.Tensor,
                             cfg: DRAConfig) -> ParticleEnsemble:
    """Full-capacity local resample to a materialized ensemble whose
    every slot of shard ``i`` carries ``log_weight[..., i]``; counts are
    folded into the sampling weights."""
    c = ensemble.capacity
    eff = particles.effective_log_weights(ensemble.log_weights,
                                          ensemble.counts)
    state = _local_resample_materialize(draws, ensemble.state, eff, c, cfg)
    lw = log_weight.to(torch.float32)[..., None].expand(eff.shape)
    return ParticleEnsemble(state=state, log_weights=lw.contiguous(),
                            counts=torch.ones_like(ensemble.counts))


# ---------------------------------------------------------------------------
# The DRAs
# ---------------------------------------------------------------------------

def mpf_resample(draws, ensemble: ParticleEnsemble, cfg: DRAConfig,
                 mesh: runtime.Mesh) -> tuple[ParticleEnsemble, dict]:
    """Independent local resampling; each offspring carries ``Ŵ_i / C`` of
    the global posterior mass."""
    c = ensemble.capacity
    local_lz, gathered = _shard_log_z(particles.effective_log_weights(
        ensemble.log_weights, ensemble.counts), mesh)
    glz = invariant_logsumexp(gathered, -1)
    out = _local_resample_ensemble(draws, ensemble,
                                   local_lz - glz - log_f32(c), cfg)
    dev = ensemble.log_weights.device
    return out, {"exchanged": torch.zeros((), dtype=torch.int32, device=dev),
                 # one scalar all_gather of the shard logZ
                 **_comm_diag(4, 1, dev)}


def _ring_exchange(state: torch.Tensor, log_weights: torch.Tensor,
                   m_buf: int, m_valid, mesh: runtime.Mesh,
                   shuffle: torch.Tensor | None = None):
    """Send the first ``m_buf`` slots of every shard to its ring
    neighbour; the first ``m_valid`` (an int or a ``(..., P)`` tensor)
    received slots replace the head.  With ``shuffle`` (ARNA's lost
    mode, ``(..., P)`` bool, the same on every shard) the head travels by
    a fused all_to_all perfect shuffle instead: both exchanges run and
    the frame's one is selected on the device."""
    mesh, d = _over(log_weights, mesh)
    p = runtime.axis_size(mesh)
    perm = runtime.ring(mesh)

    def head(x, n):
        return x.narrow(d + 1, 0, n)

    def ring(x):
        return runtime.ppermute(head(x, m_buf), mesh, perm)

    def mix(x):
        b = m_buf // p
        lead, own, rest = x.shape[:d], x.shape[d], x.shape[d + 2:]
        y = head(x, b * p).reshape(lead + (own, p, b) + rest)
        y = runtime.all_to_all(y, mesh).reshape(lead + (own, b * p) + rest)
        return torch.cat([y, x.narrow(d + 1, b * p, m_buf - b * p)], d + 1)

    def recv(x):
        if shuffle is None:
            return ring(x)
        pick = shuffle.reshape(shuffle.shape + (1,) * (x.dim() - d - 1))
        return torch.where(pick, mix(x), ring(x))

    m_valid = torch.as_tensor(m_valid, device=state.device)
    # (m_buf,) for one count, (..., P, m_buf) for a count a shard
    keep = torch.arange(m_buf, device=state.device) < m_valid[..., None]

    def splice(orig, got):
        k = keep.reshape(keep.shape + (1,) * (got.dim() - d - 2))
        return torch.cat([torch.where(k, got, head(orig, m_buf)),
                          orig.narrow(d + 1, m_buf,
                                      orig.shape[d + 1] - m_buf)], d + 1)

    return (splice(state, recv(state)),
            splice(log_weights, recv(log_weights)))


def _permute_ensemble(draws, ensemble: ParticleEnsemble) -> ParticleEnsemble:
    """Randomize every shard's slot order (systematic ancestors are
    sorted, so the ring head would always ship the lowest ancestors)."""
    return particles.permute(ensemble,
                             draws.permutation(ensemble.capacity))


def rna_resample(draws, ensemble: ParticleEnsemble, cfg: DRAConfig,
                 mesh: runtime.Mesh) -> tuple[ParticleEnsemble, dict]:
    """RNA: local resample to C, then a static ring exchange of a fixed
    fraction (paper §III / §VII.D).  Draws: the local resample's, then
    the shuffle's permutation."""
    c = ensemble.capacity
    d = ensemble.log_weights.dim() - 2
    local_lz, gathered = _shard_log_z(particles.effective_log_weights(
        ensemble.log_weights, ensemble.counts), mesh)
    glz = invariant_logsumexp(gathered, -1)
    ens = _local_resample_ensemble(draws, ensemble,
                                   local_lz - glz - log_f32(c), cfg)
    ens = _permute_ensemble(draws, ens)
    m = max(int(round(cfg.exchange_ratio * c)), 1)
    state, lw = _ring_exchange(ens.state, ens.log_weights, m, m, mesh)
    ens = ens.replace(state=state, log_weights=lw)
    dev = lw.device
    return ens, {"exchanged": torch.tensor(m, dtype=torch.int32, device=dev),
                 # logZ gather + ring ppermute of m (state, log-weight) rows
                 **_comm_diag(4 + m * (_per_particle_bytes(ens.state, d + 1)
                                       + 4), 2, dev)}


def arna_resample(draws, ensemble: ParticleEnsemble, cfg: DRAConfig,
                  mesh: runtime.Mesh, max_log_lik: torch.Tensor
                  ) -> tuple[ParticleEnsemble, dict]:
    """ARNA: RNA with a P_eff-adaptive exchange fraction (all shards
    tracking → ``q_min``, collapsed → ``q_max``) over a static
    ``m_buf``-slot buffer, and the all_to_all shuffle when every shard's
    best log-likelihood ``max_log_lik`` ``(..., P)`` is below
    ``lost_log_lik``.  Draws: the local resample's, then the shuffle's
    permutation (RNA's order)."""
    c = ensemble.capacity
    bank_mesh, d = _over(ensemble.log_weights, mesh)
    p = runtime.axis_size(mesh)
    eff = particles.effective_log_weights(ensemble.log_weights,
                                          ensemble.counts)
    p_eff = effective_processes(eff, mesh)
    local_lz, gathered = _shard_log_z(eff, mesh)
    glz = invariant_logsumexp(gathered, -1)
    ens = _local_resample_ensemble(draws, ensemble,
                                   local_lz - glz - log_f32(c), cfg)
    ens = _permute_ensemble(draws, ens)
    frac_eff = torch.clamp(p_eff / p, 0.0, 1.0)
    q = cfg.q_min + (cfg.q_max - cfg.q_min) * (1.0 - frac_eff)
    m_buf = max(int(round(cfg.q_max * c)) // p * p, p)   # P-divisible
    m_valid = torch.clamp(torch.ceil(q * c).to(torch.int32), max=m_buf)
    lost = runtime.pmax(max_log_lik, bank_mesh) < cfg.lost_log_lik
    state, lw = _ring_exchange(ens.state, ens.log_weights, m_buf, m_valid,
                               mesh, shuffle=lost)
    ens = ens.replace(state=state, log_weights=lw)
    return ens, {
        "exchanged": _replicated(m_valid, d),
        "p_eff": _replicated(p_eff, d), "q": _replicated(q, d),
        "lost": _replicated(lost, d).to(torch.int32),
        # P_eff gather + logZ gather + lost-mode pmax + the m_buf exchange
        # (ring and shuffle ship the same slab)
        **_comm_diag(12 + m_buf * (_per_particle_bytes(ens.state, d + 1)
                                   + 4), 4, lw.device)}


def rpa_resample(draws, ensemble: ParticleEnsemble, cfg: DRAConfig,
                 mesh: runtime.Mesh) -> tuple[ParticleEnsemble, dict]:
    """RPA: proportional allocation of the N offspring over shards, local
    resampling in compressed form, DLB routing of the compressed
    particles, then a local materialize (paper §III–§V)."""
    c = ensemble.capacity
    bank_mesh, d = _over(ensemble.log_weights, mesh)
    p = runtime.axis_size(mesh)
    n_total = c * p
    cap_units = int(round(cfg.slack * c))
    _, gathered = _shard_log_z(particles.effective_log_weights(
        ensemble.log_weights, ensemble.counts), mesh)
    # every shard holds the same gathered vector: compute the allocation
    # and the schedule once per member (for every shard), then take the
    # entries of the shards this process holds
    alloc = dlb.proportional_allocation(_replicated(gathered, d), n_total,
                                        cap_units)
    comp = particles.resample_compressed(
        draws, ensemble, runtime.own_shards(alloc, mesh, -1),
        scheme=cfg.resampler, capacity=cap_units,
        fill_log_weight=-log_f32(n_total))
    targets = dlb.balanced_targets(n_total, p).to(alloc.device)
    schedule = dlb.SCHEDULERS[cfg.scheduler](alloc, targets)  # (..., P, P)
    route = dlb.route_compressed(comp, runtime.own_shards(schedule, mesh, -2),
                                 k_cap=cfg.k_cap, mesh=bank_mesh)
    out = particles.materialize(dlb.merge_routed(comp, route), c)
    stats = dlb.schedule_stats(schedule)
    dev = ensemble.log_weights.device
    return out, {
        "overflow": _replicated(
            runtime.psum(route.overflow_units, bank_mesh), d),
        **stats,
        # logZ gather + all_to_all of P×K (state, count, log-weight) triples
        **_comm_diag(4 + p * cfg.k_cap
                     * (_per_particle_bytes(ensemble.state, d + 1) + 8), 2,
                     dev),
    }


def butterfly_resample(draws, ensemble: ParticleEnsemble, cfg: DRAConfig,
                       mesh: runtime.Mesh
                       ) -> tuple[ParticleEnsemble, dict]:
    """Butterfly DRA: ``log2 P`` pairwise mix stages (stage ``s`` pairs
    shard ``i`` with ``i XOR 2^s``).  In a pair of aggregate weights
    ``(W_i, W_j)`` shard ``i`` draws ``n_i = C − m_i←j + m_i→j`` offspring
    in compressed form, ``m_i→j = min(round(C·W_i/(W_i+W_j)), cap)``,
    every unit carrying ``W_i / n_i``, and ships the last ``m_i→j`` units
    as one ``cap``-slot slab (``dlb.pack_slab``) to the partner; a scalar
    butterfly (``lz_run ← logaddexp(lz_run, partner) − log 2``) ends as
    ``log(W / P)`` on every shard.  Capacity grows by ``cap`` a stage;
    one materialize restores ``C``.  Draws: each stage's comb, in stage
    order."""
    c = ensemble.capacity
    bank_mesh, d = _over(ensemble.log_weights, mesh)
    p = runtime.axis_size(mesh)
    schedule = runtime.butterfly_schedule(p)
    cap = cfg.butterfly_cap
    dev = ensemble.log_weights.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    # per stage: the two scalars (lz, lz_run) and one slab of (state,
    # count, log-weight) triples to the partner: 2 rounds
    comm = _comm_diag(len(schedule) * (8 + cap * (
        _per_particle_bytes(ensemble.state, d + 1) + 8)),
        2 * len(schedule), dev)
    if not schedule:                 # P == 1: a plain local resample
        out = _local_resample_ensemble(
            draws, ensemble, torch.full(ensemble.log_weights.shape[:-1],
                                        -log_f32(c), device=dev), cfg)
        return out, {"exchanged": zero, "overflow": zero, "truncated": zero,
                     **comm}
    ens = ensemble
    lz_run = particles.log_sum_weights(ens.log_weights, ens.counts)
    log2 = log_f32(2.0)
    shipped_total = torch.zeros(lz_run.shape, dtype=torch.int32, device=dev)
    overflow_total = torch.zeros_like(shipped_total)
    for perm in schedule:
        eff = particles.effective_log_weights(ens.log_weights, ens.counts)
        lz = invariant_logsumexp(eff, -1)
        lz_p, lzr_p = runtime.grouped_ppermute((lz, lz_run), bank_mesh,
                                               perm)
        lz_run = torch.logaddexp(lz_run, lzr_p) - log2
        pair = torch.logaddexp(lz, lz_p)
        # a dead pair (both totals -inf) moves no units either way
        live = torch.isfinite(pair)
        frac_own = torch.where(live, torch.exp(lz - pair),
                               torch.zeros_like(pair))
        frac_partner = torch.where(live, torch.exp(lz_p - pair),
                                   torch.zeros_like(pair))
        m_send = torch.clamp(torch.round(c * frac_own), max=cap).to(
            torch.int32)
        m_recv = torch.clamp(torch.round(c * frac_partner), max=cap).to(
            torch.int32)
        n_tot = c - m_recv + m_send
        fill = lz - torch.log(n_tot.clamp(min=1).to(torch.float32))
        # the comb must cover n_tot <= C + cap points
        comp = particles.resample_compressed(
            draws, ens, n_tot, scheme=cfg.resampler,
            capacity=ens.capacity + cap, fill_log_weight=fill)
        pack = dlb.pack_slab(comp, m_send, k_cap=cap)
        recv_state, recv_counts, recv_lw = runtime.grouped_ppermute(
            (pack.slab_state, pack.slab_counts, pack.slab_log_weights),
            bank_mesh, perm)
        ens = ParticleEnsemble(
            state=torch.cat([comp.state, recv_state], d + 1),
            log_weights=torch.cat([comp.log_weights, recv_lw], d + 1),
            counts=torch.cat([pack.kept_counts, recv_counts], d + 1))
        shipped_total = shipped_total + pack.shipped_units
        overflow_total = overflow_total + pack.overflow_units
    # the scalar butterfly is a hypercube all-reduce: lz_run = log(W / P)
    glz = lz_run + log_f32(float(p))
    truncated = torch.clamp(particles.logical_size(ens) - c, min=0).to(
        torch.int32)
    out = particles.materialize(
        ens.replace(log_weights=ens.log_weights - glz[..., None]), c)
    return out, {
        "exchanged": runtime.shard0(shipped_total, bank_mesh),
        "overflow": _replicated(runtime.psum(overflow_total, bank_mesh), d),
        "truncated": _replicated(runtime.psum(truncated, bank_mesh), d),
        **comm}


DRAS = {"mpf": mpf_resample, "rna": rna_resample, "arna": arna_resample,
        "rpa": rpa_resample, "butterfly": butterfly_resample}
