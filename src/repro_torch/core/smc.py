"""Sequential importance resampling, paper Alg. 1 (port of
``repro.core.smc``, single-device part).

A step is ``step(carry, observation) -> (carry, StepOutput)`` over a
``SIRCarry(draws, ensemble)``: the draws provider takes the place of the
reference's PRNG key and hands out the step's draws in the reference's
order (the dynamics normals, then the resampler's draws).  Every step is
batched over the ensemble's leading dims, so a ``FilterBank`` runs the
same step on a ``(B, N, ...)`` ensemble with a ``BankDraws`` provider.
``run_sir`` replaces ``lax.scan`` with a Python loop over frames.

``make_distributed_sir_step`` is the step of the distributed filter: the
same Alg. 1 over a ``(P, C, ...)`` ensemble of an emulated P-shard mesh,
with the global normalizer, ESS and estimate taken through the
collective facade and the resample done by a DRA
(``repro_torch.core.distributed``); with a ``domain``
(``repro_torch.core.domain``) each shard reweights against its own halo
slab through the migrate-after-advance hook.  The same step runs a bank
over the mesh: a ``(B, P, C, ...)`` ensemble, one pass for all members.
``StateSpaceModel`` is the reference's closure-style model bundle.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import distributed as dist
from repro_torch.core import domain as domain_mod
from repro_torch.core import particles, resampling, runtime
from repro_torch.core.particles import ParticleEnsemble, effective_sample_size
from repro_torch.kernels import sir_fused
from repro_torch.models.ssm.base import domain_hooks


@dataclasses.dataclass(frozen=True)
class StateSpaceModel:
    """Closure-style adapter for the ``repro_torch.models.ssm``
    ``StateSpaceModel`` protocol, as the reference's: three callables
    exposed under the protocol's method names, the lightest way to write
    a throwaway model (``core.asir`` returns one).

    init_sampler:    (draws, n) -> state with leading dims (..., n)
    dynamics_sample: (draws, state) -> state          (the proposal = prior)
    log_likelihood:  (state, observation) -> (..., n) log p(z|x)

    Image models may add the domain-decomposition hooks (both needed for
    ``ParallelParticleFilter(domain=...)``):

    positions:           (state) -> (..., n, 2) frame-coordinate (y, x)
    tile_log_likelihood: (state, slabs, origins) -> (..., n)  log p(z|x)
        against halo slabs, equal to ``log_likelihood`` for the
        particles a slab's tile owns.
    """

    init_sampler: Callable[..., Any]
    dynamics_sample: Callable[..., Any]
    log_likelihood: Callable[..., torch.Tensor]
    state_dim: int = 5
    positions: Callable[..., torch.Tensor] | None = None
    tile_log_likelihood: Callable[..., torch.Tensor] | None = None

    def init(self, draws, n: int) -> Any:
        """Protocol ``init``: ``init_sampler``."""
        return self.init_sampler(draws, n)

    def transition_sample(self, draws, state: Any) -> Any:
        """Protocol ``transition_sample``: ``dynamics_sample``."""
        return self.dynamics_sample(draws, state)

    def observation_log_prob(self, state: Any,
                             observation: Any) -> torch.Tensor:
        """Protocol ``observation_log_prob``: ``log_likelihood``."""
        return self.log_likelihood(state, observation)


@dataclasses.dataclass(frozen=True)
class SIRConfig:
    """SIR filter knobs (paper Alg. 1), as in the reference.

    ``step_backend="fused"`` runs the weight phase through
    ``repro_torch.kernels.sir_fused`` (the Hopper kernel on the card);
    configs the fused step cannot honor (a comb-only resampler such as
    ``stratified``, ancestry recording, an ``estimate_state`` or
    ``gather_state`` model hook) fall back to the composed step, as in
    the reference.  The fused step with ``metropolis``/``rejection``
    runs the weight phase without its comb and takes the ancestors from
    the chain kernel.  The reference's
    ``fused_backend`` has no counterpart: the port chooses the kernel or
    its plain version by the tensors' device.
    """

    n_particles: int = 4096
    resampler: str = "systematic"
    ess_frac: float = 0.5
    always_resample: bool = False
    step_backend: str = "composed"
    record_ancestry: bool = False


class SIRCarry(NamedTuple):
    """Carry of every SIR step: the draws provider + the ensemble."""

    draws: Any
    ensemble: ParticleEnsemble


class StepOutput(NamedTuple):
    """Per-frame outputs of one SIR step (leading dims follow the
    ensemble's)."""

    estimate: torch.Tensor
    ess: torch.Tensor
    log_marginal: torch.Tensor
    resampled: torch.Tensor
    ancestors: torch.Tensor      # (..., N) when recording, else (..., 0)
    diag: dict


class ResampleDecision(NamedTuple):
    """Outcome of ``ess_resample`` — Alg. 1 lines 15–18."""

    ancestors: torch.Tensor
    ess: torch.Tensor
    log_z: torch.Tensor
    resampled: torch.Tensor


def no_ancestors(lead: tuple = (), device=None) -> torch.Tensor:
    """The width-0 int32 ancestors placeholder when recording is off."""
    return torch.zeros(tuple(lead) + (0,), dtype=torch.int32, device=device)


def ess_resample(draws, log_weights: torch.Tensor, *, ess_frac: float,
                 resampler: str = "systematic",
                 always: bool = False) -> ResampleDecision:
    """ESS check + conditional resample; the ancestors are the identity
    where the threshold is not hit (the resample still runs)."""
    n = log_weights.shape[-1]
    ess = effective_sample_size(log_weights)
    log_z = particles.invariant_logsumexp(log_weights, -1)
    resampled = torch.logical_or(ess < ess_frac * n, torch.tensor(
        bool(always), device=ess.device))
    counts = resampling.RESAMPLERS[resampler](draws, log_weights, n,
                                              capacity=n)
    ancestors = resampling.counts_to_ancestors(counts, n)
    lane = torch.arange(n, dtype=ancestors.dtype, device=ancestors.device)
    ancestors = torch.where(resampled[..., None], ancestors,
                            lane.expand(ancestors.shape))
    return ResampleDecision(ancestors, ess, log_z, resampled)


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """View per-member ``v`` ``(...)`` against ``like`` ``(..., *rest)``."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _select(cond: torch.Tensor, new: ParticleEnsemble,
            old: ParticleEnsemble) -> ParticleEnsemble:
    """Per member (``cond`` over the leading dim): ``new`` where true,
    leafwise over a pytree state."""
    def pick(a, b):
        return torch.where(_bcast(cond, a), a, b)

    return ParticleEnsemble(*(
        particles.tree_map(pick, getattr(new, f), getattr(old, f))
        for f in ("state", "log_weights", "counts")))


def make_sir_step(model, cfg: SIRConfig):
    """Build the single-device SIR step (Alg. 1 lines 5–18) for any
    ``StateSpaceModel``.  ``step_backend="fused"`` delegates the weight
    phase to ``repro_torch.kernels.sir_fused`` with the reference's
    fallbacks; see ``SIRConfig``."""
    est_fn = getattr(model, "estimate_state", None)
    emit_fn = getattr(model, "emission", None)
    gather_fn = getattr(model, "gather_state", None)
    if (cfg.step_backend == "fused"
            and sir_fused.fused_applicable(cfg.resampler)
            and not cfg.record_ancestry and est_fn is None
            and gather_fn is None):
        return _make_fused_sir_step(model, cfg)
    n = cfg.n_particles

    def gather(state, ancestors):
        if gather_fn is not None:
            return gather_fn(state, ancestors)
        return particles.gather_particles(state, ancestors)

    def step(carry: SIRCarry, observation):
        draws, ens = carry
        ens = particles.advance(ens, draws, model.transition_sample)
        ens = particles.reweight(ens, model.observation_log_prob(
            ens.state, observation))
        est_ens = ens if est_fn is None else ens.replace(
            state=est_fn(ens.state))
        estimate = particles.weighted_mean(est_ens)
        dec = ess_resample(draws, ens.log_weights, ess_frac=cfg.ess_frac,
                           resampler=cfg.resampler,
                           always=cfg.always_resample)
        state = gather(ens.state, dec.ancestors)
        skew = n * torch.exp(ens.log_weights.amax(-1) - dec.log_z)
        diag = {"weight_skew": skew}
        lead = ens.log_weights.shape[:-1]
        if cfg.record_ancestry:
            diag["emission"] = (ens.state if emit_fn is None
                                else emit_fn(ens.state))
            diag["log_weights"] = ens.log_weights - dec.log_z[..., None]
            ancestors = dec.ancestors
        else:
            ancestors = no_ancestors(lead, ens.log_weights.device)
        # logsumexp(lw) == 0 entering every step, so log_z IS the
        # marginal-likelihood increment log p(z_k | Z^{k-1})
        lw = torch.where(dec.resampled[..., None],
                         torch.full_like(ens.log_weights, -math.log(n)),
                         ens.log_weights - dec.log_z[..., None])
        ens = ens.replace(state=state, log_weights=lw)
        out = StepOutput(estimate, dec.ess, dec.log_z, dec.resampled,
                         ancestors, diag)
        return SIRCarry(draws, ens), out

    return step


def _make_fused_sir_step(model, cfg: SIRConfig):
    """The fused-backend step: advance, one likelihood call, then the
    whole weight phase in ``sir_fused.fused_weight_step`` and the
    resampling gather of the decision it returns."""

    def step(carry: SIRCarry, observation):
        draws, ens = carry
        ens = particles.advance(ens, draws, model.transition_sample)
        ll = model.observation_log_prob(ens.state, observation)
        dec = sir_fused.fused_weight_step(
            ens.log_weights, ll, ens.state, draws, resampler=cfg.resampler,
            ess_frac=cfg.ess_frac, always=cfg.always_resample)
        state = particles.gather_particles(ens.state, dec.ancestors)
        ens = ens.replace(state=state, log_weights=dec.new_log_weights)
        lead = ens.log_weights.shape[:-1]
        out = StepOutput(dec.estimate, dec.ess, dec.log_z, dec.resampled,
                         no_ancestors(lead, ens.log_weights.device),
                         {"weight_skew": dec.weight_skew})
        return SIRCarry(draws, ens), out

    return step


def stack_outputs(outs: list[StepOutput], axis: int = 0) -> StepOutput:
    """Stack per-frame outputs along a new time axis (what ``lax.scan``
    does to the reference's outputs)."""
    def stack(*xs):
        return torch.stack(xs, axis)

    return StepOutput(*(particles.tree_map(stack, *[getattr(o, f)
                                                    for o in outs])
                        for f in ("estimate", "ess", "log_marginal",
                                  "resampled", "ancestors", "diag")))


def run_sir(draws, model, cfg: SIRConfig,
            observations) -> tuple[SIRCarry, StepOutput]:
    """Run the filter over a stacked observation sequence ``(K, ...)``:
    init draws first, then each frame's draws — the reference's key
    order (``split(key)`` into init and run streams)."""
    ens = particles.init_ensemble(draws, model.init, cfg.n_particles)
    step = make_sir_step(model, cfg)
    carry = SIRCarry(draws, ens)
    outs = []
    for k in range(len(observations)):
        carry, out = step(carry, observations[k])
        outs.append(out)
    return carry, stack_outputs(outs)


# ---------------------------------------------------------------------------
# Distributed (per-shard) SIR step
# ---------------------------------------------------------------------------

def make_distributed_sir_step(model, cfg: SIRConfig, dra: dist.DRAConfig,
                              mesh: runtime.EmulatedMesh,
                              domain: domain_mod.DomainSpec | None = None):
    """The SIR step of the distributed filter over an emulated ``P``-shard
    mesh.  ``cfg.n_particles`` is the GLOBAL count; the carry's ensemble
    is ``(P, C, ...)`` with ``C = n_particles / P``, and its draws
    provider has ``batch_shape (P,)`` (one stream per shard).  Every
    shard advances, reweights against the one shared frame, and the
    global log-normalizer, ESS and estimate come from collectives; the
    DRA always runs (its draws are always taken), and the global ESS
    decides whether its result is kept.  Outputs are the replicated
    values (one copy); ``diag`` holds the DRA's diagnostics and the
    step's comm-volume accounting.

    Member dims may lead the shard dim: a bank's ``(B, P, C, ...)``
    ensemble with ``(B, P)`` draws and one observation a member
    (``(B, ...)``, broadcast over its shards) runs in one pass, each
    member with the bits of its standalone run; outputs and ``diag``
    are then per member (``(B, ...)``), as the reference's ``vmap`` of
    this step gives them.

    With ``domain``, the observation is the ``(P, sh, sw)`` stack of the
    shards' halo slabs, and the reweight goes through
    ``domain.exchange_log_likelihood``: particles travel to their tile
    owners, are reweighted against the owner's slab (one call of the
    model's ``tile_observation_log_prob`` for all shards) and the values
    travel back to their home slots, so everything after the reweight is
    the replicated filter's.  ``mig_moved``/``mig_overflow`` join
    ``diag``, outside the DRA's comm accounting.  It needs the model's
    ``positions`` and ``tile_observation_log_prob`` hooks."""
    positions_fn, tile_fn = domain_hooks(model)
    if domain is not None and tile_fn is None:
        raise ValueError("domain decomposition needs a model with "
                         "tile_observation_log_prob and positions hooks")
    origins = None if domain is None else domain.slab_origins()
    resample = dist.DRAS[dra.kind]

    def step(carry: SIRCarry, observation):
        draws, ens = carry
        *lead, p, c = ens.log_weights.shape
        lead = tuple(lead)
        d = len(lead)                      # the shard dim
        bank_mesh = mesh.over(lead)
        ens = particles.advance(ens, draws, model.transition_sample)
        if domain is None:
            # a member's observation broadcasts over its shards
            obs = particles.tree_map(lambda o: o.unsqueeze(d), observation) \
                if d else observation
            ll = model.observation_log_prob(ens.state, obs)
            mig_diag = {}
        elif d:
            raise ValueError("a bank takes no domain decomposition")
        else:
            ll, mig_diag = domain_mod.exchange_log_likelihood(
                domain, ens, positions_fn(ens.state),
                lambda state: tile_fn(state, observation, origins),
                mesh=mesh)
        ens = particles.reweight(ens, ll)
        lw = ens.log_weights
        glz = dist.global_log_z(lw, mesh)
        ess = dist.global_ess(lw, mesh)
        # MMSE estimate with globally normalized weights (one psum)
        w = torch.exp(torch.where(torch.isfinite(lw), lw - glz[..., None],
                                  torch.full_like(lw, -math.inf)))
        x = ens.state
        estimate = runtime.psum(particles.invariant_sum(
            _bcast(w.to(x.dtype), x) * x, d + 1), bank_mesh).select(d, 0)
        do_resample = torch.logical_or(
            ess < cfg.ess_frac * (p * c),
            torch.tensor(bool(cfg.always_resample), device=ess.device))
        if dra.kind == "arna":
            # each shard's best live log-likelihood: the lost-mode test
            max_ll = torch.where(torch.isfinite(lw), ll,
                                 torch.full_like(ll, -math.inf)).amax(-1)
            r_ens, diag = resample(draws, ens, dra, mesh, max_ll)
        else:
            r_ens, diag = resample(draws, ens, dra, mesh)
        # fold the weight phase's collectives into the comm accounting:
        # logZ gather + ESS gather/psum + estimate psum
        step_bytes = 12 + math.prod(estimate.shape[d:]) \
            * estimate.element_size()
        diag = {**diag, "comm_bytes": diag["comm_bytes"] + step_bytes,
                "comm_stages": diag["comm_stages"] + 4, **mig_diag}
        # every diagnostic per member, as the reference's vmap gives it
        diag = {k: v.expand(lead) for k, v in diag.items()}
        ens = _select(do_resample, r_ens,
                      ens.replace(log_weights=lw - glz[..., None]))
        out = StepOutput(estimate, ess.select(d, 0), glz.select(d, 0),
                         do_resample.select(d, 0),
                         no_ancestors(lead, lw.device), diag)
        return SIRCarry(draws, ens), out

    return step


# ---------------------------------------------------------------------------
# Per-slot masking (resident banks)
# ---------------------------------------------------------------------------

def neutral_output(out: StepOutput, active: torch.Tensor) -> StepOutput:
    """Zero a step's outputs wherever ``active`` (``(B,)`` bool, or one
    flag per member of several member dims) is False;
    ``resampled`` becomes False."""
    def zero(x):
        return torch.where(_bcast(active, x), x, torch.zeros_like(x))

    return StepOutput(*(particles.tree_map(zero, getattr(out, f)) for f in (
        "estimate", "ess", "log_marginal", "resampled", "ancestors",
        "diag")))


def make_masked_step(step):
    """Wrap a batched SIR step with a per-slot activity gate.

    ``masked(carry, (observation, active))`` runs ``step`` on every slot,
    then selects: an active slot takes the new ensemble and real outputs,
    an inactive slot keeps its ensemble bit for bit and emits zeros.  The
    carry's draws must be a ``BankDraws`` over the slots; an inactive
    member is not asked for draws, so its stream stays frozen too.  When
    every slot is active the select would copy the new ensemble onto
    itself, so it is skipped (same bits; for an LM decode state that is
    a copy of every KV cache per step saved).
    """

    def masked(carry: SIRCarry, xs):
        observation, active = xs
        draws = carry.draws
        draws.set_active(active.tolist())
        new_carry, out = step(carry, observation)
        if bool(active.all()):
            return SIRCarry(draws, new_carry.ensemble), out
        ens = _select(active, new_carry.ensemble, carry.ensemble)
        return SIRCarry(draws, ens), neutral_output(out, active)

    return masked
