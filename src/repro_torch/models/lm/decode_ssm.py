"""LM decoding as a state-space model (port of
``repro.models.lm.decode_ssm``): the adapter that puts SMC decoding on
the shared filter substrate.

Decoding K hypotheses per prompt is a K-particle SIR filter over token
sequences.  The particle state is the decode state (KV caches, last
token, position, the emitted-token history); ``transition_sample`` is one
``forward_decode`` call plus a proposal draw from the τ-flattened
logits; ``observation_log_prob`` returns the importance increment
``log p(tok) − log q(tok)`` (plus an optional reward).  The conventions
are the reference's: the first token is drawn at prefill and its
increment folds into the initial weights; the token history rides in
the state, so the resampling gather keeps returned sequences
root-to-leaf paths of the recorded ancestry.

The reference vmaps its bank step over prompts; here every state leaf
leads with ``(B, K)`` — B prompts (the bank's slot dim) by K particles —
and ``transition_sample`` flattens them into ``B·K`` rows for one
``forward_decode`` call.  Each layer's KV cache is ``(B, K, Hkv, L, hd)``
and is written in place at the decode position (a recurrent layer's
state and conv leaves are replaced by the step's); ``gather_state``
gathers every leaf within each prompt's K particles.  All rows decode at
one position (the prompts share their length).  A MoE layer routes each
prompt's K rows on their own (``route_groups``, a group a prompt), as
the reference's step, vmapped over prompts, does: the prompts of one
call do not compete for an expert's capacity.  Archs with
cross-attention or K codebooks are refused (``check_decodable``): the
reference's adapter prefills without image inputs and draws one token a
particle.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core import smc
from repro_torch.core.particles import (ParticleEnsemble,
                                        effective_sample_size, tree_map)
from repro_torch.models.lm import model as M


@dataclasses.dataclass(frozen=True)
class SMCDecodeConfig:
    """SMC decoding knobs: K particles per prompt, proposal temperature
    τ (τ = 1 ⇒ proposal == target ⇒ uniform weights), and the shared
    ESS-triggered resampling decision."""

    n_particles: int = 8
    steps: int = 32
    proposal_temperature: float = 1.5
    ess_frac: float = 0.5
    resampler: str = "systematic"

    def sir(self) -> smc.SIRConfig:
        """The ``SIRConfig`` a decode filter runs under, with ancestry
        recording on."""
        return smc.SIRConfig(
            n_particles=self.n_particles, resampler=self.resampler,
            ess_frac=self.ess_frac, record_ancestry=True)


def check_decodable(cfg) -> None:
    """Raise ``ValueError`` for an arch SMC decoding does not take: the
    reference's adapter prefills without image embeddings (an X layer
    needs them) and draws one token per particle and step (a K-codebook
    head emits K)."""
    if cfg.cross_attn_every:
        raise ValueError(f"{cfg.name}: SMC decoding prefills token prompts "
                         f"alone, and this arch cross-attends to image "
                         f"embeddings (the reference's smc_decode cannot "
                         f"run it either)")
    if cfg.n_codebooks > 1:
        raise ValueError(f"{cfg.name}: SMC decoding draws one token a "
                         f"particle, and this arch emits "
                         f"{cfg.n_codebooks} codebooks a step (the "
                         f"reference's smc_decode cannot run it either)")


def _pick(log_probs: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    return log_probs.gather(-1, tok[..., None].long())[..., 0]


def _proposal(model: "LMDecodeSSM", draws, logits: torch.Tensor):
    """Target and proposal log-probabilities of ``(..., V)`` logits and a
    token drawn from the proposal: ``argmax(q_log + gumbel)``, the
    reference's ``jax.random.categorical``."""
    p_log = torch.log_softmax(logits, -1)
    q_log = torch.log_softmax(logits / model.decode.proposal_temperature, -1)
    member = tuple(q_log.shape[len(draws.batch_shape):])
    tok = (draws.gumbel(member) + q_log).argmax(-1).to(torch.int32)
    return p_log, q_log, tok


def _position(draws, pos: torch.Tensor) -> int:
    """The one decode position of a step: every row decodes at it (one
    ``forward_decode`` call), so every prompt that draws this step (a
    bank's active slots; all rows otherwise) must be at it.  Sessions
    hosted on one server therefore advance together; an idle row in the
    step has its cache written at this position, which its own next
    step at that position overwrites."""
    per_prompt = pos[..., 0].reshape(-1)
    active = getattr(draws, "active", None)
    live = per_prompt
    if active is not None and any(active):
        live = per_prompt[torch.tensor(active, device=pos.device)]
    at = int(live[0])
    if not bool((live == at).all()):
        raise ValueError(f"prompts decoding in one step are at positions "
                         f"{sorted(set(live.tolist()))}: one step decodes "
                         f"every row at one position (sessions on one "
                         f"server advance together)")
    return at


@dataclasses.dataclass(frozen=True, eq=False)
class LMDecodeSSM:
    """The LM-as-``StateSpaceModel`` adapter (B prompts × K particles).

    The particle state is a dict whose leaves lead with ``(B, K)``:
    ``caches`` (per layer the model's cache dict with ``(B, K)`` leading
    its leaves, e.g. ``{"k", "v"}`` of ``(B, K, Hkv, max_len, hd)``),
    ``token`` (last sampled), ``pos`` (decode position),
    ``emitted`` (tokens so far), ``inc`` (the pending increment
    ``log p − log q``), ``logp`` (cumulative target log-probability) and
    ``tokens`` (``(B, K, steps)`` history).  ``reward`` optionally scores
    ``(state, observation) -> (B, K)`` extra log-weight per step.
    """

    model: M.Decoder
    decode: SMCDecodeConfig
    prompt_len: int
    reward: Optional[Callable[[Any, Any], torch.Tensor]] = None
    state_dim: int = 1

    @property
    def cfg(self):
        """The decoder's arch config."""
        return self.model.cfg

    @property
    def max_len(self) -> int:
        """KV-cache capacity: prompt + decode steps + 1 slack slot."""
        return self.prompt_len + self.decode.steps + 1

    def init(self, draws, n: int) -> Any:
        """A blank (all-zeros) decode state of ``draws.batch_shape + (n,)``
        particles; real decoding starts from ``prefill_state``."""
        lead = tuple(draws.batch_shape) + (n,)
        dev = self.model.device
        caches = M.init_caches(self.cfg, math.prod(lead), self.max_len,
                               device=dev, dtype=self.model.dtype)

        def zeros(dtype, *tail):
            return torch.zeros(lead + tail, dtype=dtype, device=dev)

        return {
            "caches": tree_map(lambda c: c.view(lead + c.shape[1:]), caches),
            "token": zeros(torch.int32),
            "pos": torch.full(lead, self.prompt_len, dtype=torch.int32,
                              device=dev),
            "emitted": zeros(torch.int32), "inc": zeros(torch.float32),
            "logp": zeros(torch.float32),
            "tokens": zeros(torch.int32, self.decode.steps),
        }

    def transition_sample(self, draws, state: Any) -> Any:
        """One decode step: ``forward_decode`` on every particle's last
        token (the KV caches gain the token's K/V in place, the recurrent
        leaves are new), then a proposal draw; the increment waits in
        ``state["inc"]``."""
        lead = tuple(state["token"].shape)
        rows = math.prod(lead)
        pos = _position(draws, state["pos"])
        flat = tree_map(lambda c: c.view((rows,) + c.shape[len(lead):]),
                        state["caches"])
        logits, flat = M.forward_decode(self.model,
                                        state["token"].reshape(rows, 1),
                                        pos, flat,
                                        route_groups=rows // lead[-1])
        logits = logits[:, 0].float().reshape(lead + (-1,))
        p_log, q_log, tok = _proposal(self, draws, logits)
        tokens = state["tokens"].scatter(
            -1, state["emitted"][..., None].long(), tok[..., None])
        caches = tree_map(lambda c: c.view(lead + c.shape[1:]), flat)
        return {"caches": caches, "token": tok,
                "pos": state["pos"] + 1, "emitted": state["emitted"] + 1,
                "inc": _pick(p_log, tok) - _pick(q_log, tok),
                "logp": state["logp"] + _pick(p_log, tok), "tokens": tokens}

    def observation_log_prob(self, state: Any, observation: Any):
        """The importance increment of the token just drawn, plus the
        reward score.  ``observation`` is the decode-step index."""
        inc = state["inc"]
        if self.reward is not None:
            inc = inc + self.reward(state, observation)
        return inc

    def emission(self, state: Any) -> torch.Tensor:
        """Genealogy emission: the token sampled this step."""
        return state["token"]

    def estimate_state(self, state: Any) -> Any:
        """Per-step estimate: the cumulative target log-probability."""
        return {"logp": state["logp"]}

    def gather_state(self, state: Any, ancestors: torch.Tensor) -> Any:
        """Resampling gather of every leaf within each prompt's K
        particles: only ancestor indices cross, replicas are a local
        gather of caches and histories (the paper's §V compressed
        particles).  Each particle's slice of a leaf is one contiguous
        row of the flattened ``(B·K, ...)`` leaf, so the gather is a row
        ``index_select``; where every prompt kept the identity (no
        resample this step) the state is returned as it is — the same
        bits without copying the caches."""
        k = ancestors.shape[-1]
        lane = torch.arange(k, dtype=ancestors.dtype, device=ancestors.device)
        if bool((ancestors == lane).all()):
            return state
        base = torch.arange(0, ancestors.numel(), k, device=ancestors.device)
        rows = (ancestors.reshape(-1, k).long() + base[:, None]).reshape(-1)
        lead = ancestors.dim()

        def gather(x):
            flat = x.reshape((-1,) + x.shape[lead:])
            return flat.index_select(0, rows).view(x.shape)

        return tree_map(gather, state)


def prefill_state(model: LMDecodeSSM, draws, prompts: torch.Tensor):
    """Prefill the ``(B, T0)`` prompts for K particles each and draw the
    first token.

    Every prompt is replicated over its K rows and the ``B·K`` rows are
    prefilled in one call (a MoE layer routing each prompt's K rows on
    their own, as the reference prefills a prompt at a time); the first token is drawn from the τ-flattened
    next-token distribution (one ``(K, V)`` Gumbel draw per prompt) and
    its increment ``p₀ − q₀`` folds into the weights.  Returns
    ``(state, log_weights (B, K), log_z0 (B,))``.
    """
    check_decodable(model.cfg)
    dec = model.decode
    k_part = dec.n_particles
    b, t0 = prompts.shape
    rep = prompts[:, None, :].expand(b, k_part, t0).reshape(b * k_part, t0)
    h_last, caches = M.forward_prefill(model.model, rep,
                                       max_len=model.max_len,
                                       route_groups=b)
    logits = M.unembed(model.model, h_last)[:, 0].float()
    p_log, q_log, first = _proposal(model, draws,
                                    logits.reshape(b, k_part, -1))
    inc0 = _pick(p_log, first) - _pick(q_log, first)
    lw_unnorm = inc0 - torch.log(torch.tensor(float(k_part)))
    log_z0 = torch.logsumexp(lw_unnorm, -1)
    dev = prompts.device
    tokens = torch.zeros((b, k_part, dec.steps), dtype=torch.int32,
                         device=dev)
    tokens[..., 0] = first
    state = {
        "caches": tree_map(lambda c: c.view((b, k_part) + c.shape[1:]),
                           caches),
        "token": first,
        "pos": torch.full((b, k_part), t0, dtype=torch.int32, device=dev),
        "emitted": torch.ones((b, k_part), dtype=torch.int32, device=dev),
        "inc": inc0, "logp": _pick(p_log, first), "tokens": tokens,
    }
    return state, lw_unnorm - log_z0[..., None], log_z0


def decode_carry(model: LMDecodeSSM, draws, prompts: torch.Tensor):
    """A bank carry ready for the shared SIR step: ``(SIRCarry, log_z0,
    ess0)``, the step-0 log-normalizer increment and ESS of the
    prefill-sampled first token.  ``draws`` has ``batch_shape (B,)``, one
    stream per prompt: its first draw is the prefill's, as the
    reference's init stream."""
    state, lw0, log_z0 = prefill_state(model, draws, prompts)
    ens = ParticleEnsemble(state=state, log_weights=lw0,
                           counts=torch.ones_like(lw0, dtype=torch.int32))
    return smc.SIRCarry(draws, ens), log_z0, effective_sample_size(lw0)
