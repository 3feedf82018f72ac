"""SMC (particle-filter) decoding (port of ``repro.serve.smc_decode``):
the paper's technique as a serving feature.

Each prompt carries K particles, the decode hypotheses.  The model side
is ``repro_torch.models.lm.decode_ssm.LMDecodeSSM``; ``smc_decode`` is
the decode loop over the shared ``filters.make_bank_step`` (the
composed ``make_sir_step`` under the per-slot mask, with ancestry
recording) over the prompts as bank slots — the same step the tracking
FilterBank runs.  Weights and normalizers follow the shared SIR
conventions: ``logsumexp(lw) == 0`` entering every step, each step's
``log_z`` is the marginal-likelihood increment, and the total ``log_z``
sums every increment including the prefill draw's.

Prompt ``i`` draws from its own stream: an int seed ``s`` gives it a
``torch.Generator`` seeded ``shard_seed(s, i)``; the tests hand in one
replay of the reference's key stream per prompt.  Session-hosted
decoding (``suspended_decode_session``) needs ``serve/sessions.py`` and
waits for ROADMAP A11.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core import filters, smc as smc_core
from repro_torch.core.draws import BankDraws, shard_draws
from repro_torch.models.lm import decode_ssm
from repro_torch.models.lm.decode_ssm import (  # noqa: F401  (re-exports)
    LMDecodeSSM, SMCDecodeConfig,
)
from repro_torch.models.lm.model import Decoder
from repro_torch.serve.engine import check_device


class SMCDecodeResult(NamedTuple):
    """Everything one SMC decode run produces, per prompt.  Row 0 of the
    per-step fields is the prefill-sampled first token (identity
    ancestors, ``resampled`` False, the ``p₀ − q₀`` increment)."""

    sequences: torch.Tensor     # (B, K, steps) lineage-coherent token rows
    log_weights: torch.Tensor   # (B, K) final normalized log-weights
    log_z: torch.Tensor         # (B,) total log-normalizer estimate
    ess: torch.Tensor           # (steps, B) effective sample size per step
    log_marginal: torch.Tensor  # (steps, B) per-step increments
    resampled: torch.Tensor     # (steps, B) ESS-trigger trace
    ancestors: torch.Tensor     # (steps, B, K) recorded ancestor indices
    emissions: torch.Tensor     # (steps, B, K) pre-gather token draws


def prompt_draws(key, b: int, device) -> BankDraws:
    """One draws stream per prompt: an int seed (default 0), a provider
    with ``batch_shape (B,)``, or a sequence of ``B`` providers."""
    if key is None:
        key = 0
    if isinstance(key, Sequence) and not isinstance(key, (str, bytes)):
        if len(key) != b:
            raise ValueError(f"{len(key)} draws providers for {b} prompts")
        return BankDraws(list(key))
    return shard_draws(key, b, device)


def smc_decode(model: Decoder, prompt,
               smc: SMCDecodeConfig = SMCDecodeConfig(), *, key=None,
               reward=None, device=None) -> SMCDecodeResult:
    """Decode ``prompt`` ``(B, T0)`` with K SMC hypotheses per prompt.

    The B·K rows prefill in one call and then decode together, one
    ``forward_decode`` per step, for ``smc.steps - 1`` steps after the
    prefill draw.  Runs on the CUDA device unless ``device`` says
    otherwise.
    """
    device = check_device(model, device)
    prompt = torch.as_tensor(prompt, device=device).to(torch.int64)
    b, t0 = prompt.shape
    k_part = smc.n_particles
    draws = prompt_draws(key, b, device)
    ssm = LMDecodeSSM(model=model, decode=smc, prompt_len=t0, reward=reward)
    with torch.inference_mode():
        carry, log_z0, ess0 = decode_ssm.decode_carry(ssm, draws, prompt)
        first = carry.ensemble.state["tokens"][..., 0]
        step = filters.make_bank_step(ssm, smc.sir())
        active = torch.ones(b, dtype=torch.bool, device=device)
        outs = []
        for t in range(1, smc.steps):
            obs = torch.full((b,), float(t), device=device)
            carry, out = step(carry, (obs, active))
            outs.append(out)
        ident = torch.arange(k_part, dtype=torch.int32,
                             device=device).expand(1, b, k_part)
        rows = [(log_z0[None], ess0[None], torch.zeros(
            (1, b), dtype=torch.bool, device=device), ident, first[None])]
        if outs:
            o = smc_core.stack_outputs(outs)
            rows.append((o.log_marginal, o.ess, o.resampled,
                         o.ancestors.to(torch.int32), o.diag["emission"]))
        log_marginal, ess, resampled, ancestors, emissions = (
            torch.cat(parts) for parts in zip(*rows))
        ens = carry.ensemble
        return SMCDecodeResult(
            sequences=ens.state["tokens"], log_weights=ens.log_weights,
            log_z=log_marginal.sum(0), ess=ess, log_marginal=log_marginal,
            resampled=resampled, ancestors=ancestors, emissions=emissions)


def suspended_decode_session(model: LMDecodeSSM, key, prompt):
    """Session-hosted decoding needs ``serve/sessions.py``; it waits for
    ROADMAP A11."""
    raise NotImplementedError("suspended_decode_session needs "
                              "serve/sessions.py (ROADMAP A11)")
