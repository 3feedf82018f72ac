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
decoding: ``suspended_decode_session`` prefills prompts and packages
each as a ``SuspendedSession`` that ``ParticleSessionServer.resume``
hosts as a resident decode session.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import filters, smc as smc_core
from repro_torch.core.draws import BankDraws, TorchDraws, shard_draws
from repro_torch.core.particles import tree_map, weighted_mean
from repro_torch.models.lm import decode_ssm
from repro_torch.models.lm.decode_ssm import (  # noqa: F401  (re-exports)
    LMDecodeSSM, SMCDecodeConfig,
)
from repro_torch.models.lm.model import Decoder
from repro_torch.serve.engine import check_device
from repro_torch.serve.sessions import SuspendedSession, host


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
    decode_ssm.check_decodable(model.cfg)
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
    """Prefill prompts and package each as a ``SuspendedSession``.

    ``ParticleSessionServer.resume`` on one attaches its prompt as a
    resident decode session: frame ``t`` (a float32 step index, ``t = 1,
    2, ...``) advances it one token, as ``smc_decode``'s loop does.  The
    snapshot's history holds the prefill draw as frame 0 (its ``log_z0``,
    ``ess0`` and identity-ancestors row), so ``result()`` after ``steps -
    1`` served frames spans the whole decode.

    ``prompt`` is one ``(T0,)`` prompt (one session) or ``(B, T0)``
    prompts, prefilled in one call (a list of B sessions): the rows of
    ``smc_decode``'s prefill, so B sessions hosted together on one
    server decode bit for bit as ``smc_decode`` of those prompts with the
    same ``key`` (an int seed ``s`` gives prompt ``i`` the generator
    seeded ``shard_seed(s, i)``, or one ``TorchDraws`` a prompt).  All
    sessions on one server share one ``prompt_len`` and config, and
    advance together (``LMDecodeSSM``'s rows decode at one position).
    """
    dev = model.model.device
    prompts = torch.as_tensor(prompt, device=dev).to(torch.int64)
    single = prompts.dim() == 1
    prompts = prompts.reshape(-1, prompts.shape[-1])
    b = prompts.shape[0]
    if single and hasattr(key, "uniform"):
        key = [key]                  # one prompt's provider
    draws = prompt_draws(key, b, dev)
    if not all(isinstance(m, TorchDraws) for m in draws.members):
        raise TypeError("a suspended session resumes from a "
                        "torch.Generator's state: give an int seed or "
                        "TorchDraws providers")
    k_part = model.decode.n_particles
    with torch.inference_mode():
        carry, log_z0, ess0 = decode_ssm.decode_carry(model, draws, prompts)
        ens = carry.ensemble
        est0 = weighted_mean(ens.replace(
            state=model.estimate_state(ens.state)))
    sessions = [SuspendedSession(
        generator_state=m.generator.get_state().numpy().copy(),
        state=tree_map(lambda x: host(x[i]), ens.state),
        log_weights=host(ens.log_weights[i]), counts=host(ens.counts[i]),
        frames_done=1,
        estimates=tree_map(lambda x: host(x[i])[None], est0),
        ess=host(ess0[i])[None], log_marginal=host(log_z0[i])[None],
        resampled=np.zeros((1,), bool),
        ancestors=np.arange(k_part, dtype=np.int32)[None])
        for i, m in enumerate(draws.members)]
    return sessions[0] if single else sessions
