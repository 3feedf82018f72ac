"""Batched generation engine (port of ``repro.serve.engine``): prefill
once, then decode one token per step against the KV cache.

``generate`` returns tokens 1..steps — the prefill-sampled first token
included — as the reference does.  The reference scans ``steps`` decode
calls and drops the last call's sample; here the loop makes the
``steps - 1`` decode calls whose samples are returned, so the tokens are
the same with one forward pass fewer.  Sampling is greedy
(``temperature == 0``, argmax) or categorical at ``temperature``:
``argmax(logits / T + gumbel)``, with the Gumbel noise from a draws
provider (``repro_torch.core.draws``): first the prefill token's, then
one ``(B, V)`` draw per decode step.  With K codebooks (musicgen) the
logits are ``(B, K, V)`` and each codebook is sampled on its own, as the
reference does (``(B, K, V)`` draws); an arch with cross-attention takes
the prompts' image embeddings ``img`` at prefill.
"""
from __future__ import annotations

import torch

from repro_torch.core.draws import as_draws
from repro_torch.core.filters import resolve_device
from repro_torch.models.lm import model as M


def _sample(logits: torch.Tensor, temperature: float, draws) -> torch.Tensor:
    if temperature <= 0:
        return logits.argmax(-1).to(torch.int32)
    return (draws.gumbel(tuple(logits.shape)) + logits / temperature) \
        .argmax(-1).to(torch.int32)


def check_device(model: M.Decoder, device) -> torch.device:
    """The run's device (``None`` means CUDA, and raises without one);
    the model's weights must be there."""
    device = resolve_device(device)
    if model.device.type != device.type or (
            device.index is not None and model.device != device):
        raise ValueError(f"the model lives on {model.device}, the run is "
                         f"on {device}")
    return model.device


def generate(model: M.Decoder, prompt, *, steps: int = 32,
             temperature: float = 0.0, key=None, img=None,
             device=None) -> torch.Tensor:
    """``prompt`` ``(B, T0)`` token ids (``(B, T0, K)`` with K codebooks)
    → generated ``(B, steps)`` (``(B, steps, K)``) int32.

    ``temperature == 0`` is greedy argmax decoding; ``temperature > 0``
    samples with noise from ``key`` (an int seed, a ``torch.Generator``
    or a draws provider; default seed 0).  ``img`` ``(B, n_image,
    d_image)`` are the image embeddings of an arch with cross-attention.
    Runs on the CUDA device unless ``device`` says otherwise.
    """
    device = check_device(model, device)
    prompt = torch.as_tensor(prompt, device=device).to(torch.int64)
    t0 = prompt.shape[1]
    if img is not None:
        img = torch.as_tensor(img, device=device)
    draws = None if temperature <= 0 else as_draws(
        0 if key is None else key, device)
    with torch.inference_mode():
        h_last, caches = M.forward_prefill(model, prompt,
                                           max_len=t0 + steps + 1, img=img)
        tok = _sample(M.unembed(model, h_last)[:, 0].float(), temperature,
                      draws)
        out = [tok]
        for i in range(steps - 1):
            logits, caches = M.forward_decode(model, tok[:, None], t0 + i,
                                              caches)
            tok = _sample(logits[:, 0].float(), temperature, draws)
            out.append(tok)
    return torch.stack(out, dim=1)
