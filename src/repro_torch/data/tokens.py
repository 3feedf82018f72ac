"""Deterministic synthetic LM batches on torch (port of
``repro.data.tokens``).

Every batch is a pure function of ``(seed, step, cfg)``: a
``torch.Generator`` seeded from ``(seed, step)`` draws, in this order,
the token uniforms ``U[1e-6, 1)``, the repeat uniforms ``U[0, 1)`` and,
for a cross-attending arch, the image embeddings' normals, on the
batch's device.  torch cannot replay the reference's threefry streams,
so the draws can also be handed in (``uniforms``), as the filter side's
are.  From the draws on, the transform is the reference's:

* a Zipf-like token ``clip(int32(u ** -1.6), 0, vocab - 1)`` in float32,
  the cast saturating as XLA's does (``u < 2^-19.375 ≈ 1.47e-6`` gives
  ``r > 2^31``, which XLA casts to ``2^31 - 1`` and so to ``vocab - 1``;
  torch's own cast would wrap it to ``-2^31`` and so to 0);
* with probability 0.3 (``u < 0.3``) the token two positions back
  (``roll(stream, 2, axis=1)``, wrapping at the start as the reference);
* ``tokens = stream[:, :-1]``, ``targets = stream[:, 1:]``, with a
  trailing codebook axis for a multi-codebook arch.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

_INT32_MAX = 2 ** 31 - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _mix(seed: int, step: int) -> int:
    """The generator seed of batch ``(seed, step)``: splitmix64 of both,
    so its low 32 bits (all that a CPU generator keeps) depend on each."""
    return _splitmix64(_splitmix64(seed) ^ step) >> 1


def stream_shape(cfg: ArchConfig, batch: int, seq: int) -> tuple:
    """The shape of the ``seq + 1`` token stream a batch is cut from."""
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return (batch, seq + 1) + books


def _saturating_int32(r: torch.Tensor) -> torch.Tensor:
    """XLA's float32 → int32 cast: truncation, saturating at the int32
    range (the float32 just below 2^31 is 2^31 - 128)."""
    out = r.clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(torch.int32)
    return torch.where(r >= 2.0 ** 31, _INT32_MAX, out)


def zipf_tokens(u: torch.Tensor, vocab: int) -> torch.Tensor:
    """Tokens from ``U[1e-6, 1)`` uniforms: ``clip(int32(u ** -1.6), 0,
    vocab - 1)``."""
    r = torch.pow(u.to(torch.float32), -1.6)
    return _saturating_int32(r).clamp(0, vocab - 1)


def draw_uniforms(seed: int, step: int, cfg: ArchConfig, batch: int,
                  seq: int, device) -> dict:
    """The draws of batch ``(seed, step)``: ``"tokens"`` (U[1e-6, 1)),
    ``"repeat"`` (U[0, 1)), and ``"image"`` (standard normals ``(batch,
    n_image_tokens, d_image)``) for a cross-attending arch."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(_mix(int(seed), int(step)))
    shape = stream_shape(cfg, batch, seq)
    u = torch.rand(shape, generator=g, device=device)
    out = {"tokens": torch.clamp(u * (1.0 - 1e-6) + 1e-6, min=1e-6),
           "repeat": torch.rand(shape, generator=g, device=device)}
    if cfg.cross_attn_every:
        out["image"] = torch.randn(
            (batch, cfg.n_image_tokens, cfg.d_image), generator=g,
            device=device)
    return out


def make_batch(seed: int, step: int, cfg: ArchConfig, batch: int, seq: int,
               *, device, uniforms: dict | None = None) -> dict:
    """One global training batch for ``cfg`` at ``step``: int32
    ``tokens`` and ``targets`` ``(batch, seq[, K])`` and, for a
    cross-attending arch, float32 ``image_embeds``, on ``device``.
    ``uniforms`` (``draw_uniforms``' keys, any device) replaces the
    generator's draws."""
    device = torch.device(device)
    u = uniforms if uniforms is not None else draw_uniforms(
        seed, step, cfg, batch, seq, device)
    stream = zipf_tokens(u["tokens"].to(device), cfg.vocab_size)
    if stream.shape != stream_shape(cfg, batch, seq):
        raise ValueError(f"uniforms of shape {tuple(stream.shape)} for a "
                         f"{stream_shape(cfg, batch, seq)} stream")
    rep = u["repeat"].to(device=device, dtype=torch.float32) < 0.3
    stream = torch.where(rep, torch.roll(stream, 2, dims=1), stream)
    out = {"tokens": stream[:, :-1], "targets": stream[:, 1:]}
    if cfg.cross_attn_every:
        out["image_embeds"] = 0.02 * u["image"].to(device=device,
                                                   dtype=torch.float32)
    return out
