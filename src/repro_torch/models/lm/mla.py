"""Multi-head latent attention on torch (port of ``repro.models.lm.mla``;
DeepSeek-V2, arXiv:2405.04434).

K and V are compressed to a ``kv_lora_rank`` latent plus one shared
``qk_rope_dim`` rotary key, so the cache is ``{"c": (B, L, r), "pe":
(B, L, drope)}`` whatever the head count.  Two paths, as the reference's:

* ``mla_attention`` (prefill and training): decompress K and V per head
  and make one attention call at q/k head dim ``qk_nope_dim +
  qk_rope_dim`` and v head dim ``v_head_dim`` (192 and 128 at full
  width), with the explicit scale ``(dqk + drope)^-0.5``: at prefill
  ``ops.attention`` (B6 on the card), in training the reference's
  ``chunked_causal_attention`` in differentiable torch ops (B6 has no
  backward);
* ``mla_decode_absorbed`` (decode): the absorbed form, W^UK folded into
  the query and W^UV applied after the latent sum, so decode never
  builds per-head K/V.  It stays torch products and a float32 softmax
  (the latent sum accumulated in float32), as the reference computes it
  in XLA einsums outside any Pallas kernel.

Over a process grid's ``model`` axis (``model._latent_attention``) a
rank holds its heads' columns of ``wq_b``, ``wk_b``, ``wv_b`` and rows
of ``wo``; the low-rank in-projections and their norms (``REPLICATED``)
are whole on every rank.  The decode is then sequence-parallel over the
latent cache's length shards: ``absorbed_query`` on the rank's heads,
``latent_partials`` of every head over the rank's positions,
``ops.combine_partials`` of the ranks' partials in rank order and
``absorbed_output`` on the rank's heads again.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels import ops
from repro_torch.models.lm.layers import (chunked_causal_attention,
                                          normal_weight, rms_norm, rope)


# the leaves every rank of a model axis holds whole
REPLICATED = ("wq_a", "q_norm", "wkv_a", "kv_norm")


def mla_params(generator: torch.Generator, d_model: int, n_heads: int,
               cfg: MLAConfig, dtype: torch.dtype) -> dict:
    """Random latent-attention weights with the reference's shapes and
    scales (``N(0, 1/fan_in)`` projections, zero norm gains), drawn from
    ``generator`` on its device."""
    g, r, qr = generator, cfg.kv_lora_rank, cfg.q_lora_rank
    dqk, drope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    s = d_model ** -0.5
    return {
        # query low-rank path: D -> qr -> H·(dqk + drope)
        "wq_a": normal_weight((d_model, qr), s, g, dtype),
        "q_norm": torch.zeros(qr, dtype=dtype, device=g.device),
        "wq_b": normal_weight((qr, n_heads * (dqk + drope)), qr ** -0.5, g,
                              dtype),
        # kv low-rank: D -> (r latent + drope shared rotary key)
        "wkv_a": normal_weight((d_model, r + drope), s, g, dtype),
        "kv_norm": torch.zeros(r, dtype=dtype, device=g.device),
        # decompression: latent -> per-head nope key / value
        "wk_b": normal_weight((r, n_heads * dqk), r ** -0.5, g, dtype),
        "wv_b": normal_weight((r, n_heads * dv), r ** -0.5, g, dtype),
        "wo": normal_weight((n_heads * dv, d_model), (n_heads * dv) ** -0.5,
                            g, dtype),
    }


def mla_compress(p, x: torch.Tensor, positions: torch.Tensor, theta: float,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(B, T, D)`` -> the normed latent ``c_kv`` ``(B, T, r)`` and
    the rotated shared key ``k_pe`` ``(B, T, drope)``."""
    r = p["kv_norm"].shape[0]
    kv = x @ p["wkv_a"]
    c_kv = rms_norm(kv[..., :r], p["kv_norm"], eps)
    k_pe = rope(kv[..., r:][:, :, None, :], positions, theta)[:, :, 0, :]
    return c_kv, k_pe


def _queries(p, x: torch.Tensor, n_heads: int, cfg: MLAConfig,
             positions: torch.Tensor, theta: float, eps: float):
    """``(q_nope, q_pe)``: ``(B, T, H, dqk)`` and the rotated ``(B, T, H,
    drope)``."""
    b, t, _ = x.shape
    dqk = cfg.qk_nope_dim
    q = rms_norm(x @ p["wq_a"], p["q_norm"], eps) @ p["wq_b"]
    q = q.reshape(b, t, n_heads, dqk + cfg.qk_rope_dim)
    return q[..., :dqk], rope(q[..., dqk:], positions, theta)


def mla_attention(p, x: torch.Tensor, n_heads: int, cfg: MLAConfig, *,
                  positions: torch.Tensor, theta: float, eps: float,
                  cache: dict | None = None, chunk: int | None = None,
                  scores_dtype: torch.dtype = torch.float32,
                  cache_first: int = 0) -> torch.Tensor:
    """Prefill or training: ``x`` ``(B, T, D)`` -> ``(B, T, D)``.  K and
    V are decompressed per head, q and k are the nope and rope parts side
    by side (``cat``: contiguous, 16-byte aligned rows), and one causal
    attention call at scale ``(dqk + drope)^-0.5`` handles both terms:
    ``ops.attention``, or with ``chunk`` (training, the reference's
    ``mla.py:76-102``) ``chunked_causal_attention`` at that query chunk
    and ``scores_dtype``.  With ``cache`` (``{"c", "pe"}`` of ``max_len``
    slots) the latent and rotary key fill its first T slots in place; with
    ``cache_first`` the cache is a length shard whose slots hold the
    positions from that one on, and the positions of x that fall there
    fill it."""
    b, t, _ = x.shape
    dqk, drope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_pe = _queries(p, x, n_heads, cfg, positions, theta, eps)
    c_kv, k_pe = mla_compress(p, x, positions, theta, eps)
    if cache is not None:
        n = min(t - cache_first, cache["c"].shape[1])
        if n > 0:
            cache["c"][:, :n] = c_kv[:, cache_first:cache_first + n]
            cache["pe"][:, :n] = k_pe[:, cache_first:cache_first + n]
    k_nope = (c_kv @ p["wk_b"]).reshape(b, t, n_heads, dqk)
    v = (c_kv @ p["wv_b"]).reshape(b, t, n_heads, dv)
    q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, t, n_heads, drope)],
                  -1).transpose(1, 2)
    scale = (dqk + drope) ** -0.5
    if chunk is None:
        o = ops.attention(q, k, v.transpose(1, 2), causal=True, scale=scale)
    else:
        o = chunked_causal_attention(q, k, v.transpose(1, 2), chunk=chunk,
                                     scale=scale, scores_dtype=scores_dtype)
    return o.transpose(1, 2).reshape(b, t, n_heads * dv) @ p["wo"]


def mla_decode_absorbed(p, x: torch.Tensor, n_heads: int, cfg: MLAConfig, *,
                        c_cache: torch.Tensor, pe_cache: torch.Tensor,
                        pos: int, theta: float, eps: float) -> torch.Tensor:
    """Absorbed decode of ``x`` ``(B, 1, D)`` at position ``pos`` against
    the caches ``(B, L, r)`` / ``(B, L, drope)``, slot ``pos`` already
    written:

        score_h(t) = (W^UK_hᵀ q_nope_h) · c_t + q_pe_h · k_pe_t
        out_h      = W^UV_h Σ_t a_t c_t

    It reads the caches' ``[:, :pos + 1]`` views; the reference masks the
    later slots to ``-inf``, which add exact zeros, so the result is the
    same.  It is ``absorbed_query``, ``latent_partials`` over the one
    shard (the float32 latent sum, normalized) and ``absorbed_output``:
    the model's decode (``model._latent_sp_decode``) composes the same
    pieces over a cache's length shards, and on one device gives these
    bits."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_lat, q_pe = absorbed_query(p, x, n_heads, cfg, positions, theta, eps)
    o_lat, _ = latent_partials(q_lat, q_pe, c_cache[:, :pos + 1],
                               pe_cache[:, :pos + 1],
                               (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    return absorbed_output(p, o_lat.to(x.dtype), n_heads, cfg)


def absorbed_query(p, x: torch.Tensor, n_heads: int, cfg: MLAConfig,
                   positions: torch.Tensor, theta: float, eps: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """A decode token's ``(q_lat, q_pe)``: ``W^UK`` absorbed into each
    head's nope query, ``(B, H, r)``, and the rotated rope query ``(B, H,
    drope)``, for the ``n_heads`` heads of ``p``'s columns."""
    r, dqk = p["kv_norm"].shape[0], cfg.qk_nope_dim
    q_nope, q_pe = _queries(p, x, n_heads, cfg, positions, theta, eps)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                         p["wk_b"].reshape(r, n_heads, dqk))
    return q_lat, q_pe[:, 0]


def latent_partials(q_lat: torch.Tensor, q_pe: torch.Tensor,
                    c: torch.Tensor, pe: torch.Tensor,
                    scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Every head's partial over the positions of ``c`` ``(B, n, r)`` /
    ``pe`` ``(B, n, drope)`` (a length shard's visible slots), float32:
    ``(o, lse)``, the normalized latent sum ``(B, H, r)`` and the
    log-sum-exp ``(B, H)`` of the scores ``s_t = (q_lat · c_t + q_pe ·
    pe_t)·scale``, which ``ops.combine_partials`` weighs shards by.  No
    position gives ``o = 0`` and ``lse = -inf``."""
    b, h, r = q_lat.shape
    if c.shape[1] == 0:
        return (q_lat.new_zeros((b, h, r), dtype=torch.float32),
                torch.full((b, h), -torch.inf, device=q_lat.device))
    s = (torch.einsum("bhr,blr->bhl", q_lat, c)
         + torch.einsum("bhd,bld->bhl", q_pe, pe)).float() * scale
    lse = torch.logsumexp(s, -1)
    a = torch.exp(s - lse[..., None])
    return torch.einsum("bhl,blr->bhr", a, c.float()), lse


def absorbed_output(p, o_lat: torch.Tensor, n_heads: int,
                    cfg: MLAConfig) -> torch.Tensor:
    """``W^UV`` of each head applied to its latent sum ``(B, H, r)``, then
    ``wo``: ``(B, 1, D)``."""
    r, dv = o_lat.shape[-1], cfg.v_head_dim
    o = torch.einsum("bhr,rhd->bhd", o_lat, p["wv_b"].reshape(r, n_heads, dv))
    return o.reshape(o.shape[0], 1, n_heads * dv) @ p["wo"]
