"""Transformer building blocks on torch (port of ``repro.models.lm.layers``).

Norms, RoPE, the attention block and the gated MLP, with the reference's
arithmetic: ``rms_norm`` and ``rope`` compute in float32 and cast back,
the norm's gain is ``1 + gamma``, RoPE rotates the two halves of each
head, qk-norm comes before RoPE.  Weights keep the reference's
``(in, out)`` layout, so a layer is ``x @ w``.

Attention goes through ``repro_torch.kernels.ops.attention``: the
flash-attention kernel (B6) on the card, its plain version on the CPU.
The reference's XLA path (query-chunked streaming softmax over grouped
einsums, ``chunked_causal_attention``, and the full-cache masked
``decode_attention``) computes the same function; its mesh-sharding
constraints have no counterpart on one card.  A sliding window (the
``L`` layer) is the kernel's ``window``: a query at position ``p`` sees
the keys ``p - window < j <= p``, the reference's mask.

Training runs ``chunked_causal_attention``, the reference's XLA path in
differentiable torch ops: the flash kernel has no backward (neither has
the reference's Pallas kernel) and refuses tensors that require grad.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim in float32, gain ``1 + gamma``, cast
    back to ``x``'s dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` ``(..., T, n_heads, head_dim)`` at integer
    ``positions`` ``(T,)``: the halves ``x1, x2`` become
    ``(x1 cos - x2 sin, x2 cos + x1 sin)``, in float32."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freq[None, :]   # (T, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: float | None = None) -> torch.Tensor:
    """Prefill attention: ``q`` ``(B, Hq, T, hd)`` against ``k``/``v``
    ``(B, Hkv, T, hd)``, causal (within ``window`` keys when it is > 0),
    GQA — the counterpart of the reference's ``chunked_causal_attention``
    (same function, one kernel call, which visits only the key tiles a
    query tile can see)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return ops.attention(q, k, v, causal=True, scale=scale,
                         logit_softcap=softcap, window=window)


NEG_INF_MASK = -1e30


def _masked_softmax(s: torch.Tensor, mask: torch.Tensor | None,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The reference's softmax: masked scores set to -1e30 (not -inf),
    ``exp(s - max)`` in the scores' dtype, a float32 denominator whose
    reciprocal is cast to that dtype, the product cast to ``out_dtype``."""
    if mask is not None:
        s = torch.where(mask, s, NEG_INF_MASK)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True, dtype=torch.float32)
    return (p * (1.0 / denom).to(p.dtype)).to(out_dtype)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int = 0,
                             chunk: int = 512, softcap: float = 0.0,
                             scale: float | None = None, causal: bool = True,
                             scores_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Training attention, the reference's ``chunked_causal_attention``
    (``repro/models/lm/layers.py:112-185``) in differentiable torch ops:
    ``q`` ``(B, Hq, T, hd)`` against ``k``/``v`` ``(B, Hkv, Tk, hd)``,
    GQA as grouped products (KV heads never repeated), one query chunk of
    ``chunk`` rows at a time (``T % chunk == 0``, the reference's
    contract).  A window > 0 masks ``q_pos - k_pos >= window`` and, where
    ``window + chunk < Tk``, gives each chunk only its ``window + chunk``
    keys (the reference's clipped slice).  ``causal=False`` attends to
    every key.

    The scores are a ``scores_dtype`` product of the operands (exact
    float32 products of bf16 values: the reference's einsum with
    ``preferred_element_type``), times ``scale`` in that dtype, soft-capped
    ``softcap · tanh(s / softcap)``; the softmax is ``_masked_softmax``'s,
    its probabilities in ``v``'s dtype.  This, and not the flash kernel
    (B6, forward only), is what training runs."""
    b, hq, t, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    qg = q.reshape(b, hkv, g, t, hd)
    use_slice = causal and window > 0 and (window + chunk) < tk
    kv_len = window + chunk if use_slice else tk
    scale_t = torch.tensor(scale, dtype=scores_dtype)
    outs = []
    for i in range(t // chunk):
        start = (min(max(i * chunk + chunk - kv_len, 0), tk - kv_len)
                 if use_slice else 0)
        k_c = k[:, :, start:start + kv_len].to(scores_dtype)
        v_c = v[:, :, start:start + kv_len]
        q_c = qg[:, :, :, i * chunk:(i + 1) * chunk].to(scores_dtype)
        s = (q_c.reshape(b, hkv, g * chunk, hd) @ k_c.transpose(-1, -2)
             ).view(b, hkv, g, chunk, kv_len) * scale_t
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        mask = None
        if causal:
            q_pos = i * chunk + torch.arange(chunk, device=q.device)
            k_pos = start + torch.arange(kv_len, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
        p = _masked_softmax(s, mask, v.dtype)
        o = p.view(b, hkv, g * chunk, kv_len) @ v_c
        outs.append(o.view(b, hkv, g, chunk, v.shape[-1]))
    return torch.cat(outs, dim=3).reshape(b, hq, t, v.shape[-1])


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Full (non-causal) attention of ``q`` ``(B, Hq, T, hd)`` over every
    key of ``k``/``v`` ``(B, Hkv, N, hd)`` — the reference's
    ``chunked_causal_attention(causal=False)`` of an X layer over the
    image tokens, at prefill and at decode."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return ops.attention(q, k, v, causal=False, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window: int = 0,
                     softcap: float = 0.0,
                     scale: float | None = None) -> torch.Tensor:
    """One-token attention ``q`` ``(B, Hq, 1, hd)`` against the caches
    ``(B, Hkv, L, hd)`` up to and including slot ``pos`` (the last
    ``window`` of them when it is > 0).  The kernel gets the cache view
    ``[..., :pos+1, :]`` with its strides, so its causal offset ``Lk -
    Lq`` is ``pos``, and the window: it reads only the window's keys (the
    split variant's keys start at the window's first).  The cache is
    never copied."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return ops.attention(q, k_cache[:, :, :pos + 1], v_cache[:, :, :pos + 1],
                         causal=True, scale=scale, logit_softcap=softcap,
                         window=window)


# ---------------------------------------------------------------------------
# Attention block and gated MLP
# ---------------------------------------------------------------------------

def normal_weight(shape, std: float, generator: torch.Generator,
                  dtype: torch.dtype) -> torch.Tensor:
    """``N(0, std²)`` weights of ``shape`` in ``dtype``, drawn from
    ``generator`` on its device (on the ``meta`` device, shapes alone)."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    out = torch.randn(shape, generator=generator, device=generator.device,
                      dtype=dtype)
    return out.mul_(std)


def attn_params(generator: torch.Generator, d_model: int, n_heads: int,
                n_kv: int, hd: int, qk_norm: bool,
                dtype: torch.dtype) -> dict:
    """Random attention weights with the reference's shapes and scales
    (``N(0, 1/d_model)`` projections, ``N(0, 1/(H·hd))`` output, zero
    qk-norm gains), drawn from ``generator`` on its device."""
    s, s_o = d_model ** -0.5, (n_heads * hd) ** -0.5
    g = generator
    p = {"wq": normal_weight((d_model, n_heads * hd), s, g, dtype),
         "wk": normal_weight((d_model, n_kv * hd), s, g, dtype),
         "wv": normal_weight((d_model, n_kv * hd), s, g, dtype),
         "wo": normal_weight((n_heads * hd, d_model), s_o, g, dtype)}
    if qk_norm:
        p["q_norm"] = torch.zeros(hd, dtype=dtype, device=generator.device)
        p["k_norm"] = torch.zeros(hd, dtype=dtype, device=generator.device)
    return p


def apply_qkv(p, x: torch.Tensor, n_heads: int, n_kv: int, hd: int,
              positions: torch.Tensor, theta: float, qk_norm: bool,
              eps: float):
    """``(q, k, v)`` as ``(B, H, T, hd)`` views of ``x`` ``(B, T, D)``'s
    projections: qk-norm (if on), then RoPE on q and k."""
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, n_heads, hd)
    k = (x @ p["wk"]).reshape(b, t, n_kv, hd)
    v = (x @ p["wv"]).reshape(b, t, n_kv, hd)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def mlp_params(generator: torch.Generator, d_model: int, d_ff: int,
               dtype: torch.dtype) -> dict:
    """Random gated-MLP weights with the reference's shapes and scales."""
    s_in, s_out, g = d_model ** -0.5, d_ff ** -0.5, generator
    return {"w_gate": normal_weight((d_model, d_ff), s_in, g, dtype),
            "w_up": normal_weight((d_model, d_ff), s_in, g, dtype),
            "w_down": normal_weight((d_ff, d_model), s_out, g, dtype)}


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """``(silu(x W_gate) * x W_up) W_down``."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
