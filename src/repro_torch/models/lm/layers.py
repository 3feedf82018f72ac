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
    ``generator`` on its device."""
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
