"""RG-LRU recurrent blocks on torch (port of ``repro.models.lm.rglru``;
RecurrentGemma / Griffin, arXiv:2402.19427).

The recurrence ``h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)`` is a
first-order linear recurrence.  The reference runs it as a
``jax.lax.associative_scan`` over T; here prefill runs the same
log-depth scan (Hillis–Steele: ``ceil(log2 T)`` passes of torch ops on
the whole ``(B, T, W)`` float32 state, each out of place, so autograd
differentiates it and training runs the same scan), and decode is one
update.  The
reference's arithmetic is kept: the gates in float32 from the
compute-dtype conv output, the causal conv as a sum of shifted taps in
the compute dtype, ``gelu`` with the tanh approximation (JAX's default).
No hand-written kernel: the reference computes this in XLA, not Pallas
(a fused scan kernel is a later speed item, ROADMAP).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.models.lm.layers import normal_weight

_C = 8.0   # the paper's fixed recurrence temperature


def rglru_params(generator: torch.Generator, d_model: int, cfg: RGLRUConfig,
                 dtype: torch.dtype) -> dict:
    """Random RG-LRU weights with the reference's shapes and scales, drawn
    from ``generator`` on its device; ``lam`` is the reference's fixed
    init (``a = σ(Λ)^c`` in (0.9, 0.999))."""
    w, g, dev = cfg.lru_width, generator, generator.device
    s, s_w = d_model ** -0.5, w ** -0.5
    lin = torch.linspace(2.0, 6.0, w, dtype=torch.float32, device=dev)
    return {
        "w_x": normal_weight((d_model, w), s, g, dtype),
        "w_gate_in": normal_weight((d_model, w), s, g, dtype),
        "conv_w": normal_weight((cfg.conv_width, w), 0.1, g, dtype),
        "conv_b": torch.zeros(w, dtype=dtype, device=dev),
        "w_rec_gate": normal_weight((w, w), s_w, g, dtype),
        "w_in_gate": normal_weight((w, w), s_w, g, dtype),
        "lam": torch.log(torch.exp(lin) - 1.0).to(dtype),
        "w_out": normal_weight((w, d_model), s_w, g, dtype),
    }


def _gates(p, xw: torch.Tensor):
    """The decay ``a`` and gated input of ``xw`` ``(..., W)``, float32."""
    r = torch.sigmoid((xw @ p["w_rec_gate"]).float())
    i = torch.sigmoid((xw @ p["w_in_gate"]).float())
    log_a = r * (-_C * F.softplus(p["lam"]))          # log σ(Λ)^c · r (< 0)
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-12)) * (i * xw.float())
    return a, gated_in


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along T of ``x`` ``(B, T, W)`` with taps ``w``
    ``(K, W)``: the reference's sum of shifted taps, in order."""
    k, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + t] * w[i]
    return out + b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``) along dim 1: the
    Hillis–Steele scan of the reference's ``associative_scan`` combine
    ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``, in ``ceil(log2 T)``
    passes.  Each pass builds new tensors (the first ``s`` steps kept, the
    rest combined), so autograd's version checks pass and the backward is
    elementwise products and sums: no index accumulates."""
    h = b
    t, s = a.shape[1], 1
    for _ in range(math.ceil(math.log2(t)) if t > 1 else 0):
        h = torch.cat([h[:, :s], a[:, s:] * h[:, :-s] + h[:, s:]], 1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], 1)
        s *= 2
    return h


def conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k - 1`` steps of ``x`` ``(B, T, C)`` (zeros before step
    0): the causal conv's carried inputs."""
    tail = x[:, max(0, x.shape[1] - (k - 1)):]
    return F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))


def rglru_forward(p, x: torch.Tensor, cfg: RGLRUConfig,
                  return_state: bool = False):
    """The recurrent block over a sequence: ``x`` ``(B, T, D)`` →
    ``(B, T, D)``; with ``return_state`` also the final recurrent state
    ``(B, W)`` float32 and the conv cache ``(B, K - 1, W)`` (the last
    pre-conv inputs)."""
    xw_lin = x @ p["w_x"]
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    xw = _causal_conv(xw_lin, p["conv_w"], p["conv_b"])
    a, gi = _gates(p, xw)
    h = _linear_scan(a, gi)
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    if return_state:
        return out, h[:, -1], conv_tail(xw_lin, cfg.conv_width)
    return out


def rglru_decode_step(p, x: torch.Tensor, cfg: RGLRUConfig, *,
                      rec_state: torch.Tensor, conv_state: torch.Tensor):
    """One step: ``x`` ``(B, 1, D)``, ``rec_state`` ``(B, W)`` float32,
    ``conv_state`` ``(B, K - 1, W)`` → ``(out (B, 1, D), rec_state,
    conv_state)``, new tensors."""
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")[:, 0]
    xw_lin = (x @ p["w_x"])[:, 0]
    window = torch.cat([conv_state, xw_lin[:, None, :]], dim=1)
    xw = torch.einsum("bkw,kw->bw", window, p["conv_w"]) + p["conv_b"]
    a, gi = _gates(p, xw)
    rec_state = a * rec_state + gi
    h = rec_state.to(x.dtype) * gate
    return (h @ p["w_out"])[:, None, :], rec_state, window[:, 1:]
