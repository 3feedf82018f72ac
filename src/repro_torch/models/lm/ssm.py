"""Mamba-2 SSD blocks on torch (port of ``repro.models.lm.ssm``;
state-space duality, arXiv:2405.21060).

Prefill is the reference's chunked SSD: within a chunk the dense
"attention-like" products, across chunks a short loop over T/chunk
steps carrying the float32 ``(B, H, P, N)`` state.  Decode is the O(1)
recurrent update.  The reference's dtypes are kept (its mixed products
promote to float32: the prefill's output path is float32 until the
block's residual add, the decode's stays in the compute dtype).  A
sequence whose length is not a multiple of the chunk is padded at its
end with steps of zero ``dt`` (no decay, no input), which leaves every
real step and the final state as they are; the reference asserts
``T % chunk == 0`` instead.  The products that contract over the chunk
are ordered by hand (``torch.einsum`` would expand the reference's
four-operand einsum into a ``(B, NC, Q, N, H, P)`` intermediate).  No
hand-written kernel: the reference computes this in XLA, not Pallas (a
fused scan kernel is a later speed item, ROADMAP).  Training
differentiates the prefill's ops: their backwards are products,
fixed-shape reductions (a group's heads included) and torch's
``cumsum`` scans, with no float atomics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.lm.layers import normal_weight, rms_norm
from repro_torch.models.lm.rglru import conv_tail


def ssm_params(generator: torch.Generator, d_model: int, cfg: SSMConfig,
               dtype: torch.dtype) -> dict:
    """Random SSD weights with the reference's shapes and scales, drawn
    from ``generator`` on its device (the fused input projection is
    ``[z, x, B, C, dt]``)."""
    d_inner = cfg.expand * d_model
    h = d_inner // cfg.head_dim
    gn = cfg.n_groups * cfg.state_dim
    g, dev = generator, generator.device

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=dev)

    return {
        "w_in": normal_weight((d_model, 2 * d_inner + 2 * gn + h),
                              d_model ** -0.5, g, dtype),
        "conv_w": normal_weight((cfg.conv_width, d_inner + 2 * gn), 0.1, g,
                                dtype),
        "conv_b": full(d_inner + 2 * gn, 0.0),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)).to(dtype),
        "dt_bias": full(h, 0.0),
        "d_skip": full(h, 1.0),
        "out_norm": full(d_inner, 0.0),
        "w_out": normal_weight((d_inner, d_model), d_inner ** -0.5, g, dtype),
    }


def _split_proj(p, x: torch.Tensor, cfg: SSMConfig, d_model: int):
    """``z``, the conv input ``[x | B | C]`` and ``dt`` of ``x``'s fused
    projection, with the sizes of the heads ``p`` holds (all of them, or
    a rank's over a model axis): ``d_inner``, heads, groups, state."""
    n = cfg.state_dim
    h = p["a_log"].shape[0]
    d_inner = h * cfg.head_dim
    g = (p["conv_w"].shape[1] - d_inner) // (2 * n)
    proj = x @ p["w_in"]
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * g * n]
    dt = proj[..., 2 * d_inner + 2 * g * n:]
    return z, xbc, dt, d_inner, h, g, n


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along T (the reference's shifted taps, in
    order), then SiLU.  ``xbc`` ``(B, T, C)``, ``w`` ``(K, C)``."""
    k, t = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + t] * w[i]
    return F.silu(out + b)


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """``(..., Q)`` per-step log-decays → ``(..., Q, Q)`` cumulative sums
    ``cs_i - cs_j`` on and below the diagonal, ``-inf`` above."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=log_a.device))
    return diff.masked_fill(~mask, -torch.inf)


def gated_norm(y: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
               eps: float, norm=None) -> torch.Tensor:
    """``rms_norm(y · silu(z))``; with ``norm`` ``(reduce, d_total)`` the
    channels are a rank's share of ``d_total``: the sum of squares is
    ``reduce``d over the ranks before the mean (the same float32 steps
    otherwise)."""
    if norm is None:
        return rms_norm(y * F.silu(z), gamma, eps)
    reduce, total = norm
    x = y * F.silu(z)
    x32 = x.float()
    var = reduce(x32.square().sum(-1, keepdim=True)) / total
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def ssd_forward(p, x: torch.Tensor, cfg: SSMConfig, d_model: int,
                eps: float, return_state: bool = False, norm=None):
    """Chunked SSD over a sequence: ``x`` ``(B, T, D)`` → ``(B, T, D)``
    (float32 in a bfloat16 model, as the reference's promotions give);
    with ``return_state`` also the final state ``(B, H, P, N)`` float32
    and the conv cache ``(B, K - 1, C)`` (the last pre-conv inputs).  Over
    a model axis ``p`` holds the rank's heads (``model._ssd_local``),
    ``norm`` is ``gated_norm``'s and the output the rank's partial sum."""
    b, t, _ = x.shape
    z, xbc, dt, d_inner, h, g, n = _split_proj(p, x, cfg, d_model)
    hd = cfg.head_dim
    tail = conv_tail(xbc, cfg.conv_width)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, T, H)
    a = -torch.exp(p["a_log"])                                 # (H,)
    q = min(cfg.chunk, t)
    nc = -(-t // q)
    if nc * q != t:
        # zero-dt steps at the end: no decay, no input
        xbc = F.pad(xbc, (0, 0, 0, nc * q - t))
        dt = F.pad(dt, (0, 0, 0, nc * q - t))
    log_decay = dt * a                                         # (B, T', H)
    xs = xbc[..., :d_inner].reshape(b, nc, q, h, hd)
    b_c = xbc[..., d_inner:d_inner + g * n].reshape(b, nc, q, g, n)
    c_c = xbc[..., d_inner + g * n:].reshape(b, nc, q, g, n)
    ld_c = log_decay.reshape(b, nc, q, h).float()
    dt_c = dt.reshape(b, nc, q, h)
    hpg = h // g

    # intra-chunk: the "attention duality" term
    gmat = torch.exp(_segsum(ld_c.movedim(-1, -2)))           # (B,NC,H,Q,Q)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", c_c, b_c)
    # to the group's heads by expand: its backward sums a group's heads in
    # a fixed order (repeat_interleave's would index_add with atomics)
    cb = cb[:, :, :, None].expand(b, nc, g, hpg, q, q).reshape(
        b, nc, h, q, q)                                        # (B,NC,H,Q,Q)
    att = cb * gmat * dt_c.movedim(-1, -2)[..., None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", att.to(xs.dtype), xs)

    # chunk-final states: Σ_q B_q ⊗ x_q · decay to the chunk's end · dt_q
    ld_sum = ld_c.sum(2)                                       # (B,NC,H)
    decay_to_end = torch.exp(ld_sum[:, :, None, :] - torch.cumsum(ld_c, 2))
    wx = xs.float() * (decay_to_end * dt_c)[..., None]         # (B,NC,Q,H,P)
    bx = torch.einsum("bcqn,bcqhp->bchpn", b_c.float().sum(3), wx)

    # inter-chunk recurrence, float32
    chunk_decay = torch.exp(ld_sum)
    state = torch.zeros((b, h, hd, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + bx[:, c]
    prev_states = torch.stack(prev, 1).to(xs.dtype)            # (B,NC,H,P,N)

    # off-diagonal: C_t · the decayed state before the chunk
    decay_in = torch.exp(torch.cumsum(ld_c, 2))                # (B,NC,Q,H)
    y_off = torch.einsum(
        "bcqgn,bcgjpn->bcqgjp", c_c.float(),
        prev_states.float().reshape(b, nc, g, hpg, hd, n)).reshape(
        b, nc, q, h, hd) * decay_in[..., None]

    y = (y_diag + y_off).reshape(b, nc * q, h, hd)[:, :t]
    y = y + xs.reshape(b, nc * q, h, hd)[:, :t] * p["d_skip"][
        None, None, :, None].to(xs.dtype)
    y = y.reshape(b, t, d_inner)
    y = gated_norm(y, z, p["out_norm"], eps, norm)
    out = y @ p["w_out"].to(y.dtype)
    if return_state:
        return out, state, tail
    return out


def ssd_decode_step(p, x: torch.Tensor, cfg: SSMConfig, d_model: int,
                    eps: float, *, ssm_state: torch.Tensor,
                    conv_state: torch.Tensor, norm=None):
    """One step: ``x`` ``(B, 1, D)``, ``ssm_state`` ``(B, H, P, N)``,
    ``conv_state`` ``(B, K - 1, C)`` → ``(out (B, 1, D), ssm_state,
    conv_state)``, new tensors in the compute dtype.  A float32 state in
    a bfloat16 model promotes as the reference's does: the state is
    carried in float32, and the read-out, the gated norm and the output
    projection run in float32 (so does ``out``)."""
    b = x.shape[0]
    z, xbc, dt, d_inner, h, g, n = _split_proj(p, x, cfg, d_model)
    window = torch.cat([conv_state, xbc], dim=1)               # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]
    xs = conv_out[..., :d_inner].reshape(b, h, cfg.head_dim)
    bvec = conv_out[..., d_inner:d_inner + g * n].reshape(b, g, n)
    cvec = conv_out[..., d_inner + g * n:].reshape(b, g, n)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])           # (B, H)
    decay = torch.exp(dt * -torch.exp(p["a_log"]))
    hpg = h // g
    b_h = bvec.repeat_interleave(hpg, dim=1)                   # (B, H, N)
    c_h = cvec.repeat_interleave(hpg, dim=1)
    upd = xs[..., :, None] * b_h[..., None, :] * dt.to(xs.dtype)[..., None,
                                                                 None]
    st = ssm_state.dtype
    ssm_state = ssm_state * decay[..., None, None].to(xs.dtype).to(st) \
        + upd.to(st)
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, c_h.to(st))
    y = y + xs * p["d_skip"][None, :, None].to(xs.dtype)
    y = y.reshape(b, 1, d_inner)
    y = gated_norm(y, z, p["out_norm"], eps, norm)
    return y @ p["w_out"].to(y.dtype), ssm_state, window[:, 1:]
