"""Plain torch versions of the kernels (port of ``repro.kernels.ref``).

The ground truth the CUDA kernels are held against on the card, and what
the kernel ops run for tensors that lie on the CPU.  Written the most
obvious way, batched over any leading dims.
"""
from __future__ import annotations

import torch


def default_geometry(radius: int, h: int, w: int, center_bounds=None,
                     frame_origin=None) -> tuple[int, ...]:
    """The ``(lo_y, hi_y, lo_x, hi_x, oy, ox)`` patch geometry: the
    centre clamp defaults to the frame interior ``[R, dim-1-R]`` and the
    frame origin of ``image[0, 0]`` to ``(0, 0)``."""
    if center_bounds is None:
        center_bounds = (radius, h - 1 - radius, radius, w - 1 - radius)
    if frame_origin is None:
        frame_origin = (0, 0)
    geom = tuple(int(v) for v in center_bounds) + tuple(
        int(v) for v in frame_origin)
    if len(geom) != 6:
        raise ValueError(f"center_bounds/frame_origin must give 4 + 2 "
                         f"integers, got {geom}")
    return geom


def geometry_columns(radius: int, h: int, w: int, lead: tuple,
                     center_bounds=None, frame_origin=None, geometry=None,
                     device=None) -> tuple[torch.Tensor, ...]:
    """The six geometry integers as int64 tensors that broadcast against
    ``lead + (1,)``: 0-dim for one geometry shared by every member (the
    defaults, or ``center_bounds``/``frame_origin``), ``lead + (1,)``
    columns of a per-member ``lead + (6,)`` ``geometry`` table (a domain's
    slabs, each with its own clamp and origin)."""
    if geometry is None:
        return tuple(torch.tensor(v, dtype=torch.int64, device=device)
                     for v in default_geometry(radius, h, w, center_bounds,
                                               frame_origin))
    if center_bounds is not None or frame_origin is not None:
        raise ValueError("give a per-member geometry table or "
                         "center_bounds/frame_origin, not both")
    g = torch.as_tensor(geometry, device=device)
    if g.shape != tuple(lead) + (6,) or g.is_floating_point():
        raise ValueError(f"geometry must be an integer {tuple(lead) + (6,)}"
                         f" table, got {g.dtype} {tuple(g.shape)}")
    g = g.to(torch.int64)
    return tuple(g[..., k, None] for k in range(6))


def patch_log_likelihood_ref(y: torch.Tensor, x: torch.Tensor,
                             i0: torch.Tensor, image: torch.Tensor, *,
                             radius: int = 4, sigma_psf: float = 1.16,
                             sigma_like: float = 2.0, i_bg: float = 0.0,
                             matched: bool = True, center_bounds=None,
                             frame_origin=None,
                             geometry=None) -> torch.Tensor:
    """``(..., N)`` Gaussian-PSF patch log-likelihoods.

    ``y``, ``x``, ``i0`` are ``(..., N)`` and ``image`` is ``(..., H, W)``
    with the same leading dims.  Each particle's centre is rounded half
    to even (``torch.round``, as ``jnp.round``), clamped to the centre
    bounds, and its ``(2R+1)²`` window is gathered at an offset of
    ``frame_origin``; positions, centres and the PSF stay in frame
    coordinates.  ``geometry`` (``(..., 6)``: ``lo_y, hi_y, lo_x, hi_x,
    oy, ox`` per member) gives each member its own bounds and origin.
    """
    h, w = image.shape[-2:]
    lo_y, hi_y, lo_x, hi_x, oy, ox = geometry_columns(
        radius, h, w, y.shape[:-1], center_bounds, frame_origin, geometry,
        y.device)
    r = torch.arange(-radius, radius + 1, device=y.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    dy, dx = dy.reshape(-1), dx.reshape(-1)                    # (K,)
    cy = torch.clamp(torch.round(y).to(torch.int64), lo_y, hi_y)
    cx = torch.clamp(torch.round(x).to(torch.int64), lo_x, hi_x)
    py = cy[..., None] + dy                                     # (..., N, K)
    px = cx[..., None] + dx
    flat = image.reshape(image.shape[:-2] + (h * w,))
    idx = ((py - oy[..., None]) * w + (px - ox[..., None])).reshape(
        py.shape[:-2] + (-1,))
    patch = torch.gather(flat, -1, idx).reshape(py.shape)
    d2 = (py.to(y.dtype) - y[..., None]) ** 2 + (
        px.to(x.dtype) - x[..., None]) ** 2
    model = i0[..., None] * torch.exp(-d2 / (2.0 * sigma_psf ** 2)) + i_bg
    if matched:
        val = (patch * model).sum(-1) - 0.5 * (model * model).sum(-1)
    else:
        val = -0.5 * ((patch - model) ** 2).sum(-1)
    return val / (sigma_like ** 2)


def systematic_ancestors_ref(log_weights: torch.Tensor, u: torch.Tensor,
                             n_out: int) -> torch.Tensor:
    """``(..., n_out)`` systematic-resampling ancestors for offsets
    ``u`` in [0, 1) (one per leading index).  The scan accumulates in
    float64 and rounds each prefix to float32 — what torch's CPU cumsum
    of float32 does — so the CUDA plain version computes the CPU's CDF
    (torch's CUDA float32 cumsum drifts by ~2e-5 at 2^22 weights)."""
    lw = log_weights - log_weights.amax(-1, keepdim=True)
    w = torch.exp(lw)
    w = w / w.sum(-1, keepdim=True)
    cdf = torch.cumsum(w.double(), -1).to(w.dtype)
    u = torch.as_tensor(u, dtype=log_weights.dtype, device=lw.device)
    pts = (torch.arange(n_out, dtype=log_weights.dtype, device=lw.device)
           + u[..., None]) / n_out
    anc = torch.searchsorted(cdf.contiguous(),
                             pts.expand(cdf.shape[:-1] + (n_out,))
                             .contiguous(), right=True)
    return anc.clamp(0, log_weights.shape[-1] - 1).to(torch.int32)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: float | None = None,
            logit_softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """``(B, Hq, Lq, D) x (B, Hkv, Lk, D)`` GQA attention with a float32
    softmax — the plain version of the flash-attention kernel (B6).  ``v``
    is ``(B, Hkv, Lk, Dv)`` with its own head dim (latent attention's
    ``Dv <= D``, the reference's ``chunked_causal_attention`` of an M
    layer) and the output ``(B, Hq, Lq, Dv)``.

    Query head ``h`` reads KV head ``h // (Hq // Hkv)``; a causal query
    ``i`` at position ``p = i + Lk - Lq`` (the decode offset) sees keys
    ``j <= p``, and with ``window > 0`` only those with ``p - j < window``
    (the reference's sliding-window mask; a window needs ``causal``).  The
    arithmetic is the reference's: the logits are the product in the
    inputs' dtype, then float32 times ``scale`` (default ``1/sqrt(D)``
    rounded to the inputs' dtype), masked to ``-inf``; the normalized
    probabilities are cast to ``v``'s dtype before the second product.
    Every call adds one to ``mha_ref.calls``, so a run can show that its
    attention never took the plain version.
    """
    mha_ref.calls += 1
    if window < 0 or (window and not causal):
        raise ValueError(f"window={window}: a window is a positive key "
                         f"count on a causal call")
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * scale
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if causal:
        lq, lk = q.shape[2], k.shape[2]
        qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ki = torch.arange(lk, device=q.device)[None, :]
        hidden = ki > qi
        if window > 0:
            hidden = hidden | (qi - ki >= window)
        logits = logits.masked_fill(hidden, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), vv)


mha_ref.calls = 0
