"""Kernel-layer entry points (port of ``repro.kernels.ops``).

Each op dispatches on the device of the tensor it is given: a CUDA tensor
launches the hand-written Hopper kernel (or raises), a CPU tensor runs the
plain torch version.  Nothing falls back: a CUDA tensor never reaches the
plain version and no path moves work to the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (flash_attention, patch_likelihood, ref,
                                 resample, row_sum as row_sum_mod, scan)


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; any other device
    raises (there is no kernel and no plain path for it)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"no kernel path for device {t.device}")


def patch_log_likelihood(state: torch.Tensor, frames: torch.Tensor, *,
                         radius: int = 4, sigma_psf: float = 1.16,
                         sigma_like: float = 2.0, i_bg: float = 0.0,
                         matched: bool = True, center_bounds=None,
                         frame_origin=None, geometry=None) -> torch.Tensor:
    """``(..., N)`` patch log-likelihoods of ``(..., N, S)`` particle
    states (columns y, x and i0 = 0, 1, 4) against ``(..., H, W)`` frames.
    Frames with fewer leading dims are broadcast (a stride-0 view, no
    copy): the shards of a distributed filter share one frame.  One
    geometry (``center_bounds``/``frame_origin``) serves every member, or
    ``geometry``, a ``(..., 6)`` int table (on the card one made by
    ``patch_likelihood.member_geometry``), gives each member its own.
    """
    kw = dict(radius=radius, sigma_psf=sigma_psf, sigma_like=sigma_like,
              i_bg=i_bg, matched=matched, center_bounds=center_bounds,
              frame_origin=frame_origin, geometry=geometry)
    frames = frames.expand(state.shape[:-2] + frames.shape[-2:])
    if on_cuda(state):
        if state.dim() > 3:
            # a bank over a mesh: (B, P, C, S) particles as B·P rows (a
            # frame shared by a member's shards is copied per row)
            lead = state.shape[:-2]
            out = patch_likelihood.patch_log_likelihood_kernel(
                state.reshape((-1,) + state.shape[-2:]),
                frames.reshape((-1,) + frames.shape[-2:]), **kw)
            return out.reshape(lead + out.shape[-1:])
        return patch_likelihood.patch_log_likelihood_kernel(state, frames,
                                                            **kw)
    return ref.patch_log_likelihood_ref(state[..., 0], state[..., 1],
                                        state[..., 4], frames, **kw)


def _batched(fn, *tensors):
    """Run a ``(B, ...)`` kernel on ``(..., ...)`` inputs whose leading
    dims are those of the first tensor minus its last axis."""
    lead = tensors[0].shape[:-1]
    flat = [t.reshape((-1,) + t.shape[len(lead):]).contiguous()
            for t in tensors]
    out = fn(*flat)
    return out.reshape(lead + out.shape[1:])


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 scan along the last dim, batched over any leading
    dims: the comb schemes' CDF (``csrc/comb_scan.cu`` on the card)."""
    if not on_cuda(x):
        return scan.prefix_sum_ref(x)
    return _batched(scan.prefix_sum_kernel, x)


def row_sum(x: torch.Tensor, shift: torch.Tensor | None = None
            ) -> torch.Tensor:
    """``(outer, inner)`` float32 sums over dim 1 of ``x`` ``(outer, n,
    inner)``, of ``exp(x - shift)`` with an ``(outer, inner)`` ``shift``:
    on the card one launch of ``csrc/row_sum.cu``, whose order depends on
    ``n`` alone; torch's sum on the CPU."""
    if not on_cuda(x):
        return row_sum_mod.row_sum_ref(x, shift)
    return row_sum_mod.row_sum_kernel(
        x.contiguous(), None if shift is None else shift.contiguous())


def systematic_ancestors(log_weights: torch.Tensor, u: torch.Tensor,
                         n_out: int) -> torch.Tensor:
    """``(..., n_out)`` systematic ancestors of ``(..., n_in)`` log-weights
    with one comb offset per member ``u`` ``(...)`` (B1)."""
    if not on_cuda(log_weights):
        return ref.systematic_ancestors_ref(log_weights, u, n_out)
    u = torch.as_tensor(u, dtype=torch.float32, device=log_weights.device)
    u = u.expand(log_weights.shape[:-1])[..., None]
    return _batched(lambda lw, uu: resample.systematic_ancestors_kernel(
        lw, uu[:, 0], n_out), log_weights, u)


def metropolis_ancestors(log_weights: torch.Tensor, proposals: torch.Tensor,
                         log_us: torch.Tensor) -> torch.Tensor:
    """``(..., lanes)`` Metropolis-chain ancestors (B4)."""
    if not on_cuda(log_weights):
        return resample.metropolis_ancestors_ref(log_weights, proposals,
                                                 log_us)
    return _batched(resample.metropolis_ancestors_kernel, log_weights,
                    proposals, log_us)


def rejection_ancestors(log_weights: torch.Tensor, proposals: torch.Tensor,
                        log_us: torch.Tensor) -> torch.Tensor:
    """``(..., lanes)`` rejection-sampling ancestors (B5)."""
    if not on_cuda(log_weights):
        return resample.rejection_ancestors_ref(log_weights, proposals,
                                                log_us)
    return _batched(resample.rejection_ancestors_kernel, log_weights,
                    proposals, log_us)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: float | None = None,
              logit_softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """``(B, Hq, Lq, D) x (B, Hkv, Lk, D)`` GQA attention (B6), causal
    (with ``window > 0``: each query sees its last ``window`` keys) or
    full.  ``v`` is ``(B, Hkv, Lk, Dv)`` and the output ``(B, Hq, Lq,
    Dv)``: Dv = D, or latent attention's (D, Dv) = (192, 128), which the
    kernel takes (``flash_attention.UNEQUAL_HEAD_DIMS``).

    ``k``/``v`` may be strided views (a KV cache's ``[..., :pos+1, :]``).
    ``scale`` defaults to ``1/sqrt(D)`` as a Python float on both paths,
    the kernel's default (the plain version alone would round it to the
    inputs' dtype)."""
    if scale is None:
        scale = float(q.shape[-1] ** -0.5)
    if on_cuda(q):
        return flash_attention.flash_attention_kernel(
            q, k, v, causal=causal, scale=scale, logit_softcap=logit_softcap,
            window=window)
    return ref.mha_ref(q, k, v, causal=causal, scale=scale,
                       logit_softcap=logit_softcap, window=window)


def attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, key_lo: int, key_hi: int,
                       scale: float | None = None,
                       logit_softcap: float = 0.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """B6's partials: every query of ``q`` ``(B, Hq, Lq, D)`` over the
    keys ``key_lo <= j < key_hi`` of ``k``/``v`` ``(B, Hkv, Lk, D)`` (a
    cache shard, as it lies in memory), non-causal: ``(o, lse)``, the
    normalized output in q's dtype and the float32 log-sum-exp ``(B, Hq,
    Lq)`` that ``combine_partials`` weighs shards by.  An empty range
    gives ``o = 0`` and ``lse = -inf`` with no launch.  The kernel on the
    card (``flash_attention.flash_partials_kernel``), its plain version
    (``ref.attention_lse_ref``) on the CPU."""
    lo, hi = max(int(key_lo), 0), min(int(key_hi), k.shape[2])
    if scale is None:
        scale = float(q.shape[-1] ** -0.5)
    if hi <= lo:
        b, hq, lq, _ = q.shape
        return (q.new_zeros((b, hq, lq, v.shape[-1])),
                torch.full((b, hq, lq), -torch.inf, device=q.device))
    k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if on_cuda(q):
        return flash_attention.flash_partials_kernel(
            q, k, v, scale=scale, logit_softcap=logit_softcap)
    return ref.attention_lse_ref(q, k, v, scale=scale,
                                 logit_softcap=logit_softcap)


def combine_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Attention over the union of key shards from each shard's
    normalized output ``o`` ``(S, ..., Dv)`` and log-sum-exp ``lse``
    ``(S, ...)`` (shard first; B6's partials, or an MLA decode's latent
    partials): ``Σ_s w_s o_s / Σ_s w_s`` with ``w_s = exp(lse_s - max_s
    lse_s)``, summed in float32 in shard order (the same bits on every
    rank and every run, no atomics), cast to ``o``'s dtype.  A shard with
    no key (``lse = -inf``, ``o = 0``) weighs 0."""
    top = lse.amax(0)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    w = torch.exp(lse - top)
    num = w[0, ..., None] * o[0].float()
    den = w[0]
    for s in range(1, o.shape[0]):
        num = num + w[s, ..., None] * o[s].float()
        den = den + w[s]
    return (num / den.clamp_min(1e-30)[..., None]).to(o.dtype)
