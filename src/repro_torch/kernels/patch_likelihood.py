"""Gaussian-PSF patch log-likelihood on the card (port of
``repro.kernels.patch_likelihood``).

``patch_log_likelihood_kernel`` wraps ``csrc/patch_likelihood.cu``: one
thread per (member, particle), reading y, x and i0 in place from the
strided ``(B, N, S)`` state and gathering each ``(2R+1)²`` window from the
member's frame through the read-only cache.  It takes CUDA tensors only;
the plain version is ``repro_torch.kernels.ref.patch_log_likelihood_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import default_geometry

_c_ll = ctypes.c_longlong
_c_f = ctypes.c_float
_c_i = ctypes.c_int
_c_p = ctypes.c_void_p


def _lib():
    lib = build.library("patch_likelihood")
    fn = lib.ppf_patch_log_likelihood
    fn.argtypes = [_c_p, _c_ll, _c_ll, _c_p, _c_ll, _c_ll, _c_p, _c_i, _c_i,
                   _c_i, _c_f, _c_f, _c_f, _c_i, _c_i, _c_i, _c_i, _c_i,
                   _c_i, _c_i, _c_p]
    fn.restype = _c_i
    return fn


def patch_log_likelihood_kernel(state: torch.Tensor, frames: torch.Tensor, *,
                                radius: int = 4, sigma_psf: float = 1.16,
                                sigma_like: float = 2.0, i_bg: float = 0.0,
                                matched: bool = True, center_bounds=None,
                                frame_origin=None) -> torch.Tensor:
    """``(B, N)`` (or ``(N,)``) log-likelihoods on the card.

    ``state`` is ``(B, N, S)`` or ``(N, S)`` float32 with ``S ≥ 5`` and a
    unit last stride; ``frames`` is ``(B, H, W)`` or ``(H, W)`` float32
    with a unit last stride (any row and member strides, so a slab view
    of a larger frame needs no copy).  ``center_bounds`` and
    ``frame_origin`` follow the reference (frame coordinates; only the
    gather is offset).  Raises on anything else, and when the geometry
    would let a window leave the frame.
    """
    single = state.dim() == 2
    if single:
        state, frames = state[None], frames[None]
    if state.dim() != 3 or frames.dim() != 3:
        raise ValueError(f"state (B,N,S) and frames (B,H,W) expected, got "
                         f"{tuple(state.shape)} and {tuple(frames.shape)}")
    for name, t in (("state", state), ("frames", frames)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if frames.device != state.device:
        raise ValueError("state and frames on different devices")
    b, n, s = state.shape
    h, w = frames.shape[1:]
    if frames.shape[0] != b or s < 5:
        raise ValueError(f"state {tuple(state.shape)} / frames "
                         f"{tuple(frames.shape)} do not match")
    if state.stride(2) != 1 or frames.stride(2) != 1:
        raise ValueError("state and frames need a unit last stride")
    lo_y, hi_y, lo_x, hi_x, oy, ox = default_geometry(
        radius, h, w, center_bounds, frame_origin)
    if not (lo_y <= hi_y and lo_x <= hi_x and lo_y - radius - oy >= 0
            and hi_y + radius - oy <= h - 1 and lo_x - radius - ox >= 0
            and hi_x + radius - ox <= w - 1):
        raise ValueError(f"geometry {(lo_y, hi_y, lo_x, hi_x, oy, ox)} lets "
                         f"a radius-{radius} window leave the {h}x{w} frame")
    out = torch.empty((b, n), dtype=torch.float32, device=state.device)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = _lib()(state.data_ptr(), state.stride(0), state.stride(1),
                 frames.data_ptr(), frames.stride(0), frames.stride(1),
                 out.data_ptr(), b, n, radius, 0.5 / (sigma_psf * sigma_psf),
                 sigma_like * sigma_like, i_bg, int(matched), lo_y, hi_y,
                 lo_x, hi_x, oy, ox, stream)
    if err != 0:
        raise RuntimeError(f"patch_log_likelihood kernel launch failed: "
                           f"cudaError {err}")
    patch_log_likelihood_kernel.launches += 1
    return out[0] if single else out


patch_log_likelihood_kernel.launches = 0
