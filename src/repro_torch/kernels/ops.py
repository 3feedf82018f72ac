"""Kernel-layer entry points (port of ``repro.kernels.ops``).

Each op dispatches on the device of the tensor it is given: a CUDA tensor
launches the hand-written Hopper kernel (or raises), a CPU tensor runs the
plain torch version.  Nothing falls back: a CUDA tensor never reaches the
plain version and no path moves work to the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import patch_likelihood, ref


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
                         frame_origin=None) -> torch.Tensor:
    """``(..., N)`` patch log-likelihoods of ``(..., N, S)`` particle
    states (columns y, x and i0 = 0, 1, 4) against ``(..., H, W)`` frames.
    """
    kw = dict(radius=radius, sigma_psf=sigma_psf, sigma_like=sigma_like,
              i_bg=i_bg, matched=matched, center_bounds=center_bounds,
              frame_origin=frame_origin)
    if on_cuda(state):
        return patch_likelihood.patch_log_likelihood_kernel(state, frames,
                                                            **kw)
    return ref.patch_log_likelihood_ref(state[..., 0], state[..., 1],
                                        state[..., 4], frames, **kw)
