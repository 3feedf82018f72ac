"""Fused SIR weight phase (port of ``repro.kernels.sir_fused``).

Everything downstream of the model's two callbacks in one phase that
normalizes once and shares the result:

    lw' = lw + log_lik            (-inf slots stay dead)
    w   = softmax(lw')            (one max / exp / sum)
    estimate = Σ w·x              (f32 accumulation)
    ESS, log Z, the resample decision, N·max w
    ancestors — the systematic comb by a direct search of the CDF, or
                the collective-free Metropolis/rejection chains

``fused_weight_step_ref`` is the plain torch version (what CPU tensors
run, and what the kernel is held against on the card);
``fused_weight_step_kernel`` wraps ``csrc/sir_fused.cu``, which builds the
same result in a few fixed-order passes over tiles of each member.
``fused_weight_step`` dispatches on the tensors' device and takes the
step's draws in the scheme's order: the comb's one uniform, or the
chains' ``resampling_draws`` (then the weight phase runs with
``comb=False`` and the ancestors come from the chain kernel of
``csrc/resample.cu``).  Every function takes an explicit leading bank
dim ``B``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ops import on_cuda

# Resampling schemes the fused step commits on the card: the systematic
# comb and the two collective-free chains.
FUSED_RESAMPLERS = ("systematic", "metropolis", "rejection")


class FusedDecision(NamedTuple):
    """Everything the SIR step needs downstream of the model callbacks
    (leading bank dims as the inputs).  ``ancestors`` already folds the
    decision in (identity when not resampled)."""

    ancestors: torch.Tensor        # (..., N) int32
    estimate: torch.Tensor         # (..., *S) — Σ w·x, f32 accumulation
    ess: torch.Tensor              # (...)
    log_z: torch.Tensor            # (...)
    resampled: torch.Tensor        # (...) bool
    new_log_weights: torch.Tensor  # (..., N) f32
    weight_skew: torch.Tensor      # (...) N·max w


def fused_applicable(resampler: str) -> bool:
    """Whether the reference's fused step takes ``resampler`` (otherwise
    the SIR step falls back to the composed path, as the reference does)."""
    return resampler in FUSED_RESAMPLERS


def _constants(n: int, ess_frac: float) -> tuple[float, float]:
    """The f32 constants the reference rounds once: the decision
    threshold ``ess_frac·n`` and the reset weight ``-log n``."""
    return float(np.float32(ess_frac * n)), float(np.float32(-math.log(n)))


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------

def fused_weight_step_ref(log_weights: torch.Tensor, log_lik: torch.Tensor,
                          state: torch.Tensor, u: torch.Tensor, *,
                          ess_frac: float = 0.5, always: bool = False,
                          comb: bool = True) -> FusedDecision:
    """The single-normalization weight phase in plain torch.

    ``log_weights``/``log_lik`` are ``(..., N)``, ``state`` ``(..., N,
    *S)`` and ``u`` the comb offset per member ``(...)``.  With
    ``comb=False`` the ancestors are the identity (the slot the
    collective-free chains will fill).
    """
    n = log_weights.shape[-1]
    thresh, neg_log_n = _constants(n, ess_frac)
    lw = torch.where(torch.isfinite(log_weights), log_weights + log_lik,
                     torch.full_like(log_weights, -math.inf))
    m = lw.amax(-1, keepdim=True)
    mg = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(lw - mg)
    s = e.sum(-1, keepdim=True)
    w = torch.where(s > 0, e / s, torch.ones_like(e) / n)
    ess = 1.0 / torch.square(w).sum(-1)
    log_z = (mg + torch.log(s))[..., 0]
    wx = w.reshape(w.shape + (1,) * (state.dim() - w.dim())).to(state.dtype)
    estimate = (wx * state).sum(w.dim() - 1)
    resampled = torch.logical_or(ess < thresh, torch.tensor(
        bool(always), device=ess.device))
    lane = torch.arange(n, dtype=torch.int32, device=lw.device).expand(
        lw.shape)
    if comb:
        cdf = torch.cumsum(w, -1)
        u = torch.as_tensor(u, dtype=torch.float32, device=lw.device)
        pts = (torch.arange(n, dtype=torch.float32, device=lw.device)
               + u[..., None]) / n
        anc = torch.searchsorted(cdf.contiguous(),
                                 pts.expand(lw.shape).contiguous(),
                                 right=True)
        anc = anc.clamp(0, n - 1).to(torch.int32)
        anc = torch.where(resampled[..., None], anc, lane)
    else:
        anc = lane.clone()
    new_lw = torch.where(resampled[..., None],
                         torch.full_like(lw, neg_log_n), lw - log_z[..., None])
    skew = n * w.amax(-1)
    return FusedDecision(anc, estimate, ess, log_z, resampled, new_lw, skew)


# ---------------------------------------------------------------------------
# The Hopper kernel
# ---------------------------------------------------------------------------

def _lib():
    lib = build.library("sir_fused")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ppf_fused_weight_step.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                          f, i, i, f, p]
    lib.ppf_fused_weight_step.restype = i
    lib.ppf_fused_scratch_floats.argtypes = [i, i, i]
    lib.ppf_fused_scratch_floats.restype = ctypes.c_longlong
    return lib


def fused_weight_step_kernel(log_weights: torch.Tensor, log_lik: torch.Tensor,
                             state_mat: torch.Tensor, u: torch.Tensor, *,
                             ess_frac: float = 0.5, always: bool = False,
                             comb: bool = True):
    """The fused weight phase on the card.

    Takes contiguous CUDA float32 ``log_weights``/``log_lik`` ``(B, N)``,
    ``state_mat`` ``(B, N, D)`` and ``u`` ``(B,)``; returns ``(ancestors
    (B, N) int32, new_log_weights (B, N), estimate (B, D), stats (B, 6))``
    with ``stats = [ess, log_z, resampled, max_shift, exp_sum,
    weight_skew]`` — the reference's layout with a bank dim.
    """
    if log_weights.dim() != 2 or state_mat.dim() != 3:
        raise ValueError(f"log_weights (B,N) and state (B,N,D) expected, got "
                         f"{tuple(log_weights.shape)}, "
                         f"{tuple(state_mat.shape)}")
    b, n = log_weights.shape
    d = state_mat.shape[2]
    want = {"log_weights": (log_weights, (b, n)), "log_lik": (log_lik, (b, n)),
            "state": (state_mat, (b, n, d)), "u": (u, (b,))}
    for name, (t, shape) in want.items():
        if t.device.type != "cuda" or t.device != log_weights.device:
            raise ValueError(f"{name} must be on {log_weights.device} "
                             f"(a CUDA device), got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if n >= 2 ** 31 or b > 65535:
        raise ValueError(f"bank {b} x {n} particles is beyond the kernel")
    lib = _lib()
    dev = log_weights.device
    anc = torch.empty((b, n), dtype=torch.int32, device=dev)
    new_lw = torch.empty((b, n), dtype=torch.float32, device=dev)
    est = torch.empty((b, d), dtype=torch.float32, device=dev)
    stats = torch.empty((b, 6), dtype=torch.float32, device=dev)
    scratch = torch.empty((lib.ppf_fused_scratch_floats(b, n, d),),
                          dtype=torch.float32, device=dev)
    thresh, neg_log_n = _constants(n, ess_frac)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ppf_fused_weight_step(
        log_weights.data_ptr(), log_lik.data_ptr(), state_mat.data_ptr(),
        u.data_ptr(), anc.data_ptr(), new_lw.data_ptr(), est.data_ptr(),
        stats.data_ptr(), scratch.data_ptr(), b, n, d, thresh, int(always),
        int(comb), neg_log_n, stream)
    if err != 0:
        raise RuntimeError(f"fused_weight_step kernel launch failed: "
                           f"cudaError {err}")
    fused_weight_step_kernel.launches += 1
    return anc, new_lw, est, stats


fused_weight_step_kernel.launches = 0


# ---------------------------------------------------------------------------
# State flattening and the dispatcher
# ---------------------------------------------------------------------------

def state_matrix(state: torch.Tensor, lead_dims: int
                 ) -> tuple[torch.Tensor, Callable]:
    """Flatten ``(*lead, N, *S)`` state into ``(*lead, N, D)`` plus the
    unflattener of the ``(*lead, D)`` moment row."""
    feat = state.shape[lead_dims + 1:]
    dtype = state.dtype
    mat = state.reshape(state.shape[:lead_dims + 1] + (-1,))

    def unflatten_moments(row: torch.Tensor) -> torch.Tensor:
        return row.reshape(row.shape[:-1] + feat).to(dtype)

    return mat, unflatten_moments


def _weight_phase(log_weights, log_lik, state, u, ess_frac, always, comb):
    """The weight phase: the kernel for CUDA tensors, else plain."""
    if not on_cuda(log_weights):
        return fused_weight_step_ref(log_weights, log_lik, state, u,
                                     ess_frac=ess_frac, always=always,
                                     comb=comb)
    lead = log_weights.shape[:-1]
    n = log_weights.shape[-1]
    mat, unflatten = state_matrix(state, len(lead))
    d = mat.shape[-1]
    anc, new_lw, est, stats = fused_weight_step_kernel(
        log_weights.reshape(-1, n).contiguous(),
        log_lik.reshape(-1, n).contiguous(),
        mat.reshape(-1, n, d).float().contiguous(),
        torch.as_tensor(u, dtype=torch.float32, device=log_weights.device)
        .expand(lead).reshape(-1).contiguous(),
        ess_frac=ess_frac, always=always, comb=comb)
    stats = stats.reshape(lead + (6,))
    return FusedDecision(anc.reshape(lead + (n,)),
                         unflatten(est.reshape(lead + (d,))),
                         stats[..., 0], stats[..., 1], stats[..., 2] > 0.0,
                         new_lw.reshape(lead + (n,)), stats[..., 5])


def fused_weight_step(log_weights: torch.Tensor, log_lik: torch.Tensor,
                      state: torch.Tensor, draws, *,
                      resampler: str = "systematic", ess_frac: float = 0.5,
                      always: bool = False) -> FusedDecision:
    """Run the fused weight phase: the Hopper kernels for CUDA tensors,
    the plain versions for CPU tensors.  ``draws`` hands out the step's
    resampling draws in the scheme's order: ``uniform(())`` for the
    comb, ``randint`` then ``uniform`` ``(N, iters)`` for a chain, which
    runs on ``lw' = lw + ll`` (dead slots ``-inf``) and replaces the
    ancestors of the members that resample."""
    if resampler not in FUSED_RESAMPLERS:
        raise ValueError(f"fused step does not support resampler="
                         f"{resampler!r} (supported: {FUSED_RESAMPLERS})")
    if resampler == "systematic":
        return _weight_phase(log_weights, log_lik, state, draws.uniform(()),
                             ess_frac, always, comb=True)
    # function-level: repro_torch.core (its smc) imports this module
    from repro_torch.core import resampling
    n = log_weights.shape[-1]
    if resampler == "metropolis":
        iters = resampling.METROPOLIS_ITERS
        chain_fn = resampling.metropolis_ancestors_from_draws
    else:
        iters = resampling.REJECTION_TRIES
        chain_fn = resampling.rejection_ancestors_from_draws
    proposals, log_us = resampling.resampling_draws(draws, n, n, iters)
    dec = _weight_phase(log_weights, log_lik, state, 0.0, ess_frac, always,
                        comb=False)
    lw_post = torch.where(torch.isfinite(log_weights), log_weights + log_lik,
                          torch.full_like(log_weights, -math.inf))
    chain = chain_fn(lw_post, proposals, log_us)
    return dec._replace(ancestors=torch.where(
        dec.resampled[..., None], chain, dec.ancestors))
