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
same result in two fixed-order launches over tiles of each member (the
normalizer with the decision, then the tile pass with the look-back CDF)
and, with the comb, the merge comb of ``csrc/comb_merge.cuh``.
``fused_weight_step_emulated`` is that order written in torch (the
kernel's bits on any device).  ``plan`` is pure Python; the first design
(``"seven_pass"``: seven launches ending in a per-lane bisection) stays
launchable through ``_launch`` for same-run timing.
``fused_weight_step`` dispatches on the tensors' device and takes the
step's draws in the scheme's order: the comb's one uniform, or the
chains' ``resampling_draws`` (then the weight phase runs with
``comb=False`` and the ancestors come from the chain kernel of
``csrc/resample.cu``).  Every function takes an explicit leading bank
dim ``B``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build, comb_merge, scan
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


@functools.lru_cache(maxsize=256)
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
        # float64 sums rounded once, as the comb scan and B1's plain
        # version: the CPU's float32 cumsum, and repeatable on the card
        cdf = torch.cumsum(w.double(), -1).to(w.dtype)
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
# The kernel's order in torch
# ---------------------------------------------------------------------------

def fused_weight_step_emulated(log_weights: torch.Tensor,
                               log_lik: torch.Tensor, state_mat: torch.Tensor,
                               u: torch.Tensor, *, ess_frac: float = 0.5,
                               always: bool = False, comb: bool = True):
    """The kernel's ``(ancestors, new_log_weights, estimate, stats)`` for
    ``(B, N)`` float32 ``log_weights``/``log_lik``, ``(B, N, D)``
    ``state_mat`` and ``(B,)`` ``u``, from its own order: the normalizer's
    parts and tree (``comb_merge``), ESS as ``s^2 / sum e^2``, the tile
    pass's double sums of ``w x`` (thread t's particles t, t + 256, ...,
    then the trees), the look-back scan's sums of ``w`` and the merge."""
    b, n = log_weights.shape
    d = state_mat.shape[-1]
    dev = log_weights.device
    thresh, neg_log_n = _constants(n, ess_frac)
    lw = torch.where(torch.isfinite(log_weights), log_weights + log_lik,
                     torch.full_like(log_weights, -math.inf))
    m, s_t, q_t = comb_merge.tile_parts(lw, squares=True)
    big, total, sq = comb_merge.combine_parts(m, s_t, q_t, finite_shift=True)
    mg = torch.where(torch.isfinite(big), big, torch.zeros_like(big))
    s = total.float()
    f32 = dict(dtype=torch.float32, device=dev)
    wn = torch.tensor(1.0, **f32) / torch.tensor(float(n), **f32)
    wn64 = wn.double()
    ess = torch.where(s > 0, (s.double() * s.double() / sq).float(),
                      (1.0 / (float(n) * (wn64 * wn64))).float())
    log_z = mg + torch.log(s)
    resampled = (ess < thresh) | bool(always)
    skew = torch.tensor(float(n), **f32) * torch.where(
        s > 0, torch.tensor(1.0, **f32) / s, wn)
    stats = torch.stack([ess, log_z, resampled.float(), mg, s, skew], -1)
    w = torch.where(s[:, None] > 0, torch.exp(lw - mg[:, None]) / s[:, None],
                    wn)
    new_lw = torch.where(resampled[:, None], torch.full_like(lw, neg_log_n),
                         lw - log_z[:, None])
    # the estimate: per tile, thread t's particles t + 256 k in order k
    nt = comb_merge.tiles(n)
    span, threads = comb_merge.SPAN, comb_merge.THREADS
    wp = torch.zeros((b, nt * span), dtype=torch.float64, device=dev)
    wp[:, :n] = w.double()
    xp = torch.zeros((b, nt * span, d), dtype=torch.float64, device=dev)
    xp[:, :n] = state_mat.double()
    prod = (wp[..., None] * xp).reshape(b, nt, span // threads, threads, d)
    parts = comb_merge.block_tree(
        comb_merge._sequence(prod.permute(0, 1, 4, 3, 2)))   # (b, nt, d)
    per = -(-nt // threads)
    pad = torch.zeros((b, d, per * threads), dtype=torch.float64, device=dev)
    pad[:, :, :nt] = parts.transpose(1, 2)
    est = comb_merge.block_tree(comb_merge._sequence(
        pad.reshape(b, d, per, threads).transpose(2, 3))).float()
    lane = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    anc = lane.clone()
    combs = resampled if comb else torch.zeros_like(resampled)
    if bool(combs.any()):
        cdf = scan.prefix_sum_emulated(w[combs].contiguous())
        anc[combs] = comb_merge.merge_ancestors(
            cdf, u.float()[combs], n)
    return anc, new_lw, est, stats


# ---------------------------------------------------------------------------
# The Hopper kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    """The library, bound once: a launch pays no ctypes set-up."""
    lib = build.library("sir_fused")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ppf_fused_normalize.argtypes = [p] * 5 + [i, i, f, i, p]
    lib.ppf_fused_normalize.restype = i
    lib.ppf_fused_commit.argtypes = [p] * 17 + [i, i, i, i, f,
                                                ctypes.c_uint, p]
    lib.ppf_fused_commit.restype = i
    lib.ppf_fused_weight_step_seven_pass.argtypes = [p] * 9 + [
        i, i, i, f, i, i, f, p]
    lib.ppf_fused_weight_step_seven_pass.restype = i
    lib.ppf_fused_seven_pass_scratch_floats.argtypes = [i, i, i]
    lib.ppf_fused_seven_pass_scratch_floats.restype = ctypes.c_longlong
    return lib


SCAL_BYTES = 32         # a member's scalars (the kernels' Scal)


class FusedPlan(NamedTuple):
    variant: str          # "merge", or "seven_pass" (the first design)
    tiles: int = 0        # tiles of comb_merge.SPAN particles a member
    groups: int = 0       # groups of scan.GROUP tiles a member
    diagonals: int = 0    # merge blocks a member (launched with comb only)
    flag_bytes: int = 0   # zeroed scratch: ticket, counters, then the slots
    work_bytes: int = 0   # scratch written before it is read
    agg_at: int = 0       # flags: the tile slots (B x tiles)
    grp_at: int = 0       # flags: the group slots (B x groups)
    scal_at: int = 0      # work: a member's scalars, after the B x tiles parts
    est_at: int = 0       # work: the B x tiles x D estimate parts (double)
    cdf_at: int = 0       # work: the B x N CDF
    coarse_at: int = 0    # work: its every COARSE-th value, B x samples
    splits_at: int = 0    # work: the merge's B x (diagonals + 1) splits


def plan(b: int, n: int, d: int) -> FusedPlan:
    """B2's launches for ``b`` members of ``n`` particles of ``d`` state
    dims, and the scratch layout ``ppf_fused_normalize`` and
    ``ppf_fused_commit`` read.  Pure Python; the C entries check the grids
    again."""
    nt = comb_merge.tiles(n)
    ng = -(-nt // scan.GROUP)
    diags = comb_merge.merge_blocks(n, n)
    agg_at = comb_merge.FLAGS_HEAD
    grp_at = agg_at + b * nt * comb_merge.SLOT_BYTES
    scal_at = b * nt * comb_merge.PART_BYTES
    est_at = scal_at + b * SCAL_BYTES
    cdf_at = comb_merge.align(est_at + b * nt * d * 8)
    coarse_at = comb_merge.align(cdf_at + b * n * 4)
    splits_at = comb_merge.align(
        coarse_at + b * comb_merge.coarse_samples(n) * 4)
    return FusedPlan("merge", nt, ng, diags,
                     grp_at + b * ng * comb_merge.SLOT_BYTES,
                     splits_at + b * (diags + 1) * 4, agg_at, grp_at,
                     scal_at, est_at, cdf_at, coarse_at, splits_at)


def _launch(p: FusedPlan, log_weights: torch.Tensor, log_lik: torch.Tensor,
            state_mat: torch.Tensor, u: torch.Tensor, ess_frac: float,
            always: bool, comb: bool):
    """Run plan ``p``'s kernels on checked inputs; count nothing.  The
    redesign's normalizer is launched before the outputs are allocated,
    so the allocations overlap it."""
    b, n = log_weights.shape
    d = state_mat.shape[2]
    dev = log_weights.device
    thresh, neg_log_n = _constants(n, ess_frac)
    stream = torch._C._cuda_getCurrentRawStream(log_weights.get_device())
    lib = _lib()
    if p.variant == "merge":
        flags, work, epoch = comb_merge.scratch(
            "fused", log_weights, stream, p.flag_bytes, p.work_bytes)
        err = lib.ppf_fused_normalize(
            log_weights.data_ptr(), log_lik.data_ptr(),
            flags + comb_merge.COUNTERS_AT, work, work + p.scal_at, b, n,
            thresh, int(always), stream)
    stats = torch.empty((b, 6), dtype=torch.float32, device=dev)
    anc = torch.empty((b, n), dtype=torch.int32, device=dev)
    new_lw = torch.empty((b, n), dtype=torch.float32, device=dev)
    est = torch.empty((b, d), dtype=torch.float32, device=dev)
    if p.variant == "merge":
        if err == 0:
            err = lib.ppf_fused_commit(
                log_weights.data_ptr(), log_lik.data_ptr(),
                state_mat.data_ptr(), u.data_ptr(), anc.data_ptr(),
                new_lw.data_ptr(), est.data_ptr(), stats.data_ptr(), flags,
                flags + comb_merge.COUNTERS_AT, work + p.scal_at,
                work + p.est_at, flags + p.agg_at, flags + p.grp_at,
                work + p.cdf_at, work + p.coarse_at, work + p.splits_at, b,
                n, d, int(comb), neg_log_n, epoch, stream)
    else:
        scratch = torch.empty(
            (lib.ppf_fused_seven_pass_scratch_floats(b, n, d),),
            dtype=torch.float32, device=dev)
        err = lib.ppf_fused_weight_step_seven_pass(
            log_weights.data_ptr(), log_lik.data_ptr(), state_mat.data_ptr(),
            u.data_ptr(), anc.data_ptr(), new_lw.data_ptr(), est.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(), b, n, d, thresh,
            int(always), int(comb), neg_log_n, stream)
    if err != 0:
        raise RuntimeError(f"fused_weight_step {p.variant} kernel launch "
                           f"failed: cudaError {err}")
    return anc, new_lw, est, stats


_CHECKED: dict = {}      # call signatures that passed the checks -> plan


def _check(log_weights, log_lik, state_mat, u) -> None:
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
    if n >= 2 ** 31 or b > comb_merge.MAX_MEMBERS:
        raise ValueError(f"bank {b} x {n} particles is beyond the kernel")


def fused_weight_step_kernel(log_weights: torch.Tensor, log_lik: torch.Tensor,
                             state_mat: torch.Tensor, u: torch.Tensor, *,
                             ess_frac: float = 0.5, always: bool = False,
                             comb: bool = True):
    """The fused weight phase on the card.

    Takes contiguous CUDA float32 ``log_weights``/``log_lik`` ``(B, N)``,
    ``state_mat`` ``(B, N, D)`` and ``u`` ``(B,)``; returns ``(ancestors
    (B, N) int32, new_log_weights (B, N), estimate (B, D), stats (B, 6))``
    with ``stats = [ess, log_z, resampled, max_shift, exp_sum,
    weight_skew]`` — the reference's layout with a bank dim.  A signature
    that passed the checks keeps its plan.
    """
    ts = (log_weights, log_lik, state_mat, u)
    sig = tuple((t.shape, t.dtype, t.device, t.is_contiguous()) for t in ts)
    p = _CHECKED.get(sig)
    if p is None:
        _check(*ts)
        p = plan(log_weights.shape[0], log_weights.shape[1],
                 state_mat.shape[2])
        if len(_CHECKED) >= 4096:
            _CHECKED.clear()
        _CHECKED[sig] = p
    out = _launch(p, *ts, ess_frac, always, comb)
    if log_weights.numel():
        fused_weight_step_kernel.launches += 1
        fused_weight_step_kernel.variants[p.variant] += 1
    return out


fused_weight_step_kernel.launches = 0
fused_weight_step_kernel.variants = {"merge": 0, "seven_pass": 0}


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
