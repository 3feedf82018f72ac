"""Resampling ancestors on the card (port of ``repro.kernels.resample``).

Three kernels of ``csrc/resample.cu``, each beside its plain torch
version, all with an explicit leading batch dim ``B`` (bank members or
DRA shards) and any length:

* ``systematic_ancestors_kernel`` (B1) — the normalized CDF and the
  systematic comb; plain version ``ref.systematic_ancestors_ref``;
* ``metropolis_ancestors_kernel`` (B4) — one Metropolis chain per output
  lane on injected draws; plain version ``metropolis_ancestors_ref``;
* ``rejection_ancestors_kernel`` (B5) — rejection against the member's
  max, then a Metropolis fallback chain; plain version
  ``rejection_ancestors_ref``.

B4 and B5 have two chain kernels, which ``plan`` chooses between from the
shapes and the draws' alignment alone: ``"tma"`` (``k_chain_tma``, the
draws streamed through shared memory in coalesced tiles) for the
reference's budget of 32 on 16-byte aligned draws, ``"lane"``
(``k_chain``, the first design, one thread reading its own rows) for any
other.  Each wrapper counts its launches per variant in ``.variants``.

The kernel wrappers take CUDA tensors only and raise on anything else;
``repro_torch.kernels.ops`` dispatches on the device.  The reference's
``pick_block``/``kernel_applicable`` have no counterpart: every shape
takes the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_c_p = ctypes.c_void_p
_c_i = ctypes.c_int


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def dead_slot_guard(ancestors: torch.Tensor,
                    log_weights: torch.Tensor) -> torch.Tensor:
    """Redirect lanes whose slot has zero weight to the member's argmax
    (the first index of the max; 0 for an all ``-inf`` member)."""
    hot = log_weights.argmax(-1, keepdim=True).to(torch.int32)
    alive = torch.isfinite(log_weights.gather(-1, ancestors.long()))
    return torch.where(alive, ancestors, hot.expand(ancestors.shape))


def _chain_start(log_weights: torch.Tensor, proposals: torch.Tensor):
    lanes = proposals.shape[-2]
    lane = torch.arange(lanes, device=proposals.device)
    return (lane % log_weights.shape[-1]).expand(proposals.shape[:-1])


def _metropolis_steps(log_weights, proposals, log_us, a, steps):
    for r in steps:
        j = proposals[..., r].long()
        accept = log_us[..., r] < (log_weights.gather(-1, j)
                                   - log_weights.gather(-1, a))
        a = torch.where(accept, j, a)
    return a


def metropolis_ancestors_ref(log_weights: torch.Tensor,
                             proposals: torch.Tensor,
                             log_us: torch.Tensor) -> torch.Tensor:
    """``(..., lanes)`` Metropolis-chain ancestors of ``(..., n_in)``
    log-weights on ``(..., lanes, iters)`` int proposals and log-uniforms:
    lane ``l`` starts at ``l % n_in`` and moves to ``j`` iff
    ``log u < lw[j] - lw[a]``; dead final slots take the argmax."""
    a = _metropolis_steps(log_weights, proposals, log_us,
                          _chain_start(log_weights, proposals),
                          range(proposals.shape[-1]))
    return dead_slot_guard(a.to(torch.int32), log_weights)


def rejection_ancestors_ref(log_weights: torch.Tensor,
                            proposals: torch.Tensor,
                            log_us: torch.Tensor) -> torch.Tensor:
    """``(..., lanes)`` rejection ancestors: the first ``iters // 2`` draws
    accept ``j`` iff ``log u < lw[j] - max lw`` (the first accept is
    kept); lanes with none take a Metropolis chain from ``l % n_in`` over
    the rest; dead final slots take the argmax."""
    tries = proposals.shape[-1]
    m = log_weights.amax(-1, keepdim=True)
    a_rej = torch.zeros(proposals.shape[:-1], dtype=torch.long,
                        device=proposals.device)
    accepted = torch.zeros(proposals.shape[:-1], dtype=torch.bool,
                           device=proposals.device)
    for r in range(tries // 2):
        j = proposals[..., r].long()
        acc = log_us[..., r] < log_weights.gather(-1, j) - m
        a_rej = torch.where(acc & ~accepted, j, a_rej)
        accepted = accepted | acc
    a_mh = _metropolis_steps(log_weights, proposals, log_us,
                             _chain_start(log_weights, proposals),
                             range(tries // 2, tries))
    return dead_slot_guard(torch.where(accepted, a_rej, a_mh)
                           .to(torch.int32), log_weights)


# ---------------------------------------------------------------------------
# The Hopper kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    """The library, bound once: a launch pays no ctypes set-up."""
    lib = build.library("resample")
    lib.ppf_systematic_ancestors.argtypes = [_c_p, _c_p, _c_p, _c_p, _c_i,
                                             _c_i, _c_i, _c_p]
    lib.ppf_systematic_ancestors.restype = _c_i
    lib.ppf_systematic_scratch_floats.argtypes = [_c_i, _c_i]
    lib.ppf_systematic_scratch_floats.restype = ctypes.c_longlong
    lib.ppf_chain_ancestors.argtypes = [_c_p, _c_p, _c_p, _c_p, _c_p, _c_i,
                                        _c_i, _c_i, _c_i, _c_i, _c_p]
    lib.ppf_chain_ancestors.restype = _c_i
    lib.ppf_chain_tma_ancestors.argtypes = lib.ppf_chain_ancestors.argtypes
    lib.ppf_chain_tma_ancestors.restype = _c_i
    lib.ppf_chain_scratch_floats.argtypes = [_c_i, _c_i]
    lib.ppf_chain_scratch_floats.restype = ctypes.c_longlong
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be on {device} (a CUDA device), got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {shape}, got "
                         f"{tuple(t.shape)}")


def _check_sizes(b: int, n_in: int, n_out: int) -> None:
    if n_in < 1 or n_in >= 2 ** 31 or n_out >= 2 ** 31 or b > 65535:
        raise ValueError(f"batch {b} x {n_in} inputs -> {n_out} outputs is "
                         f"beyond the kernel")


def systematic_ancestors_kernel(log_weights: torch.Tensor, u: torch.Tensor,
                                n_out: int) -> torch.Tensor:
    """B1 on the card: ``(B, n_out)`` int32 ancestors of contiguous CUDA
    float32 ``log_weights`` ``(B, n_in)`` with comb offsets ``u``
    ``(B,)``."""
    if log_weights.dim() != 2:
        raise ValueError(f"log_weights (B, n_in) expected, got "
                         f"{tuple(log_weights.shape)}")
    b, n_in = log_weights.shape
    dev = log_weights.device
    _check("log_weights", log_weights, (b, n_in), torch.float32, dev)
    _check("u", u, (b,), torch.float32, dev)
    _check_sizes(b, n_in, n_out)
    lib = _lib()
    anc = torch.empty((b, n_out), dtype=torch.int32, device=dev)
    scratch = torch.empty((lib.ppf_systematic_scratch_floats(b, n_in),),
                          dtype=torch.float32, device=dev)
    err = lib.ppf_systematic_ancestors(
        log_weights.data_ptr(), u.data_ptr(), anc.data_ptr(),
        scratch.data_ptr(), b, n_in, n_out,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"systematic_ancestors kernel launch failed: "
                           f"cudaError {err}")
    systematic_ancestors_kernel.launches += 1
    return anc


# k_chain_tma's draw budget (the reference's METROPOLIS_ITERS and
# REJECTION_TRIES) and the alignment its tensor maps need
TMA_ITERS = 32
TMA_ALIGN = 16


class ChainPlan(NamedTuple):
    variant: str        # "tma" or "lane"


def plan(b: int, n_out: int, iters: int, aligned: bool) -> ChainPlan:
    """The chain kernel for ``b`` members of ``n_out`` lanes with an
    ``iters`` draw budget: ``"tma"`` at the reference's budget on 16-byte
    aligned draws (``aligned``) of fewer than 2^31 rows in all, else
    ``"lane"``.  Pure Python: the rule ``ppf_chain_tma_ancestors`` checks
    again."""
    if iters == TMA_ITERS and aligned and b * n_out < 2 ** 31:
        return ChainPlan("tma")
    return ChainPlan("lane")


def _chain_kernel(log_weights: torch.Tensor, proposals: torch.Tensor,
                  log_us: torch.Tensor, reject: bool,
                  variant: str | None = None) -> tuple[torch.Tensor, str]:
    """Launch a chain kernel; ``variant`` overrides ``plan`` (a timing
    yardstick launches the lane kernel at budget 32 so).  Returns the
    ancestors and the variant that ran."""
    if log_weights.dim() != 2 or proposals.dim() != 3:
        raise ValueError(f"log_weights (B, n_in) and proposals (B, lanes, "
                         f"iters) expected, got {tuple(log_weights.shape)}, "
                         f"{tuple(proposals.shape)}")
    b, n_in = log_weights.shape
    _, n_out, iters = proposals.shape
    dev = log_weights.device
    _check("log_weights", log_weights, (b, n_in), torch.float32, dev)
    _check("proposals", proposals, (b, n_out, iters), torch.int32, dev)
    _check("log_us", log_us, (b, n_out, iters), torch.float32, dev)
    _check_sizes(b, n_in, n_out)
    if iters < 1:
        raise ValueError(f"draw budget {iters} must be positive")
    aligned = (proposals.data_ptr() % TMA_ALIGN == 0
               and log_us.data_ptr() % TMA_ALIGN == 0)
    chosen = plan(b, n_out, iters, aligned).variant
    variant = variant or chosen
    if variant == "tma" and chosen != "tma":
        raise ValueError(f"the tma chain kernel takes budget {TMA_ITERS} on "
                         f"{TMA_ALIGN}-byte aligned draws, got {iters}")
    lib = _lib()
    launch = (lib.ppf_chain_tma_ancestors if variant == "tma"
              else lib.ppf_chain_ancestors)
    anc = torch.empty((b, n_out), dtype=torch.int32, device=dev)
    scratch = torch.empty((lib.ppf_chain_scratch_floats(b, n_in),),
                          dtype=torch.float32, device=dev)
    err = launch(
        log_weights.data_ptr(), proposals.data_ptr(), log_us.data_ptr(),
        anc.data_ptr(), scratch.data_ptr(), b, n_in, n_out, iters,
        int(reject), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{'rejection' if reject else 'metropolis'}"
                           f"_ancestors {variant} kernel launch failed: "
                           f"error {err}")
    return anc, variant


def metropolis_ancestors_kernel(log_weights: torch.Tensor,
                                proposals: torch.Tensor,
                                log_us: torch.Tensor) -> torch.Tensor:
    """B4 on the card: ``(B, lanes)`` int32 ancestors of contiguous CUDA
    float32 ``log_weights`` ``(B, n_in)``, int32 ``proposals`` and
    float32 ``log_us`` ``(B, lanes, iters)``."""
    anc, variant = _chain_kernel(log_weights, proposals, log_us, reject=False)
    metropolis_ancestors_kernel.launches += 1
    metropolis_ancestors_kernel.variants[variant] += 1
    return anc


def rejection_ancestors_kernel(log_weights: torch.Tensor,
                               proposals: torch.Tensor,
                               log_us: torch.Tensor) -> torch.Tensor:
    """B5 on the card; arguments as ``metropolis_ancestors_kernel``."""
    anc, variant = _chain_kernel(log_weights, proposals, log_us, reject=True)
    rejection_ancestors_kernel.launches += 1
    rejection_ancestors_kernel.variants[variant] += 1
    return anc


systematic_ancestors_kernel.launches = 0
metropolis_ancestors_kernel.launches = 0
metropolis_ancestors_kernel.variants = {"tma": 0, "lane": 0}
rejection_ancestors_kernel.launches = 0
rejection_ancestors_kernel.variants = {"tma": 0, "lane": 0}
