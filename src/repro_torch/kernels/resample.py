"""Resampling ancestors on the card (port of ``repro.kernels.resample``).

Three kernels of ``csrc/resample.cu``, each beside its plain torch
version, all with an explicit leading batch dim ``B`` (bank members or
DRA shards) and any length:

* ``systematic_ancestors_kernel`` (B1) — the normalized CDF and the
  systematic comb; plain version ``ref.systematic_ancestors_ref``;
  ``systematic_ancestors_emulated`` is the kernel's order of sums and its
  merge written in torch (its bits on any device);
* ``metropolis_ancestors_kernel`` (B4) — one Metropolis chain per output
  lane on injected draws; plain version ``metropolis_ancestors_ref``;
* ``rejection_ancestors_kernel`` (B5) — rejection against the member's
  max, then a Metropolis fallback chain; plain version
  ``rejection_ancestors_ref``.

B1 is four launches on every call (``systematic_plan``'s ``"merge"``:
the normalizer, the look-back CDF, the merge's splits and the merge comb
of ``csrc/comb_merge.cuh``); the first design (``"seven_pass"``: seven
launches ending in a per-lane bisection) stays launchable through
``_sys_launch`` for same-run timing.  Its scratch is kept per device and
stream (``comb_merge.scratch``).

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

from repro_torch.kernels import build, comb_merge, scan

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
    lib.ppf_systematic_normalize.argtypes = [_c_p] * 4 + [_c_i, _c_i, _c_p]
    lib.ppf_systematic_normalize.restype = _c_i
    lib.ppf_systematic_comb.argtypes = [_c_p] * 10 + [
        _c_i, _c_i, _c_i, ctypes.c_uint, _c_p]
    lib.ppf_systematic_comb.restype = _c_i
    lib.ppf_systematic_ancestors_seven_pass.argtypes = [
        _c_p, _c_p, _c_p, _c_p, _c_i, _c_i, _c_i, _c_p]
    lib.ppf_systematic_ancestors_seven_pass.restype = _c_i
    lib.ppf_systematic_seven_pass_scratch_floats.argtypes = [_c_i, _c_i]
    lib.ppf_systematic_seven_pass_scratch_floats.restype = ctypes.c_longlong
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


class SysPlan(NamedTuple):
    variant: str          # "merge", or "seven_pass" (the first design)
    tiles: int = 0        # tiles of comb_merge.SPAN weights a member
    groups: int = 0       # groups of scan.GROUP tiles a member
    diagonals: int = 0    # merge blocks a member
    flag_bytes: int = 0   # zeroed scratch: ticket, counters, then the slots
    work_bytes: int = 0   # scratch written before it is read
    agg_at: int = 0       # flags: the tile slots (B x tiles)
    grp_at: int = 0       # flags: the group slots (B x groups)
    ms_at: int = 0        # work: (m, s) a member, after the B x tiles parts
    cdf_at: int = 0       # work: the B x n_in CDF
    coarse_at: int = 0    # work: its every COARSE-th value, B x samples
    splits_at: int = 0    # work: the merge's B x (diagonals + 1) splits


def systematic_plan(b: int, n_in: int, n_out: int) -> SysPlan:
    """B1's launches for ``b`` members of ``n_in`` weights and ``n_out``
    comb points, and the scratch layout ``ppf_systematic_normalize`` and
    ``ppf_systematic_comb`` read.  Pure Python; the C entries check the
    grids again."""
    nt = comb_merge.tiles(n_in)
    ng = -(-nt // scan.GROUP)
    diags = comb_merge.merge_blocks(n_in, n_out)
    agg_at = comb_merge.FLAGS_HEAD
    grp_at = agg_at + b * nt * comb_merge.SLOT_BYTES
    ms_at = b * nt * comb_merge.PART_BYTES
    cdf_at = comb_merge.align(ms_at + b * 8)
    coarse_at = comb_merge.align(cdf_at + b * n_in * 4)
    splits_at = comb_merge.align(
        coarse_at + b * comb_merge.coarse_samples(n_in) * 4)
    return SysPlan("merge", nt, ng, diags,
                   grp_at + b * ng * comb_merge.SLOT_BYTES,
                   splits_at + b * (diags + 1) * 4, agg_at, grp_at, ms_at,
                   cdf_at, coarse_at, splits_at)


def systematic_ancestors_emulated(log_weights: torch.Tensor, u: torch.Tensor,
                                  n_out: int) -> torch.Tensor:
    """B1's ``(B, n_out)`` int32 result for float32 ``log_weights`` ``(B,
    n_in)`` and offsets ``u`` ``(B,)``, from the kernel's own order: the
    normalizer's parts and their tree (``comb_merge``), the look-back
    scan's sums (``scan.prefix_sum_emulated``) of ``w = exp(lw - m) / s``,
    and the merge comb."""
    m, s, _ = comb_merge.tile_parts(log_weights)
    big, total, _ = comb_merge.combine_parts(m, s)
    w = torch.exp(log_weights - big[:, None]) / total.float()[:, None]
    return comb_merge.merge_ancestors(scan.prefix_sum_emulated(w), u, n_out)


def _sys_launch(p: SysPlan, log_weights: torch.Tensor, u: torch.Tensor,
                n_out: int) -> torch.Tensor:
    """Run plan ``p``'s kernels on checked inputs and return the ancestors;
    count nothing.  The redesign's normalizer is launched before the
    output is allocated, so the allocation overlaps it."""
    b, n_in = log_weights.shape
    dev = log_weights.device
    stream = torch._C._cuda_getCurrentRawStream(log_weights.get_device())
    lib = _lib()
    if p.variant == "merge":
        flags, work, epoch = comb_merge.scratch(
            "systematic", log_weights, stream, p.flag_bytes, p.work_bytes)
        err = lib.ppf_systematic_normalize(
            log_weights.data_ptr(), flags + comb_merge.COUNTERS_AT, work,
            work + p.ms_at, b, n_in, stream)
        anc = torch.empty((b, n_out), dtype=torch.int32, device=dev)
        if err == 0:
            err = lib.ppf_systematic_comb(
                log_weights.data_ptr(), u.data_ptr(), anc.data_ptr(), flags,
                work + p.ms_at, flags + p.agg_at, flags + p.grp_at,
                work + p.cdf_at, work + p.coarse_at, work + p.splits_at, b,
                n_in, n_out, epoch, stream)
    else:
        anc = torch.empty((b, n_out), dtype=torch.int32, device=dev)
        scratch = torch.empty(
            (lib.ppf_systematic_seven_pass_scratch_floats(b, n_in),),
            dtype=torch.float32, device=dev)
        err = lib.ppf_systematic_ancestors_seven_pass(
            log_weights.data_ptr(), u.data_ptr(), anc.data_ptr(),
            scratch.data_ptr(), b, n_in, n_out, stream)
    if err != 0:
        raise RuntimeError(f"systematic_ancestors {p.variant} kernel launch "
                           f"failed: cudaError {err}")
    return anc


_SYS_CHECKED: dict = {}     # call signatures that passed the checks -> plan


def systematic_ancestors_kernel(log_weights: torch.Tensor, u: torch.Tensor,
                                n_out: int) -> torch.Tensor:
    """B1 on the card: ``(B, n_out)`` int32 ancestors of contiguous CUDA
    float32 ``log_weights`` ``(B, n_in)`` with comb offsets ``u``
    ``(B,)``.  A signature that passed the checks keeps its plan."""
    sig = (log_weights.shape, log_weights.dtype, log_weights.device,
           log_weights.is_contiguous(), u.shape, u.dtype, u.device,
           u.is_contiguous(), n_out)
    p = _SYS_CHECKED.get(sig)
    if p is None:
        if log_weights.dim() != 2:
            raise ValueError(f"log_weights (B, n_in) expected, got "
                             f"{tuple(log_weights.shape)}")
        b, n_in = log_weights.shape
        dev = log_weights.device
        _check("log_weights", log_weights, (b, n_in), torch.float32, dev)
        _check("u", u, (b,), torch.float32, dev)
        _check_sizes(b, n_in, n_out)
        p = systematic_plan(b, n_in, n_out)
        if len(_SYS_CHECKED) >= 4096:
            _SYS_CHECKED.clear()
        _SYS_CHECKED[sig] = p
    b = log_weights.shape[0]
    if not (b and n_out):
        return torch.empty((b, n_out), dtype=torch.int32,
                           device=log_weights.device)
    anc = _sys_launch(p, log_weights, u, n_out)
    systematic_ancestors_kernel.launches += 1
    systematic_ancestors_kernel.variants[p.variant] += 1
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
systematic_ancestors_kernel.variants = {"merge": 0, "seven_pass": 0}
metropolis_ancestors_kernel.launches = 0
metropolis_ancestors_kernel.variants = {"tma": 0, "lane": 0}
rejection_ancestors_kernel.launches = 0
rejection_ancestors_kernel.variants = {"tma": 0, "lane": 0}
