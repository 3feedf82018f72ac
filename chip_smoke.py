#!/usr/bin/env python3
"""Drive the torch port's main path on one CUDA card.

    python3 chip_smoke.py [--out FILE]

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   Hopper kernel from ``src/repro_torch/csrc`` with ``nvcc`` (one process
   per source, in parallel) into ``src/repro_torch/_build/``;
2. holds each kernel against its plain torch version on the card, at the
   slice's shapes, and requires two runs of each kernel to give the same
   bits; reads B6's prefill variant's SASS for unserialized wgmma.  B3
   (the separable kernel) also at R = 2, 6 and 9, in the Eq. 4 form and
   an Eq. 4 close fit, on converged clouds in no slot order (the staged
   window box, with outliers, too wide for the box), and on halo slabs
   and a frame view at an odd column, bit for bit equal to the full
   frame.  The comb scan (one launch) is held against the float64 scan at
   the composed step's, RPA's and SMC decoding's shapes, ragged rows
   about the tile span, 1024 rows of 4097 and a row whose mass is all in
   its last element, with the systematic, stratified and multinomial
   combs built on it; B4/B5 both on the tma kernel that ``plan`` picks at
   the reference's budget and on the lane kernel;
3. runs the paper's §VII.C tracking filter at full width — 512×512
   frames, SNR 2, N = 2^22 particles, fused step — over 40-frame movies
   made on the card, for 8 seeds, and checks its RMSE, ESS and
   log-marginals;
4. runs a FilterBank of 8 members × 2^20 particles over 40 frames of
   512×512 and checks every member's RMSE, and that member 0 equals a
   standalone filter with the same seed bit for bit.  The RMSE bound is
   the reference's 1.5 px, after a warm-up of 20 frames: from a prior
   uniform over a 512×512 frame the filter can take more than 10 frames
   to find the spot at SNR 2 (each run's lock-on frame is printed);
5. runs the composed default config (systematic comb) at N = 2^22 over
   the same 40-frame movie three times, through the patch kernel and the
   comb scan once a frame each: the runs must agree bit for bit and pass
   the tracking gate;
5b. runs the single filter at N = 2^22 on the same 512×512 movie with the
   collective-free resamplers (fused step, ``metropolis`` and
   ``rejection``), through the patch, fused and chain kernels;
5c. runs the paper's distributed filter on an emulated 8-shard mesh,
   8 × 2^22 = 2^25 particles over the same movie, for MPF, RNA and RPA,
   and checks tracking, repeatability, the comm accounting against the
   analytic formulas and the kernels it launched;
5d. serves the qwen3-32b architecture at full width (d_model 5120, 64/8
   heads, d_ff 25600, vocab 151936) with 16 of its 64 layers and random
   bf16 weights drawn on the card: ``generate`` (4 prompts × 1024
   tokens, 32 greedy steps) and ``smc_decode`` (the same prompts, K = 8
   particles, 32 steps, τ = 1.5, systematic resampling), each through
   the flash-attention kernel (B6) once per layer and forward call: the
   prefill on its wgmma variant, every decode step on its split-key
   variant (the per-variant launch counts are checked).  It checks
   decode against prefill logits, repeatability, that SMC
   sequences are the recorded genealogy's paths, log Z and ESS, and a
   τ = 1 run's uniform weights;
6. holds B3 against its plain version on its timing inputs — (i) the
   single filter's final particles in ancestor order, (ii) the same under
   a fixed permutation, (iii) RNA's final 8 x 2^22 ensemble, and the bank
   shape on uniformly spread particles — and times B3 and the comb scan
   beside their first designs on the same inputs, in turns (new, first,
   first, new), failing unless the new B3 is faster at every input and
   the new scan at 8 x 2^22; then
   times each kernel and its plain version (median of 20 CUDA-event
   timed launches) beside the kernel's bound and, for B6, PyTorch's
   ``scaled_dot_product_attention`` on the same inputs and B6's
   mma.sync kernel launched directly, for the comb scan ``torch.cumsum``,
   for B4/B5 their lane kernel launched directly (yardsticks: the port
   never calls SDPA or a float ``torch.cumsum`` on the card, and takes the
   mma.sync and lane kernels only at other shapes), and the end-to-end
   frames/s and tokens/s.

The launch counters are set to 0 just before each main-path run and read
just after; a kernel the run did not launch fails the script.  Any failed
check raises, so the script exits non-zero and prints no result line.
Without a CUDA device it exits non-zero at once.  The last line is
``{"ok": true, "device": {...}}``; the line before it the card; before
that the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor FP32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PATCH_TOL = 3e-5          # rtol = atol, the reference's kernel bound
FUSED_TOL = 2e-6          # rtol = atol on scalars / estimate / log-weights
TIE_DELTA = 1e-5          # kernel vs plain: comb point to a float64 CDF
                          # boundary (torch's CUDA cumsum is off by ~4e-6)
COMB_TOL = 5e-7           # kernel vs the float64 CDF's comb: ~8 ulp of 1
REPS = 20
# tracking gates at the paper's 512x512 frame, SNR 2: the reference's
# 1.5 px bound (tests/test_tracking.py), after a warm-up of 20 frames,
# not the 10 that bound uses at 64x64.  From a prior uniform over a
# 512x512 frame the filter can take more than 10 frames to find the spot
# (lock-on frames are printed; PERF.md and ROADMAP C4 give the readings)
FRAMES, WARMUP, RMSE_PX, LOCK_PX = 40, 20, 1.5, 2.0
N_SEEDS = 8
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
ATTN_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 2e-5}
# the LM phase: qwen3-32b at full width, 16 of its 64 layers (64 layers
# of bf16 weights are 65.5 GB: too little of 80 GB would be left for the
# K-particle caches and their resampling gather)
LM_ARCH, LM_LAYERS, LM_SEED = "qwen3-32b", 16, 0
LM_BATCH, LM_PROMPT, LM_STEPS, LM_K, LM_TAU = 4, 1024, 32, 8, 1.5
LM_CHECK_STEPS = (1, 8, 31)
# decode vs prefill logits in bf16: a bf16 step is 2^-8 relative, the
# residual stream takes ~64 roundings over 16 layers (a random walk of
# ~0.03 relative), and the logits reach |4.5| over 151936 entries
LM_LOGIT_TOL = 0.15


def card() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bits(t):
    """A tensor's raw bits, so NaN == NaN in bitwise comparisons."""
    import torch
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def same_bits(a, b) -> bool:
    import torch
    return torch.equal(bits(a), bits(b))


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after two warm-ups."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS) -> float:
    """CUDA-event time of ``reps`` back-to-back calls of ``fn()`` over
    ``reps``, after two warm-ups: the device's time per call wherever the
    host enqueues faster than the card runs."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(new, first) -> tuple[float, float]:
    """``cuda_ms`` of two versions of a kernel on the same inputs, in
    turns (new, first, first, new): the mean of each one's two medians."""
    a, b, c, d = cuda_ms(new), cuda_ms(first), cuda_ms(first), cuda_ms(new)
    return (a + d) / 2, (b + c) / 2


def max_err(got, want, tol: float) -> float:
    """Max |got - want| after checking ``|got-want| ≤ tol + tol·|want|``."""
    import torch
    got, want = got.double(), want.double()
    finite = torch.isfinite(want)
    check(torch.equal(finite, torch.isfinite(got)),
          "finite pattern differs from the plain version")
    diff = (got - want).abs()[finite]
    bound = tol + tol * want.abs()[finite]
    if diff.numel():
        worst = float((diff - bound).max())
        check(worst <= 0, f"error {float(diff.max()):.3g} beyond rtol=atol="
                          f"{tol} (excess {worst:.3g})")
        return float(diff.max())
    return 0.0


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def patch_inputs(b, n, h, w, seed, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    state = torch.empty((b, n, 5), device=dev)
    state[..., 0] = torch.rand((b, n), generator=g, device=dev) * (h - 1)
    state[..., 1] = torch.rand((b, n), generator=g, device=dev) * (w - 1)
    state[..., 2:4] = torch.randn((b, n, 2), generator=g, device=dev)
    state[..., 4] = torch.rand((b, n), generator=g, device=dev) * 3.0
    frames = torch.randn((b, h, w), generator=g, device=dev)
    return state, frames


def converged(state, center, spread, seed, dev):
    """Put ``state``'s particles in a cloud of ``spread`` px around
    ``center``, in no slot order (a converged posterior after a resampler
    that does not keep ancestor order)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = state.shape[:-1] + (2,)
    state[..., 0:2] = (torch.tensor(center, device=dev)
                       + spread * torch.randn(shape, generator=g, device=dev))
    return state


def close_fit_inputs(n, dev, h=512, w=512, spacing=24, i0=2.0):
    """Eq. 4 near a perfect fit: a frame of far-apart spots (``spacing``
    px) and ``n`` particles each sitting on one of them with its
    intensity, so every window's residuals are a few ulp."""
    import torch
    from repro_torch.models.tracking import TrackingConfig
    sig = TrackingConfig().sigma_psf
    ys = torch.arange(spacing, h - spacing, spacing, device=dev,
                      dtype=torch.float64) + 0.3
    xs = torch.arange(spacing, w - spacing, spacing, device=dev,
                      dtype=torch.float64) + 0.6
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    cy, cx = cy.reshape(-1), cx.reshape(-1)
    yy = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    frame = torch.zeros((h, w), device=dev, dtype=torch.float64)
    for k in range(cy.numel()):
        frame += i0 * torch.exp(-((yy - cy[k]) ** 2 + (xx - cx[k]) ** 2)
                                / (2 * sig * sig))
    pick = torch.arange(n, device=dev) % cy.numel()
    state = torch.zeros((1, n, 5), device=dev)
    state[0, :, 0] = cy[pick].float()
    state[0, :, 1] = cx[pick].float()
    state[0, :, 4] = i0
    return state, frame.float()[None]


def check_patch(dev) -> dict:
    """B3 (``k_patch_sep``) against its plain version within PATCH_TOL and
    bit for bit on a second launch: the main path's shapes, R = 2, 6 and
    9 (the looped kernel; R = 4 is unrolled), the Eq. 4 form and an Eq. 4
    close fit, converged clouds in no slot order (the block-staged box,
    with outliers and too wide for the box), the halo-slab geometry at an
    aligned and an odd origin and a frame view at an odd column (the
    4-byte loads), each bit for bit equal to the full frame's.  Every
    launch takes the separable variant."""
    import torch
    from repro_torch.kernels import patch_likelihood, ref

    def plain(state, frames, **kw):
        return ref.patch_log_likelihood_ref(state[..., 0], state[..., 1],
                                            state[..., 4], frames, **kw)

    kern = patch_likelihood.patch_log_likelihood_kernel
    kern.variants.update(dict.fromkeys(kern.variants, 0))
    launched = 0

    def held(label, state, frames, **kw):
        nonlocal launched
        got = kern(state, frames, **kw)
        again = kern(state, frames, **kw)
        launched += 2
        check(same_bits(got, again), f"patch kernel not repeatable: {label}")
        err = max_err(got, plain(state, frames, **kw), PATCH_TOL)
        log(f"patch {label}: max_abs_err={err:.3g}, repeatable")
        return got, err

    worst = 0.0
    cases = [(1, 2 ** 22, True, 4), (8, 2 ** 20, True, 4),
             (2, 2 ** 16, False, 4), (1, 2 ** 20, True, 2),
             (1, 2 ** 20, False, 6), (1, 2 ** 18, True, 9)]
    for b, n, matched, radius in cases:
        state, frames = patch_inputs(b, n, 512, 512, 7 + b, dev)
        # exact .5 positions pin round-half-to-even
        state[:, :64, 0] = torch.arange(64, device=dev) + 100.5
        state[:, :64, 1] = torch.arange(64, device=dev) + 7.5
        _, err = held(f"B={b} N={n} matched={matched} R={radius}", state,
                      frames, matched=matched, radius=radius)
        worst = max(worst, err)
    # converged clouds in no slot order: the staged box, with 2% outliers
    # (outside it), and a cloud too wide for the bounding box
    for label, spread, outliers in (("cloud 1 px", 1.0, 0.0),
                                    ("cloud 1 px, 2% outliers", 1.0, 0.02),
                                    ("cloud 15 px", 15.0, 0.0)):
        state, frames = patch_inputs(2, 2 ** 20, 512, 512, 31, dev)
        converged(state, (200.0, 300.0), spread, 32, dev)
        far = torch.rand(state.shape[:2], device=dev) < outliers
        anywhere = torch.rand(state.shape[:2] + (2,), device=dev) * 511.0
        state[..., 0:2] = torch.where(far[..., None], anywhere,
                                      state[..., 0:2])
        for matched in (True, False):
            _, err = held(f"{label}, matched={matched}", state, frames,
                          matched=matched)
            worst = max(worst, err)
    # Eq. 4 close fit: residuals of a few ulp, log-likelihoods near 0
    state, frames = close_fit_inputs(2 ** 16, dev)
    got, err = held("Eq. 4 close fit", state, frames, matched=False)
    check(float(got.abs().max()) < 1e-4, "Eq. 4 close fit is not close")
    worst = max(worst, err)
    # halo-slab geometry: a slab of rows/cols [128, 384) plus a radius-4
    # halo (and one at an odd origin: 4-byte loads), evaluated with
    # center_bounds/frame_origin, equals the full frame bit for bit
    state, frames = patch_inputs(2, 2 ** 16, 512, 512, 99, dev)
    state[..., 0:2] = 128.0 + torch.rand((2, 2 ** 16, 2), device=dev) * 255.0
    full, err_full = held("full frame for the slabs", state, frames)
    for lo in (124, 123):
        slab = frames[:, lo:388 + (124 - lo), lo:388 + (124 - lo)]
        geom = dict(center_bounds=(128, 383, 128, 383),
                    frame_origin=(lo, lo))
        got, err = held(f"slab at ({lo}, {lo})", state, slab, **geom)
        check(same_bits(got, full),
              f"slab at ({lo}, {lo}) differs from the full frame")
        worst = max(worst, err, err_full)
    # a frame view one column in (not 16-byte aligned): the 4-byte loads
    wide = torch.randn((2, 512, 520), device=dev)
    wide[:, :, 1:513] = frames
    got, err = held("frame view at an odd column", state, wide[:, :, 1:513])
    check(same_bits(got, full), "4-byte loads differ from 16-byte loads")
    worst = max(worst, err)
    check(kern.variants == {"separable": launched, "direct": 0},
          f"patch variants {kern.variants}")
    return {"max_abs_err": worst}


def check_patch_inputs(inputs: dict) -> None:
    """B3 on the timing inputs (the filters' own particles) against its
    plain version, member by member, and bit for bit on a second launch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.patch_likelihood import \
        patch_log_likelihood_kernel as kern
    for label, (state, frames) in inputs.items():
        got = kern(state, frames)
        check(same_bits(got, kern(state, frames)),
              f"patch kernel not repeatable on {label}")
        err = max(max_err(got[i], ref.patch_log_likelihood_ref(
            state[i, :, 0], state[i, :, 1], state[i, :, 4], frames[i]),
            PATCH_TOL) for i in range(state.shape[0]))
        log(f"patch timing input {label} {tuple(state.shape[:2])}: "
            f"max_abs_err={err:.3g}, repeatable")


def fused_inputs(b, n, seed, dev, d=5):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lw = (torch.full((b, n), -math.log(n), device=dev)
          + 0.1 * torch.randn((b, n), generator=g, device=dev))
    ll = 2.0 * torch.randn((b, n), generator=g, device=dev)
    state = torch.rand((b, n, d), generator=g, device=dev) * 512.0
    u = torch.rand((b,), generator=g, device=dev)
    return lw, ll, state, u


def comb_ties_ok(anc_k, anc_p, w, u) -> tuple[int, float]:
    """Ancestors must agree except where the comb point lies within
    TIE_DELTA of the float64 CDF at both disagreeing boundaries: two f32
    scans summed in different orders differ by a few ulp of 1, and at
    N = 2^22 one ulp (6e-8) is a quarter of the comb spacing, so many
    lanes may fall on either side.  Returns the number of tie lanes and
    the largest such distance (CDF units)."""
    import torch
    n = anc_k.shape[-1]                  # comb points (n_out)
    lanes = torch.arange(n, device=anc_k.device, dtype=torch.float32)
    pos = ((lanes + u.float()[:, None]) / n).double()
    return comb_ties_at(anc_k, anc_p, torch.cumsum(w.double(), -1), pos)


def comb_ties_at(anc_k, anc_p, cdf64, pos) -> tuple[int, float]:
    """``comb_ties_ok`` for any sorted comb: ``pos`` (float64, one point
    per lane) and the float64 CDF ``cdf64`` given."""
    import torch
    b, i = (anc_k != anc_p).nonzero(as_tuple=True)
    if b.numel() == 0:
        return 0, 0.0
    lo = torch.minimum(anc_k[b, i], anc_p[b, i]).long()
    hi = torch.maximum(anc_k[b, i], anc_p[b, i]).long()
    p = pos[b, i]
    off = torch.maximum((cdf64[b, lo] - p).abs(),
                        (cdf64[b, hi - 1] - p).abs())
    worst = float(off.max())
    check(worst <= TIE_DELTA, f"ancestor mismatch off a CDF tie: "
                              f"{worst:.3g} from the float64 CDF")
    return int(b.numel()), worst


def comb_offset(anc, w, u, resampled) -> float:
    """How far, in CDF units, the comb points of the resampled members
    must move for ``anc`` to be the exact answer under the float64 CDF:
    0 for an exact comb, the CDF's own rounding error otherwise.  The
    kernel's f32 scan must stay within ``COMB_TOL`` (a few ulp of 1); an
    ancestor off by a lane where the weights are not tiny fails that."""
    import torch
    if not bool(resampled.any()):
        return 0.0
    anc, w, u = anc[resampled].long(), w[resampled], u[resampled]
    n, n_out = w.shape[-1], anc.shape[-1]
    cdf64 = torch.cumsum(w.double(), -1)
    # the comb point in f32 exactly as the reference computes it, so the
    # offset measures the CDF's error, not the comb's f32 rounding
    pos = ((torch.arange(n_out, device=w.device, dtype=torch.float32)
            + u.float()[:, None]) / n_out).double()
    below = torch.where(anc > 0, cdf64.gather(-1, (anc - 1).clamp(min=0)),
                        torch.zeros_like(pos))
    above = torch.where(anc < n - 1, cdf64.gather(-1, anc),
                        torch.full_like(pos, math.inf))
    return float(torch.maximum(below - pos, pos - above).clamp(min=0).max())


def check_fused(dev) -> dict:
    import torch
    from repro_torch.kernels import sir_fused

    kern = sir_fused.fused_weight_step_kernel
    worst, ties, offsets = 0.0, 0, {"kernel": 0.0, "plain": 0.0}

    def one(lw, ll, state, u, always=False, comb=True, label=""):
        nonlocal worst, ties
        out = kern(lw, ll, state, u, always=always, comb=comb)
        again = kern(lw, ll, state, u, always=always, comb=comb)
        check(all(same_bits(a, b) for a, b in zip(out, again)),
              f"fused kernel not repeatable {label}")
        anc, new_lw, est, stats = out
        ref = sir_fused.fused_weight_step_ref(lw, ll, state, u, always=always,
                                              comb=comb)
        check(torch.equal(stats[:, 2] > 0, ref.resampled),
              f"decision differs {label}")
        errs = [max_err(stats[:, 0], ref.ess, FUSED_TOL),
                max_err(stats[:, 1], ref.log_z, FUSED_TOL),
                max_err(stats[:, 5], ref.weight_skew, FUSED_TOL),
                max_err(est, ref.estimate, FUSED_TOL),
                max_err(new_lw, ref.new_log_weights, FUSED_TOL)]
        # the plain version's normalized weights, for the tie rule
        lwp = torch.where(torch.isfinite(lw), lw + ll,
                          torch.full_like(lw, -math.inf))
        w = torch.softmax(lwp.double(), -1).nan_to_num(1.0 / lw.shape[1])
        t, _ = comb_ties_ok(anc, ref.ancestors, w, u)
        ties += t
        worst = max(worst, *errs)
        comb_members = ref.resampled & comb
        off = {"kernel": comb_offset(anc, w, u, comb_members),
               "plain": comb_offset(ref.ancestors, w, u, comb_members)}
        check(off["kernel"] <= COMB_TOL,
              f"fused {label}: kernel ancestors {off['kernel']:.3g} from the "
              f"float64 CDF's comb (limit {COMB_TOL})")
        for k in offsets:
            offsets[k] = max(offsets[k], off[k])
        log(f"fused {label}: resampled={ref.resampled.tolist()} "
            f"max_abs_err={max(errs):.3g} tie lanes={t} "
            f"({t / anc.numel():.4%}); comb offset from the float64 CDF: "
            f"kernel {off['kernel']:.3g}, plain {off['plain']:.3g}")
        return out, ref

    one(*fused_inputs(1, 2 ** 22, 1, dev), label="B=1 N=2^22")
    lw, ll, state, u = fused_inputs(8, 2 ** 20, 2, dev)
    lw[0] = -math.inf                      # an all -inf member
    ll[1] = 1e-3 * ll[1]                   # a member that does not resample
    (_, _, _, stats), ref = one(lw, ll, state, u, label="B=8 N=2^20")
    check(not bool(ref.resampled[1]) and bool(ref.resampled[2]),
          "bank case lost its no-resample / resample members")
    check(math.isinf(float(stats[0, 1])) and float(stats[0, 0]) == 2 ** 20,
          "all -inf member: log_z must be -inf and ess = n")
    (_, _, _, stats), _ = one(lw, ll, state, u, always=True,
                              label="B=8 always")
    check(bool((stats[:, 2] > 0).all()), "always=True must resample")
    (anc, _, _, _), _ = one(lw, ll, state, u, always=True, comb=False,
                            label="B=8 comb=False")
    check(torch.equal(anc, torch.arange(2 ** 20, device=dev,
                                        dtype=torch.int32).expand(8, -1)),
          "comb=False must give identity ancestors")
    # a member's result must not depend on B: member 2 alone == in the bank
    solo = kern(lw[2:3].contiguous(), ll[2:3].contiguous(),
                state[2:3].contiguous(), u[2:3].contiguous())
    bank = kern(lw, ll, state, u)
    check(all(same_bits(s[0], b_[2]) for s, b_ in zip(solo, bank)),
          "member result depends on the bank")
    return {"max_abs_err": worst, "tie_lanes": ties,
            "comb_offset": offsets}


def check_systematic(dev) -> dict:
    """B1 against its plain version: ancestors within the comb rules of
    the fused check (TIE_DELTA against the plain version, COMB_TOL
    against the float64 CDF's comb), bit for bit on a second run, a
    member independent of B; at the DRA shape 8 x 2^22 and at n_out != n_in
    with a ragged tail.  The reported error is in CDF units: the largest
    distance of a comb point where kernel and plain version disagree
    from the float64 CDF (limit TIE_DELTA)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.resample import systematic_ancestors_kernel

    ties, worst, offsets = 0, 0.0, {"kernel": 0.0, "plain": 0.0}
    cases = [(8, 2 ** 22, 2 ** 22, 31), (2, 2 ** 20 + 333, 2 ** 19, 32),
             (2, 2 ** 19, 2 ** 20 + 77, 33)]
    for b, n_in, n_out, seed in cases:
        lw, ll, _, u = fused_inputs(b, n_in, seed, dev, d=1)
        lw = lw + ll                      # a filter's post-likelihood weights
        anc = systematic_ancestors_kernel(lw, u, n_out)
        again = systematic_ancestors_kernel(lw, u, n_out)
        check(same_bits(anc, again), f"B1 not repeatable {b}x{n_in}")
        plain = ref.systematic_ancestors_ref(lw, u, n_out)
        w = torch.softmax(lw.double(), -1)
        t, dist = comb_ties_ok(anc, plain, w, u)
        ties, worst = ties + t, max(worst, dist)
        every = torch.ones(b, dtype=torch.bool, device=dev)
        off = {"kernel": comb_offset(anc, w, u, every),
               "plain": comb_offset(plain, w, u, every)}
        check(off["kernel"] <= COMB_TOL,
              f"B1 {b}x{n_in}->{n_out}: kernel ancestors {off['kernel']:.3g}"
              f" from the float64 CDF's comb (limit {COMB_TOL})")
        check(bool((anc >= 0).all() and (anc < n_in).all()),
              "B1 ancestors out of range")
        for k in offsets:
            offsets[k] = max(offsets[k], off[k])
        solo = systematic_ancestors_kernel(lw[1:2].contiguous(),
                                           u[1:2].contiguous(), n_out)
        check(same_bits(solo[0], anc[1]), "B1 member depends on the batch")
        log(f"B1 B={b} n_in={n_in} n_out={n_out}: tie lanes={t} "
            f"({t / anc.numel():.4%}); comb offset from the float64 CDF: "
            f"kernel {off['kernel']:.3g}, plain {off['plain']:.3g}")
    return {"max_abs_err": worst, "tie_lanes": ties, "comb_offset": offsets}


# the comb scan's shapes: the composed step's one row, RPA's 8 shards, SMC
# decoding's short rows (B prompts x K = 8 hypotheses, one launch), a
# ragged tail across tiles, and a row of exactly one tile
SCAN_CASES = [(1, 2 ** 22, 61), (8, 2 ** 22, 62), (32, 8, 63),
              (3, 2 ** 20 + 333, 64), (2, 4096, 65), (4, 8, 66),
              (1, 4095, 67), (2, 4097, 68), (1024, 4097, 69)]
SCAN_TOL = 2.0 ** -23      # rtol = atol against the float64 scan: 1 ulp of 1


def comb_weights(lw):
    """The weights the comb schemes scan: normalized, then divided by their
    sum again, as ``core.resampling`` does."""
    from repro_torch.core.particles import normalized_weights
    w = normalized_weights(lw)
    return w / w.sum(-1, keepdim=True).clamp(min=1e-38)


def scheme_draws(seed, b, dev):
    """One draws provider per member, stacked as a bank's are."""
    from repro_torch.core.draws import BankDraws, TorchDraws
    return BankDraws([TorchDraws.from_seed(seed + i, dev) for i in range(b)])


def scheme_points(scheme, draws, n):
    """The sorted comb points (float32, ``(B, n)``) that ``scheme`` takes
    from ``draws`` for ``n_out = capacity = n``, as ``core.resampling``
    makes them (the multinomial spacings through the scan, as there)."""
    import torch
    from repro_torch.kernels import ops
    lanes = torch.arange(n, device=draws.device, dtype=torch.float32)
    if scheme == "systematic":
        return (lanes + draws.uniform(())[:, None]) / n
    if scheme == "stratified":
        return (lanes + draws.uniform((n,))) / n
    cs = ops.prefix_sum(draws.exponential((n + 1,)))
    return cs[:, :-1] / cs[:, n:]


def check_scan(dev) -> dict:
    """The comb scan against its plain version (the float64 scan rounded
    once) within SCAN_TOL, and against the float64 CDF within COMB_TOL; bit
    for bit on three launches; a row independent of the batch; the
    systematic, stratified and multinomial combs built on it against the
    float64 CDF's comb (comb_offset within COMB_TOL for systematic, the
    TIE_DELTA rule for all three).  Prints, without gating, whether
    torch's own CUDA cumsum repeats on the same input: the fault the
    kernel repairs."""
    import torch
    from repro_torch.core import resampling
    from repro_torch.kernels.scan import (prefix_sum_emulated,
                                          prefix_sum_kernel, prefix_sum_ref)

    worst, cdf_worst, ties, rec = 0.0, 0.0, 0, {}
    for b, n, seed in SCAN_CASES + [(2, 2 ** 20, None)]:
        if seed is None:
            # all of a row's mass in its last element
            lw = torch.full((b, n), -math.inf, device=dev)
            lw[:, -1] = 0.0
        else:
            lw, ll, _, _ = fused_inputs(b, n, seed, dev, d=1)
            lw = lw + ll
        w = comb_weights(lw)
        runs = [prefix_sum_kernel(w) for _ in range(3)]
        check(all(same_bits(runs[0], r) for r in runs[1:]),
              f"scan not repeatable {b}x{n}")
        y = runs[0]
        err = max_err(y, prefix_sum_ref(w), SCAN_TOL)
        exact = float((y == prefix_sum_ref(w)).float().mean())
        # the kernel's own order of sums, written in torch (not gated)
        emulated = float((y == prefix_sum_emulated(w)).float().mean())
        cdf64 = torch.cumsum(w.double(), -1)
        cdf_err = float((y.double() - cdf64).abs().max())
        check(cdf_err <= COMB_TOL, f"scan {b}x{n}: {cdf_err:.3g} from the "
                                   f"float64 CDF (limit {COMB_TOL})")
        if b > 1:
            solo = prefix_sum_kernel(w[b - 1:].contiguous())
            check(same_bits(solo[0], y[b - 1]), "scan row depends on batch")
        if seed is None:
            check(bool((y[:, :-1] == 0).all() and (y[:, -1] == 1).all()),
                  "scan of a last-element mass")
            rec[f"{b}x{n} last"] = {"max_abs_err": err}
            log(f"scan {b}x{n}, all mass last: exact, repeatable, rows independent")
            continue
        lib = [torch.cumsum(w, -1) for _ in range(3)]
        lib_repeats = all(same_bits(lib[0], c) for c in lib[1:])
        lib_err = float((lib[0].double() - cdf64).abs().max())
        # the combs built on the scan, against the float64 CDF's comb
        comb = {}
        for k, scheme in enumerate(("systematic", "stratified",
                                    "multinomial")):
            dseed = 1000 * seed + 100 * k
            counts = resampling.RESAMPLERS[scheme](
                scheme_draws(dseed, b, dev), lw, n)
            anc = resampling.counts_to_ancestors(counts, n)
            pos = scheme_points(scheme, scheme_draws(dseed, b, dev),
                                n).double()
            anc64 = torch.searchsorted(cdf64, pos.contiguous(), right=True)
            anc64 = anc64.clamp(max=n - 1).to(torch.int32)
            t, dist = comb_ties_at(anc, anc64, cdf64, pos)
            ties += t
            comb[scheme] = {"tie_lanes": t, "tie_dist": dist}
            if scheme == "systematic":
                u = scheme_draws(dseed, b, dev).uniform(())
                every = torch.ones(b, dtype=torch.bool, device=dev)
                off = comb_offset(anc, w, u, every)
                check(off <= COMB_TOL, f"systematic comb on the scan "
                                       f"{b}x{n}: {off:.3g} from the float64"
                                       f" CDF's comb (limit {COMB_TOL})")
                comb[scheme]["comb_offset"] = off
        worst, cdf_worst = max(worst, err), max(cdf_worst, cdf_err)
        rec[f"{b}x{n}"] = {"max_abs_err": err, "bitwise_equal_share": exact,
                           "emulated_bitwise_share": emulated,
                           "cdf64_err": cdf_err, "combs": comb,
                           "torch_cumsum_repeats": lib_repeats,
                           "torch_cumsum_cdf64_err": lib_err}
        log(f"scan {b}x{n}: max_abs_err {err:.3g} vs the plain version "
            f"(rtol=atol={SCAN_TOL:.3g}; {exact:.4%} bitwise equal; "
            f"{emulated:.4%} bitwise equal to the emulated order), "
            f"{cdf_err:.3g} from the float64 CDF (limit {COMB_TOL}), "
            f"repeatable; combs {comb}; torch.cumsum on the card: repeats "
            f"{lib_repeats}, {lib_err:.3g} from the float64 CDF (not gated)")
        del lw, ll, w, runs, y, cdf64, lib
    return {"max_abs_err": worst, "cdf64_err": cdf_worst, "tie_lanes": ties,
            "cases": rec}


def chain_inputs(b, n, seed, dev, iters=32, lanes=None):
    """Post-likelihood log-weights and the chains' draws for ``lanes``
    (default ``n``) lanes; member 0 of a bank is all -inf, member 1 has all
    its mass on one slot, member 2 half its slots dead, and a lone member
    some dead slots."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lanes = n if lanes is None else lanes
    lw = 3.0 * torch.randn((b, n), generator=g, device=dev)
    dead = torch.rand((b, n), generator=g, device=dev)
    if b == 1:
        lw[dead < 0.1] = -math.inf
    else:
        lw[0] = -math.inf
        lw[1] = -math.inf
        lw[1, n // 3] = 0.0
        lw[2][dead[2] < 0.5] = -math.inf
    prop = torch.randint(n, (b, lanes, iters), generator=g, device=dev,
                         dtype=torch.int32)
    log_us = torch.log(torch.rand((b, lanes, iters), generator=g,
                                  device=dev))
    return lw, prop, log_us


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    import torch
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# (members, n_in, lanes, budget, seed, misaligned draws): the main path's
# shape, the bank's with its edge members, more lanes than slots with a
# tile that straddles members, a budget the tma kernel does not take, and
# misaligned draws (both on the lane kernel), and fewer rows than a tile
CHAIN_CASES = [(1, 2 ** 22, 2 ** 22, 32, 41, False),
               (8, 2 ** 20, 2 ** 20, 32, 42, False),
               (3, 5000, 10077, 32, 43, False),
               (3, 40, 25, 32, 46, False),
               (3, 5000, 4099, 20, 44, False),
               (3, 5000, 4099, 32, 45, True)]


def check_chains(dev) -> dict:
    """B4 and B5 against their plain versions, bit for bit, on every case
    of CHAIN_CASES (dead slots, an all -inf member, a one-hot member),
    twice; the variant ``plan`` chose, and at budget 32 the lane kernel too,
    launched directly."""
    import torch
    from repro_torch.kernels import resample

    variants = {}
    for b, n, lanes, iters, seed, mis in CHAIN_CASES:
        lw, prop, log_us = chain_inputs(b, n, seed, dev, iters, lanes)
        if mis:
            prop, log_us = misaligned(prop), misaligned(log_us)
        for name in ("metropolis", "rejection"):
            kern = getattr(resample, f"{name}_ancestors_kernel")
            plain = getattr(resample, f"{name}_ancestors_ref")
            before = dict(kern.variants)
            anc = kern(lw, prop, log_us)
            ran = [v for v in kern.variants if kern.variants[v] != before[v]]
            check(same_bits(anc, kern(lw, prop, log_us)),
                  f"{name} kernel not repeatable {b}x{n}")
            want = plain(lw, prop, log_us)
            bad = int((anc != want).sum())
            check(bad == 0, f"{name} {ran} kernel differs from its plain "
                            f"version on {bad} lanes ({b}x{n}, {lanes} lanes,"
                            f" budget {iters})")
            expect = "tma" if iters == 32 and not mis else "lane"
            check(ran == [expect], f"{name} {b}x{n} budget {iters}: ran "
                                   f"{ran}, want {expect}")
            if expect == "tma":
                lane, _ = resample._chain_kernel(lw, prop, log_us,
                                                 name == "rejection", "lane")
                check(same_bits(lane, anc), f"{name}: the lane kernel differs"
                                            f" from the tma kernel")
            if b > 1:
                check(bool((anc[0] == 0).all()),
                      f"{name}: all -inf member must take slot 0")
                check(bool((anc[1] == n // 3).all()),
                      f"{name}: one-hot member must take its hot slot")
            alive = torch.isfinite(lw.gather(-1, anc.long()))
            check(bool(alive[b > 1:].all()), f"{name}: lane on a dead slot")
            variants[f"{name} {b}x{n} lanes={lanes} iters={iters}"
                     f"{' misaligned' if mis else ''}"] = ran[0]
            also = " and to the lane kernel" if expect == "tma" else ""
            log(f"{name} B={b} N={n} lanes={lanes} budget={iters}"
                f"{' misaligned' if mis else ''} [{ran[0]}]: bitwise equal "
                f"to the plain version{also}, repeatable")
        del lw, prop, log_us
    return {"max_abs_err": 0.0, "variants": variants}


# ---------------------------------------------------------------------------
# Bounds and timings
# ---------------------------------------------------------------------------

# the special-function units' exp rate: MUFU.EX2, 16 a clock an SM, at the
# boost clock of the FP32 peak (132 SMs x 16 x 1.98 GHz)
PEAK_SFU = 132 * 16 * 1.98e9


def patch_bound(b, n, h, w, radius=4) -> tuple[float, str]:
    """Least time of B3 for ``b`` members of ``n`` particles on ``h`` x
    ``w`` frames, the larger of two:

    * bytes: each particle's whole 20-byte state row (y, x and i0 are
      columns 0, 1 and 4 of contiguous 5-float rows, so reading them moves
      every 32-byte sector of the rows), its 4-byte output, and each frame
      once, over the HBM rate;
    * operations, from the least arithmetic known — the separable form's:
      2(2R+1) exps a particle (a row's and a column's) on the SFU at
      PEAK_SFU, and on the FP32 pipes at PEAK_FP32 one FMA (2 FLOP) a
      window pixel plus 6 FLOP a row and a column for the exps' arguments
      and the weight sums.  The two units run side by side, so the
      operations take the longer of their two times.

    The window gathers are not counted: the frames stay in L2."""
    k = 2 * radius + 1
    bytes_ = b * n * 24 + b * h * w * 4
    t_b = bytes_ / PEAK_BYTES
    t_o = max(b * n * 2 * k / PEAK_SFU,
              b * n * (2 * k * k + 6 * 2 * k) / PEAK_FP32)
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def fused_bound(b, n, d, resampled: int) -> tuple[float, str]:
    """Least time: read lw, ll, state once, write anc, new_lw, est, stats
    once; per particle ~(10 + 2D) FP32 operations, plus a log2(N)-step
    comb search of 3 operations a step for each member that resampled."""
    bytes_ = b * n * (16 + 4 * d) + b * (d + 6) * 4
    ops = b * n * (10 + 2 * d) + resampled * n * math.ceil(math.log2(n)) * 3
    t_b, t_o = bytes_ / PEAK_BYTES, ops / PEAK_FP32
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def systematic_bound(b, n_in, n_out) -> tuple[float, str]:
    """Least time: read lw (4 B) per input and write anc (4 B) per output
    once; per input ~4 FP32 operations (shift, exp, divide, scan add),
    per output the comb point (2) and a ceil(log2(n_in+1))-step bisection
    of 3 operations a step.  The CDF scratch is not counted: it is the
    kernel's choice, not the function's."""
    bytes_ = b * (n_in + n_out) * 4
    ops = b * (4 * n_in + n_out * (2 + 3 * math.ceil(math.log2(n_in + 1))))
    t_b, t_o = bytes_ / PEAK_BYTES, ops / PEAK_FP32
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def chain_bound(b, n_in, n_out, iters) -> tuple[float, str]:
    """Least time: read lw once and each lane's (iters) int32 proposals
    and f32 log-us, write one int32 per lane — (8 iters + 4) B per lane;
    3 operations per draw (subtract, compare, select)."""
    bytes_ = b * (n_in * 4 + n_out * (8 * iters + 4))
    ops = b * n_out * iters * 3
    t_b, t_o = bytes_ / PEAK_BYTES, ops / PEAK_FP32
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def scan_bound(rows, n) -> tuple[float, str]:
    """Least time: read x and write y once (8 B an element); one FP32 add
    an element."""
    t_b, t_o = rows * n * 8 / PEAK_BYTES, rows * n / PEAK_FP32
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def time_scan(dev) -> dict:
    """The comb scan at the composed step's shape (1 x 2^22) and RPA's (8 x
    2^22) on a comb's weights: the kernel through its wrapper and the first
    design (three passes, ``scan._launch`` with a fresh output as the
    wrapper allocates one) in turns, the plain version, torch.cumsum (the
    library call for the same function, which the port never makes on the
    card), and the kernel's device time per launch back to back."""
    import torch
    from repro_torch.kernels import scan
    first = scan.ScanPlan("three_pass", 0, 0, 0)
    out = {}
    for rows in (1, 8):
        lw, ll, _, _ = fused_inputs(rows, 2 ** 22, 9, dev, d=1)
        w = comb_weights(lw + ll)
        bound, by = scan_bound(rows, 2 ** 22)
        ms, first_ms = in_turns(
            lambda: scan.prefix_sum_kernel(w),
            lambda: scan._launch(first, w, torch.empty_like(w)))
        out[f"{rows}x2^22"] = {
            "variant": "lookback", "ms": ms, "first_ms": first_ms,
            "device_ms": device_ms(lambda: scan.prefix_sum_kernel(w)),
            "plain_ms": cuda_ms(lambda: scan.prefix_sum_ref(w)),
            "library_ms": cuda_ms(lambda: torch.cumsum(w, -1)),
            "bound_ms": bound, "bound_by": by}
        del lw, ll, w
    return out


def time_patch(inputs: dict, cfg) -> dict:
    """B3 on each timing input: the kernel through its wrapper and the
    first design (``patch_likelihood._launch`` with the ``"direct"`` plan,
    after the same checks) in turns, the kernel's device time per launch
    back to back, and the bound."""
    from repro_torch.kernels import patch_likelihood as pl
    direct = pl.PatchPlan("direct", False)
    kw = dict(radius=cfg.patch_radius, sigma_psf=cfg.sigma_psf,
              sigma_like=cfg.sigma_like, i_bg=cfg.i_bg, matched=True)
    out = {}
    for label, (state, frames) in inputs.items():
        b, n = state.shape[:2]
        ms, first_ms = in_turns(
            lambda: pl.patch_log_likelihood_kernel(state, frames, **kw),
            lambda: pl._launch(direct, state, frames, pl._check(
                state, frames, cfg.patch_radius, None, None), **kw))
        bound, by = patch_bound(b, n, *frames.shape[1:], cfg.patch_radius)
        out[label] = {"shape": [b, n], "variant": "separable", "ms": ms,
                      "first_ms": first_ms,
                      "device_ms": device_ms(
                          lambda: pl.patch_log_likelihood_kernel(
                              state, frames, **kw)),
                      "bound_ms": bound, "bound_by": by}
    return out


def comm_formulas(kind, p, c, cfg, state_bytes, estimate_bytes):
    """The reference's analytic comm accounting (repro/core/distributed.py,
    DESIGN.md §14.3) per frame and shard, plus the SIR step's weight-phase
    collectives (12 B + the estimate, 4 rounds; repro/core/smc.py)."""
    if kind == "mpf":
        dra = (4, 1)
    elif kind == "rna":
        m = max(int(round(cfg.exchange_ratio * c)), 1)
        dra = (4 + m * (state_bytes + 4), 2)
    else:
        dra = (4 + p * cfg.k_cap * (state_bytes + 8), 2)
    return dra[0] + 12 + estimate_bytes, dra[1] + 4


def attn_inputs(qshape, kvshape, dtype, seed, dev, lk=None):
    """Random q, k, v; with ``lk`` the k/v are the ``[..., :lk, :]`` views
    of a longer cache (strides of the whole buffer, no copy)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
               for s in (qshape, kvshape, kvshape))
    if lk is not None:
        k, v = k[:, :, :lk], v[:, :, :lk]
    return q, k, v


# label: q shape, k/v shape, dtype, soft-cap, view length (decode), causal
ATTN_CASES = {
    "prefill": ((4, 64, 1024, 128), (4, 8, 1024, 128), "bfloat16", 0.0,
                None, True),
    "decode": ((32, 64, 1, 128), (32, 8, 1057, 128), "bfloat16", 0.0, 1025,
               True),
    "ragged": ((2, 8, 37, 64), (2, 2, 1000, 64), "float32", 50.0, None,
               True),
    "mha": ((2, 32, 512, 80), (2, 32, 512, 80), "bfloat16", 0.0, None, True),
    "mqa": ((2, 48, 300, 128), (2, 1, 300, 128), "bfloat16", 0.0, None,
            True),
    "mqa-decode": ((8, 48, 1, 128), (8, 1, 800, 128), "bfloat16", 0.0, 700,
                   True),
    "full": ((2, 8, 50, 128), (2, 2, 77, 128), "bfloat16", 0.0, None, False),
    "full-f32": ((2, 8, 50, 96), (2, 2, 77, 96), "float32", 0.0, None,
                 False),
}
# every bf16 head dim the kernel is built for, ragged and soft-capped
ATTN_CASES.update({
    f"d{d}": ((2, 8, 37, d), (2, 2, 100, d), "bfloat16", 30.0, None, True)
    for d in (16, 32, 48, 64, 80, 96, 112, 128)})
# the edges of the split (decode) and wgmma (prefill) variants
ATTN_CASES.update({
    "generate-decode": ((4, 64, 1, 128), (4, 8, 1057, 128), "bfloat16", 0.0,
                        1040, True),
    "decode-one-split": ((4, 64, 1, 128), (4, 8, 120, 128), "bfloat16", 0.0,
                         100, True),
    "decode-16k": ((1, 64, 1, 128), (1, 8, 16384, 128), "bfloat16", 0.0,
                   None, True),
    # 16 rows; the last of 9 splits holds key 1152 alone, which the rows
    # of position 0 do not see
    "decode-lq2": ((2, 64, 2, 128), (2, 8, 1200, 128), "bfloat16", 0.0,
                   1153, True),
    # 64 rows, the most the split variant takes: four row tiles
    "decode-lq8": ((2, 64, 8, 128), (2, 8, 1057, 128), "bfloat16", 0.0,
                   1040, True),
    "granite-decode": ((4, 48, 1, 128), (4, 1, 1057, 128), "bfloat16", 0.0,
                       1040, True),
    "prefill-1000": ((2, 64, 1000, 128), (2, 8, 1000, 128), "bfloat16", 0.0,
                     None, True),
    "prefill-chunk": ((2, 64, 256, 128), (2, 8, 1024, 128), "bfloat16", 0.0,
                      None, True),
    "prefill-d64": ((2, 32, 512, 64), (2, 8, 512, 64), "bfloat16", 0.0, None,
                    True),
    "wgmma-cap": ((2, 64, 300, 128), (2, 8, 300, 128), "bfloat16", 30.0,
                  None, True),
    "wgmma-full": ((2, 64, 200, 128), (2, 8, 333, 128), "bfloat16", 0.0,
                   None, False),
})


def check_attention(dev) -> dict:
    """B6 against its plain version (``ref.mha_ref``) at the LM path's
    prefill and decode shapes (the decode on a strided cache view), a
    ragged soft-capped float32 case, the MHA (group 1) and MQA (group 48)
    groupings, non-causal calls and every bf16 head dim the kernel is
    built for, and the edges of the split and wgmma variants: within
    ATTN_TOL, and bit for bit on a second launch.  The float32 plain
    version of the same bf16 inputs is reported too, and the variant
    that served each case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     plan)

    worst = {}
    for i, (label, (qs, ks, dt, cap, lk, causal)) in enumerate(
            ATTN_CASES.items()):
        dtype = getattr(torch, dt)
        q, k, v = attn_inputs(qs, ks, dtype, 50 + i, dev, lk)
        kw = dict(causal=causal, scale=qs[-1] ** -0.5, logit_softcap=cap)
        out = flash_attention_kernel(q, k, v, **kw)
        again = flash_attention_kernel(q, k, v, **kw)
        check(torch.equal(out, again), f"B6 {label} not repeatable")
        want = ref.mha_ref(q, k, v, **kw)
        err = max_err(out.float(), want.float(), ATTN_TOL[str(dtype)])
        err32 = float((out.float() - ref.mha_ref(
            q.float(), k.float(), v.float(), **kw)).abs().max())
        worst[label] = err
        p = plan(tuple(q.shape), tuple(k.shape), dtype)
        log(f"B6 {label} [{p.variant}"
            f"{f' x{p.splits}' if p.variant == 'split' else ''}] "
            f"q{tuple(q.shape)} kv{tuple(k.shape)} {dt}"
            f"{' cap ' + str(cap) if cap else ''}"
            f"{'' if causal else ' non-causal'}: max_abs_err={err:.3g} "
            f"(rtol=atol={ATTN_TOL[str(dtype)]}; vs the float32 plain "
            f"version {err32:.3g}), repeatable")
        del q, k, v, out, again, want
    return {"max_abs_err": max(worst.values()), "cases": worst}


def check_wgmma() -> dict:
    """B6's prefill variant issues warpgroup products: each flash_wgmma<D>
    in the built library's SASS holds HGMMA instructions, and fewer of
    them wait on their own group (``gsb0``) than there are, so they go
    out back to back and not one at a time, as ptxas issues them when it
    serializes a kernel's wgmma."""
    from repro_torch.kernels import build
    lib = build.build_all() / "libflash_attention_sm90.so"
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "flash_wgmma" in name:
            d = name.split("flash_wgmmaILi", 1)[1].split("E", 1)[0]
            ops = [ln for ln in part.splitlines() if "HGMMA" in ln]
            counts[f"flash_wgmma<{d}>"] = {
                "hgmma": len(ops), "waiting": sum("gsb0" in ln for ln in ops)}
    check(sorted(counts) == ["flash_wgmma<128>", "flash_wgmma<64>"]
          and all(0 < c["waiting"] < c["hgmma"] for c in counts.values()),
          f"wgmma in the prefill variant's SASS: {counts}")
    log(f"B6 wgmma variant SASS: {counts} (HGMMA, and those that wait on "
        f"their own group)")
    return counts


def attention_bound(q, k) -> tuple[float, str]:
    """Least time for causal GQA attention: read q, k, v and write o once
    (the bytes), against 4·D FLOP per visible (query, key) pair on the
    bf16 tensor cores (QK^T and PV; causal pairs of query i are
    i + Lk - Lq + 1)."""
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    pairs = lq * (lk - lq) + lq * (lq + 1) // 2
    flops = 4 * b * hq * d * pairs
    bytes_ = (2 * q.numel() + 2 * b * k.shape[1] * lk * d) * q.element_size()
    t_b, t_o = bytes_ / PEAK_BYTES, flops / PEAK_BF16
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def lm_config():
    """The LM phase's config: LM_ARCH at full width, LM_LAYERS deep."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)


def time_attention(dev) -> dict:
    """B6, its plain version and PyTorch's scaled_dot_product_attention
    (the library yardstick, never on the port's path) at the LM phase's
    four attention shapes; a decode reads the cache view at the middle of
    the run (its first 1040 of 1057 slots).  The mma.sync kernel, which
    served every bf16 shape before the split and wgmma variants, is timed
    beside them as a yardstick, by a direct launch off the path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    cfg = lm_config()
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    t_max = LM_PROMPT + LM_STEPS + 1
    shapes = {}
    for run, rows in (("smc", LM_BATCH * LM_K), ("generate", LM_BATCH)):
        shapes[f"{run}_prefill"] = ((rows, hq, LM_PROMPT, d),
                                    (rows, hkv, LM_PROMPT, d), None)
        shapes[f"{run}_decode"] = ((rows, hq, 1, d), (rows, hkv, t_max, d),
                                   LM_PROMPT + LM_STEPS // 2)
    out = {}
    for i, (label, (qs, ks, lk)) in enumerate(shapes.items()):
        q, k, v = attn_inputs(qs, ks, torch.bfloat16, 70 + i, dev, lk)
        scale = qs[-1] ** -0.5
        causal = q.shape[2] == k.shape[2]
        variant = fa.plan(tuple(q.shape), tuple(k.shape), q.dtype)
        ms = cuda_ms(lambda: flash_attention_kernel(q, k, v))
        mma_ms = cuda_ms(lambda: fa._launch(fa.Plan("mma"), q, k, v, causal,
                                            scale, 0.0))
        plain = cuda_ms(lambda: ref.mha_ref(q, k, v, scale=scale), reps=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale, enable_gqa=True))
        bound, by = attention_bound(q, k)
        out[label] = {"q": list(q.shape), "k": list(k.shape),
                      "variant": variant.variant, "splits": variant.splits,
                      "ms": ms, "mma_ms": mma_ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": bound, "bound_by": by}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def lm_prompts(cfg, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(LM_SEED + 1)
    return torch.randint(cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=g,
                         device=dev)


def decode_vs_prefill(model, prompt, tokens) -> dict:
    """Greedy decode step by step through the model's public functions,
    keeping the logits of the steps in LM_CHECK_STEPS; the tokens must be
    ``generate``'s, and prefilling prompt ⧺ tokens[:j] must give step j's
    logits at its last position within LM_LOGIT_TOL, with the same argmax
    wherever the top-2 gap exceeds the tolerance."""
    import torch
    from repro_torch.models.lm import model as M

    t0 = prompt.shape[1]
    with torch.inference_mode():
        h, caches = M.forward_prefill(model, prompt, t0 + LM_STEPS + 1)
        tok = M.unembed(model, h)[:, 0].float().argmax(-1).to(torch.int32)
        seen, kept = [tok], {}
        for j in range(1, LM_STEPS):
            logits, caches = M.forward_decode(model, tok[:, None],
                                              t0 + j - 1, caches)
            logits = logits[:, 0].float()
            if j in LM_CHECK_STEPS:
                kept[j] = logits
            tok = logits.argmax(-1).to(torch.int32)
            seen.append(tok)
        del caches
        check(torch.equal(torch.stack(seen, 1), tokens),
              "step-by-step greedy decode differs from generate")
        worst, compared, agreed = 0.0, 0, 0
        for j, want in kept.items():
            seq = torch.cat([prompt, tokens[:, :j].long()], 1)
            h, caches = M.forward_prefill(model, seq, seq.shape[1] + 1)
            got = M.unembed(model, h)[:, 0].float()
            del caches
            worst = max(worst, float((got - want).abs().max()))
            top2 = got.topk(2, -1).values
            clear = (top2[:, 0] - top2[:, 1]) > LM_LOGIT_TOL
            compared += int(clear.sum())
            agreed += int((got.argmax(-1) == tokens[:, j])[clear].sum())
    check(worst <= LM_LOGIT_TOL, f"decode vs prefill logits differ by "
                                 f"{worst:.4g} (limit {LM_LOGIT_TOL})")
    check(agreed == compared, f"greedy tokens differ on {compared - agreed} "
                              f"of {compared} clear steps")
    return {"max_abs_logit_err": worst, "clear_steps": compared,
            "steps_checked": list(LM_CHECK_STEPS)}


def run_lm(dev, all_k, reset, counts, name) -> dict:
    """Phase 5d: generate and smc_decode at qwen3-32b width, 16 layers."""
    import dataclasses
    import torch
    from repro_torch.core import genealogy
    from repro_torch.kernels import ref
    from repro_torch.models.lm import model as M
    from repro_torch.serve import SMCDecodeConfig, generate, smc_decode

    cfg = lm_config()
    t0 = time.perf_counter()
    model = M.init_params(cfg, LM_SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{LM_ARCH} x {LM_LAYERS} layers: {n_params / 1e9:.3f} B parameters "
        f"bf16 ({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = lm_prompts(cfg, dev)
    want_launches = LM_LAYERS * LM_STEPS       # one prefill + steps-1 decodes
    # the prefill on the wgmma variant, every decode step on the split one
    want_variants = {"wgmma": LM_LAYERS, "split": LM_LAYERS * (LM_STEPS - 1),
                     "mma": 0, "f32": 0}
    attn = all_k["flash_attention"]

    def plain_never_ran(what):
        check(ref.mha_ref.calls == 0, f"{what} ran the plain attention "
                                      f"{ref.mha_ref.calls} times")

    def launches_ok(what, scans):
        """B6 once per layer and forward call; ``scans`` comb scans (one
        per bank step of smc_decode, none for generate)."""
        got = counts(all_k)
        want = {k: 0 for k in all_k}
        want["flash_attention"] = want_launches
        want["prefix_sum"] = scans
        check(got == want, f"{what} launches {got}, want {want}")
        check(attn.variants == want_variants, f"{what} B6 variants "
              f"{attn.variants}, want {want_variants}")
        plain_never_ran(what)
        return got["flash_attention"]

    def prefill_s(rows):
        """Seconds of one prefill of ``rows`` (the prompts repeated)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            M.forward_prefill(model, rows, LM_PROMPT + LM_STEPS + 1)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    # -- generate ----------------------------------------------------------
    reset()
    t0 = time.perf_counter()
    tokens = generate(model, prompt, steps=LM_STEPS)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    gen_launches = launches_ok("generate", 0)
    gen_variants = dict(attn.variants)
    check(tokens.shape == (LM_BATCH, LM_STEPS) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "generate tokens")
    t0 = time.perf_counter()
    again = generate(model, prompt, steps=LM_STEPS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    check(torch.equal(tokens, again), "generate not repeatable")
    t_pre = prefill_s(prompt)
    gen = {"launches": gen_launches, "variants": gen_variants,
           "seconds": t_gen,
           "first_run_seconds": t_first, "prefill_seconds": t_pre,
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / t_pre,
           "decode_tokens_per_s": LM_BATCH * (LM_STEPS - 1) / (t_gen - t_pre)}
    gen["consistency"] = decode_vs_prefill(model, prompt, tokens)
    log(f"generate {LM_BATCH} x {LM_PROMPT} + {LM_STEPS} greedy: launches "
        f"B6 {gen_launches} {gen['variants']}; {t_gen:.3f} s steady "
        f"({t_first:.3f} s first); "
        f"prefill {gen['prefill_tokens_per_s']:.1f} tokens/s, decode "
        f"{gen['decode_tokens_per_s']:.2f} tokens/s; decode vs prefill "
        f"logits {gen['consistency']['max_abs_logit_err']:.4g} (limit "
        f"{LM_LOGIT_TOL}), greedy agrees on all "
        f"{gen['consistency']['clear_steps']} clear steps [{name}]")
    del again

    # -- smc_decode --------------------------------------------------------
    smc = SMCDecodeConfig(n_particles=LM_K, steps=LM_STEPS,
                          proposal_temperature=LM_TAU)
    reset()
    t0 = time.perf_counter()
    res = smc_decode(model, prompt, smc, key=LM_SEED + 2)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    smc_launches = launches_ok("smc_decode", LM_STEPS - 1)
    smc_scans = all_k["prefix_sum"].launches
    smc_variants = dict(attn.variants)
    t0 = time.perf_counter()
    res2 = smc_decode(model, prompt, smc, key=LM_SEED + 2)
    torch.cuda.synchronize()
    t_smc = time.perf_counter() - t0
    for field in res._fields:
        check(torch.equal(getattr(res, field), getattr(res2, field)),
              f"smc_decode {field} not repeatable")
    del res2
    for b in range(LM_BATCH):
        paths = genealogy.reconstruct_trajectories(res.ancestors[:, b],
                                                   res.emissions[:, b])
        check(torch.equal(paths, res.sequences[b]),
              f"prompt {b}: sequences are not the genealogy's paths")
    check(bool(torch.isfinite(res.log_z).all()), "non-finite log Z")
    check(bool(((res.ess >= 1 - 1e-3) & (res.ess <= LM_K * (1 + 1e-5)))
               .all()), f"ESS outside [1, {LM_K}]")
    t_pre = prefill_s(prompt.repeat_interleave(LM_K, 0))
    smc_rec = {
        "launches": smc_launches, "variants": smc_variants,
        "scan_launches": smc_scans, "seconds": t_smc,
        "first_run_seconds": t_first, "prefill_seconds": t_pre,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / t_pre,
        "prefill_row_tokens_per_s": LM_BATCH * LM_K * LM_PROMPT / t_pre,
        "decode_tokens_per_s":
            LM_BATCH * LM_K * (LM_STEPS - 1) / (t_smc - t_pre),
        "resample_events": int(res.resampled.sum()),
        "log_z": res.log_z.tolist(), "mean_ess": float(res.ess.mean()),
        "min_ess": float(res.ess.min())}
    log(f"smc_decode {LM_BATCH} x {LM_PROMPT}, K={LM_K}, {LM_STEPS} steps, "
        f"tau={LM_TAU}: launches B6 {smc_launches} {smc_variants}, comb "
        f"scan {smc_scans}; "
        f"{t_smc:.3f} s steady "
        f"({t_first:.3f} s first); prefill {smc_rec['prefill_tokens_per_s']:.1f}"
        f" prompt tokens/s ({smc_rec['prefill_row_tokens_per_s']:.1f} row "
        f"tokens/s), decode {smc_rec['decode_tokens_per_s']:.2f} hypothesis "
        f"tokens/s; log Z {[round(x, 4) for x in smc_rec['log_z']]}, ESS mean "
        f"{smc_rec['mean_ess']:.3f} min {smc_rec['min_ess']:.3f}, "
        f"{smc_rec['resample_events']} resample events; sequences == "
        f"genealogy paths, repeatable [{name}]")
    del res

    # -- tau = 1: proposal == target ---------------------------------------
    flat = smc_decode(model, prompt, dataclasses.replace(
        smc, proposal_temperature=1.0), key=LM_SEED + 3)
    err = float(flat.log_z.abs().max())
    check(err <= 1e-4 and not bool(flat.resampled.any()),
          f"tau=1: |log Z| {err:.3g}, {int(flat.resampled.sum())} resamples")
    smc_rec["tau1_max_abs_log_z"] = err
    plain_never_ran("the LM phase")
    log(f"smc_decode tau=1: max |log Z| {err:.3g} (limit 1e-4), no resample")
    del flat, model
    torch.cuda.empty_cache()
    return {"arch": LM_ARCH, "layers": LM_LAYERS, "params": n_params,
            "generate": gen, "smc_decode": smc_rec}


def make_movie(seed, cfg, dev):
    from repro_torch.core.draws import TorchDraws
    from repro_torch.data.synthetic_movie import generate_movie
    return generate_movie(TorchDraws.from_seed(seed, dev), cfg,
                          n_frames=FRAMES)


def track(res, movie, member=None) -> dict:
    """RMSE after ``WARMUP`` frames (gated), after 10 (the reference's
    64x64 warm-up, reported) and the lock-on frame: one past the last
    frame whose error is ``LOCK_PX`` or more."""
    import torch
    est = res.estimates if member is None else res.estimates[member]
    err = (est[:, :2] - movie.trajectories[:, 0]).norm(dim=-1).double()
    bad = (err >= LOCK_PX).nonzero()
    return {"rmse": float(err[WARMUP:].pow(2).mean().sqrt()),
            "rmse_after_10": float(err[10:].pow(2).mean().sqrt()),
            "lock_frame": int(bad.max()) + 1 if bad.numel() else 0,
            "finite": bool(torch.isfinite(est).all())}


def gate_tracks(tracks, what) -> None:
    for i, t in enumerate(tracks):
        check(t["finite"], f"{what} {i}: non-finite estimates")
        check(t["rmse"] < RMSE_PX, f"{what} {i}: RMSE {t['rmse']:.4f} px "
                                   f"after {WARMUP} frames")


def fmt_tracks(tracks) -> str:
    return (f"RMSE after {WARMUP} frames "
            f"{[round(t['rmse'], 4) for t in tracks]} (all < {RMSE_PX}), "
            f"after 10 {[round(t['rmse_after_10'], 4) for t in tracks]}, "
            f"lock-on frame {[t['lock_frame'] for t in tracks]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the measured record here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import FilterBank, ParallelParticleFilter, SIRConfig
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.patch_likelihood import \
        patch_log_likelihood_kernel as patch_k
    from repro_torch.kernels import resample
    from repro_torch.kernels.resample import \
        systematic_ancestors_kernel as sys_k, \
        metropolis_ancestors_kernel as metro_k, \
        rejection_ancestors_kernel as rej_k
    from repro_torch.kernels.sir_fused import \
        fused_weight_step_kernel as fused_k, fused_weight_step_ref
    from repro_torch.kernels.flash_attention import \
        flash_attention_kernel as attn_k
    from repro_torch.kernels.scan import prefix_sum_kernel as scan_k
    from repro_torch.core.distributed import DRAConfig
    from repro_torch.core.runtime import EmulatedMesh
    from repro_torch.models.tracking import TrackingConfig, TrackingSSM

    t_start = time.perf_counter()
    name = card()
    log(f"card: {name}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.BUILD_LOG.get('_seconds', 'cached')} s)")
    for src, text in sorted(build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    # -- phase 2 -------------------------------------------------------------
    patch_check = check_patch(dev)
    fused_check = check_fused(dev)
    sys_check = check_systematic(dev)
    scan_check = check_scan(dev)
    chain_check = check_chains(dev)
    attn_check = check_attention(dev)
    attn_check["wgmma_sass"] = check_wgmma()
    ref.mha_ref.calls = 0        # from here on no path may run it
    all_k = {"patch_log_likelihood": patch_k, "fused_weight_step": fused_k,
             "systematic_ancestors": sys_k, "metropolis_ancestors": metro_k,
             "rejection_ancestors": rej_k, "flash_attention": attn_k,
             "prefix_sum": scan_k}

    def reset():
        for k in all_k.values():
            k.launches = 0
        for k in (attn_k, metro_k, rej_k, patch_k):
            k.variants.update(dict.fromkeys(k.variants, 0))

    def counts(names=("patch_log_likelihood", "fused_weight_step")):
        torch.cuda.synchronize()
        return {n: all_k[n].launches for n in names}

    # -- phase 3: single filter at the paper's §VII.C frame ------------------
    cfg = TrackingConfig()
    model = TrackingSSM(cfg)
    n_single = 2 ** 22
    sir = SIRConfig(n_particles=n_single, ess_frac=0.5, step_backend="fused")
    pf = ParallelParticleFilter(model=model, sir=sir)
    # movie seed s, filter seed s + 1; seed 0 is the measured main path
    movies = [make_movie(s, cfg, dev) for s in range(N_SEEDS)]
    movie = movies[0]
    reset()
    t0 = time.perf_counter()
    res = pf.run(1, movie.frames)
    launches_single = counts()
    t_single = time.perf_counter() - t0
    check(launches_single == {"patch_log_likelihood": FRAMES,
                              "fused_weight_step": FRAMES},
          f"single filter launches {launches_single}")
    check(patch_k.variants == {"separable": FRAMES, "direct": 0},
          f"single filter patch variants {patch_k.variants}")
    check(bool(torch.isfinite(res.ess).all()
               and torch.isfinite(res.log_marginal).all()),
          "non-finite ESS / log-marginal")
    t0 = time.perf_counter()
    res2 = pf.run(1, movie.frames)
    torch.cuda.synchronize()
    t_single2 = time.perf_counter() - t0
    check(same_bits(res.estimates, res2.estimates)
          and same_bits(res.final.state, res2.final.state),
          "single filter not repeatable")
    fps_single = FRAMES / t_single2
    single = [track(res, movie)] + [
        track(pf.run(s + 1, m.frames), m) for s, m in enumerate(movies)
        if s > 0]
    gate_tracks(single, "single filter")
    rmse = single[0]["rmse"]
    log(f"single filter N=2^22 512x512 fused, seed 0: RMSE={rmse:.4f} px, "
        f"mean ESS={float(res.ess.mean()):.0f}, resampled "
        f"{int(res.resampled.sum())}/{FRAMES}, launches {launches_single}, "
        f"{fps_single:.2f} frames/s steady ({FRAMES / t_single:.2f} "
        f"first run) [{name}]")
    log(f"single filter, {N_SEEDS} seeds: {fmt_tracks(single)}")

    # -- phase 4: FilterBank at the same frame ---------------------------------
    b_bank, n_bank = 8, 2 ** 20
    movies = [make_movie(10 + i, cfg, dev) for i in range(b_bank)]
    frames = torch.stack([m.frames for m in movies])
    seeds = [100 + i for i in range(b_bank)]
    bank_sir = SIRConfig(n_particles=n_bank, ess_frac=0.5,
                         step_backend="fused")
    bank = FilterBank(model=model, sir=bank_sir)
    reset()
    t0 = time.perf_counter()
    bres = bank.run(seeds, frames)
    launches_bank = counts()
    t_bank = time.perf_counter() - t0
    check(launches_bank == {"patch_log_likelihood": FRAMES,
                            "fused_weight_step": FRAMES},
          f"bank launches {launches_bank}")
    members = [track(bres, m, i) for i, m in enumerate(movies)]
    gate_tracks(members, "bank")
    solo = ParallelParticleFilter(model=model, sir=bank_sir).run(
        seeds[0], frames[0])
    for field in ("estimates", "ess", "log_marginal", "resampled"):
        check(same_bits(getattr(bres, field)[0], getattr(solo, field)),
              f"bank member 0 {field} differs from the standalone filter")
    check(same_bits(bres.final.state[0], solo.final.state)
          and same_bits(bres.final.log_weights[0], solo.final.log_weights),
          "bank member 0 final ensemble differs from the standalone filter")
    t0 = time.perf_counter()
    bank.run(seeds, frames)
    torch.cuda.synchronize()
    fps_bank = FRAMES / (time.perf_counter() - t0)
    log(f"bank B={b_bank} x N=2^{n_bank.bit_length() - 1} 512x512 fused: "
        f"member 0 bitwise == standalone, launches {launches_bank}, "
        f"{fps_bank:.2f} bank frames/s steady ({FRAMES / t_bank:.2f} "
        f"first run) [{name}]")
    log(f"bank members: {fmt_tracks(members)}")

    # -- phase 5: composed default config at the main path's size -------------
    # the default SIRConfig (systematic comb, composed step): its CDF is the
    # scan kernel's, once a frame, and three runs must repeat bit for bit
    comp = ParallelParticleFilter(model=model, sir=SIRConfig(
        n_particles=n_single, ess_frac=0.5))
    comp_runs = []
    for _ in range(3):
        reset()
        t0 = time.perf_counter()
        cres = comp.run(1, movie.frames)
        launches_comp = counts(all_k)
        comp_runs.append((cres, time.perf_counter() - t0))
        want = {k: 0 for k in all_k}
        want.update({"patch_log_likelihood": FRAMES, "prefix_sum": FRAMES})
        check(launches_comp == want, f"composed launches {launches_comp}")
        check(patch_k.variants == {"separable": FRAMES, "direct": 0},
              f"composed patch variants {patch_k.variants}")
    first = comp_runs[0][0]
    for cres, _ in comp_runs[1:]:
        check(same_bits(cres.estimates, first.estimates)
              and same_bits(cres.final.state, first.final.state)
              and same_bits(cres.final.log_weights, first.final.log_weights),
              "composed filter not repeatable")
    check(bool(torch.isfinite(first.ess).all()
               and torch.isfinite(first.log_marginal).all()),
          "composed: non-finite ESS / log-marginal")
    comp_track = track(first, movie)
    gate_tracks([comp_track], "composed filter")
    fps_comp = FRAMES / comp_runs[-1][1]
    composed = {"n": n_single, "frames": FRAMES, "launches": launches_comp,
                "track": comp_track, "frames_per_s": fps_comp,
                "first_run_frames_per_s": FRAMES / comp_runs[0][1],
                "resampled": int(first.resampled.sum())}
    log(f"composed (default config) N=2^22 512x512, seed 0: RMSE "
        f"{comp_track['rmse']:.4f} px after {WARMUP} (after 10: "
        f"{comp_track['rmse_after_10']:.4f}, lock-on frame "
        f"{comp_track['lock_frame']}), resampled {composed['resampled']}/"
        f"{FRAMES}, three runs bitwise equal, launches {launches_comp}, "
        f"{fps_comp:.2f} frames/s steady ({composed['first_run_frames_per_s']:.2f}"
        f" first run) [{name}]")
    del comp_runs, first, cres

    # -- phase 5b: collective-free resamplers at full width -------------------
    chain_runs = {}
    for scheme, kname in (("metropolis", "metropolis_ancestors"),
                          ("rejection", "rejection_ancestors")):
        cpf = ParallelParticleFilter(model=model, sir=SIRConfig(
            n_particles=n_single, ess_frac=0.5, step_backend="fused",
            resampler=scheme))
        reset()
        t0 = time.perf_counter()
        cres = cpf.run(1, movie.frames)
        got = counts(all_k)
        t_first = time.perf_counter() - t0
        want = {k: 0 for k in all_k}
        want.update({"patch_log_likelihood": FRAMES,
                     "fused_weight_step": FRAMES, kname: FRAMES})
        check(got == want, f"{scheme} filter launches {got}")
        check(all_k[kname].variants == {"tma": FRAMES, "lane": 0},
              f"{scheme} filter chain variants {all_k[kname].variants}")
        t0 = time.perf_counter()
        cres2 = cpf.run(1, movie.frames)
        torch.cuda.synchronize()
        fps = FRAMES / (time.perf_counter() - t0)
        check(same_bits(cres.estimates, cres2.estimates)
              and same_bits(cres.final.state, cres2.final.state),
              f"{scheme} filter not repeatable")
        check(bool(torch.isfinite(cres.ess).all()
                   and torch.isfinite(cres.log_marginal).all()),
              f"{scheme}: non-finite ESS / log-marginal")
        tr = track(cres, movie)
        gate_tracks([tr], f"{scheme} filter")
        chain_runs[scheme] = {"launches": got[kname],
                              "variants": dict(all_k[kname].variants),
                              "track": tr,
                              "frames_per_s": fps,
                              "first_run_frames_per_s": FRAMES / t_first,
                              "resampled": int(cres.resampled.sum())}
        log(f"{scheme} filter N=2^22 512x512 fused, seed 0: RMSE "
            f"{tr['rmse']:.4f} px after {WARMUP} (after 10: "
            f"{tr['rmse_after_10']:.4f}, lock-on frame {tr['lock_frame']}),"
            f" resampled {int(cres.resampled.sum())}/{FRAMES}, launches "
            f"{got}, {fps:.2f} frames/s steady ({FRAMES / t_first:.2f} "
            f"first run) [{name}]")
        del cres, cres2

    # -- phase 5c: the distributed filter on an emulated 8-shard mesh --------
    p_mesh, c_mesh = 8, 2 ** 22
    dras = {"mpf": DRAConfig(kind="mpf"),
            "rna": DRAConfig(kind="rna", exchange_ratio=0.1),
            "rpa": DRAConfig(kind="rpa", scheduler="lgs", k_cap=64,
                             slack=2.0)}
    dist_runs = {}
    for kind, dra in dras.items():
        dpf = ParallelParticleFilter(model=model, sir=SIRConfig(
            n_particles=p_mesh * c_mesh, ess_frac=0.5), mesh=EmulatedMesh(
            p_mesh), dra=dra)
        reset()
        t0 = time.perf_counter()
        dres = dpf.run(1, movie.frames)
        got = counts(all_k)
        t_first = time.perf_counter() - t0
        want = {k: 0 for k in all_k}
        # MPF and RNA comb on B1; RPA's per-shard comb scans its CDF
        want.update({"patch_log_likelihood": FRAMES,
                     "systematic_ancestors": 0 if kind == "rpa" else FRAMES,
                     "prefix_sum": FRAMES if kind == "rpa" else 0})
        check(got == want, f"{kind} launches {got}")
        check(patch_k.variants == {"separable": FRAMES, "direct": 0},
              f"{kind} patch variants {patch_k.variants}")
        if kind == "rna":
            # B3's timing input (iii): the ensemble in the slot order RNA
            # leaves it
            rna_final = dres.final.state
        t0 = time.perf_counter()
        dres2 = dpf.run(1, movie.frames)
        torch.cuda.synchronize()
        fps = FRAMES / (time.perf_counter() - t0)
        check(same_bits(dres.estimates, dres2.estimates)
              and same_bits(dres.final.state, dres2.final.state)
              and same_bits(dres.final.log_weights, dres2.final.log_weights),
              f"{kind} distributed filter not repeatable")
        check(bool(torch.isfinite(dres.ess).all()
                   and torch.isfinite(dres.log_marginal).all()),
              f"{kind}: non-finite ESS / log-marginal")
        check(dres.final.state.shape == (p_mesh, c_mesh, 5),
              f"{kind}: final ensemble {tuple(dres.final.state.shape)}")
        cb, cs = comm_formulas(kind, p_mesh, c_mesh, dra, 5 * 4, 5 * 4)
        check(bool((dres.diag["comm_bytes"] == cb).all()
                   and (dres.diag["comm_stages"] == cs).all()),
              f"{kind}: comm accounting {dres.diag['comm_bytes'][0]} B / "
              f"{dres.diag['comm_stages'][0]} stages, formulas {cb} / {cs}")
        tr = track(dres, movie)
        gate_tracks([tr], f"{kind} distributed filter")
        extra = ""
        if kind == "rpa":
            extra = (f", overflow units/frame max "
                     f"{int(dres.diag['overflow'].max())}, links max "
                     f"{int(dres.diag['links'].max())}")
        dist_runs[kind] = {
            "launches": got, "track": tr, "frames_per_s": fps,
            "first_run_frames_per_s": FRAMES / t_first,
            "comm_bytes": cb, "comm_stages": cs,
            "resampled": int(dres.resampled.sum()),
            "mean_ess": float(dres.ess.mean())}
        log(f"{kind} 8 x 2^22 = 2^25 particles, 512x512: RMSE "
            f"{tr['rmse']:.4f} px after {WARMUP} (after 10: "
            f"{tr['rmse_after_10']:.4f}, lock-on frame {tr['lock_frame']}),"
            f" mean ESS {float(dres.ess.mean()):.0f}, resampled "
            f"{int(dres.resampled.sum())}/{FRAMES}, comm {cb} B / {cs} "
            f"stages per frame and shard (= formulas){extra}, launches "
            f"{got}, {fps:.2f} frames/s steady ({FRAMES / t_first:.2f} "
            f"first run) [{name}]")
        del dres, dres2

    # -- phase 5d: LM serving at qwen3-32b width ------------------------------
    lm = run_lm(dev, all_k, reset, counts, name)

    # -- phase 6: timings --------------------------------------------------------
    # B3's timing inputs: (i) the single filter's final particles, in
    # ancestor order; (ii) the same under a fixed permutation; (iii) RNA's
    # final 8 x 2^22 ensemble against the shared frame (a stride-0 view,
    # as the distributed step passes it); the bank shape on uniformly
    # spread particles
    state = res.final.state[None].contiguous()
    frames1 = movie.frames[-1][None].contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    perm = torch.randperm(n_single, generator=g, device=dev)
    bstate, bframes = patch_inputs(b_bank, n_bank, 512, 512, 4, dev)
    patch_in = {"i": (state, frames1),
                "ii": (state[:, perm].contiguous(), frames1),
                "iii": (rna_final, movie.frames[-1].expand(
                    p_mesh, *movie.frames.shape[1:])),
                "bank": (bstate, bframes)}
    check_patch_inputs(patch_in)
    patch_times = time_patch(patch_in, cfg)
    for label, t in patch_times.items():
        log(f"times [{name}]: B3 input {label} {tuple(t['shape'])}: "
            f"{t['ms']:.4f} ms (first design {t['first_ms']:.4f}, "
            f"{t['first_ms'] / t['ms']:.2f}x; device {t['device_ms']:.4f}; "
            f"bound {t['bound_ms']:.4f} {t['bound_by']})")
    check(all(t["ms"] < t["first_ms"] for t in patch_times.values()),
          "B3: the separable kernel is not faster than the first design "
          "at every input")
    patch_ms = patch_times["i"]["ms"]
    patch_plain_ms = cuda_ms(lambda: ref.patch_log_likelihood_ref(
        state[..., 0], state[..., 1], state[..., 4], frames1))
    p_bound, p_by = patch_times["i"]["bound_ms"], patch_times["i"]["bound_by"]
    del patch_in, rna_final
    lw, ll, fstate, u = fused_inputs(1, n_single, 5, dev)
    fused_ms = cuda_ms(lambda: fused_k(lw, ll, fstate, u))
    fused_plain_ms = cuda_ms(lambda: fused_weight_step_ref(lw, ll, fstate, u))
    n_res = int(fused_weight_step_ref(lw, ll, fstate, u).resampled.sum())
    f_bound, f_by = fused_bound(1, n_single, 5, n_res)
    patch_bank_ms = patch_times["bank"]["ms"]
    blw, bll, bst, bu = fused_inputs(b_bank, n_bank, 6, dev)
    fused_bank_ms = cuda_ms(lambda: fused_k(blw, bll, bst, bu))
    slw, sll, _, su = fused_inputs(p_mesh, c_mesh, 7, dev, d=1)
    slw = slw + sll
    sys_ms = cuda_ms(lambda: sys_k(slw, su, c_mesh))
    sys_plain_ms = cuda_ms(lambda: ref.systematic_ancestors_ref(
        slw, su, c_mesh))
    s_bound, s_by = systematic_bound(p_mesh, c_mesh, c_mesh)
    del slw, sll, su
    clw, cprop, clogu = chain_inputs(1, n_single, 8, dev)
    metro_ms = cuda_ms(lambda: metro_k(clw, cprop, clogu))
    metro_plain_ms = cuda_ms(lambda: resample.metropolis_ancestors_ref(
        clw, cprop, clogu))
    rej_ms = cuda_ms(lambda: rej_k(clw, cprop, clogu))
    rej_plain_ms = cuda_ms(lambda: resample.rejection_ancestors_ref(
        clw, cprop, clogu))
    # the first design (the lane kernel), on the same inputs: the yardstick
    lane_ms = {r: cuda_ms(lambda: resample._chain_kernel(
        clw, cprop, clogu, r, "lane")) for r in (False, True)}
    c_bound, c_by = chain_bound(1, n_single, n_single, 32)
    del clw, cprop, clogu
    log(f"times [{name}]: B1 {sys_ms:.4f} ms at 8x2^22 (plain "
        f"{sys_plain_ms:.4f}, bound {s_bound:.4f} {s_by}); B4 "
        f"{metro_ms:.4f} ms (lane kernel {lane_ms[False]:.4f}, plain "
        f"{metro_plain_ms:.4f}), B5 {rej_ms:.4f} ms (lane kernel "
        f"{lane_ms[True]:.4f}, plain {rej_plain_ms:.4f}) at 2^22 x 32, "
        f"bound {c_bound:.4f} {c_by}")
    check(metro_ms < lane_ms[False] and rej_ms < lane_ms[True],
          "the tma chain kernel is not faster than the lane kernel")
    scan_times = time_scan(dev)
    for label, t in scan_times.items():
        log(f"times [{name}]: comb scan {label}: {t['ms']:.4f} ms (first "
            f"design {t['first_ms']:.4f}, device {t['device_ms']:.4f}, "
            f"plain {t['plain_ms']:.4f}, torch.cumsum {t['library_ms']:.4f}, "
            f"bound {t['bound_ms']:.4f} {t['bound_by']})")
    check(scan_times["8x2^22"]["ms"] < scan_times["8x2^22"]["first_ms"],
          "comb scan: the one-pass kernel is not faster than the first "
          "design at 8 x 2^22")
    attn_times = time_attention(dev)
    for label, t in attn_times.items():
        log(f"times [{name}]: B6 {label} [{t['variant']}] q{tuple(t['q'])} "
            f"kv{tuple(t['k'])}: {t['ms']:.4f} ms (mma.sync kernel "
            f"{t['mma_ms']:.4f}, plain {t['plain_ms']:.4f}, sdpa "
            f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} "
            f"{t['bound_by']})")
    log(f"times [{name}]: patch {patch_ms:.4f} ms (plain {patch_plain_ms:.4f},"
        f" bound {p_bound:.4f} {p_by}), fused {fused_ms:.4f} ms (plain "
        f"{fused_plain_ms:.4f}, bound {f_bound:.4f} {f_by}) at N=2^22; "
        f"bank {b_bank}x2^{n_bank.bit_length() - 1}: patch "
        f"{patch_bank_ms:.4f} ms, fused "
        f"{fused_bank_ms:.4f} ms")

    kernels = [
        {"name": "patch_log_likelihood", "variant": "separable",
         "route": "cuda",
         "source": "src/repro_torch/csrc/patch_likelihood.cu",
         "replaces": "src/repro/kernels/patch_likelihood.py:71",
         "launches": launches_single["patch_log_likelihood"],
         "max_abs_err": patch_check["max_abs_err"], "ms": patch_ms,
         "plain_ms": patch_plain_ms, "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": None},
        {"name": "fused_weight_step", "route": "cuda",
         "source": "src/repro_torch/csrc/sir_fused.cu",
         "replaces": "src/repro/kernels/sir_fused.py:225",
         "launches": launches_single["fused_weight_step"],
         "max_abs_err": fused_check["max_abs_err"], "ms": fused_ms,
         "plain_ms": fused_plain_ms, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": None},
        {"name": "systematic_ancestors", "route": "cuda",
         "source": "src/repro_torch/csrc/resample.cu",
         "replaces": "src/repro/kernels/resample.py:68",
         "launches": dist_runs["mpf"]["launches"]["systematic_ancestors"],
         "max_abs_err": sys_check["max_abs_err"], "ms": sys_ms,
         "plain_ms": sys_plain_ms, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None},
        {"name": "metropolis_ancestors", "variant": "tma", "route": "cuda",
         "source": "src/repro_torch/csrc/resample.cu",
         "replaces": "src/repro/kernels/resample.py:154",
         "launches": chain_runs["metropolis"]["launches"],
         "max_abs_err": chain_check["max_abs_err"], "ms": metro_ms,
         "plain_ms": metro_plain_ms, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": None},
        {"name": "rejection_ancestors", "variant": "tma", "route": "cuda",
         "source": "src/repro_torch/csrc/resample.cu",
         "replaces": "src/repro/kernels/resample.py:207",
         "launches": chain_runs["rejection"]["launches"],
         "max_abs_err": chain_check["max_abs_err"], "ms": rej_ms,
         "plain_ms": rej_plain_ms, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": None},
        # the composed step's shape; RPA's 8 x 2^22 is in the record's
        # "scan" entry
        {"name": "prefix_sum", "variant": "lookback", "route": "cuda",
         "source": "src/repro_torch/csrc/comb_scan.cu",
         "replaces": "src/repro/core/resampling.py:64",
         "launches": composed["launches"]["prefix_sum"],
         "max_abs_err": scan_check["max_abs_err"],
         "ms": scan_times["1x2^22"]["ms"],
         "plain_ms": scan_times["1x2^22"]["plain_ms"],
         "bound_ms": scan_times["1x2^22"]["bound_ms"],
         "bound_by": scan_times["1x2^22"]["bound_by"],
         "library_ms": scan_times["1x2^22"]["library_ms"]},
        # the decode shape (the split variant), 31 of every 32 launches on
        # the LM path; the prefill shapes (the wgmma variant, the same
        # source) are in the record's "attention" entry
        {"name": "flash_attention", "variant": "split", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:84",
         "launches": lm["smc_decode"]["launches"],
         "max_abs_err": attn_check["max_abs_err"],
         "ms": attn_times["smc_decode"]["ms"],
         "plain_ms": attn_times["smc_decode"]["plain_ms"],
         "bound_ms": attn_times["smc_decode"]["bound_ms"],
         "bound_by": attn_times["smc_decode"]["bound_by"],
         "library_ms": attn_times["smc_decode"]["library_ms"]},
    ]
    record = {
        "card": name, "kernels": kernels,
        "tie_lanes": fused_check["tie_lanes"],
        "comb_offset": fused_check["comb_offset"],
        "systematic_tie_lanes": sys_check["tie_lanes"],
        "systematic_comb_offset": sys_check["comb_offset"],
        "chains": chain_runs, "chain_check": chain_check,
        "chain_lane_ms": {"metropolis": lane_ms[False],
                          "rejection": lane_ms[True]},
        "composed": composed, "scan": scan_times, "scan_check": scan_check,
        "distributed": dist_runs, "lm": lm,
        "attention": attn_times, "attention_check": attn_check,
        "patch_inputs": patch_times,
        "bank_ms": {"patch_log_likelihood": patch_bank_ms,
                    "fused_weight_step": fused_bank_ms},
        "single": {"n": n_single, "frames": FRAMES, "warmup": WARMUP,
                   "tracks": single, "frames_per_s": fps_single,
                   "first_run_frames_per_s": FRAMES / t_single},
        "bank": {"b": b_bank, "n": n_bank, "frames": FRAMES,
                 "warmup": WARMUP, "tracks": members,
                 "frames_per_s": fps_bank,
                 "first_run_frames_per_s": FRAMES / t_bank},
        "seconds": time.perf_counter() - t_start,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    log(f"total {record['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
