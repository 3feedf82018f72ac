#!/usr/bin/env python3
"""Drive the torch port's main path on one CUDA card.

    python3 chip_smoke.py [--out FILE]

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   Hopper kernel from ``src/repro_torch/csrc`` with ``nvcc`` (one process
   per source, in parallel) into ``src/repro_torch/_build/``;
2. holds each kernel against its plain torch version on the card, at the
   slice's shapes, and requires two runs of each kernel to give the same
   bits; reads B6's prefill variant's SASS for unserialized wgmma.  B6
   also with a sliding window on every variant (gemma3's D = 128, window
   1024 prefill on wgmma; recurrentgemma's D = 256, G = 10, window 2048
   on mma.sync; windowed decodes on split at both head dims, whose keys
   outside the window are then set to NaN: the output must stay finite
   and bit for bit the same), at head dim 256 and on non-causal calls
   over 1601 image keys (prefill and decode), at latent attention's q/k
   and v head dims (192, 128) on mma.sync and f32 (ragged, grouped,
   non-causal, a decode offset, one query row); and B6 at every call
   shape phases 5j, 5k and 5n c run (``kinds_calls``, from ``KINDS``,
   ``MOE``, the configs and a rank's heads on LMGRID_SERVE_SHAPE, in the
   layouts the model hands it: every prefill, and
   each decode step whose split plan differs from the step before, with
   the first, middle and last), against its plain version in bf16 and
   float32 within ATTN_TOL, repeatable, the windowed decodes again with
   NaN outside the window, 5k's also through the float32 kernel.  B3
   (the separable kernel) also at R = 2, 6 and 9, in the Eq. 4 form and
   an Eq. 4 close fit, on converged clouds in no slot order (the staged
   window box, with outliers, too wide for the box), and on halo slabs
   and a frame view at an odd column, bit for bit equal to the full
   frame; and B3 with a per-member geometry table at the domain path's
   shape (8 x 9 · 2^22 merged states against the 8 slabs, 264 x 136, of
   a 512x512 frame on a 2 x 4 grid, and a ragged N whose blocks straddle
   two members): every particle within PATCH_TOL of the plain version
   with the same table, every particle its member's tile owns bit for bit
   the full frame's, repeatable.  The comb scan (one launch) is held against the float64 scan at
   the composed step's, RPA's and SMC decoding's shapes, ragged rows
   about the tile span, 1024 rows of 4097 and a row whose mass is all in
   its last element, with the systematic, stratified and multinomial
   combs built on it; B1 and B2 (the redesign: normalizer, look-back CDF,
   merge comb) bit for bit equal to their torch emulations and on a second
   run, a member independent of B, and held to their plain versions by
   the comb rules (B2 also its decision and FUSED_TOL) at the DRA and bank
   shapes, n_out != n_in with ragged tails, a skewed input (one slot with
   99% of the mass, a dead run), without the comb, and, for B1, a member
   with no finite weight (ancestor 0, as the first design); B4/B5 both on
   the tma kernel that ``plan`` picks at the reference's budget and on the
   lane kernel; and this slice's shapes: B2 at state widths 1, 8 and 40,
   B1 and B3 at the bank over the mesh's 32 x 2^22 and B3 on ASIR's
   262,144-row lattice, and the fixed-order row sums of ``core`` giving a
   row the same bits alone, in 8 rows and in 32; and the row-sum kernel
   (``csrc/row_sum.cu``, every float sum of ``core`` on the card) bit for
   bit its torch emulation and a second launch, with and without the
   shift of logsumexp, at 1, 8 and 32 x 2^22, ragged rows (2^22 - 1,
   4097, 1025, 1), rows whose starts are not 16-byte aligned (8 x (2^22 -
   3), 7 x (2^22 + 5)) and inner = 5, 40 and 48, within ROW_SUM_TOL of the
   float64 sum (relative to the sum of |x|), a row's bits alone == in its
   batch, in 2, 4, 8 and 32 rows and from a misaligned start;
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
4b. runs the composed FilterBank of 8 x 2^20 on phase 4's movies and
   seeds: every member bit for bit the standalone composed filter with
   its seed (ROADMAP C7), B3 and the comb scan once a frame;
5. runs the composed default config (systematic comb) at N = 2^22 over
   the same 40-frame movie three times, through the patch kernel and the
   comb scan once a frame each: the runs must agree bit for bit and pass
   the tracking gate;
5b. runs the single filter at N = 2^22 on the same 512×512 movie with the
   collective-free resamplers (fused step, ``metropolis`` and
   ``rejection``), through the patch, fused and chain kernels;
5c. runs the paper's distributed filter on an emulated 8-shard mesh,
   8 × 2^22 = 2^25 particles over the same movie, for MPF, RNA, ARNA, RPA
   and butterfly, and checks tracking, repeatability, the comm accounting
   against the analytic formulas and the kernels it launched (butterfly:
   the comb scan once a stage, no overflow or truncated units; ARNA's
   lost-mode frames are printed);
5e. runs the domain-decomposed filter (2 x 4 tiles of the 512x512 frame,
   one per shard) for RNA and RPA with 5c's configs, movie and seed: it
   must equal 5c's replicated runs bit for bit, launch B3 once a frame
   with the per-member geometry, overflow nothing and move particles, and
   repeat; the per-shard observation bytes and each run's peak memory
   are printed; then RNA with a bounded window (k_cap = 2^16), whose
   migration is checked frame by frame (kept + shipped units == each
   shard's units, the diagnostics as the reference defines them);
5f. runs a FilterBank over the emulated 8-shard mesh at full width: 4
   members x 2^25 particles (2^27 on the card), RNA and RPA twice each,
   member 0 on 5c's seed and movie: every member under the tracking gate,
   member 0 bit for bit 5c's standalone run, the two runs bit for bit
   equal, B3 and the comb (B1 or the comb scan) launched once a frame for
   the whole bank; RNA again on a (2, 8) bank x data grid with
   ``bank_axis``, bit for bit the bank without it;
5i. runs the distributed filter as 8 processes, one shard each, over a
   gloo process group on this one card (``python -m
   torch.distributed.run --standalone --nproc-per-node 8 -m
   repro_torch.launch.track --transport gloo``, 5c's movie saved to a
   ``.npy``): RNA and RPA at 5c's width and seed and a 2-member RNA bank
   (member 0 on 5c's seed); every rank's outputs and diag, its final
   shard and the ensemble gathered from the rank files bit for bit 5c's
   runs; each rank launches B3 and B1 (RNA) or the comb scan (RPA) once a
   frame and the row sum as often a frame as 5c (5f for the bank).  Then
   proc-grid-bank-rna: the 8 ranks as a (2, 4) (bank, data) grid
   (``--grid 2x4``) running a 4-member RNA bank at 4 x 2^22 particles a
   member with ``bank_axis`` (2 members x 2^22 a rank; member 0 on 5c's
   seed) and RNA alone on the data axis: every rank's outputs, diag and
   final shard bit for bit an in-process ``make_mesh((2, 4))`` run of the
   bank on the card, that run bit for bit the bank on ``EmulatedMesh(4)``
   (5f's rule), the filter on the data axis bit for bit member 0; each
   rank launches B3 and B1 once a frame and the row sum as often as 5f's
   bank-mesh-rna (5c's RNA for the filter).  Then the nccl transport at
   world size 1 (``launch.mesh.spawn``): every verb bit for bit
   ``EmulatedMesh(1)``'s, and every verb on both axes of a (1, 1) process
   grid's sub-groups too.  After 5h, proc-sessions: 4 gloo ranks
   (``launch.mesh.spawn``) on the bank axis serve 5h's 12 tracking
   sessions of 2^22 at capacity 8 (2 slots a rank) under 5h's churn,
   composed: every session bit for bit its standalone filter of 5h on
   every rank, session 5 suspended on the ranks at tick 30 and finished
   on an in-process single-device server bit for bit, one B3 and one comb
   scan a tick on every rank.  Frames/s and ticks/s (contention of the
   ranks on one card, not a multi-card rate), staged bytes a frame and
   the phase's seconds are printed, not gated; a failed rank fails the
   script;
5g. runs the rest of the filter layer: ASIR on a 256 x 256 x 4 lattice
   (one B3 launch over its 262,144 rows and one B2 launch a frame, RMSE
   within 2.5 px of phase 3's exact filter for each of its 8 seeds);
   stochastic volatility and Lorenz-96 at N = 2^22 over 200 frames
   simulated on the card, 8 seeds, fused and composed (normalized
   weights after every step, ESS in [1, N], seed 0 repeated step by step
   bit for bit, B2 or the comb scan once a frame, the backends' mean
   summed log-marginals within 4 standard errors); and the genealogy
   smoothers at N = 2^20, T = 24 against the Kalman RTS smoother (the
   reference's CLT bound, smoothing and lag 8 beating filtering);
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
5h. serves on the card: 12 tracking sessions of 2^22 particles (512x512,
   SNR 2, 40-frame movies) on a capacity-8 ``ParticleSessionServer``,
   fused and composed, under a fixed churn schedule (staggered attaches,
   detaches when a movie ends, session 2 suspended to a directory and
   resumed, session 5 resumed on a capacity-4 server): every session bit
   for bit its standalone filter and under the tracking gate, at most one
   step program a tier, B3 and B2 or the comb scan once a tick for the
   whole tier; the composed server under ``ParticleFrontend`` with 8
   Poisson streams at 20 frames/s for 5 s (every frame delivered in
   order, streams 0 and 1 bit for bit their standalone runs; latency
   quantiles from the Metrics snapshot); a fleet of two capacity-4 banks
   and a standby, 8 streams with skew 4, the standby brought up and one
   stream migrated onto it, bank b killed at its 24th step (every stream
   bit for bit its standalone run);
   and two of 5d's prompts decoded as resident sessions with 5d's
   weights (bit for bit ``smc_decode``, B6's launches as in 5d);
5j. serves the other layer kinds at full width with random bf16 weights
   (``KINDS``): gemma3-27b (12 of 62 layers, two LLLLLG units, window
   1024; 4 × 2048 prompts), recurrentgemma-2b (all 26 RRL layers, D =
   256 over one KV head, window 2048; 4 × 2560), mamba2-1.3b (all 48 D
   layers; 4 × 2048), llama-3.2-vision-11b (10 of 40 layers, two GGGGX
   units; 4 × 1024 with 1601 × 1280 image embeddings from the seed) and
   musicgen-medium (all 48 layers; 4 × 1024 × 4 codebooks): ``generate``
   (32 greedy steps) twice, equal bit for bit, its decode logits against
   prefill logits (mamba2's also beside ``ssm_witnesses``: its decode
   with the SSM state in float32 within the arch's limit, one with its
   conv windows handed over a slot late beyond it, one with the state
   dropped recorded),
   and for the first three ``smc_decode`` (K = 8, 32
   steps, τ = 1.5) twice, equal bit for bit, sequences the genealogy's
   paths, finite log Z, ESS in [1, K]; every attention layer through B6
   with its launches by variant checked (the windowed prefills on wgmma
   or, at D = 256, mma.sync; every decode on split), the comb scan once
   a bank step, ``mha_ref`` never; each model freed before the next;
5k. serves the M kind (latent attention) and MoE FFNs at full width the
   same way (``MOE``): deepseek-v2-236b (4 of 60 layers, MMMM, FFNs
   dense, moe, moe, moe: 160 experts of 1536, top 6, 2 shared; 24.8 GiB)
   and moonshot-v1-16b-a3b (16 of 48 G layers, 1 dense + 15 MoE: 64
   experts of 1408; 17.8 GiB), 4 × 1024 prompts: ``generate`` twice and
   ``smc_decode`` (K = 8, its 32 rows at the full prompt) twice, bit for
   bit; B6 by variant {"mma": 4} a deepseek run (the M prefill at (192,
   128); the absorbed decode launches nothing) and {"wgmma": 16, "split":
   16 × 31} a moonshot run, the comb scan once a bank step, ``mha_ref``
   never; the MoE aux of a prefill at the configs' capacity factor 1.25,
   printed; decode vs prefill logits at capacity factor E / k, where the
   prefill drops nothing (checked), within ``kinds_tols``' limit;
5l. (run right after phase 2, while the card is empty) trains
   stablelm-3b whole (32 layers at full width, 2.80 B float32 master
   weights drawn on the card, bf16 compute, remat, AdamW, batches of 8 x
   1024 from ``make_batch`` in 2 microbatches, loss chunks of 512) for 20
   steps through ``repro_torch.train``, which runs no kernel of the port
   (the reference trains outside its Pallas kernel): the loss falls by
   TRAIN_FALL; the step-0 gradient in bf16 within TRAIN_GRAD_TOL of the
   float32-compute one, leaf by leaf, none zero; 1 against 2 microbatches
   in float32 at the reference's tolerances (16 layers); two 3-step runs
   and a checkpoint resume at step 2 (2 layers) bit for bit; no kernel
   launched and ``mha_ref`` never run, and B6 refusing a CUDA input that
   requires grad; step ms, tokens/s, the bf16 share and peak memory
   printed;
5m. (right after 5l) trains the other layer kinds, MoE FFNs and the
   codebook head at full width, one arch at a time, each freed before
   the next (``TRAIN_KINDS``): recurrentgemma-2b whole (R, L), mamba2-1.3b
   whole (D), musicgen-medium whole (4 codebooks), llama-3.2-vision-11b
   10 of 40 layers (G, X over 1601 image tokens of 1280), moonshot-v1-16b-
   a3b 4 of 48 (a dense layer and 3 MoE: 64 experts of 1408, top 6, 2
   shared), deepseek-v2-236b 1 of 60 (its dense first M layer at (192,
   128), 128 heads); 5l's batches, optimizer and precision: a. 10 steps,
   the loss falling by TRAIN_FALL; b. the seed's bf16 gradient against
   the float32-compute one, leaf by leaf within TRAIN_GRAD_TOL (MoE
   router and experts within TRAIN_MOE_GRAD_TOL, set from a reckoning of
   bf16 routing flips), none zero, except llama's X-gated leaves, exactly
   zero while tanh(xattn_gate) = 0 and held again after one step; c.
   moonshot's aux loss and dropped fraction finite, printed; d. two
   2-step runs the same bits; f. no kernel launched, B6's count 0
   through the M and X layers, ``mha_ref`` never; step ms, tokens/s,
   6·N·tokens over 989 TFLOP/s (N active) and peak memory printed;
5n. (right after 5m) the LM over a (data, model) process grid: four
   ranks spawned on the card over gloo (``launch.mesh.spawn``,
   ``launch.lm_grid.grid_phase``; contention of ranks on one card, each
   collective staged through host memory), each one-device baseline run
   on rank 0 and freed before the grid's work: a. qwen3-32b at full width
   cut to 2 layers on (2, 2), 5l's batches in one microbatch, precision,
   remat and AdamW: the step-0 gradient gathered leaf by leaf within
   TRAIN_GRAD_TOL of the one-device step's and the loss within
   LMGRID_LOSS_TOL, the loss falling over 10 steps, two 3-step runs the
   same bits and the step-2 checkpoint restored onto (4,) the same bits
   (grid-invariant digests of every weight and moment); b. moonshot's
   dense and one MoE layer at full width on (2, 2) with its config's
   ep_shardmap + rs_ag: at capacity E / k the same gradient and loss
   gates (router and experts within TRAIN_MOE_GRAD_TOL), at 1.25 the
   dropped fraction, aux loss and largest load finite and printed, two
   runs the same bits; a and b launch no kernel; c. 5d's model served on
   (1, 4) through ``make_serve_step``, 4 x 1024 prompts and 32 greedy
   steps fed the one-device run's tokens: every step's logits within
   LM_LOGIT_TOL, the argmax the same but at recorded ties, B6's launches
   and variants on every rank the one-device run's, ``mha_ref`` never;
   step ms, tokens/s, staged bytes and peak memory a rank printed;
6. holds B3 against its plain version on its timing inputs — (i) the
   single filter's final particles in ancestor order, (ii) the same under
   a fixed permutation, (iii) RNA's final 8 x 2^22 ensemble, and the bank
   shape on uniformly spread particles — and times B3 and the comb scan
   beside their first designs on the same inputs, in turns (new, first,
   first, new), failing unless the new B3 is faster at every input and
   the new scan at 8 x 2^22; times B3 with a one-row per-member table
   against the shared geometry on input (i), in turns, and B3 at the
   domain shape (RNA's final ensemble migrated to its owners against 8
   slabs) beside its bound; holds B1 on its timing inputs — (i) a
   filter's post-likelihood weights at 8 x 2^22, (ii) the mpf cell's final
   log-weights plus the final particles' likelihood of the last frame, (iii)
   the skewed input — to phase 2's gates, and times B1 there and B2 at
   1 x 2^22 with and without the comb and at the bank's 8 x 2^20 beside
   their first designs (``resample._sys_launch`` and ``sir_fused._launch``
   with the seven-pass plans) in turns, failing unless each redesign is
   faster at every input; then
   times each kernel and its plain version (median of 20 CUDA-event
   timed launches) beside the kernel's bound and, for B6, PyTorch's
   ``scaled_dot_product_attention`` on the same inputs and B6's
   mma.sync kernel launched directly, for the comb scan ``torch.cumsum``,
   for B4/B5 their lane kernel launched directly (yardsticks: the port
   never calls SDPA or a float ``torch.cumsum`` on the card, and takes the
   mma.sync and lane kernels only at other shapes), and the end-to-end
   frames/s and tokens/s; and, recorded but not gated, B1 and B3 at the
   bank over the mesh's 32 x 2^22 (B3 on 5f's final RNA ensemble), B3 on
   ASIR's lattice and B2 at D = 1, 8 and 40, each beside its first design
   and its bound; and the row-sum kernel at 1, 8 and 32 x 2^22 and at
   (2^22, 5) beside its first design (``row_sum.first_design_kernel``)
   and torch's sum (its plain version and the library call) in turns,
   with its bound, registers and blocks an SM, failing unless its device
   time beats the first design's at every shape; and, recorded, B6 at
   phase 5j's and 5k's new attention shapes (the timed calls of
   ``kinds_calls``) beside its bound (the bytes of the keys some query
   sees, 2·(D + Dv) FLOP a visible pair), its plain version and SDPA
   with an explicit band mask.

The launch counters are set to 0 just before each main-path run and read
just after; a kernel the run did not launch fails the script.  Any failed
check raises, so the script exits non-zero and prints no result line.
Without a CUDA device it exits non-zero at once.  The last line is
``{"ok": true, "device": {...}}``; the line before it the card; before
that the ``{"kernels": [...]}`` record, where each kernel also lists its
launches in phases 5f-5n (``launches_new_phases``; for
the row sum, its launches a frame in each cell; for 5i and 5n, each
rank's).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
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


def queued_device_ms(fn, reps: int = 100) -> float:
    """Device time per call of ``fn()`` even where the host enqueues a
    call slower than the card runs it (where ``device_ms`` times the
    host): the calls queue behind a ~10 ms ``torch.cuda._sleep`` and the
    events time them back to back."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
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


DOMAIN_P, DOMAIN_FRAME = 8, (512, 512)


def check_patch_domain(dev) -> dict:
    """B3 with a per-member geometry table at the domain path's shape: the
    merged ``(8, 9 · 2^22, 5)`` states of ``DomainSpec.for_mesh((512,
    512), 8, 4)`` (grid 2 x 4, slabs 264 x 136) against the ``(8, 264,
    136)`` slab stack of one frame, and a ragged N (a block straddles two
    members).  Positions are uniform over the frame and past its edges,
    so most particles sit in a foreign slab and are clamped into it (the
    overflow residents' case).  Every particle is held to the plain
    version (with the same table) within PATCH_TOL; every particle its
    member's tile owns equals, bit for bit, the kernel on the full frame
    with the default geometry; a second launch repeats the bits."""
    import torch
    from repro_torch.core.domain import DomainSpec, owner_of, tile_frames
    from repro_torch.kernels import ref
    from repro_torch.kernels.patch_likelihood import \
        patch_log_likelihood_kernel as kern
    from repro_torch.models.tracking import TrackingConfig, tile_geometry
    cfg = TrackingConfig()
    spec = DomainSpec.for_mesh(DOMAIN_FRAME, DOMAIN_P, cfg.patch_radius)
    check(spec.grid == (2, 4) and spec.slab_shape == (264, 136),
          f"domain spec {spec}")
    g = torch.Generator(device=dev)
    g.manual_seed(51)
    frame = torch.randn(DOMAIN_FRAME, generator=g, device=dev)
    slabs = tile_frames(spec, frame[None])[0]
    table = tile_geometry(cfg, spec.slab_shape, spec.slab_origins(), dev)
    full_frames = frame.expand(DOMAIN_P, *DOMAIN_FRAME)
    shard = torch.arange(DOMAIN_P, device=dev)[:, None]
    worst, out = 0.0, {}
    launches0 = kern.per_member_launches
    for n in (9 * 2 ** 22, 2 ** 16 + 37):
        state = torch.empty((DOMAIN_P, n, 5), device=dev)
        state[..., 0:2] = (torch.rand((DOMAIN_P, n, 2), generator=g,
                                      device=dev) * 520.0 - 4.0)
        state[..., 2:4] = 0.0
        state[..., 4] = torch.rand((DOMAIN_P, n), generator=g,
                                   device=dev) * 3.0
        got = kern(state, slabs, geometry=table)
        check(same_bits(got, kern(state, slabs, geometry=table)),
              f"per-member B3 not repeatable at N={n}")
        full = kern(state, full_frames)
        own = owner_of(spec, state[..., 0], state[..., 1]) == shard
        check(same_bits(got[own], full[own]),
              f"per-member B3 at N={n}: an owned particle differs from the "
              f"full frame")
        err, chunk = 0.0, 2 ** 21
        for m in range(DOMAIN_P):
            for a in range(0, n, chunk):
                st = state[m:m + 1, a:a + chunk]
                err = max(err, max_err(got[m:m + 1, a:a + chunk],
                                       ref.patch_log_likelihood_ref(
                                           st[..., 0], st[..., 1],
                                           st[..., 4], slabs[m:m + 1],
                                           geometry=table[m:m + 1]),
                                       PATCH_TOL))
        worst = max(worst, err)
        out[f"N={n}"] = {"max_abs_err": err,
                         "owned": int(own.sum()), "rows": DOMAIN_P * n}
        log(f"patch per-member geometry (8, {n}) vs (8, 264, 136) slabs: "
            f"max_abs_err={err:.3g}, {int(own.sum())} owned bitwise equal "
            f"to the full frame, repeatable")
        del state, got, full, own
    check(kern.per_member_launches - launches0 == 4,
          "per-member launches not counted")
    return {"max_abs_err": worst, "cases": out}


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


def skewed_log_weights(b, n, seed, dev):
    """Per member: N(0, 1) log-weights, a run of -inf slots (a sixteenth
    of the member, from a quarter in), and one slot (below the run) holding
    at least 99% of the mass."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lw = torch.randn((b, n), generator=g, device=dev)
    lw[:, n // 4:n // 4 + n // 16] = -math.inf
    hot = torch.randint(0, n // 4, (b,), generator=g, device=dev)
    lw[torch.arange(b, device=dev), hot] = (torch.logsumexp(lw, -1)
                                            + math.log(100.0))
    return lw


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
    """B2 (the redesign) bit for bit equal to its torch emulation and on a
    second run, a member independent of B, and against its plain version:
    the decision equal, ESS, log Z, skew, the estimate and the new
    log-weights within FUSED_TOL, the ancestors by the comb rules."""
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
        emu = sir_fused.fused_weight_step_emulated(lw, ll, state, u,
                                                   always=always, comb=comb)
        check(all(same_bits(a, b) for a, b in zip(out, emu)),
              f"fused kernel differs from its emulation {label}: "
              f"{[int((bits(a) != bits(b)).sum()) for a, b in zip(out, emu)]}"
              f" differing elements (anc, new_lw, est, stats)")
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
    one(*fused_inputs(1, 2 ** 22, 1, dev), comb=False,
        label="B=1 N=2^22 comb=False")
    _, _, sstate, su = fused_inputs(2, 2 ** 22, 3, dev)
    slw = skewed_log_weights(2, 2 ** 22, 4, dev)
    one(slw, torch.zeros_like(slw), sstate, su, always=True,
        label="B=2 N=2^22 skewed")
    del sstate, slw
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
    # this slice's state widths: stochastic volatility (D = 1), Lorenz-96
    # (D = 8, one estimate pass of EST_DIMS) and D = 40 (five passes)
    for d in (1, 8, 40):
        one(*fused_inputs(1, 2 ** 22, 40 + d, dev, d=d),
            label=f"B=1 N=2^22 D={d}")
    # a member's result must not depend on B: member 2 alone == in the bank
    solo = kern(lw[2:3].contiguous(), ll[2:3].contiguous(),
                state[2:3].contiguous(), u[2:3].contiguous())
    bank = kern(lw, ll, state, u)
    check(all(same_bits(s[0], b_[2]) for s, b_ in zip(solo, bank)),
          "member result depends on the bank")
    return {"max_abs_err": worst, "tie_lanes": ties,
            "comb_offset": offsets}


def systematic_case(lw, u, n_out, label, acc) -> None:
    """B1 (the redesign) on one input: bit for bit equal to its torch
    emulation and on a second run, member 1 alone equal to member 1 in the
    batch, and against its plain version by the comb rules (TIE_DELTA
    against the plain version, COMB_TOL against the float64 CDF's comb).
    Adds the tie lanes, the largest tie distance and the comb offsets to
    ``acc``."""
    import torch
    from repro_torch.kernels import ref, resample
    kern = resample.systematic_ancestors_kernel
    b, n_in = lw.shape
    anc = kern(lw, u, n_out)
    check(same_bits(anc, kern(lw, u, n_out)), f"B1 not repeatable {label}")
    emu = resample.systematic_ancestors_emulated(lw, u, n_out)
    check(same_bits(anc, emu), f"B1 {label}: differs from its emulation at "
                               f"{int((anc != emu).sum())} lanes")
    plain = ref.systematic_ancestors_ref(lw, u, n_out)
    w = torch.softmax(lw.double(), -1)
    t, dist = comb_ties_ok(anc, plain, w, u)
    every = torch.ones(b, dtype=torch.bool, device=lw.device)
    off = {"kernel": comb_offset(anc, w, u, every),
           "plain": comb_offset(plain, w, u, every)}
    check(off["kernel"] <= COMB_TOL,
          f"B1 {label}: kernel ancestors {off['kernel']:.3g} from the "
          f"float64 CDF's comb (limit {COMB_TOL})")
    check(bool((anc >= 0).all() and (anc < n_in).all()),
          f"B1 {label}: ancestors out of range")
    if b > 1:
        solo = kern(lw[1:2].contiguous(), u[1:2].contiguous(), n_out)
        check(same_bits(solo[0], anc[1]),
              f"B1 {label}: member depends on the batch")
    acc["tie_lanes"] += t
    acc["max_abs_err"] = max(acc["max_abs_err"], dist)
    for k in off:
        acc["comb_offset"][k] = max(acc["comb_offset"][k], off[k])
    acc["cases"][label] = {"tie_lanes": t, "lanes": anc.numel(),
                           "comb_offset": off}
    log(f"B1 {label} B={b} n_in={n_in} n_out={n_out}: == emulation, "
        f"repeatable; tie lanes={t} ({t / anc.numel():.4%}); comb offset "
        f"from the float64 CDF: kernel {off['kernel']:.3g}, plain "
        f"{off['plain']:.3g}")


def check_systematic(dev) -> dict:
    """B1 by ``systematic_case`` at the DRA shape 8 x 2^22, at n_out != n_in
    with ragged tails, and on a skewed input (one slot with 99% of the
    mass, a dead run); a member with no finite weight (its CDF NaN) takes
    ancestor 0 on both designs, as the first design's bisection gives.
    The reported error is in CDF units: the largest distance of a comb
    point where kernel and plain version disagree from the float64 CDF
    (limit TIE_DELTA)."""
    import torch
    from repro_torch.kernels import resample
    acc = {"tie_lanes": 0, "max_abs_err": 0.0, "cases": {},
           "comb_offset": {"kernel": 0.0, "plain": 0.0}}
    cases = [(8, 2 ** 22, 2 ** 22, 31), (2, 2 ** 20 + 333, 2 ** 19, 32),
             (2, 2 ** 19, 2 ** 20 + 77, 33)]
    for b, n_in, n_out, seed in cases:
        lw, ll, _, u = fused_inputs(b, n_in, seed, dev, d=1)
        # a filter's post-likelihood weights
        systematic_case(lw + ll, u, n_out, f"{b}x{n_in}->{n_out}", acc)
    n = 2 ** 20 + 333
    u = fused_inputs(2, 8, 34, dev, d=1)[3]
    systematic_case(skewed_log_weights(2, n, 35, dev), u, n, "skewed", acc)
    # a member with no finite weight: ancestor 0 on both designs
    lw = torch.full((1, 5000), -math.inf, device=dev)
    anc = resample.systematic_ancestors_kernel(lw, u[:1].contiguous(), 3000)
    first = resample._sys_launch(resample.SysPlan("seven_pass"), lw,
                                 u[:1].contiguous(), 3000)
    check(bool((anc == 0).all()) and same_bits(anc, first) and same_bits(
        anc, resample.systematic_ancestors_emulated(lw, u[:1], 3000)),
          "B1 all -inf member: ancestors must be 0, as the first design's")
    return acc


def check_systematic_inputs(inputs: dict) -> dict:
    """B1's timing inputs held to ``systematic_case``'s gates."""
    acc = {"tie_lanes": 0, "max_abs_err": 0.0, "cases": {},
           "comb_offset": {"kernel": 0.0, "plain": 0.0}}
    for label, (lw, u) in inputs.items():
        systematic_case(lw, u, lw.shape[1], f"timing input {label}", acc)
    return acc


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


def time_patch_domain(state, frame1, rna_final, frame, cfg) -> dict:
    """B3 with a per-member table: (1) on timing input (i) with a one-row
    table of the default geometry, in turns against the shared-geometry
    call (the bits must agree); (2) at the domain path's shape: RNA's
    final 8 x 2^22 ensemble migrated to its tile owners (8 x 9 · 2^22
    merged rows, k_cap = C) against the last frame's 8 slabs, one launch
    with the per-member geometry, beside its bound."""
    import torch
    from repro_torch.core import domain as domain_mod
    from repro_torch.core.particles import ParticleEnsemble
    from repro_torch.core.runtime import EmulatedMesh
    from repro_torch.kernels import ref
    from repro_torch.kernels.patch_likelihood import (
        member_geometry, patch_log_likelihood_kernel as kern)
    from repro_torch.models.tracking import make_domain_spec, tile_geometry
    r = cfg.patch_radius
    h, w = frame1.shape[1:]
    table1 = member_geometry([ref.default_geometry(r, h, w)], r, h, w,
                             state.device)
    check(same_bits(kern(state, frame1, geometry=table1),
                    kern(state, frame1)),
          "B3: a one-row default table differs from the shared geometry")
    pm_ms, shared_ms = in_turns(lambda: kern(state, frame1, geometry=table1),
                                lambda: kern(state, frame1))
    p = rna_final.shape[0]
    spec = make_domain_spec(cfg, p)
    ens = ParticleEnsemble(rna_final, torch.zeros(rna_final.shape[:2],
                                                  device=state.device),
                           torch.ones(rna_final.shape[:2], dtype=torch.int32,
                                      device=state.device))
    merged, _ = domain_mod.migrate(spec, ens, rna_final[..., 0:2],
                                   mesh=EmulatedMesh(p))
    st = merged.state
    del merged, ens
    slabs = domain_mod.tile_frames(spec, frame[None])[0]
    table = tile_geometry(cfg, spec.slab_shape, spec.slab_origins(),
                          state.device)
    b, n = st.shape[:2]
    bound, by = patch_bound(b, n, *spec.slab_shape, r)
    out = {"per_member_ms": pm_ms, "shared_ms": shared_ms,
           "shape": [b, n], "ms": cuda_ms(lambda: kern(st, slabs,
                                                       geometry=table)),
           "device_ms": device_ms(lambda: kern(st, slabs, geometry=table)),
           "bound_ms": bound, "bound_by": by}
    del st
    torch.cuda.empty_cache()
    return out


def time_systematic(inputs: dict) -> dict:
    """B1 on each timing input: the redesign through its wrapper and the
    first design (``resample._sys_launch`` with the seven-pass plan) in
    turns, each design's device time per call back to back, and the
    bound."""
    from repro_torch.kernels import resample
    first = resample.SysPlan("seven_pass")
    kern = resample.systematic_ancestors_kernel
    out = {}
    for label, (lw, u) in inputs.items():
        b, n = lw.shape

        def old():
            return resample._sys_launch(first, lw, u, n)
        ms, first_ms = in_turns(lambda: kern(lw, u, n), old)
        bound, by = systematic_bound(b, n, n)
        out[label] = {"shape": [b, n], "variant": "merge", "ms": ms,
                      "first_ms": first_ms,
                      "device_ms": device_ms(lambda: kern(lw, u, n)),
                      "first_device_ms": device_ms(old),
                      "bound_ms": bound, "bound_by": by}
    return out


def time_fused(inputs: dict) -> dict:
    """B2 on each timing input ``(lw, ll, state, u, comb)``: the redesign
    through its wrapper and the first design (``sir_fused._launch`` with
    the seven-pass plan) in turns, device times back to back, the bound."""
    from repro_torch.kernels import sir_fused
    first = sir_fused.FusedPlan("seven_pass")
    kern = sir_fused.fused_weight_step_kernel
    out = {}
    for label, (lw, ll, st, u, comb) in inputs.items():
        b, n, d = st.shape

        def new():
            return kern(lw, ll, st, u, comb=comb)

        def old():
            return sir_fused._launch(first, lw, ll, st, u, 0.5, False, comb)
        ms, first_ms = in_turns(new, old)
        n_res = int((new()[3][:, 2] > 0).sum()) if comb else 0
        bound, by = fused_bound(b, n, d, n_res)
        out[label] = {"shape": [b, n, d], "comb": comb, "variant": "merge",
                      "ms": ms, "first_ms": first_ms,
                      "device_ms": device_ms(new),
                      "first_device_ms": device_ms(old),
                      "resampled": n_res, "bound_ms": bound, "bound_by": by}
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
    elif kind == "arna":
        m_buf = max(int(round(cfg.q_max * c)) // p * p, p)
        dra = (12 + m_buf * (state_bytes + 4), 4)
    elif kind == "butterfly":
        stages = p.bit_length() - 1
        dra = (stages * (8 + cfg.butterfly_cap * (state_bytes + 8)),
               2 * stages)
    else:
        dra = (4 + p * cfg.k_cap * (state_bytes + 8), 2)
    return dra[0] + 12 + estimate_bytes, dra[1] + 4


def attn_inputs(qshape, kvshape, dtype, seed, dev, lk=None, dv=None):
    """Random q, k, v; with ``lk`` the k/v are the ``[..., :lk, :]`` views
    of a longer cache (strides of the whole buffer, no copy); ``dv`` is
    v's head dim (default k's)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    vshape = kvshape[:3] + (dv or kvshape[3],)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
               for s in (qshape, kvshape, vshape))
    if lk is not None:
        k, v = k[:, :, :lk], v[:, :, :lk]
    return q, k, v


# label: q shape, k/v shape, dtype, soft-cap, view length (decode), causal
# and, where given, the sliding window (0 for none) and v's head dim
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
    for d in (16, 32, 48, 64, 80, 96, 112, 128, 256)})
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
# the sliding window (gemma3's L layers: G = 2, D = 128, window 1024;
# recurrentgemma's: G = 10 over one KV head, D = 256, window 2048) on
# every variant, windows shorter and longer than the keys, and the
# cross-attention of llama-3.2-vision's X layers (non-causal, 1601 image
# keys) at prefill and decode
ATTN_CASES.update({
    "window-wgmma": ((2, 32, 2048, 128), (2, 16, 2048, 128), "bfloat16", 0.0,
                     None, True, 1024),
    "window-mma-d256": ((1, 10, 2560, 256), (1, 1, 2560, 256), "bfloat16",
                        0.0, None, True, 2048),
    "window-split": ((4, 32, 1, 128), (4, 16, 2200, 128), "bfloat16", 0.0,
                     2100, True, 1024),
    "window-split-d256": ((4, 10, 1, 256), (4, 1, 2700, 256), "bfloat16",
                          0.0, 2600, True, 2048),
    "window-split-lq8": ((2, 16, 8, 128), (2, 2, 1100, 128), "bfloat16",
                         30.0, 1057, True, 300),
    "window-mma-d80": ((2, 16, 300, 80), (2, 2, 300, 80), "bfloat16", 0.0,
                       None, True, 100),
    "window-long": ((2, 32, 500, 128), (2, 16, 500, 128), "bfloat16", 0.0,
                    None, True, 1024),
    "window-f32": ((2, 8, 37, 64), (2, 2, 1000, 64), "float32", 50.0, None,
                   True, 77),
    "xattn-prefill": ((2, 32, 1024, 128), (2, 8, 1601, 128), "bfloat16", 0.0,
                      None, False),
    "xattn-decode": ((4, 32, 1, 128), (4, 8, 1601, 128), "bfloat16", 0.0,
                     None, False),
    "xattn-d256": ((2, 10, 7, 256), (2, 1, 1601, 256), "bfloat16", 0.0,
                   None, False),
})
# latent attention's (q/k, v) head dims (192, 128) on the mma.sync and f32
# variants: ragged and soft-capped, grouped, non-causal, a decode offset
# on a strided cache view and one query row (still mma.sync, never split)
ATTN_CASES.update({
    "mla-ragged": ((2, 8, 37, 192), (2, 2, 100, 192), "bfloat16", 30.0,
                   None, True, 0, 128),
    "mla-full": ((2, 8, 50, 192), (2, 8, 77, 192), "bfloat16", 0.0, None,
                 False, 0, 128),
    "mla-offset": ((2, 16, 70, 192), (2, 16, 300, 192), "bfloat16", 0.0,
                   260, True, 0, 128),
    "mla-one-row": ((4, 16, 1, 192), (4, 16, 300, 192), "bfloat16", 0.0,
                    257, True, 0, 128),
    "mla-f32": ((2, 8, 37, 192), (2, 2, 100, 192), "float32", 30.0, None,
                True, 0, 128),
    "mla-f32-offset": ((2, 16, 9, 192), (2, 16, 300, 192), "float32", 0.0,
                       260, True, 0, 128),
})
# windowed cases run again with every key outside the window NaN in k
# and v: the output must be finite and bit for bit the clean inputs', so
# the kernel never reads those keys
ATTN_NAN_CASES = ("window-split", "window-split-d256")


def check_attention(dev) -> dict:
    """B6 against its plain version (``ref.mha_ref``) at the LM path's
    prefill and decode shapes (the decode on a strided cache view), a
    ragged soft-capped float32 case, the MHA (group 1) and MQA (group 48)
    groupings, non-causal calls and every bf16 head dim the kernel is
    built for, the edges of the split and wgmma variants, the sliding
    window on every variant and the cross-attention shapes: within
    ATTN_TOL, and bit for bit on a second launch (ATTN_NAN_CASES also with
    NaN keys outside the window).  The float32 plain version of the same
    bf16 inputs is reported too, and the variant that served each case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     plan)

    worst = {}
    for i, (label, (qs, ks, dt, cap, lk, causal, *extra)) in enumerate(
            ATTN_CASES.items()):
        dtype = getattr(torch, dt)
        window = extra[0] if extra else 0
        dv = extra[1] if len(extra) > 1 else ks[-1]
        q, k, v = attn_inputs(qs, ks, dtype, 50 + i, dev, lk, dv)
        kw = dict(causal=causal, scale=qs[-1] ** -0.5, logit_softcap=cap,
                  window=window)
        out = flash_attention_kernel(q, k, v, **kw)
        again = flash_attention_kernel(q, k, v, **kw)
        check(torch.equal(out, again), f"B6 {label} not repeatable")
        want = ref.mha_ref(q, k, v, **kw)
        err = max_err(out.float(), want.float(), ATTN_TOL[str(dtype)])
        err32 = float((out.float() - ref.mha_ref(
            q.float(), k.float(), v.float(), **kw)).abs().max())
        worst[label] = err
        p = plan(tuple(q.shape), tuple(k.shape), dtype, window=window, dv=dv)
        check(out.shape == q.shape[:3] + (dv,), f"B6 {label} output "
                                                f"{tuple(out.shape)}")
        check(dv == ks[-1] or p.variant in ("mma", "f32"),
              f"B6 {label}: ({ks[-1]}, {dv}) planned on {p.variant}")
        nan_note = ""
        if label in ATTN_NAN_CASES:
            # keys [0, first key the call sees) of the same views, NaN
            hidden = p.key0
            check(hidden > 0, f"B6 {label}: no key outside the window")
            k[:, :, :hidden] = float("nan")
            v[:, :, :hidden] = float("nan")
            blind = flash_attention_kernel(q, k, v, **kw)
            check(bool(torch.isfinite(blind).all())
                  and torch.equal(blind, out),
                  f"B6 {label}: keys outside the window change the output")
            nan_note = (f"; {hidden} keys outside the window NaN: finite, "
                        f"same bits")
        log(f"B6 {label} [{p.variant}"
            f"{f' x{p.splits} from key {p.key0}' if p.variant == 'split' else ''}] "
            f"q{tuple(q.shape)} kv{tuple(k.shape)}"
            f"{f' v head dim {dv}' if dv != ks[-1] else ''} {dt}"
            f"{' cap ' + str(cap) if cap else ''}"
            f"{' window ' + str(window) if window else ''}"
            f"{'' if causal else ' non-causal'}: max_abs_err={err:.3g} "
            f"(rtol=atol={ATTN_TOL[str(dtype)]}; vs the float32 plain "
            f"version {err32:.3g}), repeatable{nan_note}")
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


def attention_bound(q, k, causal=True, window=0,
                    dv=None) -> tuple[float, str]:
    """Least time for GQA attention: read q, the k and v rows some query
    sees and write o once (the bytes), against 2·(D + Dv) FLOP per
    visible (query, key) pair on the bf16 tensor cores (QK^T at q/k head
    dim D, PV at v head dim Dv, default D: 4·D; a causal query i at
    position p = i + Lk - Lq sees p + 1 keys, at most ``window`` of them;
    a non-causal one all Lk)."""
    from repro_torch.kernels.flash_attention import first_key
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    dv = dv or d
    if causal:
        seen = [p + 1 for p in range(lk - lq, lk)]
        if window:
            seen = [min(n, window) for n in seen]
        pairs, key0 = sum(seen), first_key(lq, lk, window)
    else:
        pairs, key0 = lq * lk, 0
    flops = 2 * b * hq * (d + dv) * pairs
    bytes_ = (q.numel() + b * hq * lq * dv
              + b * k.shape[1] * (lk - key0) * (d + dv)) * q.element_size()
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


def time_attention_kinds(dev) -> dict:
    """B6 at the timed calls of ``kinds_calls`` (phase 5j's and 5k's new
    attention shapes, in their layouts) beside its bound, its plain
    version and SDPA (the library yardstick, never on the port's path; it
    takes v's own head dim).  Where the
    visible keys are not SDPA's own causal triangle (a window, a decode
    offset) SDPA gets the explicit boolean band mask and K/V repeated to
    the query heads outside the timing (its memory-efficient kernel
    takes a mask, not grouped heads)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    out = {}
    timed = {k: c for k, c in kinds_calls().items() if c["timed"]}
    for i, (label, c) in enumerate(timed.items()):
        q, k, v = kinds_inputs(c, 90 + i, dev)
        lq, n, causal, window = q.shape[2], k.shape[2], c["causal"], \
            c["window"]
        kw = dict(causal=causal, window=window, scale=c["scale"],
                  logit_softcap=c["softcap"])
        p = fa.plan(tuple(q.shape), tuple(k.shape), q.dtype, window=window,
                    dv=c["dv"])
        ms = cuda_ms(lambda: flash_attention_kernel(q, k, v, **kw))
        plain = cuda_ms(lambda: ref.mha_ref(q, k, v, **kw), reps=3)
        if causal and (window or lq != n):
            pos = torch.arange(lq, device=dev)[:, None] + n - lq
            key = torch.arange(n, device=dev)[None, :]
            mask = key <= pos
            if window:
                mask &= pos - key < window
            g = q.shape[1] // k.shape[1]
            kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=mask, scale=c["scale"]))
            del kk, vv, mask
        else:
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True, scale=c["scale"]))
        bound, by = attention_bound(q, k, causal, window, c["dv"])
        out[label] = {"q": list(q.shape), "k": list(k.shape),
                      "dv": c["dv"], "phase": c["phase"],
                      "window": window, "causal": causal,
                      "variant": p.variant, "splits": p.splits,
                      "key0": p.key0, "ms": ms, "plain_ms": plain,
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


def decode_logits(model, prompt, tokens, img=None, handoff=None):
    """Decode ``tokens`` step by step through the model's public functions
    after the prompt's prefill, step j fed ``tokens[:, j - 1]``: the
    logits of the steps in LM_CHECK_STEPS and every step's argmax (the
    prefill's first).  ``handoff`` may edit the prefill's caches before
    the first step; ``img`` goes to the prefill."""
    import torch
    from repro_torch.models.lm import model as M

    t0 = prompt.shape[1]
    with torch.inference_mode():
        h, caches = M.forward_prefill(model, prompt, t0 + LM_STEPS + 1,
                                      img=img)
        if handoff is not None:
            handoff(caches)
        seen = [M.unembed(model, h)[:, 0].float().argmax(-1).to(torch.int32)]
        kept = {}
        for j in range(1, LM_STEPS):
            logits, caches = M.forward_decode(model, tokens[:, j - 1:j],
                                              t0 + j - 1, caches)
            logits = logits[:, 0].float()
            if j in LM_CHECK_STEPS:
                kept[j] = logits
            seen.append(logits.argmax(-1).to(torch.int32))
        del caches
    return kept, torch.stack(seen, 1)


def prefill_logits(model, prompt, tokens, img=None) -> dict:
    """For each j in LM_CHECK_STEPS, the last position's logits of
    prefilling prompt ⧺ tokens[:j]."""
    import torch
    from repro_torch.models.lm import model as M

    out = {}
    with torch.inference_mode():
        for j in LM_CHECK_STEPS:
            seq = torch.cat([prompt, tokens[:, :j].long()], 1)
            h, caches = M.forward_prefill(model, seq, seq.shape[1] + 1,
                                          img=img)
            out[j] = M.unembed(model, h)[:, 0].float()
            del caches
    return out


def logit_gap(kept, want) -> float:
    """The largest |decode - prefill| logit over the checked steps."""
    return max(float((want[j] - kept[j]).abs().max()) for j in kept)


def decode_vs_prefill(model, prompt, tokens, tol=LM_LOGIT_TOL,
                      img=None, want=None) -> dict:
    """Greedy decode step by step (``decode_logits``): its tokens must be
    ``generate``'s, and prefilling prompt ⧺ tokens[:j] (``want``, else
    ``prefill_logits``) must give step j's logits at its last position
    within ``tol``, with the same argmax wherever the top-2 gap exceeds
    the tolerance.  With codebooks every codebook's logits are held so;
    ``img`` goes to every prefill."""
    import torch

    kept, seen = decode_logits(model, prompt, tokens, img)
    check(torch.equal(seen, tokens),
          "step-by-step greedy decode differs from generate")
    if want is None:
        want = prefill_logits(model, prompt, tokens, img)
    worst, compared, agreed = logit_gap(kept, want), 0, 0
    for j, got in want.items():
        top2 = got.topk(2, -1).values
        clear = (top2[..., 0] - top2[..., 1]) > tol
        compared += int(clear.sum())
        agreed += int((got.argmax(-1) == tokens[:, j])[clear].sum())
    check(worst <= tol, f"decode vs prefill logits differ by "
                        f"{worst:.4g} (limit {tol})")
    check(agreed == compared, f"greedy tokens differ on {compared - agreed} "
                              f"of {compared} clear steps")
    return {"max_abs_logit_err": worst, "clear_steps": compared,
            "steps_checked": list(LM_CHECK_STEPS)}


def run_lm(dev, all_k, reset, counts, name):
    """Phase 5d: generate and smc_decode at qwen3-32b width, 16 layers.
    Returns the record, the model and the prompts (phase 5h reuses
    them)."""
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
    del flat
    return {"arch": LM_ARCH, "layers": LM_LAYERS, "params": n_params,
            "generate": gen, "smc_decode": smc_rec}, model, prompt


# phase 5j: the L, R, D and X layer kinds and the multi-codebook head at
# full width, depth cut to fit the card and the run: arch -> (layers or
# None for all, prompt length, whether smc_decode runs (the reference's
# smc_decode cannot take image inputs or codebooks)).  gemma3 keeps two
# LLLLLG units, llama-3.2-vision two GGGGX units; the prompts of the
# windowed archs are longer than their windows (1024 and 2048)
KINDS = {"gemma3-27b": (12, 2048, True),
         "recurrentgemma-2b": (None, 2560, True),
         "mamba2-1.3b": (None, 2048, True),
         "llama-3.2-vision-11b": (10, 1024, False),
         "musicgen-medium": (None, 1024, False)}
KINDS_SEED = 5
# phase 5k: the M kind (latent attention) and MoE FFNs at full width, in
# KINDS' form.  deepseek-v2-236b keeps 4 of 60 layers (MMMM, FFNs dense,
# moe, moe, moe: 24.8 GiB of bf16 weights, 7.5 GB a MoE layer),
# moonshot-v1-16b-a3b 16 of 48 (G, 1 dense + 15 MoE: 17.8 GiB); LM_BATCH
# x LM_PROMPT prompts, smc_decode's 32 rows at the full prompt
MOE = {"deepseek-v2-236b": (4, LM_PROMPT, True),
       "moonshot-v1-16b-a3b": (16, LM_PROMPT, True)}
MOE_SEED = 7
# decode vs prefill at full width takes every MoE layer past dropping
# (capacity factor E / k: an expert's capacity is every token), but a
# decode token whose k-th and (k+1)-th router probabilities tie within
# bf16's rounding of the two shapes' products takes another expert than
# at prefill: the router's logits are bf16, and exact ties at the k-th
# place are common among 64 or 160 experts.  The limit is kinds_tols'
# depth rule times this factor, set from readings, not derived (PR 25:
# 0.5156 deepseek, 0.4766 moonshot, with 1 to 8 rows a step on another
# expert set; 0.25 at a deepseek step with none), and a broken decode
# (``moe_witnesses``: every cache a slot late) must read beyond it
MOE_LOGIT_FACTOR = 4.0


def run_shape(arch):
    """``(layers or None, prompt length, smc_decode runs)`` of a 5j or 5k
    arch."""
    return KINDS[arch] if arch in KINDS else MOE[arch]


def kinds_config(arch):
    """Phase 5j's or 5k's config of ``arch``: full width, KINDS' or MOE's
    depth."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    layers = run_shape(arch)[0]
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def no_drop_config(cfg):
    """``cfg`` with a MoE capacity factor of E / k (times 1 + 1e-6 against
    the float product's rounding): each expert has a slot for every
    token, so nothing drops."""
    import dataclasses
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k * (1 + 1e-6)))


def kinds_tols(cfg) -> tuple[float, float]:
    """Decode vs prefill logits in bf16: LM_LOGIT_TOL's random walk of
    residual-stream roundings, scaled by the square root of the layers
    against qwen3's 16 (the first, depth-only limit); an arch with D
    layers gets √2 more (the second, its limit).  That margin is set from
    readings, not derived: mamba2's sound decode reads over the depth
    rule, and so does its decode with the SSM state and its read-out in
    float32 and its decode with the state dropped (``ssm_witnesses``), so
    the excess lies in the layers' other roundings, not in the state; a
    broken decode reads far over the margin (PERF.md §6)."""
    from repro_torch.models.lm import model as M
    depth = LM_LOGIT_TOL * math.sqrt(max(1.0, cfg.n_layers / LM_LAYERS))
    ssm = any(k == "D" for k, _ in M.make_plan(cfg).layers())
    return depth, depth * (math.sqrt(2) if ssm else 1.0) * (
        MOE_LOGIT_FACTOR if cfg.moe else 1.0)


def kinds_want(cfg, steps):
    """B6's launches by variant of one prefill and ``steps - 1`` decode
    steps: one a G, L or X layer and forward call and one an M layer's
    prefill; the prefill's variant from the prompt's shapes (``plan``),
    every decode step's "split" (an M layer's absorbed decode launches no
    kernel)."""
    import torch
    from repro_torch.kernels.flash_attention import plan
    from repro_torch.models.lm import model as M
    want = {"wgmma": 0, "split": 0, "mma": 0, "f32": 0}
    t = run_shape(cfg.name)[1]
    hd, b = cfg.resolved_head_dim, LM_BATCH
    for kind, _ in M.make_plan(cfg).layers():
        if kind == "M":
            m = cfg.mla
            dqk = m.qk_nope_dim + m.qk_rope_dim
            want[plan((b, cfg.n_heads, t, dqk), (b, cfg.n_heads, t, dqk),
                      torch.bfloat16, dv=m.v_head_dim).variant] += 1
            continue
        if kind not in ("G", "L", "X"):
            continue
        lk = cfg.n_image_tokens if kind == "X" else t
        window = M._theta_window(cfg, kind)[1]
        v = plan((b, cfg.n_heads, t, hd), (b, cfg.n_kv_heads, lk, hd),
                 torch.bfloat16, window=window).variant
        want[v] += 1
        want["split"] += steps - 1
    return want


def kinds_calls() -> dict:
    """Phase 5j's and 5k's B6 calls, from KINDS, MOE, the configs and the
    LM_* constants: label -> the call.  For each arch, attention kind (G,
    L, X, M) and run (``generate`` at LM_BATCH rows; ``smc_decode`` at
    LM_BATCH·LM_K where the arch runs it): the prefill, and the decode
    steps (views of ``t0 + 1 .. t0 + LM_STEPS - 1`` keys of a ``t0 +
    LM_STEPS + 1``-slot cache; an X layer's the 1601 image keys; an M
    layer's absorbed decode makes no B6 call) whose split plan differs
    from the step before, with the first, the middle (``t0 + LM_STEPS //
    2``) and the last.  An M layer's q and k have head dim ``qk_nope_dim
    + qk_rope_dim`` and its v ``dv`` (v_head_dim), scale the q/k dim's.
    ``layout`` is how the model lays out q, k and v: "prefill" transposes
    ``(B, L, H, D)`` projections, "decode" slices a ``(B, H, slots, D)``
    cache, "image" holds the image K/V contiguous (q is always a
    transposed projection).  ``timed`` marks the calls phase 6 times:
    each arch's L, X and M kinds (its G where it has no other), the
    prefill at generate's rows and the middle decode at smc_decode's
    (else generate's).  ``phase`` is "5j" or "5k"; the calls of a rank
    of phase 5n c (its 16 query and 2 key/value heads of qwen3-32b,
    ``generate``'s rows) have phase "5n" and are not timed."""
    import torch
    from repro_torch.kernels.flash_attention import plan
    from repro_torch.models.lm import model as M
    calls = {}
    for arch, (_, t0, with_smc) in {**KINDS, **MOE}.items():
        cfg = kinds_config(arch)
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        kinds = sorted({k for k, _ in M.make_plan(cfg).layers()}
                       & {"G", "L", "X", "M"})
        new = [k for k in kinds if k != "G"] or ["G"]
        runs = [("generate", LM_BATCH)]
        if with_smc:
            runs.append(("smc", LM_BATCH * LM_K))
        slots, mid = t0 + LM_STEPS + 1, t0 + LM_STEPS // 2
        for kind in kinds:
            window = M._theta_window(cfg, kind)[1]
            x = kind == "X"
            n = cfg.n_image_tokens if x else t0
            dk, dv = hd, hd
            if kind == "M":
                dk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
                dv, hkv = cfg.mla.v_head_dim, hq
            base = dict(causal=not x, window=window, scale=dk ** -0.5,
                        softcap=0.0 if x else cfg.logit_softcap, dv=dv,
                        phase="5k" if arch in MOE else "5j")
            for run, rows in runs:
                timed = kind in new
                calls[f"{arch} {kind} {run} prefill"] = dict(
                    base, q=(rows, hq, t0, dk), k=(rows, hkv, n, dk),
                    slots=None, layout="image" if x else "prefill",
                    timed=timed and run == "generate")
                if kind == "M":
                    continue
                timed &= run == runs[-1][0]
                if x:
                    calls[f"{arch} {kind} {run} decode"] = dict(
                        base, q=(rows, hq, 1, hd), k=(rows, hkv, n, hd),
                        slots=None, layout="image", timed=timed)
                    continue
                keys, last = [], None
                for lk in range(t0 + 1, t0 + LM_STEPS):
                    p = plan((rows, hq, 1, hd), (rows, hkv, lk, hd),
                             torch.bfloat16, window=window)
                    cut = (p.variant, p.splits, p.split_keys)
                    if cut != last or lk in (t0 + 1, mid, t0 + LM_STEPS - 1):
                        keys.append(lk)
                    last = cut
                for lk in keys:
                    calls[f"{arch} {kind} {run} decode {lk}"] = dict(
                        base, q=(rows, hq, 1, hd), k=(rows, hkv, lk, hd),
                        slots=slots, layout="decode",
                        timed=timed and lk == mid)
    # phase 5n c: a rank's heads of 5d's model on LMGRID_SERVE_SHAPE
    cfg, tp = lm_config(), LMGRID_SERVE_SHAPE[1]
    hq, hkv, hd = (cfg.n_heads // tp, cfg.n_kv_heads // tp,
                   cfg.resolved_head_dim)
    t0, rows = LM_PROMPT, LM_BATCH
    slots, mid = t0 + LM_STEPS + 1, t0 + LM_STEPS // 2
    base = dict(causal=True, window=0, scale=hd ** -0.5,
                softcap=cfg.logit_softcap, dv=hd, phase="5n")
    calls[f"{LM_ARCH} G grid-rank prefill"] = dict(
        base, q=(rows, hq, t0, hd), k=(rows, hkv, t0, hd), slots=None,
        layout="prefill", timed=False)
    last = None
    for lk in range(t0 + 1, t0 + LM_STEPS):
        p = plan((rows, hq, 1, hd), (rows, hkv, lk, hd), torch.bfloat16)
        cut = (p.variant, p.splits, p.split_keys)
        if cut != last or lk in (t0 + 1, mid, t0 + LM_STEPS - 1):
            calls[f"{LM_ARCH} G grid-rank decode {lk}"] = dict(
                base, q=(rows, hq, 1, hd), k=(rows, hkv, lk, hd),
                slots=slots, layout="decode", timed=False)
        last = cut
    return calls


def kinds_inputs(call, seed, dev):
    """Random bf16 q, k, v of a ``kinds_calls`` call, laid out as the
    model hands them to B6."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dtype = torch.bfloat16

    def heads_last(shape):          # (B, H, L, D) as a view of (B, L, H, D)
        b, h, n, d = shape
        return torch.randn((b, n, h, d), generator=g, device=dev).to(
            dtype).transpose(1, 2)

    q = heads_last(call["q"])
    vshape = call["k"][:3] + (call["dv"],)
    if call["layout"] == "prefill":
        return q, heads_last(call["k"]), heads_last(vshape)
    b, h, n, d = call["k"]
    k, v = (torch.randn((b, h, call["slots"] or n, dd), generator=g,
                        device=dev).to(dtype) for dd in (d, call["dv"]))
    return q, k[:, :, :n], v[:, :, :n]


def check_attention_kinds(dev) -> dict:
    """B6 at every call of ``kinds_calls`` against its plain version on
    the same bf16 inputs and on their float32 copies, both within the
    bf16 ATTN_TOL (the plain versions in slices of 4 rows, which bounds
    their memory), and bit for bit on a second launch; a windowed decode
    whose first key is past 0 again with every key before it NaN in k
    and v: finite, the same bits.  Phase 5k's calls also run the float32
    kernel on the float32 copies, against the float32 plain version
    within the float32 ATTN_TOL, twice with the same bits."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     plan)
    tol = ATTN_TOL[str(torch.bfloat16)]
    tol32 = ATTN_TOL[str(torch.float32)]
    worst, worst32, worst_k32, cases = 0.0, 0.0, 0.0, {}
    for i, (label, c) in enumerate(kinds_calls().items()):
        ph = c["phase"]
        q, k, v = kinds_inputs(c, 200 + i, dev)
        kw = dict(causal=c["causal"], scale=c["scale"],
                  logit_softcap=c["softcap"], window=c["window"])
        out = flash_attention_kernel(q, k, v, **kw)
        check(torch.equal(out, flash_attention_kernel(q, k, v, **kw)),
              f"B6 {ph} {label} not repeatable")
        err = err32 = k32 = 0.0
        for r in range(0, q.shape[0], 4):
            rows = slice(r, r + 4)
            qr, kr, vr = q[rows], k[rows], v[rows]
            err = max(err, max_err(out[rows].float(), ref.mha_ref(
                qr, kr, vr, **kw).float(), tol))
            want32 = ref.mha_ref(qr.float(), kr.float(), vr.float(), **kw)
            err32 = max(err32, max_err(out[rows].float(), want32, tol))
            if ph == "5k":
                q32, k32_, v32 = qr.float(), kr.float(), vr.float()
                got32 = flash_attention_kernel(q32, k32_, v32, **kw)
                check(torch.equal(got32, flash_attention_kernel(
                    q32, k32_, v32, **kw)), f"B6 5k {label} float32 kernel "
                                            f"not repeatable")
                k32 = max(k32, max_err(got32, want32, tol32))
                del q32, k32_, v32, got32
            del want32
        p = plan(tuple(q.shape), tuple(k.shape), q.dtype, window=c["window"],
                 dv=c["dv"])
        check(out.shape == q.shape[:3] + (c["dv"],),
              f"B6 {ph} {label} output {tuple(out.shape)}")
        note = ""
        if c["layout"] == "decode" and p.key0 > 0:
            k[:, :, :p.key0] = float("nan")
            v[:, :, :p.key0] = float("nan")
            blind = flash_attention_kernel(q, k, v, **kw)
            check(bool(torch.isfinite(blind).all())
                  and torch.equal(blind, out),
                  f"B6 {ph} {label}: keys outside the window change the "
                  f"output")
            note = f"; {p.key0} keys outside the window NaN: same bits"
            del blind
        if ph == "5k":
            note += (f"; float32 kernel {k32:.3g} (rtol=atol={tol32}), "
                     f"repeatable")
        worst, worst32 = max(worst, err), max(worst32, err32)
        worst_k32 = max(worst_k32, k32)
        cases[label] = {"q": list(q.shape), "k": list(k.shape),
                        "dv": c["dv"], "variant": p.variant,
                        "splits": p.splits, "key0": p.key0,
                        "max_abs_err": err, "max_abs_err_f32": err32,
                        "f32_kernel_max_abs_err": k32 if ph == "5k" else None}
        vdim = f" v head dim {c['dv']}" if c["dv"] != k.shape[-1] else ""
        log(f"B6 {ph} {label} [{p.variant}"
            f"{f' x{p.splits} from key {p.key0}' if p.variant == 'split' else ''}]"
            f" q{tuple(q.shape)} kv{tuple(k.shape)}{vdim}"
            f"{' window ' + str(c['window']) if c['window'] else ''}"
            f"{'' if c['causal'] else ' non-causal'}: max_abs_err="
            f"{err:.3g}, vs float32 {err32:.3g} (rtol=atol={tol}), "
            f"repeatable{note}")
        del q, k, v, out
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "max_abs_err_f32": worst32,
            "f32_kernel_max_abs_err": worst_k32,
            "calls": len(cases), "cases": cases}


def ssm_witnesses(model, prompt, tokens, want, arch) -> dict:
    """Readings of an arch with D layers beside its decode-vs-prefill gap
    (``want``: ``prefill_logits``): the same decode with every SSM state
    carried in float32 from the prefill's hand-over on (the state, its
    read-out, the gated norm and the output projection in float32, the
    reference's promotion), which must come within the arch's limit as
    any sound decode; a broken decode, every conv window handed over one
    slot late (its newest input lost, an off-by-one), which must exceed
    it; and, recorded, every SSM state dropped at the hand-over (at random
    weights its gap is the sound decode's, so this gate cannot see a lost
    state: the CPU tests hold the state to the reference's)."""
    import torch

    def f32_state(caches):
        for c in caches:
            if "ssm" in c:
                c["ssm"] = c["ssm"].float()

    def conv_late(caches):
        for c in caches:
            if "ssm" in c:
                w = c["conv"]
                c["conv"] = torch.cat([torch.zeros_like(w[:, :1]),
                                       w[:, :-1]], 1)

    def state_dropped(caches):
        for c in caches:
            if "ssm" in c:
                c["ssm"] = torch.zeros_like(c["ssm"])

    tol = kinds_tols(model.cfg)[1]
    out = {}
    for label, hook in (("f32_state", f32_state), ("conv_late", conv_late),
                        ("state_dropped", state_dropped)):
        kept, _ = decode_logits(model, prompt, tokens, handoff=hook)
        out[label] = logit_gap(kept, want)
    check(out["f32_state"] <= tol,
          f"5j {arch}: the float32-state decode differs from the prefill "
          f"by {out['f32_state']:.4g} (limit {tol:.3g})")
    check(out["conv_late"] > tol, f"5j {arch}: the broken decode's gap "
                                  f"{out['conv_late']:.4g} is within the "
                                  f"limit {tol:.3g}")
    return out


class RouteLog:
    """While entered, every ``moe.apply_moe`` call records the sorted
    top-k expert set of each row's last position and that row's margin
    between its k-th and (k+1)-th router probability (the model's MoE
    layers call the module's attribute, so the wrapper sees each)."""

    def __init__(self, on: bool):
        self.on, self.calls = on, []

    def __enter__(self):
        from repro_torch.models.lm import moe as MOE
        self.real = MOE.apply_moe
        if self.on:
            MOE.apply_moe = self.apply
        return self

    def __exit__(self, *exc):
        from repro_torch.models.lm import moe as MOE
        MOE.apply_moe = self.real

    def apply(self, p, x, cfg, groups=1):
        import torch
        b, t, d = x.shape
        # the whole call's product, as apply_moe forms it (the last rows'
        # alone may round otherwise)
        probs = torch.softmax((x.reshape(-1, d) @ p["router"]).float(), -1)
        top = probs.view(b, t, -1)[:, -1].topk(cfg.top_k + 1, -1)
        self.calls.append((top.indices[:, :cfg.top_k].sort(-1).values,
                           top.values[:, -2] - top.values[:, -1]))
        return self.real(p, x, cfg, groups)


def moe_witnesses(model, prompt, tokens, want, routes, tol, arch) -> dict:
    """Readings of an arch with MoE FFNs beside its decode-vs-prefill gap
    (``want``: ``prefill_logits``; ``routes``: the RouteLog of that
    prefill and the decode that followed it): at each checked step, the
    rows whose top-k expert set at some MoE layer differs between decode
    and prefill at the same position, and the smallest router margin at
    that step's prefill (recorded); a broken decode, every cache written
    a slot late at the hand-over (the newest prompt slot lost), which
    must read beyond ``tol``; and for an arch with M layers the absorbed
    decode computed in float32 (recorded)."""
    import torch
    from repro_torch.models.lm import mla as MLA
    n_moe = sum(b.ffn == "moe" for b in model.blocks)
    calls = routes.calls
    pre = calls[:n_moe * len(LM_CHECK_STEPS)]
    dec = calls[n_moe * len(LM_CHECK_STEPS):]
    flips, margins = {}, {}
    for n, j in enumerate(LM_CHECK_STEPS):
        p_sets = pre[n * n_moe:(n + 1) * n_moe]
        d_sets = dec[j * n_moe:(j + 1) * n_moe]     # after the prefill's
        moved = torch.zeros_like(p_sets[0][1], dtype=torch.bool)
        for (pe, _), (de, _) in zip(p_sets, d_sets):
            moved |= (pe != de).any(-1)
        flips[j] = int(moved.sum())
        margins[j] = min(float(m.min()) for _, m in p_sets)

    def late(caches):
        for c in caches:
            for name, axis in (("c", 1), ("pe", 1), ("k", 2), ("v", 2)):
                if name in c:
                    w = c[name]
                    t0 = prompt.shape[1]
                    w.narrow(axis, 1, t0 - 1).copy_(
                        w.narrow(axis, 0, t0 - 1).clone())

    out = {"rows_on_other_experts": flips, "min_router_margin": margins}
    kept, _ = decode_logits(model, prompt, tokens, handoff=late)
    out["caches_late"] = logit_gap(kept, want)
    check(out["caches_late"] > tol, f"5k {arch}: the broken decode's gap "
                                    f"{out['caches_late']:.4g} is within the "
                                    f"limit {tol:.3g}")
    if any(b.kind == "M" for b in model.blocks):
        real = MLA.mla_decode_absorbed

        def f32(p, x, n_heads, cfg, *, c_cache, pe_cache, pos, theta, eps):
            return real({k: v.float() for k, v in p.items()}, x.float(),
                        n_heads, cfg, c_cache=c_cache.float(),
                        pe_cache=pe_cache.float(), pos=pos, theta=theta,
                        eps=eps).to(x.dtype)
        MLA.mla_decode_absorbed = f32
        try:
            kept, _ = decode_logits(model, prompt, tokens)
        finally:
            MLA.mla_decode_absorbed = real
        out["absorbed_f32"] = logit_gap(kept, want)
    return out


def moe_aux(model, prompt, t0) -> dict:
    """The MoE aux of one prefill of ``prompt`` into ``t0 + LM_STEPS + 1``
    slots, summed over the MoE layers, as numbers."""
    import torch
    from repro_torch.models.lm import model as M
    aux = {}
    with torch.inference_mode():
        M.forward_prefill(model, prompt, t0 + LM_STEPS + 1, aux=aux)
    return {k: v.item() for k, v in aux.items()}


def run_kinds(dev, all_k, reset, counts, name, archs=None, phase="5j",
              seed=KINDS_SEED) -> dict:
    """Phase 5j (``archs`` KINDS) or 5k (MOE): each arch at full width,
    random bf16 weights: ``generate`` (greedy, LM_STEPS) twice, equal bit
    for bit, its decode logits against prefill logits
    (``decode_vs_prefill``) and, where the arch decodes with SMC,
    ``smc_decode`` (K = LM_K, LM_STEPS steps, τ = LM_TAU) twice, equal
    bit for bit, sequences the genealogy's paths, finite log Z, ESS in
    [1, K].  Every attention layer goes through B6: its launches by
    variant must be ``kinds_want``'s, the comb scan once a bank step, no
    other kernel, and ``mha_ref`` never runs.  An arch with MoE FFNs also
    reports the MoE aux of a prefill of the prompts at its config's
    capacity factor, and holds decode against prefill at
    ``no_drop_config``'s (the model's weights under that config, with
    ``generate``'s tokens at it), where the prefill must drop nothing.
    Each model is freed before the next."""
    import torch
    from repro_torch.core import genealogy
    from repro_torch.kernels import ref
    from repro_torch.models.lm import model as M
    from repro_torch.serve import SMCDecodeConfig, generate, smc_decode

    archs = KINDS if archs is None else archs
    attn = all_k["flash_attention"]
    out = {}
    for i, arch in enumerate(archs):
        cfg = kinds_config(arch)
        _, t0, with_smc = archs[arch]
        t_start = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()      # what earlier phases hold
        model = M.init_params(cfg, seed + i, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 100 + i)
        books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        prompt = torch.randint(cfg.vocab_size, (LM_BATCH, t0) + books,
                               generator=g, device=dev)
        img = None
        if cfg.cross_attn_every:
            img = torch.randn((LM_BATCH, cfg.n_image_tokens, cfg.d_image),
                              generator=g, device=dev).to(model.dtype)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        rec = {"layers": cfg.n_layers, "params": n_params,
               "kinds": "".join(k for k, _ in M.make_plan(cfg).layers()),
               "prompt": list(prompt.shape),
               "weights_gib": sum(p.numel() * p.element_size()
                                  for p in model.parameters()) / 2 ** 30}
        want = kinds_want(cfg, LM_STEPS)

        def launches_ok(what, scans):
            got = counts(all_k)
            expect = {k: 0 for k in all_k}
            expect["flash_attention"] = sum(want.values())
            expect["prefix_sum"] = scans
            check(got == expect, f"{phase} {arch} {what} launches {got}, "
                                 f"want {expect}")
            check(attn.variants == want, f"{phase} {arch} {what} B6 "
                  f"variants {attn.variants}, want {want}")
            check(ref.mha_ref.calls == 0, f"{phase} {arch} {what} ran the "
                                          f"plain attention")
            return {"flash_attention": got["flash_attention"],
                    "variants": dict(attn.variants),
                    "prefix_sum": got["prefix_sum"]}

        reset()
        t = time.perf_counter()
        tokens = generate(model, prompt, steps=LM_STEPS, img=img)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t
        rec["generate_launches"] = launches_ok("generate", 0)
        check(tokens.shape == (LM_BATCH, LM_STEPS) + books and bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            f"{phase} {arch} generate tokens {tuple(tokens.shape)}")
        t = time.perf_counter()
        again = generate(model, prompt, steps=LM_STEPS, img=img)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t
        check(torch.equal(tokens, again), f"{phase} {arch} generate not "
                                          f"repeatable")
        del again
        rec["generate"] = {
            "seconds": t_gen, "first_run_seconds": t_first,
            "tokens_per_s": LM_BATCH * LM_STEPS / t_gen}
        depth_tol, tol = kinds_tols(cfg)
        rec["logit_limit"], rec["depth_logit_limit"] = tol, depth_tol
        if cfg.moe:
            rec["moe_aux"] = moe_aux(model, prompt, t0)
            model.cfg = no_drop_config(cfg)
            rec["no_drop_aux"] = moe_aux(model, prompt, t0)
            check(abs(rec["no_drop_aux"]["moe_drop_frac"]) < 1e-6,
                  f"{phase} {arch}: the prefill drops "
                  f"{rec['no_drop_aux']['moe_drop_frac']} at capacity "
                  f"factor {model.cfg.moe.capacity_factor}")
            tokens = generate(model, prompt, steps=LM_STEPS)
        with RouteLog(cfg.moe is not None) as routes:
            want_logits = prefill_logits(model, prompt, tokens, img)
            rec["consistency"] = decode_vs_prefill(
                model, prompt, tokens, tol=tol, img=img, want=want_logits)
        if cfg.moe:
            rec["moe_witness"] = moe_witnesses(model, prompt, tokens,
                                               want_logits, routes, tol, arch)
        model.cfg = cfg
        if "D" in rec["kinds"]:
            rec["ssm_witness"] = ssm_witnesses(model, prompt, tokens,
                                               want_logits, arch)
            log(f"5j {arch} decode vs prefill logits: sound "
                f"{rec['consistency']['max_abs_logit_err']:.4g}, SSM state "
                f"in float32 {rec['ssm_witness']['f32_state']:.4g} (limit "
                f"{tol:.3g}; depth rule {depth_tol:.3g}); conv window one "
                f"slot late {rec['ssm_witness']['conv_late']:.4g} (must "
                f"exceed {tol:.3g}); SSM state dropped "
                f"{rec['ssm_witness']['state_dropped']:.4g} (recorded)")
        del want_logits
        if cfg.moe:
            w = rec["moe_witness"]
            log(f"{phase} {arch} MoE aux of a {LM_BATCH} x {t0} prefill, "
                f"summed over the MoE layers: at capacity factor "
                f"{cfg.moe.capacity_factor} {rec['moe_aux']}; at "
                f"{no_drop_config(cfg).moe.capacity_factor:.6g} (decode vs "
                f"prefill) {rec['no_drop_aux']}")
            log(f"{phase} {arch} decode vs prefill logits: sound "
                f"{rec['consistency']['max_abs_logit_err']:.4g} (limit "
                f"{tol:.3g}; depth rule {depth_tol:.3g}); rows on another "
                f"expert set by step {w['rows_on_other_experts']}, least "
                f"router margin {w['min_router_margin']}; every cache a slot"
                f" late {w['caches_late']:.4g} (must exceed {tol:.3g})"
                + (f"; absorbed decode in float32 {w['absorbed_f32']:.4g} "
                   f"(recorded)" if "absorbed_f32" in w else ""))
        log(f"{phase} {arch} ({cfg.n_layers} layers {rec['kinds']}, "
            f"{n_params / 1e9:.3f} B parameters, {rec['weights_gib']:.2f} "
            f"GiB): generate {LM_BATCH} x {t0}"
            f"{' x ' + str(books[0]) + ' codebooks' if books else ''}"
            f"{' + image ' + str(tuple(img.shape[1:])) if img is not None else ''}"
            f" + {LM_STEPS}: B6 {rec['generate_launches']}; {t_gen:.3f} s "
            f"({t_first:.3f} s first), {rec['generate']['tokens_per_s']:.1f}"
            f" tokens/s; decode vs prefill logits "
            f"{rec['consistency']['max_abs_logit_err']:.4g} (limit "
            f"{tol:.3g}), greedy agrees on all "
            f"{rec['consistency']['clear_steps']} clear steps, repeatable "
            f"[{name}]")
        if with_smc:
            smc = SMCDecodeConfig(n_particles=LM_K, steps=LM_STEPS,
                                  proposal_temperature=LM_TAU)
            reset()
            t = time.perf_counter()
            res = smc_decode(model, prompt, smc, key=seed + 200 + i)
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t
            rec["smc_launches"] = launches_ok("smc_decode", LM_STEPS - 1)
            t = time.perf_counter()
            res2 = smc_decode(model, prompt, smc, key=seed + 200 + i)
            torch.cuda.synchronize()
            t_smc = time.perf_counter() - t
            for field in res._fields:
                check(torch.equal(getattr(res, field), getattr(res2, field)),
                      f"{phase} {arch} smc_decode {field} not repeatable")
            del res2
            for b in range(LM_BATCH):
                paths = genealogy.reconstruct_trajectories(
                    res.ancestors[:, b], res.emissions[:, b])
                check(torch.equal(paths, res.sequences[b]),
                      f"{phase} {arch} prompt {b}: sequences are not the "
                      f"genealogy's paths")
            check(bool(torch.isfinite(res.log_z).all()),
                  f"{phase} {arch}: non-finite log Z")
            check(bool(((res.ess >= 1 - 1e-3)
                        & (res.ess <= LM_K * (1 + 1e-5))).all()),
                  f"{phase} {arch}: ESS outside [1, {LM_K}]")
            rec["smc_decode"] = {
                "seconds": t_smc, "first_run_seconds": t_first,
                "tokens_per_s": LM_BATCH * LM_K * LM_STEPS / t_smc,
                "resample_events": int(res.resampled.sum()),
                "log_z": res.log_z.tolist(), "mean_ess": float(res.ess.mean()),
                "min_ess": float(res.ess.min())}
            log(f"{phase} {arch} smc_decode {LM_BATCH} x {t0}, K={LM_K}, "
                f"{LM_STEPS} steps, tau={LM_TAU}: B6 {rec['smc_launches']};"
                f" {t_smc:.3f} s ({t_first:.3f} s first), "
                f"{rec['smc_decode']['tokens_per_s']:.1f} hypothesis "
                f"tokens/s; log Z "
                f"{[round(x, 4) for x in rec['smc_decode']['log_z']]}, ESS "
                f"mean {rec['smc_decode']['mean_ess']:.3f} min "
                f"{rec['smc_decode']['min_ess']:.3f}, "
                f"{rec['smc_decode']['resample_events']} resample events; "
                f"sequences == genealogy paths, repeatable [{name}]")
            del res
        rec["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        rec["seconds"] = time.perf_counter() - t_start
        log(f"{phase} {arch}: {rec['seconds']:.1f} s, peak "
            f"{rec['peak_gib']:.2f} GiB above what earlier phases hold")
        out[arch] = rec
        del model, prompt, img, tokens
        torch.cuda.empty_cache()
    return out


# phase 5l: training stablelm-3b whole (32 G layers, d_model 2560, 2.80 B
# parameters) on the card: float32 master weights, bf16 compute, remat,
# AdamW, batch 8 x 1024 in 2 microbatches, loss chunks of 512
TRAIN_ARCH, TRAIN_SEED, TRAIN_STEPS = "stablelm-3b", 11, 20
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_XENT = 8, 1024, 2, 512
TRAIN_OPT = dict(lr=3e-4, warmup_steps=5, total_steps=TRAIN_STEPS)
TRAIN_FALL = 0.3          # nat, step 1 to step 20 (tests/test_train.py)
# gate b: a bf16 step's gradient against the float32-compute one, each
# leaf's relative L2 error.  A bf16 rounding is 2^-9 relative; a layer's
# forward and backward add ~10 of them and 32 layers compound them as a
# random walk, sqrt(640) x 2^-9 ≈ 0.05; twice that
TRAIN_GRAD_TOL = 0.1
# gate c: the reference's test (tests/test_train.py:37-57): its optimizer
# and tolerances, float32 compute, 1 against 2 microbatches, from the
# seed's weights, at full width and 16 of the 32 layers: the float32 step
# of the whole batch at full depth does not fit the card (74.4 GiB
# allocated on an H100 80GB HBM3 when it ran out)
TRAIN_ACC_OPT = dict(lr=1e-3, warmup_steps=0)
TRAIN_ACC_LOSS, TRAIN_ACC_RTOL, TRAIN_ACC_ATOL = 1e-4, 2e-3, 2e-5
TRAIN_ACC_LAYERS = 16
# ... on every element whose two float32 gradients agree within 5%.  Adam's
# first step moves an element by lr·x/(|x| + eps), x its clipped
# gradient: a relative disagreement r in x moves it by at most lr·r/4,
# 1.25e-5 at 5%, inside atol; an element whose float32 gradient is
# rounding noise (x near eps = 1e-8, summed in another order) moves by up
# to 2·lr.  At full width such elements exist by chance (on an H100
# 80GB HBM3, 41 beyond the tolerance of 1.53e9 at the seed's weights, 424
# of 2.80e9 after 20 steps), so they are counted and their excess
# printed, not gated; the gradients themselves must agree within
# TRAIN_ACC_GRAD relative L2 a leaf (float32 sums over 8192 tokens in two
# orders: 4.3e-6 at the seed's weights, 6.3e-5 after 20 steps, at worst)
TRAIN_ACC_RESOLVED, TRAIN_ACC_GRAD = 0.05, 1e-3
# gate e at 2 of the 32 layers: a checkpoint of the whole model's weights
# and moments is 33.6 GB of disk, of 2 layers 5.0 GB
TRAIN_RESUME_LAYERS = 2


def digest(tensors) -> list:
    """Two exact integer sums of every tensor's raw bits (the sum and the
    wrapped sum of squares of its int32 words): equal bits give equal
    digests, in any order of summation."""
    import torch
    out = []
    for t in tensors:
        b = t.detach().contiguous().view(torch.int32).to(torch.int64)
        out.append((int(b.sum()), int((b * b).sum())))
    return out


def train_digest(model, state) -> list:
    return digest([p for _, p in sorted(model.named_parameters())]
                  + [state[k][n] for k in ("m", "v")
                     for n in sorted(state[k])])


def run_train(dev, all_k, reset, counts, rsum_k, name) -> dict:
    """Phase 5l: stablelm-3b trained whole at full width on the card
    (``repro_torch.train``; no kernel of the port on its path).  Gates: a.
    20 steps with finite losses and gradient norms, the loss falling by
    TRAIN_FALL; b. at step 0 the bf16 step's gradient held to the
    float32-compute one, leaf by leaf within TRAIN_GRAD_TOL, every leaf
    non-zero and finite; c. 1 against 2 microbatches in float32 from the
    seed's weights (at TRAIN_ACC_LAYERS layers): the loss and the
    weights at the reference's tolerances, the latter on every element
    whose float32 gradient the two runs resolve (TRAIN_ACC_RESOLVED),
    and every leaf's gradient within TRAIN_ACC_GRAD; d. two 3-step runs
    from the seed, the same bits (losses and a digest of every master
    tensor and moment); e. a
    checkpoint at step 2 reloaded into fresh tensors, step 3 the
    uninterrupted run's bits (at TRAIN_RESUME_LAYERS layers); f. no
    kernel launch and no plain attention in the phase, and B6 refuses
    CUDA inputs that require grad.  Prints step ms (median of steps
    5-20), tokens/s, the share of 989 TFLOP/s that 6·N·tokens a step
    makes, and peak memory."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import restore_state, save_state
    from repro_torch.models.lm import model as M
    from repro_torch.optim import OptConfig, adamw_update, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.step import accumulate_grads

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    check(cfg.remat and cfg.attn_chunk == 512 and cfg.n_layers == 32,
          f"5l config {cfg}")
    tc = TrainConfig(num_microbatches=TRAIN_MICRO, xent_chunk=TRAIN_XENT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset()
    ref.mha_ref.calls = 0
    rec = {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": TRAIN_MICRO, "xent_chunk": TRAIN_XENT,
           "base_gib": base / 2 ** 30}

    def batch(s, c=cfg):
        return make_batch(TRAIN_SEED, s, c, TRAIN_BATCH, TRAIN_SEQ,
                          device=dev)

    def fresh(c=cfg, seed=TRAIN_SEED):
        model = M.init_train_params(c, seed, device=dev)
        return model, init_opt_state(model)

    model, state = fresh()
    n = sum(p.numel() for p in model.parameters())
    rec["params"] = n
    check(abs(n - 2.80e9) < 0.01e9, f"5l: {n} parameters, not 2.80 B")
    log(f"5l {TRAIN_ARCH} whole: {n / 1e9:.4f} B parameters float32 "
        f"({(torch.cuda.memory_allocated() - base) / 2 ** 30:.2f} GiB), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in {TRAIN_MICRO} "
        f"microbatches [{name}]")

    # -- b: the step-0 gradient, bf16 against float32 compute ------------
    t_gate = time.perf_counter()
    b0 = batch(0)
    accumulate_grads(model, cfg, tc, b0)
    g16 = {k: p.grad for k, p in model.named_parameters()}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    accumulate_grads(model, cfg32, tc, b0)
    errs = {}
    for k, p in model.named_parameters():
        g32 = p.grad
        check(bool(torch.isfinite(g16[k]).all() and
                   torch.isfinite(g32).all()), f"5l b: {k} not finite")
        norm = float(torch.linalg.vector_norm(g32))
        check(norm > 0 and float(torch.linalg.vector_norm(g16[k])) > 0,
              f"5l b: {k}'s gradient is zero")
        errs[k] = float(torch.linalg.vector_norm(g16[k] - g32)) / norm
        p.grad = None
    del g16
    worst = max(errs, key=errs.get)
    rec["grad_rel_l2"] = {"max": errs[worst], "leaf": worst,
                          "attn": {w: max(v for k, v in errs.items()
                                          if k.endswith(f"attn.{w}"))
                                   for w in ("wq", "wk", "wv", "wo")}}
    rec["gate_s"] = {"b": time.perf_counter() - t_gate}
    log(f"5l b: bf16 vs float32 gradient, relative L2 a leaf: max "
        f"{errs[worst]:.4f} ({worst}), attention "
        f"{ {w: round(v, 4) for w, v in rec['grad_rel_l2']['attn'].items()} }"
        f" (limit {TRAIN_GRAD_TOL}); {rec['gate_s']['b']:.1f} s [{name}]")
    check(errs[worst] <= TRAIN_GRAD_TOL,
          f"5l b: {worst} relative L2 {errs[worst]:.4f} > {TRAIN_GRAD_TOL}")
    del model, state
    drop_cached()

    # -- c: 1 against 2 microbatches, float32 compute, from the seed's
    # weights as the reference's test starts from its init (each run from
    # its own draw of them: the seed gives the same bits, gate d).  A
    # train step is accumulate_grads then adamw_update; they run apart
    # here so the two gradients can be compared too -------------------
    t_gate = time.perf_counter()
    acc_opt = OptConfig(**TRAIN_ACC_OPT)
    cfg_c = dataclasses.replace(cfg32, n_layers=TRAIN_ACC_LAYERS)
    runs = {}
    for m_ in (1, TRAIN_MICRO):
        model, state = fresh(cfg_c)
        met = accumulate_grads(model, cfg_c, TrainConfig(
            num_microbatches=m_, xent_chunk=TRAIN_XENT), b0)
        grads = {k: p.grad for k, p in model.named_parameters()}
        adamw_update(grads, state, model, acc_opt)
        runs[m_] = (float(met["loss"]), model, grads)
        del state, model, grads
    (loss1, want_m, g1), (loss2, got_m, g2) = runs[1], runs[TRAIN_MICRO]
    loss_gap = abs(loss1 - loss2)
    worst_c = worst_u = -math.inf
    grad_l2, bad, unresolved = 0.0, {}, 0
    for (k, want), got in zip(want_m.named_parameters(),
                              got_m.parameters()):
        grad_l2 = max(grad_l2, float(torch.linalg.vector_norm(g2[k] - g1[k])
                                     / torch.linalg.vector_norm(g1[k])))
        excess = (got - want).detach().abs() - (
            TRAIN_ACC_ATOL + TRAIN_ACC_RTOL * want.detach().abs())
        loose = (g2[k] - g1[k]).abs() > TRAIN_ACC_RESOLVED * g1[k].abs()
        unresolved += int(loose.sum())
        if bool(loose.any()):
            worst_u = max(worst_u, float(excess[loose].max()))
        excess = excess[~loose]
        if excess.numel():
            worst_c = max(worst_c, float(excess.max()))
            if int((excess > 0).sum()):
                bad[k] = int((excess > 0).sum())
    del runs, want_m, got_m, g1, g2
    drop_cached()
    rec["microbatch"] = {"loss_gap": loss_gap, "grad_rel_l2": grad_l2,
                         "excess": worst_c, "violations": bad,
                         "unresolved": unresolved,
                         "unresolved_excess": worst_u}
    rec["gate_s"]["c"] = time.perf_counter() - t_gate
    log(f"5l c: float32 1 vs {TRAIN_MICRO} microbatches from the seed's "
        f"weights, {TRAIN_ACC_LAYERS} layers: loss gap {loss_gap:.3g} (limit "
        f"{TRAIN_ACC_LOSS}), gradients {grad_l2:.3g} relative L2 at worst "
        f"(limit {TRAIN_ACC_GRAD}); weights over rtol {TRAIN_ACC_RTOL} atol "
        f"{TRAIN_ACC_ATOL}: worst excess {worst_c:.3g}, beyond it {bad}; "
        f"{unresolved} elements whose two gradients differ by more than "
        f"{TRAIN_ACC_RESOLVED:.0%} left out (their worst excess "
        f"{worst_u:.3g}); {rec['gate_s']['c']:.1f} s [{name}]")
    check(loss_gap < TRAIN_ACC_LOSS and grad_l2 <= TRAIN_ACC_GRAD
          and worst_c <= 0, f"5l c: microbatching changed the update "
                            f"({loss_gap}, {grad_l2}, {worst_c}, {bad})")

    # -- a: 20 steps (the first 3 are gate d's first run) ----------------
    t_gate = time.perf_counter()
    model, state = fresh()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, OptConfig(**TRAIN_OPT), tc)
    losses, gnorms, times = [], [], []
    for s in range(TRAIN_STEPS):
        b = batch(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # (``_, _, met = ...`` would keep the optimizer state, the last
        # ``_``, alive past ``del model, state``: 21.7 GiB into gate d on
        # an H100 80GB HBM3 at 700 W)
        met = step(model, state, b)[2]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(met["loss"].clone())
        gnorms.append(float(met["grad_norm"]))
        if s == 2:
            want3 = train_digest(model, state)
    losses_f = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses_f + gnorms),
          f"5l a: non-finite loss or grad norm {losses_f} {gnorms}")
    fall = losses_f[0] - losses_f[-1]
    rec.update(losses=losses_f, grad_norms=gnorms, fall=fall,
               step_s=times)
    med = statistics.median(times[4:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec.update(step_ms=med * 1e3, tokens_per_s=tokens / med,
               flop_share=6 * n * tokens / med / PEAK_BF16,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, state
    drop_cached()
    rec["gate_s"]["a"] = time.perf_counter() - t_gate
    log(f"5l a: loss {losses_f[0]:.4f} -> {losses_f[-1]:.4f} (fall "
        f"{fall:.4f}, needs {TRAIN_FALL}); grad norm {gnorms[0]:.3f} -> "
        f"{gnorms[-1]:.3f}; {rec['gate_s']['a']:.1f} s [{name}]")
    check(fall >= TRAIN_FALL, f"5l a: the loss fell {fall:.4f} in "
                              f"{TRAIN_STEPS} steps, not {TRAIN_FALL}")
    log(f"5l times [{name}]: step {rec['step_ms']:.1f} ms (median of steps "
        f"5-{TRAIN_STEPS}; first {times[0] * 1e3:.1f}), "
        f"{rec['tokens_per_s']:.0f} tokens/s, 6·N·tokens at "
        f"{100 * rec['flop_share']:.2f}% of 989 TFLOP/s, peak "
        f"{rec['peak_gib']:.2f} GiB allocated ({rec['base_gib']:.2f} before "
        f"the phase)")

    # -- d: a second 3-step run from the seed, the same bits -------------
    t_gate = time.perf_counter()
    model, state = fresh()
    for s in range(3):
        met = step(model, state, batch(s))[2]
        check(same_bits(met["loss"], losses[s]),
              f"5l d: step {s + 1} loss differs between two runs")
    check(train_digest(model, state) == want3,
          "5l d: two 3-step runs differ in the bits of a master tensor or "
          "moment")
    del model, state
    drop_cached()
    rec["gate_s"]["d"] = time.perf_counter() - t_gate

    # -- e: checkpoint at step 2, reload, step 3 (2 layers) --------------
    t_gate = time.perf_counter()
    small = dataclasses.replace(cfg, n_layers=TRAIN_RESUME_LAYERS)
    sstep = make_train_step(small, OptConfig(**TRAIN_OPT), tc)
    model, state = fresh(small)
    for s in range(3):
        met = sstep(model, state, batch(s, small))[2]
    want_loss, want_e = met["loss"], train_digest(model, state)
    model, state = fresh(small)
    for s in range(2):
        sstep(model, state, batch(s, small))
    tmp = os.path.join(ROOT, ".chip_scratch", "train")
    shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    save_state(tmp, 2, model, state)
    t_save = time.perf_counter() - t0
    model, state = fresh(small, TRAIN_SEED + 1)
    t0 = time.perf_counter()
    restore_state(tmp, 2, model, state)
    t_load = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    met = sstep(model, state, batch(2, small))[2]
    check(same_bits(met["loss"], want_loss) and
          train_digest(model, state) == want_e,
          "5l e: step 3 after the checkpoint is not the uninterrupted "
          "run's")
    rec["resume"] = {"layers": TRAIN_RESUME_LAYERS, "save_s": t_save,
                     "load_s": t_load}
    del model, state
    drop_cached()
    rec["gate_s"]["e"] = time.perf_counter() - t_gate

    # -- f: no kernel, no plain attention; B6 refuses grads on the card ---
    got = counts(all_k)
    got["row_sum"] = rsum_k.launches
    check(all(v == 0 for v in got.values()), f"5l launched kernels {got}")
    check(ref.mha_ref.calls == 0, f"5l ran the plain attention "
                                  f"{ref.mha_ref.calls} times")
    q = torch.randn((1, 4, 16, 64), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    try:
        ops.attention(q, q[:, :2].detach(), q[:, :2].detach())
    except RuntimeError as e:
        check("no backward" in str(e), f"5l f: B6 raised {e}")
    else:
        raise AssertionError("5l f: B6 took a CUDA input that requires grad")
    check(all_k["flash_attention"].launches == 0, "5l f: B6 launched")
    rec["launches"] = got
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"5l: gates a-f passed; d/e: two 3-step runs and a resume at step "
        f"2 bit for bit (checkpoint of {TRAIN_RESUME_LAYERS} layers saved "
        f"{t_save:.1f} s, loaded {t_load:.1f} s); gates "
        f"{ {k: round(v, 1) for k, v in rec['gate_s'].items()} } s, phase "
        f"{rec['seconds']:.1f} s [{name}]")
    return rec


# phase 5m: training the M, X, R and D kinds, MoE FFNs and the codebook
# head at full width, each arch after the last is freed, right after 5l
# while the card is empty: 5l's batches (8 x 1024 from make_batch in 2
# microbatches), loss chunks, bf16 compute, remat and AdamW.  Widths,
# expert counts, vocabularies and image tokens are never cut; depth only
# where 16 B a parameter (float32 master, gradient, two moments) would
# not fit 80 GB: llama-vision two GGGGX units (3.2 B), moonshot its dense
# layer and 3 MoE layers (2.5 B; 64 experts of 1408, top 6), deepseek its
# dense first layer (1.4 B; one MoE layer holds 3.77 B parameters, 60 GB
# at 16 B before anything else)
TRAIN_KINDS = {"recurrentgemma-2b": None, "mamba2-1.3b": None,
               "musicgen-medium": None, "llama-3.2-vision-11b": 10,
               "moonshot-v1-16b-a3b": 4, "deepseek-v2-236b": 1}
TRAIN_KINDS_STEPS, TRAIN_KINDS_SEED = 10, 13
TRAIN_KINDS_DIGEST_STEPS = 2      # gate d: two runs of this many steps
# gate b for a MoE arch's router and expert leaves, set from a reckoning
# before any run on the card, never from a reading: top-k comes from the bf16
# router product, so a token whose 6th and 7th router logits (~N(0, 1)
# at init; 64 experts: mean gap ~0.095) lie closer than the two runs'
# logit difference (sigma ~0.008: bf16 inputs, weights and output
# rounding, and the drift of the hidden states) takes another expert:
# ~0.4 x 0.008 / 0.095, 3-6% of tokens, ~280 of a microbatch's 4096 a
# layer.  A flip moves 2 of a token's 6 expert contributions, so an
# expert leaf's relative L2 is ~sqrt(2p / 6) = 0.11-0.14, up to ~0.2 if
# every flip also shifts a capacity drop; the limit is 0.25.  Every
# other leaf keeps TRAIN_GRAD_TOL
TRAIN_MOE_GRAD_TOL = 0.25
MOE_LEAVES = ("moe.router", "moe.we_gate", "moe.we_up", "moe.we_down")
# gate b for the D kind (mamba2-1.3b's 48 SSD layers), by leaf.  The
# depth-scaled reckoning above does not hold there: the card's first
# reading failed TRAIN_GRAD_TOL (ssm.a_log 0.2043 at layer 39, every
# other leaf lower), and the reference's own bf16 gradient lies as far
# from its float32 one at that depth.  tests/bf16_grad_noise.py (48 D
# layers, d_model 256, 2 x 1024 tokens, seed 1, on the CPU) reads, for
# the largest layer of each leaf, reference / port: a_log 0.4103 /
# 0.3538, dt_bias 0.3639 / 0.3231, d_skip 0.2393 / 0.2057, pre_norm
# 0.1222 / 0.1132, out_norm 0.1214 / 0.1164, conv_b 0.1154 / 0.1086,
# conv_w 0.1141 / 0.1052, w_in 0.1102 / 0.1018, w_out 0.1097 / 0.1011,
# embed 0.1085 / 0.1000 (the per-head a_log and dt_bias enter
# exponentials of chunk-long sums).  Each D-arch leaf is held to the
# larger of TRAIN_GRAD_TOL and the reference's own reading
TRAIN_D_GRAD_TOL = {"ssm.a_log": 0.4103, "ssm.dt_bias": 0.3639,
                    "ssm.d_skip": 0.2393, "pre_norm": 0.1222,
                    "ssm.out_norm": 0.1214, "ssm.conv_b": 0.1154,
                    "ssm.conv_w": 0.1141, "ssm.w_in": 0.1102,
                    "ssm.w_out": 0.1097, "embed": 0.1085}


def grad_limit(name: str, kinds, moe_leaves) -> tuple[str, float]:
    """Gate b's group and limit for weight ``name``: a MoE router or
    expert leaf TRAIN_MOE_GRAD_TOL, a D arch's leaf its TRAIN_D_GRAD_TOL
    entry (at least TRAIN_GRAD_TOL), an X-gated leaf and the rest
    TRAIN_GRAD_TOL."""
    if name in moe_leaves:
        return "moe", TRAIN_MOE_GRAD_TOL
    if x_leaf(name, kinds):
        return "x", TRAIN_GRAD_TOL
    if "D" in kinds:
        leaf = name.split(".", 2)[-1] if name.startswith("blocks.") \
            else name
        return "d", max(TRAIN_GRAD_TOL, TRAIN_D_GRAD_TOL.get(leaf, 0.0))
    return "other", TRAIN_GRAD_TOL


def active_params(model, cfg) -> tuple[int, int]:
    """``(total, active)`` parameters: the active count keeps top_k of
    n_experts of each MoE layer's routed experts (their ``we_gate``,
    ``we_up``, ``we_down``) and every other weight, the shared experts,
    the router, attention and the embeddings and head included."""
    total = sum(p.numel() for p in model.parameters())
    routed = sum(p.numel() for n, p in model.named_parameters()
                 if ".moe.we_" in n)
    frac = cfg.moe.top_k / cfg.moe.n_experts if cfg.moe else 1.0
    return total, total - routed + int(routed * frac)


def x_leaf(name: str, kinds) -> bool:
    """Whether weight ``name`` reaches the loss only through an X layer's
    ``tanh(xattn_gate)`` gate (``img_proj``, the X layers' ``xattn``
    projections and their ``pre_norm``, which feeds only the query), so
    that its gradient is exactly zero while the gate is 0."""
    if name == "img_proj":
        return True
    parts = name.split(".")
    return (parts[0] == "blocks" and kinds[int(parts[1])] == "X"
            and parts[2] in ("xattn", "pre_norm"))


def grad_gate(model, cfg, cfg32, tc, b0, zero_x, kinds):
    """Gate b at ``model``'s weights: the bf16-compute gradient against
    the float32-compute one, each leaf's relative L2.  With ``zero_x``
    the X kind's gated leaves must be exactly zero in both (and are left
    out of the errors); every other leaf must be finite and non-zero.
    Returns ``(errors by leaf, bf16 gradients, step-0 metrics)``."""
    import torch
    from repro_torch.train.step import accumulate_grads
    met = accumulate_grads(model, cfg, tc, b0)
    g16 = {k: p.grad for k, p in model.named_parameters()}
    accumulate_grads(model, cfg32, tc, b0)
    errs, zeros = {}, []
    for k, p in model.named_parameters():
        g32, p.grad = p.grad, None
        check(bool(torch.isfinite(g16[k]).all() and
                   torch.isfinite(g32).all()), f"5m b: {k} not finite")
        if zero_x and x_leaf(k, kinds):
            check(not bool(g16[k].any()) and not bool(g32.any()),
                  f"5m b: {k} has a gradient while tanh(xattn_gate) = 0")
            zeros.append(k)
            continue
        norm = float(torch.linalg.vector_norm(g32))
        check(norm > 0 and float(torch.linalg.vector_norm(g16[k])) > 0,
              f"5m b: {k}'s gradient is zero")
        errs[k] = float(torch.linalg.vector_norm(g16[k] - g32)) / norm
    if zero_x:
        check(len(zeros) > 0, "5m b: no X-gated leaf found")
    return errs, g16, met


def drop_cached() -> None:
    """Free what a deleted model leaves: collect reference cycles first
    (torch's first checkpointed call imports in a frame that a cycle keeps,
    and with it that step's frames and their model, until the collector
    runs), then empty torch's cache."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def freed(label: str) -> float:
    """Empty torch's cache and return the GiB still allocated (a freed
    arch must leave none), logged under ``label``."""
    import torch
    torch.cuda.synchronize()
    drop_cached()
    held = torch.cuda.memory_allocated() / 2 ** 30
    log(f"{label}: {held:.2f} GiB allocated")
    return held


def run_train_kinds(dev, all_k, reset, counts, rsum_k, name) -> dict:
    """Phase 5m: each arch of TRAIN_KINDS trained at full width on the
    card through ``repro_torch.train`` (no kernel of the port on its
    path).  Gates, each arch: a. TRAIN_KINDS_STEPS steps with finite
    losses and gradient norms, the loss falling by TRAIN_FALL; b. at the
    seed's weights the bf16 step's gradient held to the float32-compute
    one leaf by leaf within TRAIN_GRAD_TOL (a MoE arch's router and
    expert leaves within TRAIN_MOE_GRAD_TOL), no leaf zero or
    non-finite, except that for the X kind ``img_proj`` and the X
    layers' projections must be exactly zero (``tanh(0)`` gates them);
    there all leaves are held again after one bf16 AdamW step, where the
    gate has moved; c. a MoE arch's ``moe_aux_loss`` and
    ``moe_drop_frac`` finite, the dropped fraction a MoE layer in [0,
    1); d. two TRAIN_KINDS_DIGEST_STEPS-step runs from the seed, the same
    bits (losses, the MoE metrics, ``train_digest``); f. no kernel
    launched and no plain attention run in the phase.  Prints step ms
    (median of steps 3-10), tokens/s, the share of 989 TFLOP/s that
    6·N·tokens makes (N: ``active_params``), peak memory and the loss
    before and after."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import ref
    from repro_torch.models.lm import model as M
    from repro_torch.optim import OptConfig, adamw_update, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    tc = TrainConfig(num_microbatches=TRAIN_MICRO, xent_chunk=TRAIN_XENT)
    opt = OptConfig(**TRAIN_OPT)
    reset()
    ref.mha_ref.calls = 0
    out = {}
    for arch, layers in TRAIN_KINDS.items():
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        plan = M.make_plan(cfg).layers()
        kinds = [k for k, _ in plan]
        moe_layers = sum(f == "moe" for _, f in plan)
        check(cfg.remat and cfg.compute_dtype == "bfloat16",
              f"5m {arch} config {cfg}")
        base = freed(f"5m {arch} start") * 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        rec = {"layers": cfg.n_layers, "plan": "".join(kinds),
               "moe_layers": moe_layers, "base_gib": base / 2 ** 30}

        def batch(s):
            return make_batch(TRAIN_KINDS_SEED, s, cfg, TRAIN_BATCH,
                              TRAIN_SEQ, device=dev)

        # -- b: the seed's gradients, bf16 against float32 compute -------
        t_gate = time.perf_counter()
        model = M.init_train_params(cfg, TRAIN_KINDS_SEED, device=dev)
        n, n_active = active_params(model, cfg)
        rec.update(params=n, active_params=n_active)
        log(f"5m {arch} x {cfg.n_layers} layers ({rec['plan']}): "
            f"{n / 1e9:.4f} B parameters float32, {n_active / 1e9:.4f} B "
            f"active [{name}]")
        b0 = batch(0)
        has_x = "X" in kinds
        moe_leaves = [k for k, _ in model.named_parameters()
                      if any(f".{w}" in k for w in MOE_LEAVES)]
        errs, g16, met0 = grad_gate(model, cfg, cfg32, tc, b0, has_x,
                                    kinds)
        rounds = [errs]
        if has_x:
            # one bf16 AdamW step from the seed moves xattn_gate off 0
            state = init_opt_state(model)
            adamw_update(g16, state, model, opt)
            del state, g16
            gate = [float(p.detach()) for k, p in model.named_parameters()
                    if k.endswith("xattn_gate")]
            check(all(g != 0.0 for g in gate), f"5m b: gates {gate}")
            rec["xattn_gate_after_step"] = gate
            errs, g16, _ = grad_gate(model, cfg, cfg32, tc, b0, False,
                                     kinds)
            rounds.append(errs)
        del g16
        worst, over = {}, []
        for i, e in enumerate(rounds):
            for k, err in e.items():
                group, limit = grad_limit(k, kinds, moe_leaves)
                key = f"{group}{i}"
                if key not in worst or err > worst[key][1]:
                    worst[key] = (k, err)
                if err > limit:
                    over.append(f"{k} {err:.4f} > {limit}")
        rec["grad_rel_l2_top"] = sorted(rounds[0].items(),
                                        key=lambda kv: -kv[1])[:8]
        rec["grad_rel_l2"] = {k: {"leaf": w, "err": v}
                              for k, (w, v) in worst.items()}
        if moe_layers:
            rec["step0_moe"] = {k: float(met0[k]) for k in
                                ("moe_aux_loss", "moe_drop_frac")}
        gate_b = time.perf_counter() - t_gate
        log(f"5m b {arch}: bf16 vs float32 gradient, worst relative L2 "
            f"{ {k: (w, round(v, 4)) for k, (w, v) in worst.items()} } "
            f"(limits {TRAIN_GRAD_TOL}, MoE leaves {TRAIN_MOE_GRAD_TOL}, "
            f"D leaves TRAIN_D_GRAD_TOL; "
            f"0: the seed's weights" + (", X leaves exactly 0; 1: after "
                                        "one step" if has_x else "")
            + f"); {gate_b:.1f} s [{name}]")
        check(not over, f"5m b {arch}: relative L2 over the limit: {over}")
        del model
        rec["held_gib"] = {"after b": freed(f"5m {arch} after b")}

        # -- a: TRAIN_KINDS_STEPS steps (the first 2 are gate d's first
        # run), c: the MoE metrics ------------------------------------
        t_gate = time.perf_counter()
        model = M.init_train_params(cfg, TRAIN_KINDS_SEED, device=dev)
        state = init_opt_state(model)
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(cfg, opt, tc)
        mets, times = [], []
        for s in range(TRAIN_KINDS_STEPS):
            b = batch(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # no name on the returned state, so that del frees it
            met = step(model, state, b)[2]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mets.append({k: v.clone() for k, v in met.items()})
            if s + 1 == TRAIN_KINDS_DIGEST_STEPS:
                want_d = train_digest(model, state)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, state
        rec["held_gib"]["after a"] = freed(f"5m {arch} after a")
        losses = [float(m["loss"]) for m in mets]
        gnorms = [float(m["grad_norm"]) for m in mets]
        check(all(math.isfinite(x) for x in losses + gnorms),
              f"5m a {arch}: non-finite loss or grad norm {losses} {gnorms}")
        fall = losses[0] - losses[-1]
        med = statistics.median(times[2:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        rec.update(losses=losses, grad_norms=gnorms, fall=fall,
                   step_s=times, step_ms=med * 1e3,
                   tokens_per_s=tokens / med,
                   flop_share=6 * n_active * tokens / med / PEAK_BF16)
        if moe_layers:
            aux = [float(m["moe_aux_loss"]) for m in mets]
            drop = [float(m["moe_drop_frac"]) for m in mets]
            rec.update(moe_aux_loss=aux, moe_drop_frac=drop)
            # -3e-8 is "none dropped": 1 - kept · fl(1 / (n·k)), rounded
            # once, as XLA compiles the reference's 1 - mean
            check(all(math.isfinite(x) for x in aux + drop)
                  and all(-1e-6 <= d / moe_layers < 1.0 for d in drop),
                  f"5m c {arch}: aux {aux}, dropped fraction {drop}")
            log(f"5m c {arch}: moe_aux_loss {aux[0]:.6f} -> {aux[-1]:.6f}, "
                f"moe_drop_frac (summed over {moe_layers} MoE layers) "
                f"{drop[0]:.6f} -> {drop[-1]:.6f} [{name}]")
        gate_a = time.perf_counter() - t_gate
        log(f"5m a {arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (fall "
            f"{fall:.4f}, needs {TRAIN_FALL}); grad norm {gnorms[0]:.3f} -> "
            f"{gnorms[-1]:.3f}; {gate_a:.1f} s [{name}]")
        check(fall >= TRAIN_FALL, f"5m a {arch}: the loss fell {fall:.4f} "
                                  f"in {TRAIN_KINDS_STEPS} steps")
        log(f"5m times {arch} [{name}]: step {rec['step_ms']:.1f} ms "
            f"(median of steps 3-{TRAIN_KINDS_STEPS}; first "
            f"{times[0] * 1e3:.1f}), {rec['tokens_per_s']:.0f} tokens/s, "
            f"6·N·tokens at {100 * rec['flop_share']:.2f}% of 989 TFLOP/s "
            f"(N = {n_active / 1e9:.4f} B active), peak "
            f"{rec['peak_gib']:.2f} GiB allocated ({rec['base_gib']:.2f} "
            f"before the arch)")

        # -- d: a second run from the seed, the same bits ---------------
        t_gate = time.perf_counter()
        model = M.init_train_params(cfg, TRAIN_KINDS_SEED, device=dev)
        state = init_opt_state(model)
        for s in range(TRAIN_KINDS_DIGEST_STEPS):
            met = step(model, state, batch(s))[2]
            for k, v in met.items():
                check(same_bits(v, mets[s][k]),
                      f"5m d {arch}: step {s + 1} {k} differs between "
                      f"two runs")
        check(train_digest(model, state) == want_d,
              f"5m d {arch}: two {TRAIN_KINDS_DIGEST_STEPS}-step runs "
              f"differ in the bits of a master tensor or moment")
        del model, state
        rec["gate_s"] = {"b": gate_b, "a": gate_a,
                         "d": time.perf_counter() - t_gate}
        rec["seconds"] = time.perf_counter() - t_arch
        log(f"5m {arch}: gates a-d passed, {rec['seconds']:.1f} s")
        out[arch] = rec

    # -- f: no kernel, no plain attention --------------------------------
    got = counts(all_k)
    got["row_sum"] = rsum_k.launches
    check(all(v == 0 for v in got.values()), f"5m launched kernels {got}")
    check(all_k["flash_attention"].launches == 0, "5m f: B6 launched")
    check(ref.mha_ref.calls == 0, f"5m ran the plain attention "
                                  f"{ref.mha_ref.calls} times")
    seconds = time.perf_counter() - t_phase
    log(f"5m: gates a-d and f passed for {len(out)} archs in "
        f"{seconds:.1f} s [{name}]")
    return {"archs": out, "launches": got, "seconds": seconds}


# phase 5n: the LM over a (data, model) process grid, four ranks spawned
# on the one card over gloo (as 5i's): contention of ranks on one card,
# not a multi-card rate.  a: qwen3-32b at full width cut to 2 layers on
# (2, 2), 5l's batches, precision, remat and AdamW; b: moonshot at full
# width, its dense layer and one MoE layer, on (2, 2) with its config's
# ep_shardmap + rs_ag; c: serving qwen3-32b x 16 layers (5d's model) on
# (1, 4), B6 on each rank's 16 query and 2 key/value heads.  Each
# one-device baseline runs on rank 0 before the grid's work and is freed
# first; the checkpoint of a (the whole model's weights and moments,
# about 30 GB, each rank writing its blocks) goes under
# .chip_scratch/grid and is removed.  5l's batch of 8 x 1024 runs in one
# microbatch here: a rank holds 4 x 1024 tokens, a 5l microbatch's
# count, and every microbatch costs its weights' gathers through host
# memory again (a first 5n run at 5l's 2 took 24 s a step on an H100
# 80GB HBM3 at 700 W)
LMGRID_SHAPE, LMGRID_ELASTIC, LMGRID_SERVE_SHAPE = (2, 2), (4,), (1, 4)
LMGRID_TRAIN_LAYERS, LMGRID_MOE_LAYERS = 2, 2
LMGRID_STEPS, LMGRID_REPEAT, LMGRID_CKPT, LMGRID_DROP_STEPS = 10, 3, 2, 1
# the sharded step-0 loss against one device's: both bf16 compute on the
# same batch and weights, the sums in other orders (a bf16 rounding is
# 2^-9 relative, the loss ~12 nat: a few hundredths at worst)
LMGRID_LOSS_TOL = 0.05


def grid_spec(dev) -> dict:
    """The ranks' spec of phase 5n (``lm_grid.grid_phase``)."""
    import dataclasses
    from repro_torch.configs import get_config
    qwen = dataclasses.replace(get_config(LM_ARCH),
                               n_layers=LMGRID_TRAIN_LAYERS)
    moon = get_config("moonshot-v1-16b-a3b")
    moon = dataclasses.replace(moon, n_layers=LMGRID_MOE_LAYERS)
    check(moon.moe.dispatch == "ep_shardmap" and moon.moe.ep_reduce
          == "rs_ag" and moon.moe.first_dense_layers == 1,
          f"5n b config {moon.moe}")
    common = dict(seed=TRAIN_SEED, opt=TRAIN_OPT, tc=dict(
        num_microbatches=1, xent_chunk=TRAIN_XENT),
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, shape=LMGRID_SHAPE,
        names=("data", "model"))
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       ".chip_scratch", "grid")
    return {"device": "cuda", "threads": 2, "scratch": tmp,
            "train": dict(common, cfg=qwen, steps=LMGRID_STEPS,
                          repeat=LMGRID_REPEAT, ckpt=(tmp, LMGRID_CKPT),
                          elastic=LMGRID_ELASTIC),
            "moe": dict(common, cfg=no_drop_config(moon), steps=1, repeat=0,
                        drops={"cfg": moon, "steps": LMGRID_DROP_STEPS}),
            "serve": dict(cfg=lm_config(), seed=LM_SEED, steps=LM_STEPS,
                          prompt=lm_prompts(lm_config(), dev).cpu().numpy(),
                          shape=LMGRID_SERVE_SHAPE, names=("data", "model"),
                          tol=LM_LOGIT_TOL)}


def run_grid(dev, name) -> dict:
    """Phase 5n: ``lm_grid.grid_phase`` on four gloo ranks sharing the card
    (``launch.mesh.spawn``).  Gates: a. the sharded step-0 gradient,
    gathered leaf by leaf, within TRAIN_GRAD_TOL of the one-device step's
    on the same batch and weights, the loss within LMGRID_LOSS_TOL; the loss
    falls over LMGRID_STEPS steps; two LMGRID_REPEAT-step runs the same bits
    (grid-invariant digests of every weight and moment); the checkpoint
    at step LMGRID_CKPT restored onto (4,) with the same bits; b. at
    capacity factor E / k the same gradient gate (the router and expert
    leaves within TRAIN_MOE_GRAD_TOL) and loss gate, at the config's
    capacity the dropped fraction, aux loss and largest load finite and
    two runs the same bits; a and b launch no kernel; c. every step's
    logits within LM_LOGIT_TOL of one device's, the argmax the same but at
    recorded ties, B6's launches and variants on every rank one device's,
    the plain attention never run.  Prints step ms, tokens/s, staged bytes
    and peak memory a rank."""
    import torch
    from repro_torch.launch import lm_grid
    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    spec = grid_spec(dev)
    shutil.rmtree(spec["scratch"], ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 2 ** 30
    # the ranks' allocators map memory in growable segments: four
    # processes share the card, and cached blocks of one are lost to the
    # others (set for the spawned ranks only)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn(lm_grid.grid_phase, 4, (spec,), transport="gloo",
                      deadline=900.0, timeout=600.0)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        shutil.rmtree(spec["scratch"], ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    r0 = ranks[0]
    out = {"seconds": seconds, "script_gib": base, "ranks": 4}

    # -- a ----------------------------------------------------------------
    a = r0["train"]
    run, rep = a["run"], a["repeat"]
    errs = run["grad_errors"]
    worst = max(errs, key=errs.get)
    gap = abs(run["losses"][0] - a["baseline_loss"])
    check(bool(errs) and errs[worst] <= TRAIN_GRAD_TOL,
          f"5n a: {worst} relative L2 {errs[worst]:.4f} > {TRAIN_GRAD_TOL}")
    check(gap <= LMGRID_LOSS_TOL, f"5n a: step-0 loss {run['losses'][0]} vs "
                                f"one device {a['baseline_loss']}")
    check(all(math.isfinite(v) for v in run["losses"]) and
          run["losses"][-1] < run["losses"][0],
          f"5n a: losses {run['losses']}")
    for r in ranks:
        ra = r["train"]
        check(ra["run"]["losses"] == run["losses"],
              "5n a: the ranks report different losses")
        check(ra["run"]["digests"][LMGRID_REPEAT]
              == ra["repeat"]["digests"][LMGRID_REPEAT],
              f"5n a: two {LMGRID_REPEAT}-step runs differ")
        check(ra["restored"] == ra["run"]["digests"][f"ckpt {LMGRID_CKPT}"]
              and ra["restored_step"] == LMGRID_CKPT,
              f"5n a: the checkpoint restored onto {LMGRID_ELASTIC} differs")
        for part in ("train", "moe"):
            check(not any(r[part]["kernel_launches"].values()),
                  f"5n {part}: launched {r[part]['kernel_launches']}")
    # every kernel's launches in a and b, the most of any rank
    out["train_launches"] = {
        k: max(r[part]["kernel_launches"][k] for r in ranks
               for part in ("train", "moe"))
        for k in r0["train"]["kernel_launches"]}
    step_ms = sorted(run["ms"][1:])[len(run["ms"][1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out["train"] = {
        "arch": LM_ARCH, "layers": LMGRID_TRAIN_LAYERS, "grid": LMGRID_SHAPE,
        "params_per_rank": run["params_local"],
        "grad_rel_l2": {"max": errs[worst], "leaf": worst},
        "loss_gap": gap, "losses": run["losses"], "step_ms": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3,
        "staged_bytes_per_step": run["staged_bytes"] / LMGRID_STEPS,
        "peak_gib": {i: r["train"]["run"].get("peak_gib")
                     for i, r in enumerate(ranks)},
        "microbatches": 1,
        "baseline_s": a["baseline_s"], "run_s": a["run_s"],
        "repeat_s": a["repeat_s"], "ckpt_s": run.get("ckpt_s"),
        "restore_s": a["restore_s"], "seconds": a["seconds"]}
    log(f"5n a {LM_ARCH} x {LMGRID_TRAIN_LAYERS} layers on {LMGRID_SHAPE} "
        f"(data, model), 4 gloo ranks on one card, "
        f"{run['params_local'] / 1e9:.3f} B parameters a rank: step-0 "
        f"gradient vs one device max relative L2 {errs[worst]:.4f} ({worst};"
        f" limit {TRAIN_GRAD_TOL}), loss gap {gap:.5f} (limit "
        f"{LMGRID_LOSS_TOL}); losses {[round(v, 4) for v in run['losses']]}; "
        f"two {LMGRID_REPEAT}-step runs same bits; step {LMGRID_CKPT}'s "
        f"checkpoint on {LMGRID_ELASTIC} same bits (saved in "
        f"{run.get('ckpt_s', 0):.1f} s, restored in {a['restore_s']:.1f} s);"
        f" step {step_ms:.0f} ms median, {tokens / step_ms * 1e3:.0f} "
        f"tokens/s, staged {run['staged_bytes'] / LMGRID_STEPS / 1e9:.2f} GB "
        f"a step in all, peak "
        f"{max(v or 0 for v in out['train']['peak_gib'].values()):.1f} "
        f"GiB a rank; one device's step-0 on rank 0 "
        f"{a['baseline_s']:.1f} s (peak {a.get('baseline_peak_gib', 0):.1f} "
        f"GiB) [{name}]")

    # -- b ----------------------------------------------------------------
    b = r0["moe"]
    bru = b["run"]
    berrs = bru["grad_errors"]
    moe_leaves = tuple(n for n in berrs if ".moe." in n and n.split(".")[-1]
                       in ("router", "we_gate", "we_up", "we_down"))
    for n, e in berrs.items():
        lim = TRAIN_MOE_GRAD_TOL if n in moe_leaves else TRAIN_GRAD_TOL
        check(e <= lim, f"5n b: {n} relative L2 {e:.4f} > {lim}")
    bgap = abs(bru["losses"][0] - b["baseline_loss"])
    check(bgap <= LMGRID_LOSS_TOL, f"5n b: step-0 loss {bru['losses'][0]} vs "
                                 f"one device {b['baseline_loss']}")
    d1, d2 = b["drops"]
    check(d1["digests"] == d2["digests"], "5n b: two runs at the config's "
                                          "capacity differ")
    aux = d1["aux"]
    check(all(math.isfinite(v) for v in aux.values())
          and all(math.isfinite(v) for m in d1["metrics"]
                  for v in m.values()), f"5n b: aux {aux}")
    bworst = max(berrs, key=berrs.get)
    out["moe"] = {"grid": LMGRID_SHAPE, "params_per_rank": bru["params_local"],
                  "grad_rel_l2": {"max": berrs[bworst], "leaf": bworst},
                  "loss_gap": bgap, "drops": aux,
                  "drop_metrics": d1["metrics"],
                  "first_step_ms_no_drop": bru["ms"][0],
                  "first_step_ms": d1["ms"][-1],
                  "staged_bytes_no_drop": bru["staged_bytes"],
                  "staged_bytes_per_step": d1["staged_bytes"]
                  / LMGRID_DROP_STEPS, "seconds": b["seconds"]}
    log(f"5n b moonshot-v1-16b-a3b x {LMGRID_MOE_LAYERS} layers (1 dense + 1 "
        f"MoE of 64 x 1408, top 6, ep_shardmap + rs_ag) on {LMGRID_SHAPE}: at "
        f"capacity E/k step-0 gradient vs one device max relative L2 "
        f"{berrs[bworst]:.4f} ({bworst}; MoE leaves {TRAIN_MOE_GRAD_TOL}, "
        f"others {TRAIN_GRAD_TOL}), loss gap {bgap:.5f}; at capacity 1.25: "
        f"dropped (mean of the shards') {aux['moe_drop_frac']:.4f}, aux loss"
        f" {aux['moe_aux_loss']:.5f}, largest load {aux['moe_max_load']:.0f}"
        f", two {LMGRID_DROP_STEPS}-step runs same bits; a single first "
        f"step {d1['ms'][-1]:.0f} ms ({bru['ms'][0]:.0f} ms at E/k), staged "
        f"{d1['staged_bytes'] / LMGRID_DROP_STEPS / 1e9:.2f} GB a step "
        f"({bru['staged_bytes'] / 1e9:.2f} at E/k) [{name}]")

    # -- c ----------------------------------------------------------------
    c = r0["serve"]
    check(c["max_gap"] <= LM_LOGIT_TOL and c["flips"] == 0,
          f"5n c: logits gap {c['max_gap']} (limit {LM_LOGIT_TOL}), "
          f"{c['flips']} argmax flips outside ties")
    for i, r in enumerate(ranks):
        rc = r["serve"]
        check(rc["launches"] == c["baseline_launches"] > 0 and
              rc["variants"] == c["baseline_variants"],
              f"5n c rank {i}: B6 {rc['launches']} {rc['variants']}, one "
              f"device {c['baseline_launches']} {c['baseline_variants']}")
        check(rc["plain_calls"] == 0, f"5n c rank {i}: the plain attention "
                                      f"ran {rc['plain_calls']} times")
        check(not any(v for k, v in rc["kernel_launches"].items()
                      if k not in ("flash_attention", "row_sum")),
              f"5n c rank {i}: launched {rc['kernel_launches']}")
    pre_tps = LM_BATCH * LM_PROMPT / c["prefill_s"]
    dec_tps = LM_BATCH * (LM_STEPS - 1) / c["decode_s"]
    out["serve"] = {
        "grid": LMGRID_SERVE_SHAPE, "layers": LM_LAYERS,
        "launches_per_rank": c["launches"], "variants": c["variants"],
        "max_logit_gap": c["max_gap"], "tie_flips": c["tie_flips"],
        "prefill_tokens_per_s": pre_tps, "decode_tokens_per_s": dec_tps,
        "prefill_staged_bytes": c["prefill_staged_bytes"],
        "decode_staged_bytes_per_step": c["decode_staged_bytes"]
        / (LM_STEPS - 1), "cache_shape": c["cache_shape"],
        "peak_gib": {i: r["serve"].get("peak_gib")
                     for i, r in enumerate(ranks)},
        "seconds": c["seconds"]}
    log(f"5n c {LM_ARCH} x {LM_LAYERS} layers served on {LMGRID_SERVE_SHAPE}"
        f": B6 {c['launches']} launches {c['variants']} on each of 4 ranks "
        f"(one device {c['baseline_launches']}), a rank's cache "
        f"{c['cache_shape']}, plain attention never ran; logits vs one "
        f"device max gap {c['max_gap']:.4f} (limit {LM_LOGIT_TOL}), argmax "
        f"the same but {c['tie_flips']} ties; prefill {pre_tps:.1f} "
        f"tokens/s, decode {dec_tps:.2f} tokens/s (4 ranks contending for "
        f"one card), staged {c['prefill_staged_bytes'] / 1e9:.3f} GB at "
        f"prefill and {c['decode_staged_bytes'] / (LM_STEPS - 1) / 1e6:.2f}"
        f" MB a decode step in all [{name}]")
    log(f"5n: phase {seconds:.1f} s (a {a['seconds']:.1f}, b "
        f"{b['seconds']:.1f}, c {c['seconds']:.1f}) [{name}]")
    return out


def dist_launches(kind, all_k, stages) -> dict:
    """The kernel launches of a 40-frame distributed run: B3 once a frame;
    MPF, RNA and ARNA comb on B1; RPA's per-shard comb scans its CDF once
    a frame, butterfly's once a stage."""
    want = {k: 0 for k in all_k}
    want["patch_log_likelihood"] = FRAMES
    if kind in ("mpf", "rna", "arna"):
        want["systematic_ancestors"] = FRAMES
    elif kind == "rpa":
        want["prefix_sum"] = FRAMES
    else:
        want["prefix_sum"] = FRAMES * stages
    return want


def run_domain(dev, model, movie, dras, replicated, all_k, reset, counts,
               name) -> dict:
    """Phase 5e: ``ParallelParticleFilter(domain=make_domain_spec(cfg, 8),
    mesh=EmulatedMesh(8))`` for RNA and RPA with phase 5c's configs, movie
    and seed, at ``k_cap=None``: equal to 5c's replicated runs bit for bit
    (estimates, ESS, log-marginal, resampled, final ensemble), B3 once a
    frame with the per-member geometry, no overflow, particles moved,
    repeatable; then RNA with ``k_cap = 2^16``, whose migration is
    recorded frame by frame (kept + shipped == each shard's units, and
    the diagnostics as the reference defines them)."""
    import torch
    from repro_torch.core import ParallelParticleFilter, SIRConfig
    from repro_torch.core import domain as domain_mod
    from repro_torch.core.runtime import EmulatedMesh
    from repro_torch.kernels.patch_likelihood import \
        patch_log_likelihood_kernel as patch_k
    from repro_torch.models.tracking import make_domain_spec
    cfg = model.cfg
    p, c = DOMAIN_P, 2 ** 22
    spec = make_domain_spec(cfg, p)
    slab_b, frame_b = spec.slab_bytes(), spec.frame_bytes()
    check((slab_b, frame_b) == (143616, 1048576),
          f"observation bytes {slab_b} / {frame_b}")
    stages = p.bit_length() - 1
    runs = {}
    for kind in ("rna", "rpa"):
        pf = ParallelParticleFilter(model=model, sir=SIRConfig(
            n_particles=p * c, ess_frac=0.5), mesh=EmulatedMesh(p),
            dra=dras[kind], domain=spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        patch_k.per_member_launches = 0
        t0 = time.perf_counter()
        res = pf.run(1, movie.frames)
        got = counts(all_k)
        t_first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(got == dist_launches(kind, all_k, stages),
              f"domain {kind} launches {got}")
        check(patch_k.per_member_launches == FRAMES
              and patch_k.variants == {"separable": FRAMES, "direct": 0},
              f"domain {kind}: B3 per-member launches "
              f"{patch_k.per_member_launches}, variants {patch_k.variants}")
        rep = replicated[kind]
        for f in ("estimates", "ess", "log_marginal", "resampled"):
            check(same_bits(getattr(res, f), rep[f]),
                  f"domain {kind}: {f} differs from the replicated run")
        for f in ("state", "log_weights", "counts"):
            check(same_bits(getattr(res.final, f), getattr(rep["final"], f)),
                  f"domain {kind}: final {f} differs from the replicated "
                  f"run")
        moved, over = res.diag["mig_moved"], res.diag["mig_overflow"]
        check(int(over.abs().sum()) == 0, f"domain {kind}: overflow {over}")
        check(bool((moved > 0).all()), f"domain {kind}: frames with nothing "
                                       f"moved: {moved}")
        t0 = time.perf_counter()
        res2 = pf.run(1, movie.frames)
        torch.cuda.synchronize()
        fps = FRAMES / (time.perf_counter() - t0)
        check(same_bits(res.estimates, res2.estimates)
              and same_bits(res.final.state, res2.final.state),
              f"domain {kind} not repeatable")
        tr = track(res, movie)
        runs[kind] = {"launches": got, "track": tr, "frames_per_s": fps,
                      "first_run_frames_per_s": FRAMES / t_first,
                      "mig_moved_per_frame": [int(v) for v in moved],
                      "peak_bytes": peak, "base_bytes": base,
                      "slab_bytes": slab_b, "frame_bytes": frame_b}
        log(f"domain {kind} 8 x 2^22 on 2x4 tiles of 512x512: bitwise equal "
            f"to the replicated run (estimates, ESS, log-marginal, resampled,"
            f" final ensemble), RMSE {tr['rmse']:.4f} px, B3 per-member "
            f"launches {FRAMES}/{FRAMES}, mig_overflow 0, mig_moved/frame "
            f"{int(moved.min())}-{int(moved.max())}, launches {got}, "
            f"{fps:.2f} frames/s steady ({FRAMES / t_first:.2f} first run); "
            f"observation {slab_b} B a slab against {frame_b} B a frame; "
            f"peak memory {peak / 2 ** 30:.2f} GiB (before the run "
            f"{base / 2 ** 30:.2f}) [{name}]")
        del res, res2, pf
        torch.cuda.empty_cache()

    # a bounded window: the overflow residents stay home, with the
    # migration recorded frame by frame around the step's own call
    spec_k = make_domain_spec(cfg, p, k_cap=2 ** 16)
    orig = domain_mod._migrate_route
    rec = []

    def recording(spec, ens, yx, mesh):
        plan, route, merged, diag = orig(spec, ens, yx, mesh)
        live = torch.where(torch.isfinite(ens.log_weights), ens.counts,
                           torch.zeros_like(ens.counts))
        rec.append((live.sum(-1), route.kept_counts.sum(-1),
                    route.send_units.sum((-2, -1)), route.overflow_units,
                    plan.row_send.sum(-1), diag))
        return plan, route, merged, diag

    pf = ParallelParticleFilter(model=model, sir=SIRConfig(
        n_particles=p * c, ess_frac=0.5), mesh=EmulatedMesh(p),
        dra=dras["rna"], domain=spec_k)
    domain_mod._migrate_route = recording
    try:
        res = pf.run(1, movie.frames)
    finally:
        domain_mod._migrate_route = orig
    check(len(rec) == FRAMES, f"bounded run recorded {len(rec)} frames")
    check(bool(torch.isfinite(res.estimates).all()
               and torch.isfinite(res.ess).all()
               and torch.isfinite(res.log_marginal).all()),
          "bounded domain run: non-finite outputs")
    for k, (units, kept, shipped, over, sched, diag) in enumerate(rec):
        check(torch.equal(kept.long() + shipped.long(), units.long()),
              f"bounded run frame {k}: kept + shipped != units per shard")
        check(int(diag["mig_moved"]) == int(sched.sum() - over.sum())
              == int(shipped.sum()) == int(res.diag["mig_moved"][k])
              and int(diag["mig_overflow"]) == int(over.sum())
              == int(res.diag["mig_overflow"][k]),
              f"bounded run frame {k}: migration diagnostics")
    tr = track(res, movie)
    over = res.diag["mig_overflow"]
    runs["rna_k_cap_2^16"] = {
        "track": tr, "mig_overflow_per_frame": [int(v) for v in over],
        "mig_moved_per_frame": [int(v) for v in res.diag["mig_moved"]]}
    log(f"domain rna k_cap=2^16: finite, kept + shipped == units on every "
        f"shard and frame, diagnostics as defined; mig_overflow total "
        f"{int(over.sum())} (max {int(over.max())}/frame), mig_moved total "
        f"{int(res.diag['mig_moved'].sum())}, RMSE {tr['rmse']:.4f} px "
        f"(no gate: the overflow residents' likelihood is clamped) [{name}]")
    del res, pf, rec
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# Phases 5f and 5g: the bank over the mesh, and the rest of the filter layer
# ---------------------------------------------------------------------------

BANK_B, BANK_P, BANK_C = 4, 8, 2 ** 22
ASIR_GRID, ASIR_BINS, ASIR_ROWS = 256, 4, 262144
FAMILY_FRAMES, FAMILY_N = 200, 2 ** 22
SMOOTH_N, SMOOTH_T = 2 ** 20, 24
# tests/test_genealogy.py's seeds and smoother slacks (slack · sqrt(mean
# tr P_t|T / N), tests/stats.py's smoother_mean_bound)
SMOOTH_SEEDS = {"ar1": 11, "spiral": 13}
SMOOTH_SLACKS = {"ar1": 14.0, "spiral": 16.0}


def bank_launches(kind, all_k) -> dict:
    """A 40-frame bank run over the mesh: B3 and the kind's comb once a
    frame for the whole bank."""
    want = {k: 0 for k in all_k}
    want["patch_log_likelihood"] = FRAMES
    want["systematic_ancestors" if kind == "rna" else "prefix_sum"] = FRAMES
    return want


def run_bank_mesh(dev, model, movie, dras, replicated, all_k, reset, counts,
                  name) -> tuple[dict, object]:
    """Phase 5f: ``FilterBank(mesh=EmulatedMesh(8), dra=...)`` with B = 4
    members of N = 2^25 (C = 2^22 a shard): 2^27 particles, four users of
    the paper's 33.5M-particle filter.  Member 0 takes phase 5c's seed and
    movie, the others their own.  RNA and RPA, each twice: every member
    under the tracking gate, member 0 bit for bit phase 5c's standalone run
    of the same DRA, the two runs bit for bit equal, one launch of B3 and
    of the comb a frame for the bank; RNA once more on a (2, 8) bank x data
    grid with ``bank_axis``, bit for bit the bank without it.  Returns the
    record and RNA's final (32, 2^22, 5) particles with the last frames,
    phase 6's B3 input at the bank shape."""
    import torch
    from repro_torch.core import FilterBank, SIRConfig
    from repro_torch.core.runtime import EmulatedMesh, make_mesh
    from repro_torch.kernels.patch_likelihood import \
        patch_log_likelihood_kernel as patch_k
    movies = [movie] + [make_movie(20 + i, model.cfg, dev)
                        for i in range(BANK_B - 1)]
    frames = torch.stack([m.frames for m in movies])
    seeds = [1] + [201 + i for i in range(BANK_B - 1)]
    sir = SIRConfig(n_particles=BANK_P * BANK_C, ess_frac=0.5)
    runs, b3_input = {}, None
    for kind in ("rna", "rpa"):
        bank = FilterBank(model=model, sir=sir, mesh=EmulatedMesh(BANK_P),
                          dra=dras[kind])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        t0 = time.perf_counter()
        res = bank.run(seeds, frames)
        got = counts(all_k)
        t_first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(got == bank_launches(kind, all_k),
              f"bank-mesh {kind} launches {got}")
        check(patch_k.variants == {"separable": FRAMES, "direct": 0},
              f"bank-mesh {kind} patch variants {patch_k.variants}")
        check(res.final.state.shape == (BANK_B, BANK_P, BANK_C, 5),
              f"bank-mesh {kind}: final {tuple(res.final.state.shape)}")
        rep = replicated[kind]
        for f in ("estimates", "ess", "log_marginal", "resampled"):
            check(same_bits(getattr(res, f)[0], rep[f]),
                  f"bank-mesh {kind}: member 0 {f} differs from phase 5c")
        for f in ("state", "log_weights", "counts"):
            check(same_bits(getattr(res.final, f)[0],
                            getattr(rep["final"], f)),
                  f"bank-mesh {kind}: member 0 final {f} differs from 5c")
        t0 = time.perf_counter()
        res2 = bank.run(seeds, frames)
        torch.cuda.synchronize()
        fps = FRAMES / (time.perf_counter() - t0)
        for f in ("estimates", "ess", "log_marginal", "resampled"):
            check(same_bits(getattr(res, f), getattr(res2, f)),
                  f"bank-mesh {kind}: {f} not repeatable")
        for f in ("state", "log_weights", "counts"):
            check(same_bits(getattr(res.final, f), getattr(res2.final, f)),
                  f"bank-mesh {kind}: final {f} not repeatable")
        del res2
        tracks = [track(res, m, i) for i, m in enumerate(movies)]
        gate_tracks(tracks, f"bank-mesh {kind} member")
        runs[kind] = {"launches": got, "tracks": tracks,
                      "frames_per_s": fps,
                      "first_run_frames_per_s": FRAMES / t_first,
                      "peak_bytes": peak, "base_bytes": base}
        log(f"bank-mesh {kind} B={BANK_B} x 8 x 2^22 = 2^27 particles, "
            f"512x512: member 0 bitwise == phase 5c's standalone run, two "
            f"runs bitwise equal, launches {got}, {fps:.2f} bank frames/s "
            f"steady ({FRAMES / t_first:.2f} first run), peak memory "
            f"{peak / 2 ** 30:.2f} GiB (before the run "
            f"{base / 2 ** 30:.2f}) [{name}]")
        log(f"bank-mesh {kind} members: {fmt_tracks(tracks)}")
        if kind == "rna":
            grid = make_mesh((2, BANK_P), ("bank", "data"))
            laid = FilterBank(model=model, sir=sir, mesh=grid,
                              dra=dras[kind], bank_axis="bank").run(seeds,
                                                                   frames)
            for f in ("estimates", "ess", "log_marginal", "resampled"):
                check(same_bits(getattr(laid, f), getattr(res, f)),
                      f"bank_axis: {f} differs from the bank without it")
            for f in ("state", "log_weights", "counts"):
                check(same_bits(getattr(laid.final, f),
                                getattr(res.final, f)),
                      f"bank_axis: final {f} differs")
            del laid
            log(f"bank-mesh rna on a (2, 8) bank x data grid with bank_axis:"
                f" bitwise equal to the bank without it [{name}]")
            b3_input = (res.final.state.reshape(-1, BANK_C, 5),
                        frames[:, -1, None].expand(
                            BANK_B, BANK_P, *frames.shape[2:]).reshape(
                            -1, *frames.shape[2:]))
        del res, bank
        torch.cuda.empty_cache()
    return runs, b3_input


# ---------------------------------------------------------------------------
# Phase 5i: one process a shard over a torch.distributed group
# ---------------------------------------------------------------------------

# 5c's mesh as processes: 8 ranks of 2^22 particles on the one card
PROC_P, PROC_C = 8, 2 ** 22
# proc-grid-bank-rna: the 8 ranks as a (bank, data) grid, GRID_B members of
# GRID_SHAPE[1] x 2^22 particles each (2 members x 2^22 a rank); the
# emulated reference holds GRID_B x 2^24 = 2^26 particles, half of 5f's
GRID_SHAPE, GRID_B = (2, 4), 4
GRID_N = GRID_SHAPE[1] * PROC_C
# proc-sessions: 5h's sessions on SESS_RANKS ranks of the bank axis;
# session SESS_OUT leaves the ranks (suspended) at tick SESS_OUT_AT and
# finishes on a single-device server
SESS_RANKS, SESS_OUT, SESS_OUT_AT = 4, 5, 30

def run_group(cmd, env, timeout: float, log_path: str) -> None:
    """Run ``cmd`` (``torchrun`` and its ranks) in a session of its own,
    its output to ``log_path``; on a failure or past ``timeout`` kill the
    whole session and raise with the log's tail."""
    import signal
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    if rc != 0:
        tail = open(log_path).read()[-4000:]
        raise AssertionError(f"{cmd[:6]} ... "
                             f"{'timed out' if rc is None else f'rc {rc}'}"
                             f":\n{tail}")


def run_processes(dev, movie, replicated, row_sum_cells, name) -> dict:
    """Phase 5i: the paper's distributed filter as ``PROC_P`` processes, one
    shard each, over a gloo group on this one card
    (``python -m torch.distributed.run --standalone --nproc-per-node 8 -m
    repro_torch.launch.track --transport gloo``): RNA and RPA at 5c's
    width, seed and movie, and a 2-member RNA bank (member 0 on 5c's
    seed).  Every rank's outputs and diag, its final shard and the
    ensemble gathered from the ranks must be 5c's bit for bit (bank
    member 0 too); each rank must launch B3 once a frame, B1 (RNA) or
    the comb scan (RPA) once a frame, and the row sum as often a frame as
    5c (5f for the bank).  Then the nccl transport at world size 1:
    every verb bit for bit ``EmulatedMesh(1)``'s.  Frames/s (eight
    processes time-sharing one card: contention, not a multi-card
    filter), the bytes staged between the card and host memory a frame
    and the phase's seconds are printed, not gated."""
    import numpy as np
    import torch
    from repro_torch.core.runtime import EmulatedMesh
    from repro_torch.launch import grid as launch_grid
    from repro_torch.launch import mesh as launch_mesh
    t_phase = time.perf_counter()
    p, particles = PROC_P, PROC_P * PROC_C
    tmp = os.path.join(ROOT, ".chip_scratch", "processes")
    os.makedirs(tmp, exist_ok=True)
    movie_path = os.path.join(tmp, "movie.npy")
    np.save(movie_path, movie.frames.cpu().numpy())
    out_dir = os.path.join(tmp, "out")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [x for x in [os.environ.get("PYTHONPATH")] if x]),
        OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(p), "-m", "repro_torch.launch.track",
           "--transport", "gloo", "--device", dev.type, "--dra", "rna", "rpa",
           "--bank", "2", "--particles", str(particles),
           "--frames", str(FRAMES), "--seed", "1", "--movie", movie_path,
           "--out", out_dir]
    t0 = time.perf_counter()
    try:
        run_group(cmd, env, 900, os.path.join(tmp, "torchrun.log"))
        t_run = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(p)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        os.remove(movie_path)
    want_launch = {
        "rna": {"patch_log_likelihood": FRAMES,
                "systematic_ancestors": FRAMES, "prefix_sum": 0,
                "row_sum": round(row_sum_cells["rna"] * FRAMES)},
        "rpa": {"patch_log_likelihood": FRAMES, "systematic_ancestors": 0,
                "prefix_sum": FRAMES,
                "row_sum": round(row_sum_cells["rpa"] * FRAMES)},
        "bank-rna": {"patch_log_likelihood": FRAMES,
                     "systematic_ancestors": FRAMES, "prefix_sum": 0,
                     "row_sum": round(row_sum_cells["bank-mesh-rna"]
                                      * FRAMES)}}
    runs = {}
    for label, want in want_launch.items():
        kind = label.removeprefix("bank-")
        rep = replicated[kind]
        member = (lambda x: x[0]) if label.startswith("bank") \
            else (lambda x: x)
        for r, rec in enumerate(ranks):
            check((rec["rank"], rec["world"], rec["transport"])
                  == (r, p, "gloo"), f"5i rank file {r}: {rec['rank']}, "
                  f"{rec['world']}, {rec['transport']}")
            got = rec["runs"][label]
            for f in ("estimates", "ess", "log_marginal", "resampled"):
                check(same_bits(member(got[f]), rep[f].cpu()),
                      f"5i {label} rank {r}: {f} differs from phase 5c")
            check(set(got["diag"]) == set(rep["diag"]),
                  f"5i {label} rank {r}: diag keys {sorted(got['diag'])}")
            for k, v in rep["diag"].items():
                check(same_bits(member(got["diag"][k]), v.cpu()),
                      f"5i {label} rank {r}: diag {k} differs from 5c")
            for f in ("state", "log_weights", "counts"):
                shard = member(got["final"][f])
                check(shard.shape[0] == 1 and same_bits(
                    shard[0], getattr(rep["final"], f)[r].cpu()),
                    f"5i {label} rank {r}: final {f} differs from 5c")
            check(got["launches"] == want,
                  f"5i {label} rank {r}: launches {got['launches']}, "
                  f"want {want}")
        for f in ("state", "log_weights", "counts"):
            gathered = torch.cat([member(rec["runs"][label]["final"][f])
                                  for rec in ranks])
            check(same_bits(gathered, getattr(rep["final"], f).cpu()),
                  f"5i {label}: gathered final {f} differs from 5c")
        if label.startswith("bank"):
            other = ranks[0]["runs"][label]
            check(bool(torch.isfinite(other["ess"][1]).all()
                       and torch.isfinite(other["log_marginal"][1]).all()),
                  "5i bank member 1: non-finite ESS / log-marginal")
        secs = [rec["runs"][label]["seconds"] for rec in ranks]
        staged = [rec["runs"][label]["staged_bytes"] for rec in ranks]
        runs[label] = {
            "launches_per_rank": want,
            "frames_per_s": FRAMES / max(secs),
            "rank_seconds": secs,
            "staged_bytes_per_frame_per_rank": [s / FRAMES for s in staged],
            "staged_bytes_per_frame": sum(staged) / FRAMES}
        log(f"5i {label} over {p} gloo ranks on one card, "
            f"{particles // p} particles a rank: every rank and the gathered"
            f" ensemble bitwise == phase 5c{' member 0' if 'bank' in label else ''}"
            f", launches a rank {want}, {FRAMES / max(secs):.3f} frames/s "
            f"(contention of {p} processes on one card), staged "
            f"{sum(staged) / FRAMES:.0f} B a frame in all [{name}]")
    # the nccl transport at world size 1: every verb, ppermute and
    # all_to_all to itself included, bit for bit the one-shard mesh's
    inputs = launch_mesh.verb_inputs(1)
    got = launch_mesh.spawn(launch_mesh.verbs, 1, (inputs, "cuda"),
                            transport="nccl", deadline=300)[0]
    want = launch_mesh.verbs(EmulatedMesh(1), inputs, dev)
    check(set(got) == set(want), f"5i nccl verbs {sorted(got)}")
    for k, v in want.items():
        check(same_bits(got[k], v), f"5i nccl verb {k} differs from "
                                     f"EmulatedMesh(1)")
    log(f"5i nccl transport, world size 1: {len(want)} verb results "
        f"bitwise == EmulatedMesh(1) [{name}]")
    # the same on a (1, 1) process grid: each axis's sub-group
    grid_inputs = {"bank": [inputs], "data": [launch_mesh.verb_inputs(1, 1)]}
    got = launch_mesh.spawn(launch_grid.grid_checks, 1, ({
        "axis_shapes": (1, 1), "axis_names": ("bank", "data"),
        "verbs": grid_inputs}, "cuda"), transport="nccl", deadline=300)[0]
    for axis, ins in grid_inputs.items():
        want_g = launch_mesh.verbs(EmulatedMesh(1), ins[0], dev)
        check(set(got["verbs"][axis]) == set(want_g),
              f"5i nccl grid verbs on {axis}: {sorted(got['verbs'][axis])}")
        for k, v in want_g.items():
            check(same_bits(got["verbs"][axis][k], v),
                  f"5i nccl grid verb {k} on {axis} differs from "
                  f"EmulatedMesh(1)")
    log(f"5i nccl transport, a (1, 1) process grid: {len(want)} verbs on "
        f"each axis's sub-group bitwise == EmulatedMesh(1) [{name}]")
    t0 = time.perf_counter()
    grid = run_proc_grid(dev, movie, row_sum_cells, tmp, env, name)
    runs.update(grid.pop("runs"))
    seconds = time.perf_counter() - t_phase
    log(f"5i: torchrun {t_run:.1f} s, grid {time.perf_counter() - t0:.1f} "
        f"s, phase {seconds:.1f} s [{name}]")
    return {"p": p, "particles": particles, "runs": runs,
            "torchrun_seconds": t_run, "seconds": seconds,
            "nccl_verbs": sorted(want), "grid": grid}


def run_proc_grid(dev, movie, row_sum_cells, tmp, env, name) -> dict:
    """5i's proc-grid-bank-rna: ``launch.track --grid 2x4`` on 8 gloo
    ranks, a GRID_B-member RNA bank with ``bank_axis`` and RNA alone on the
    data axis, held to the same bank on an emulated (2, 4) grid in this
    process (itself held to the bank on ``EmulatedMesh(4)``)."""
    import numpy as np
    import torch
    from repro_torch.core.runtime import EmulatedMesh, make_mesh
    from repro_torch.launch import track as launch_track
    p = math.prod(GRID_SHAPE)
    per = GRID_B // GRID_SHAPE[0]
    seeds = [1 + i for i in range(GRID_B)]
    frames = movie.frames.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = launch_track.run(make_mesh(GRID_SHAPE, ("bank", "data")), frames,
                            "rna", GRID_N, bank=seeds, bank_axis="bank",
                            device=dev)
    flat = launch_track.run(EmulatedMesh(GRID_SHAPE[1]), frames, "rna",
                            GRID_N, bank=seeds, device=dev)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    t_ref = time.perf_counter() - t0
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        check(same_bits(flat[f], want[f]), f"5i grid: emulated grid bank {f} "
                                           f"differs from EmulatedMesh(4)'s")
    for k, v in want["diag"].items():
        check(same_bits(flat["diag"][k], v), f"5i grid: emulated grid bank "
                                             f"diag {k} differs")
    for f, v in want["final"].items():
        check(same_bits(flat["final"][f], v), f"5i grid: emulated grid bank "
                                              f"final {f} differs")
    check(want["launches"]["patch_log_likelihood"] == FRAMES
          and want["launches"]["systematic_ancestors"] == FRAMES,
          f"5i grid: emulated launches {want['launches']}")
    del flat
    movie_path = os.path.join(tmp, "grid-movie.npy")
    np.save(movie_path, frames)
    out_dir = os.path.join(tmp, "grid-out")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(p), "-m", "repro_torch.launch.track",
           "--transport", "gloo", "--device", dev.type, "--dra", "rna",
           "--bank", str(GRID_B), "--grid",
           "x".join(map(str, GRID_SHAPE)), "--particles", str(GRID_N),
           "--frames", str(FRAMES), "--seed", "1", "--movie", movie_path,
           "--out", out_dir]
    t0 = time.perf_counter()
    try:
        run_group(cmd, env, 900, os.path.join(tmp, "torchrun-grid.log"))
        t_run = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(p)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        os.remove(movie_path)
    want_launch = {
        "grid-rna": {"patch_log_likelihood": FRAMES,
                     "systematic_ancestors": FRAMES, "prefix_sum": 0,
                     "row_sum": round(row_sum_cells["rna"] * FRAMES)},
        "grid-bank-rna": {"patch_log_likelihood": FRAMES,
                          "systematic_ancestors": FRAMES, "prefix_sum": 0,
                          "row_sum": round(row_sum_cells["bank-mesh-rna"]
                                           * FRAMES)}}
    runs = {}
    for label, launches in want_launch.items():
        bank = label == "grid-bank-rna"
        member = (lambda x: x) if bank else (lambda x: x[0])
        for r, rec in enumerate(ranks):
            b, d = divmod(r, GRID_SHAPE[1])
            check((rec["rank"], rec["world"], rec["transport"])
                  == (r, p, "gloo"), f"5i grid rank file {r}")
            got = rec["runs"]["bank-rna" if bank else "rna"]
            for f in ("estimates", "ess", "log_marginal", "resampled"):
                check(same_bits(got[f], member(want[f])),
                      f"5i {label} rank {r}: {f} differs from the emulated "
                      f"grid")
            check(set(got["diag"]) == set(want["diag"]),
                  f"5i {label} rank {r}: diag keys {sorted(got['diag'])}")
            for k, v in want["diag"].items():
                check(same_bits(got["diag"][k], member(v)),
                      f"5i {label} rank {r}: diag {k} differs")
            for f, v in want["final"].items():
                # (B, P, C, ...): the rank's members (member 0 for the
                # filter) on its data shard
                mine = v[b * per:(b + 1) * per, d:d + 1] if bank \
                    else v[0, d:d + 1]
                check(same_bits(got["final"][f], mine),
                      f"5i {label} rank {r}: final {f} differs")
            check(got["launches"] == launches,
                  f"5i {label} rank {r}: launches {got['launches']}, want "
                  f"{launches}")
        key = "bank-rna" if bank else "rna"
        secs = [rec["runs"][key]["seconds"] for rec in ranks]
        staged = [rec["runs"][key]["staged_bytes"] for rec in ranks]
        runs[label] = {
            "launches_per_rank": launches, "frames_per_s": FRAMES / max(secs),
            "rank_seconds": secs,
            "staged_bytes_per_frame_per_rank": [x / FRAMES for x in staged],
            "staged_bytes_per_frame": sum(staged) / FRAMES}
        log(f"5i proc-{label} on a {GRID_SHAPE} (bank, data) grid of {p} "
            f"gloo ranks on one card, "
            f"{'2 members x ' if bank else ''}2^22 particles a rank: every "
            f"rank bitwise == the emulated grid"
            f"{'' if bank else ' bank member 0'}, launches a rank "
            f"{launches}, {FRAMES / max(secs):.3f} frames/s (contention of "
            f"{p} processes on one card), staged "
            f"{sum(staged) / FRAMES:.0f} B a frame in all [{name}]")
    log(f"5i grid: emulated references (grid and EmulatedMesh(4), "
        f"{GRID_B} x 2^{GRID_N.bit_length() - 1}) {t_ref:.1f} s, peak "
        f"{peak:.2f} GiB above the script's own; torchrun {t_run:.1f} s "
        f"[{name}]")
    return {"runs": runs, "reference_seconds": t_ref, "reference_peak_gib":
            peak, "torchrun_seconds": t_run}


def proc_session_ops() -> list:
    """5h's churn as a ``launch.grid.serve_ops`` script for the process
    server: the sessions attach at SERVE_STARTS (seeds 900 + i), session
    2 is suspended at tick 20 and resumed on the same server at 26 (5h's
    schedule), session SESS_OUT is suspended at tick SESS_OUT_AT and
    leaves; each finished session's result is kept, then it detaches."""
    ops, fed, live, left = [], {}, set(), set(range(len(SERVE_STARTS)))
    left.discard(SESS_OUT)
    tick = 0
    while left:
        for i, start in enumerate(SERVE_STARTS):
            if tick == start:
                ops.append(("attach", i, 900 + i))
                live.add(i)
                fed[i] = 0
        if tick == SERVE_SUSPEND[2][0]:
            ops.append(("suspend", 2))
            live.discard(2)
        if tick == SERVE_SUSPEND[2][1]:
            ops.append(("resume", 2, None))
            live.add(2)
        if tick == SESS_OUT_AT:
            ops.append(("suspend", SESS_OUT))
            live.discard(SESS_OUT)
        for i in sorted(live):
            ops.append(("submit", i, fed[i]))
            fed[i] += 1
        ops.append(("step",))
        for i in sorted(live):
            if fed[i] == FRAMES:
                ops.append(("result", i))
                live.discard(i)
                left.discard(i)
        tick += 1
    return ops


def run_proc_sessions(dev, model, solo, name) -> dict:
    """5i's proc-sessions (run after 5h, whose composed standalone filters
    it is held to): ``ParticleSessionServer`` over SESS_RANKS spawned gloo
    ranks on the bank axis, capacity SERVE_CAP (2 slots a rank), 5h's 12
    tracking sessions of SERVE_N particles, composed, under 5h's churn.
    Every session on every rank bit for bit its standalone filter (the
    final ensemble by digest); session SESS_OUT, suspended on the ranks
    (the same bits on each), finishes on a single-device server in this
    process bit for bit; each rank launches one B3 and one comb scan a
    tick."""
    import torch
    from repro_torch.core import SIRConfig
    from repro_torch.launch import grid as launch_grid
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.serve import ParticleSessionServer
    t_phase = time.perf_counter()
    sir = {"n_particles": SERVE_N, "ess_frac": 0.5,
           "step_backend": "composed"}
    case = {"tracking": {}, "n_frames": FRAMES,
            "movies": {i: 50 + i for i in range(len(SERVE_STARTS))},
            "sir": sir, "capacity": SERVE_CAP, "bank_axis": "bank",
            "ops": proc_session_ops(), "digest": True}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ranks = launch_mesh.spawn(launch_grid.grid_checks, SESS_RANKS, ({
        "axis_shapes": (SESS_RANKS,), "axis_names": ("bank",),
        "sessions": [case]}, dev.type), transport="gloo", deadline=600,
        timeout=300)
    outs = [rank["sessions"][0] for rank in ranks]
    ticks = outs[0]["ticks"]
    want_launch = {"patch_log_likelihood": ticks,
                   "systematic_ancestors": 0, "prefix_sum": ticks}
    for r, got in enumerate(outs):
        check(got["ticks"] == ticks and got["step_traces"] == 1
              and got["tiers"] == (SERVE_CAP,),
              f"5i proc-sessions rank {r}: ticks {got['ticks']}, step "
              f"programs {got['step_traces']}, tiers {got['tiers']}")
        check(set(got["results"]) == set(solo) - {SESS_OUT},
              f"5i proc-sessions rank {r}: results {sorted(got['results'])}")
        for i, res in got["results"].items():
            for f in ("estimates", "ess", "log_marginal", "resampled"):
                check(same_bits(res[f], solo[i][f]),
                      f"5i proc-sessions rank {r}: session {i} {f} differs "
                      f"from its standalone filter")
            check(res["final"] == solo[i]["final"],
                  f"5i proc-sessions rank {r}: session {i} final ensemble "
                  f"differs from its standalone filter")
        launches = {k: got["launches"][k] for k in want_launch}
        check(launches == want_launch,
              f"5i proc-sessions rank {r}: launches {launches}, want "
              f"{want_launch} (one a tick)")
        check(got["suspended_digest"] == outs[0]["suspended_digest"],
              f"5i proc-sessions rank {r}: suspended session differs from "
              f"rank 0's")
    # session SESS_OUT, suspended on the ranks, finishes on one device
    sus = outs[0]["suspended"][SESS_OUT]
    movie = make_movie(50 + SESS_OUT, model.cfg, dev)
    srv = ParticleSessionServer(model, SIRConfig(**sir), capacity=1)
    h = srv.resume(sus)
    for k in range(sus.frames_done, FRAMES):
        srv.submit(h, movie.frames[k])
    res = srv.result(h)
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        check(same_bits(getattr(res, f), solo[SESS_OUT][f]),
              f"5i proc-sessions: session {SESS_OUT} resumed on one device: "
              f"{f} differs from its standalone filter")
    check(launch_grid.digest({f: getattr(res.final, f) for f in (
        "state", "log_weights", "counts")}) == solo[SESS_OUT]["final"],
          f"5i proc-sessions: session {SESS_OUT} resumed on one device: "
          f"final ensemble differs")
    del srv, res, movie, sus
    secs = [got["seconds"] for got in outs]
    staged = [rank["staged_bytes"] for rank in ranks]
    frames_done = sum(op[0] == "submit" for op in case["ops"])
    rec = {"ranks": SESS_RANKS, "ticks": ticks,
           "launches_per_rank": want_launch, "rank_seconds": secs,
           "ticks_per_s": ticks / max(secs),
           "session_frames_per_s": frames_done / max(secs),
           "staged_bytes_per_tick": sum(staged) / ticks,
           "seconds": time.perf_counter() - t_phase}
    log(f"5i proc-sessions: {len(solo)} x 2^{SERVE_N.bit_length() - 1} "
        f"sessions on {SESS_RANKS} gloo ranks of the bank axis (capacity "
        f"{SERVE_CAP}, 2 slots a rank), 5h's churn: every session on every "
        f"rank bitwise == its standalone filter, session {SESS_OUT} "
        f"suspended on the ranks at tick {SESS_OUT_AT} and finished on one "
        f"device bitwise; {ticks} ticks, launches a rank {want_launch}; "
        f"{rec['ticks_per_s']:.2f} ticks/s, {rec['session_frames_per_s']:.2f}"
        f" session frames/s (contention of {SESS_RANKS} processes on one "
        f"card), staged {rec['staged_bytes_per_tick']:.0f} B a tick in all, "
        f"phase {rec['seconds']:.1f} s [{name}]")
    return rec


def stepwise(model, sir, seed, zs, dev):
    """The single-device SIR run step by step, as ``run_sir`` drives it,
    with every step's ``logsumexp`` of the carried log-weights (the
    normalization gate) and the outputs for a bitwise repeat check."""
    import torch
    from repro_torch.core import particles, smc
    from repro_torch.core.draws import as_draws
    draws = as_draws(seed, dev)
    carry = smc.SIRCarry(draws, particles.init_ensemble(
        draws, model.init, sir.n_particles))
    step = smc.make_sir_step(model, sir)
    lse, outs = [], []
    for k in range(zs.shape[0]):
        carry, out = step(carry, zs[k])
        lse.append(torch.logsumexp(carry.ensemble.log_weights, -1))
        outs.append(out)
    return torch.stack(lse), smc.stack_outputs(outs), carry.ensemble


def run_families(dev, all_k, reset, counts, name) -> dict:
    """Phase 5g's stochastic volatility and Lorenz-96 (the reference's
    defaults: mu -1, phi 0.97, sigma 0.3; D 8, F 8, stride 2) at N = 2^22,
    200 frames simulated on the card, 8 seeds, fused and composed steps:
    every output finite, ESS in [1, N], seed 0 step by step with the
    carried weights normalized after every step and bit for bit the
    filter's run, B2 once a frame (fused) or the comb scan once a frame
    (composed), and the two backends' mean summed log-marginals within 4
    standard errors over the seeds."""
    import torch
    from repro_torch.core import ParallelParticleFilter, SIRConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.models import ssm
    out = {}
    for fam, model in (("stochvol", ssm.StochasticVolatilitySSM()),
                       ("lorenz96", ssm.Lorenz96SSM())):
        sims = [ssm.simulate(TorchDraws.from_seed(300 + s, dev), model,
                             FAMILY_FRAMES)[1] for s in range(N_SEEDS)]
        totals, rec = {}, {}
        for backend, kname in (("fused", "fused_weight_step"),
                               ("composed", "prefix_sum")):
            sir = SIRConfig(n_particles=FAMILY_N, ess_frac=0.5,
                            step_backend=backend)
            pf = ParallelParticleFilter(model=model, sir=sir)
            sums = []
            for s in range(N_SEEDS):
                if s == 0:
                    reset()
                    t0 = time.perf_counter()
                res = pf.run(400 + s, sims[s])
                if s == 0:
                    got = counts(all_k)
                    secs = time.perf_counter() - t0
                    want = {k: 0 for k in all_k}
                    want[kname] = FAMILY_FRAMES
                    check(got == want, f"{fam} {backend} launches {got}")
                    lse, souts, final = stepwise(model, sir, 400, sims[0],
                                                 dev)
                    check(float(lse.abs().max()) < 1e-4,
                          f"{fam} {backend}: weights not normalized after "
                          f"every step (max |logsumexp| "
                          f"{float(lse.abs().max()):.3g})")
                    for f, g in (("estimates", "estimate"), ("ess", "ess"),
                                 ("log_marginal", "log_marginal"),
                                 ("resampled", "resampled")):
                        check(same_bits(getattr(res, f), getattr(souts, g)),
                              f"{fam} {backend}: {f} not repeatable")
                    check(same_bits(res.final.state, final.state),
                          f"{fam} {backend}: final state not repeatable")
                    rec[backend] = {"launches": got,
                                    "frames_per_s": FAMILY_FRAMES / secs,
                                    "max_abs_log_sum_weights":
                                        float(lse.abs().max())}
                check(bool(torch.isfinite(res.estimates).all()
                           and torch.isfinite(res.log_marginal).all()
                           and torch.isfinite(res.ess).all()),
                      f"{fam} {backend} seed {s}: non-finite outputs")
                ess = res.ess.double()
                check(float(ess.min()) >= 1.0 - 1e-3
                      and float(ess.max()) <= FAMILY_N * (1 + 1e-5),
                      f"{fam} {backend} seed {s}: ESS outside [1, N]")
                sums.append(float(res.log_marginal.double().sum()))
            totals[backend] = sums
            rec[backend]["summed_log_marginals"] = sums
        mf, mc = (statistics.mean(totals[b]) for b in ("fused", "composed"))
        se = math.sqrt((statistics.variance(totals["fused"])
                        + statistics.variance(totals["composed"]))
                       / N_SEEDS)
        check(abs(mf - mc) <= 4 * se, f"{fam}: fused and composed mean "
                                      f"summed log-marginals {mf:.3f} / "
                                      f"{mc:.3f} beyond 4 SE ({se:.3f})")
        rec["mean_gap_in_se"] = abs(mf - mc) / se
        out[fam] = rec
        log(f"{fam} N=2^22, {FAMILY_FRAMES} frames simulated on the card, "
            f"{N_SEEDS} seeds: mean summed log-marginal fused {mf:.3f}, "
            f"composed {mc:.3f} ({abs(mf - mc) / se:.2f} SE apart); "
            f"weights normalized after every step, ESS in [1, N], seed 0 "
            f"step by step bitwise the filter's run; fused "
            f"{rec['fused']['launches']['fused_weight_step']} B2 launches, "
            f"{rec['fused']['frames_per_s']:.1f} frames/s; composed "
            f"{rec['composed']['launches']['prefix_sum']} comb scans, "
            f"{rec['composed']['frames_per_s']:.1f} frames/s [{name}]")
        del sims
    return out


def run_asir(dev, model, movies, single, all_k, reset, counts,
             name) -> dict:
    """Phase 5g's ASIR: ``ASIRConfig(grid=256, intensity_bins=4)`` on the
    512x512 frame (2-px cells, the reference's test and benchmark cell
    size) at N = 2^22, fused step, phase 3's 8 seeds and movies: RMSE at
    most phase 3's exact RMSE for the seed + 2.5 px after the warm-up, and
    one B3 launch over the 262,144-row lattice and one B2 launch a
    frame."""
    import torch
    from repro_torch.core import ParallelParticleFilter, SIRConfig
    from repro_torch.core.asir import (ASIRConfig, lattice_states,
                                       make_asir_model)
    acfg = ASIRConfig(grid=ASIR_GRID, intensity_bins=ASIR_BINS)
    check(lattice_states(model.cfg, acfg, dev).shape == (ASIR_ROWS, 5),
          "ASIR lattice rows")
    am = make_asir_model(model, model.cfg, acfg, device=dev)
    pf = ParallelParticleFilter(model=am, sir=SIRConfig(
        n_particles=2 ** 22, ess_frac=0.5, step_backend="fused"))
    tracks = []
    for s, m in enumerate(movies):
        if s == 0:
            reset()
            t0 = time.perf_counter()
        res = pf.run(s + 1, m.frames)
        if s == 0:
            got = counts(all_k)
            fps = FRAMES / (time.perf_counter() - t0)
            want = {k: 0 for k in all_k}
            want.update({"patch_log_likelihood": FRAMES,
                         "fused_weight_step": FRAMES})
            check(got == want, f"ASIR launches {got}")
            res2 = pf.run(1, m.frames)
            check(same_bits(res.estimates, res2.estimates)
                  and same_bits(res.final.state, res2.final.state),
                  "ASIR not repeatable")
            del res2
        t = track(res, m)
        check(t["finite"], f"ASIR seed {s}: non-finite estimates")
        check(t["rmse"] <= single[s]["rmse"] + 2.5,
              f"ASIR seed {s}: RMSE {t['rmse']:.4f} beyond the exact "
              f"filter's {single[s]['rmse']:.4f} + 2.5 px")
        tracks.append(t)
    torch.cuda.synchronize()
    log(f"ASIR grid {ASIR_GRID}x{ASIR_GRID}x{ASIR_BINS} ({ASIR_ROWS} lattice "
        f"rows a B3 launch) N=2^22 fused, {len(movies)} seeds: "
        f"{fmt_tracks(tracks)}; exact filter's "
        f"{[round(t['rmse'], 4) for t in single]} (+2.5 px gate); launches "
        f"{got}, repeatable, {fps:.2f} frames/s (first run) [{name}]")
    return {"tracks": tracks, "launches": got, "first_run_frames_per_s": fps}


def run_smoothers(dev, name) -> dict:
    """Phase 5g's smoothers: ``ar1`` and ``spiral`` at N = 2^20, T = 24,
    ``record_ancestry=True`` (the composed step), observations simulated on
    the card: the reference's three gates (tests/test_genealogy.py) — the
    filter-smoother within the CLT bound of ``kalman_smoother`` with its
    slacks, smoothing beats filtering, lag 8 beats filtering."""
    import numpy as np
    from repro_torch.core import ParallelParticleFilter, SIRConfig
    from repro_torch.core import genealogy
    from repro_torch.core.draws import TorchDraws
    from repro_torch.models import ssm

    def rmse(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))

    out = {}
    for fam, seed in SMOOTH_SEEDS.items():
        model = ssm.oracle_configs()[fam]
        _, zs = ssm.simulate(TorchDraws.from_seed(seed, dev), model,
                             SMOOTH_T)
        res = ParallelParticleFilter(model=model, sir=SIRConfig(
            n_particles=SMOOTH_N, ess_frac=0.9, record_ancestry=True)).run(
            seed + 100, zs)
        oracle = ssm.kalman_smoother(model, zs)
        tr = np.trace(oracle.covs, axis1=-2, axis2=-1)
        bound = SMOOTH_SLACKS[fam] * float(np.sqrt(tr.mean() / SMOOTH_N))
        emis, lws = res.diag["emission"], res.diag["log_weights"]
        sm = genealogy.filter_smoother_mean(res.ancestors, emis, lws[-1])
        lag = genealogy.fixed_lag_smoother_mean(res.ancestors, emis, lws, 8)
        err = rmse(sm.cpu(), oracle.means)
        filt = rmse(res.estimates.cpu(), oracle.means)
        lag_err = rmse(lag.cpu(), oracle.means)
        check(err <= bound, f"{fam}: smoother RMSE {err:.4g} beyond the CLT "
                            f"bound {bound:.4g}")
        check(err < filt, f"{fam}: smoothing ({err:.4g}) does not beat "
                          f"filtering ({filt:.4g})")
        check(lag_err < filt, f"{fam}: lag 8 ({lag_err:.4g}) does not beat "
                              f"filtering ({filt:.4g})")
        out[fam] = {"smoother_rmse": err, "bound": bound,
                    "filter_rmse": filt, "lag8_rmse": lag_err}
        log(f"smoother {fam} N=2^20 T={SMOOTH_T}: RMSE to kalman_smoother "
            f"{err:.4g} (CLT bound {bound:.4g}), filtering {filt:.4g}, lag 8 "
            f"{lag_err:.4g} [{name}]")
    return out


def check_invariant_sums(dev) -> dict:
    """The fixed-order row sums (``particles.invariant_sum`` and
    ``invariant_logsumexp``) give a row the same bits alone, in a
    filter's 8 rows and in the bank over the mesh's 32, at the distributed
    step's shapes: 2^22 slots, butterfly's 2^22 + 32, the estimate's
    (2^22, 5) over the slots; torch's own sum, for contrast, is
    counted where it differs."""
    import torch
    from repro_torch.core.particles import (invariant_logsumexp,
                                            invariant_sum)
    g = torch.Generator(device=dev)
    g.manual_seed(45)
    torch_differs = 0
    for shape, dim in (((32, 2 ** 22), -1), ((32, 2 ** 22 + 32), -1),
                       ((32, 2 ** 22, 5), 1)):
        x = torch.randn(shape, generator=g, device=dev)
        for fn in (invariant_sum, invariant_logsumexp):
            whole = fn(x, dim)
            for rows in (1, 8):
                check(same_bits(fn(x[:rows].contiguous(), dim), whole[:rows]),
                      f"{fn.__name__} {shape}: {rows} rows alone differ "
                      f"from the same rows in the batch")
        torch_differs += int(not same_bits(x[:8].sum(dim), x.sum(dim)[:8]))
        del x
    log(f"fixed-order sums: a row's bits alone == in 8 == in 32 rows at 2^22,"
        f" 2^22 + 32 and (2^22, 5); torch's sum differs at "
        f"{torch_differs} of 3 shapes")
    return {"torch_sum_differs": torch_differs}


ROW_SUM_TOL = 1e-6         # relative to the float64 sum of |x|
# (outer, n, inner, seed): the sums' shapes; ragged rows about the tile
# (4096, and the first design's 1024); rows whose starts are not 16-byte
# aligned (n * inner % 4 != 0: the kernel's scalar loads); the estimate's
# view at inner = 5; inner = 40 and 48 (the generic path in one pass and
# in two)
ROW_SUM_CASES = [(1, 2 ** 22, 1, 71), (8, 2 ** 22, 1, 72),
                 (32, 2 ** 22, 1, 73), (1, 2 ** 22 - 1, 1, 74),
                 (3, 1025, 1, 75), (5, 1, 1, 76), (8, 2 ** 20, 5, 77),
                 (8, 2 ** 22 - 3, 1, 79), (7, 2 ** 22 + 5, 1, 80),
                 (4, 2 ** 22, 5, 81), (3, 4096 + 1, 1, 82),
                 (2, 2 ** 20 + 3, 40, 83), (2, 3 * 4096 + 5, 48, 84)]


def misaligned(x):
    """A copy of ``x`` whose data starts 4 bytes past a 16-byte boundary."""
    import torch
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def check_row_sum(dev) -> dict:
    """The row-sum kernel (``csrc/row_sum.cu``) at the sums' shapes: bit
    for bit its torch emulation and a second launch, with and without the
    shift (``exp(x - max)``, logsumexp's pass); within ROW_SUM_TOL of the
    float64 sum relative to ``Σ|x|`` (weights in [0, 1), and signed values
    at inner > 1, the estimate's view); a row's bits alone (a fresh,
    aligned copy) and in its batch, in 2, 4, 8 and 32 rows, and from a
    misaligned start; the plain version (torch's sum) and the first
    design within the same tolerance."""
    import torch
    from repro_torch.kernels.row_sum import (first_design_kernel,
                                             row_sum_emulated,
                                             row_sum_kernel, row_sum_ref)
    g = torch.Generator(device=dev)
    worst_rel, max_abs = 0.0, 0.0
    for outer, n, inner, seed in ROW_SUM_CASES:
        g.manual_seed(seed)
        x = (torch.randn if inner > 1 else torch.rand)(
            (outer, n, inner), generator=g, device=dev)
        got = row_sum_kernel(x)
        check(same_bits(got, row_sum_kernel(x)),
              f"row sum {x.shape}: two launches differ")
        check(same_bits(got, row_sum_emulated(x)),
              f"row sum {x.shape}: differs from its emulation")
        shift = x.amax(1)
        got_s = row_sum_kernel(x, shift)
        check(same_bits(got_s, row_sum_emulated(x, shift)),
              f"row sum {x.shape} with a shift: differs from its emulation")
        x64 = x.double()
        scale = x64.abs().sum(1)
        rel = float(((got.double() - x64.sum(1)).abs() / scale).max())
        exp64 = torch.exp(x64 - shift.double()[:, None])
        rel_s = float(((got_s.double() - exp64.sum(1)).abs()
                       / exp64.sum(1)).max())
        plain = row_sum_ref(x)
        rel_p = float(((plain.double() - x64.sum(1)).abs() / scale).max())
        first = first_design_kernel(x)
        rel_f = float(((first.double() - x64.sum(1)).abs() / scale).max())
        check(max(rel, rel_s, rel_p, rel_f) <= ROW_SUM_TOL,
              f"row sum {x.shape}: {rel:.3g} / shifted {rel_s:.3g} / plain "
              f"{rel_p:.3g} / first design {rel_f:.3g} from the float64 sum "
              f"(limit {ROW_SUM_TOL})")
        worst_rel = max(worst_rel, rel, rel_s)
        max_abs = max(max_abs, float((got - plain).abs().max()))
        for r in sorted({0, outer // 2, outer - 1}):
            check(same_bits(row_sum_kernel(x[r:r + 1].clone()),
                            got[r:r + 1]) and same_bits(
                      row_sum_kernel(x[r:r + 1].clone(),
                                     shift[r:r + 1].clone()),
                      got_s[r:r + 1]),
                  f"row sum {x.shape}: row {r} alone differs from the same "
                  f"row in the batch")
        if outer == 32:
            for rows in (1, 2, 4, 8):
                check(same_bits(row_sum_kernel(x[:rows].contiguous()),
                                got[:rows]),
                      f"row sum: {rows} rows alone differ from the same "
                      f"rows in 32")
            check(same_bits(row_sum_kernel(x[17:18].contiguous()),
                            got[17:18]), "row sum: row 17 alone differs")
        if outer <= 8:
            mis = misaligned(x)
            check(same_bits(row_sum_kernel(mis), got)
                  and same_bits(row_sum_kernel(mis, shift), got_s),
                  f"row sum {x.shape}: a misaligned copy differs")
            del mis
        del x, x64, exp64
    log(f"row sum: bit for bit its emulation and repeatable (with and "
        f"without the shift) at {[c[:3] for c in ROW_SUM_CASES]}; a row's "
        f"bits alone == in its batch, in 2, 4, 8 and 32 rows and from a "
        f"misaligned start; worst error {worst_rel:.3g} of Σ|x| from the "
        f"float64 sum (limit {ROW_SUM_TOL}); max |kernel - torch.sum| "
        f"{max_abs:.3g}")
    return {"max_abs_err": max_abs, "max_rel_err": worst_rel}


def row_sum_bound(rows, n, inner=1) -> tuple[float, str]:
    """Bytes: every element read once, 4 B (the (rows, inner) output is
    negligible); the adds are n a row and column, far under the FP32
    rate."""
    return rows * n * inner * 4 / PEAK_BYTES * 1e3, "bytes"


ROW_SUM_TIMED = [(1, 2 ** 22, 1), (8, 2 ** 22, 1), (32, 2 ** 22, 1),
                 (1, 2 ** 22, 5)]


def time_row_sum(dev) -> dict:
    """The row sum at 1, 8 and 32 x 2^22 (the single filter's, the 8-shard
    mesh's and the bank over the mesh's rows) and at (2^22, 5) (the
    estimate's view), beside its first design and torch's sum (the plain
    version and the library call) in turns (new, first, torch, torch,
    first, new): host-inclusive ms (``cuda_ms``) and device ms
    (``queued_device_ms``), with the shift, the bound, and the kernel's
    registers and resident blocks an SM."""
    import torch
    from repro_torch.kernels.row_sum import (first_design_kernel,
                                             occupancy, row_sum_kernel)
    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(78)
    for rows, n, inner in ROW_SUM_TIMED:
        x = torch.rand((rows, n, inner), generator=g, device=dev)
        shift = x.amax(1)
        fns = {"ms": lambda: row_sum_kernel(x),
               "first_ms": lambda: first_design_kernel(x),
               "library_ms": lambda: x.sum(1)}
        host = {k: [] for k in fns}
        dev_t = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                host[k].append(cuda_ms(fns[k]))
                dev_t[k].append(queued_device_ms(fns[k]))
        bound, by = row_sum_bound(rows, n, inner)
        rec = {"shape": [rows, n, inner], "bound_ms": bound, "bound_by": by,
               **{k: statistics.mean(v) for k, v in host.items()},
               "device_ms": statistics.mean(dev_t["ms"]),
               "first_device_ms": statistics.mean(dev_t["first_ms"]),
               "library_device_ms": statistics.mean(dev_t["library_ms"]),
               "shift_ms": cuda_ms(lambda: row_sum_kernel(x, shift)),
               "shift_device_ms": queued_device_ms(
                   lambda: row_sum_kernel(x, shift)),
               "first_shift_ms": cuda_ms(lambda: first_design_kernel(
                   x, shift)),
               **occupancy(inner)}
        # the plain version is torch's sum: the same call
        rec["plain_ms"] = rec["library_ms"]
        out[f"{rows}x2^22" + ("" if inner == 1 else f"x{inner}")] = rec
        del x
    return out


def check_new_shapes(dev, cfg) -> dict:
    """Phase 2 at this slice's shapes: B1 at the bank over the mesh's 32 x
    2^22 by ``systematic_case``; B3 there (spread particles, one frame a
    member) and on ASIR's 262,144-row lattice against a 512x512 frame,
    member by member against its plain version within PATCH_TOL and bit
    for bit on a second launch (``check_patch_inputs``).  Returns B1's
    record and the B3 inputs for phase 6."""
    import torch
    from repro_torch.core.asir import ASIRConfig, lattice_states
    acc = {"tie_lanes": 0, "max_abs_err": 0.0, "cases": {},
           "comb_offset": {"kernel": 0.0, "plain": 0.0}}
    lw, ll, _, u = fused_inputs(BANK_B * BANK_P, BANK_C, 37, dev, d=1)
    sys_in = ((lw + ll).contiguous(), u)
    del lw, ll
    systematic_case(*sys_in, BANK_C, "bank-mesh 32x2^22", acc)
    lattice = lattice_states(cfg, ASIRConfig(grid=ASIR_GRID,
                                             intensity_bins=ASIR_BINS), dev)
    frame = patch_inputs(1, 8, 512, 512, 38, dev)[1]
    patch_in = {"bank-mesh 32x2^22": patch_inputs(BANK_B * BANK_P, BANK_C,
                                                  512, 512, 39, dev),
                "ASIR lattice": (lattice[None].contiguous(), frame)}
    check_patch_inputs(patch_in)
    del patch_in["bank-mesh 32x2^22"]
    torch.cuda.empty_cache()
    return {"systematic": acc, "systematic_input": sys_in,
            "patch_inputs": patch_in}


def run_composed_bank(model, frames, seeds, n, all_k, reset, counts, rsum_k,
                      name) -> dict:
    """Phase 4b (ROADMAP C7): the composed single-device FilterBank of 8 x
    2^20 on phase 4's movies; every member bit for bit the standalone
    composed filter with its seed; B3 and the comb scan once a frame for
    the whole bank, and its float sums on the row-sum kernel."""
    from repro_torch.core import FilterBank, ParallelParticleFilter, SIRConfig
    sir = SIRConfig(n_particles=n, ess_frac=0.5)
    bank = FilterBank(model=model, sir=sir)
    reset()
    t0 = time.perf_counter()
    bres = bank.run(seeds, frames)
    got = counts(all_k)
    t_bank = time.perf_counter() - t0
    row_sums = rsum_k.launches
    want = {k: 0 for k in all_k}
    want.update({"patch_log_likelihood": FRAMES, "prefix_sum": FRAMES})
    check(got == want, f"composed bank launches {got}")
    check(row_sums > 0, "composed bank: no row-sum launch")
    for i, seed in enumerate(seeds):
        solo = ParallelParticleFilter(model=model, sir=sir).run(seed,
                                                                frames[i])
        for f in ("estimates", "ess", "log_marginal", "resampled"):
            check(same_bits(getattr(bres, f)[i], getattr(solo, f)),
                  f"composed bank member {i} {f} differs from its "
                  f"standalone filter (C7)")
        check(same_bits(bres.final.state[i], solo.final.state)
              and same_bits(bres.final.log_weights[i],
                            solo.final.log_weights),
              f"composed bank member {i}: final ensemble differs (C7)")
    log(f"composed bank B={len(seeds)} x N=2^{n.bit_length() - 1} 512x512: "
        f"every member bit "
        f"for bit its standalone composed filter (C7), launches {got}, "
        f"row sums {row_sums / FRAMES:.2f} a frame, "
        f"{FRAMES / t_bank:.2f} bank frames/s first run [{name}]")
    return {"launches": got, "row_sum_per_frame": row_sums / FRAMES,
            "first_run_frames_per_s": FRAMES / t_bank,
            "resampled": int(bres.resampled.sum())}


# phase 5h: serving.  2^22 particles a session, the single cell's density
# over the 512x512 frame: at 2^20 a slot one of 12 sessions (movie 59,
# seed 909) locked on after the 20-frame warm-up (RMSE 1.8794 px; ROADMAP
# C4's late lock-on, the session bit for bit its standalone filter)
SERVE_N, SERVE_CAP = 2 ** 22, 8
SERVE_STARTS = [4 * i for i in range(8)] + [44, 48, 52, 56]
# session -> (suspend tick, resume tick, onto the capacity-4 server)
SERVE_SUSPEND = {2: (20, 26, False), 5: (30, 31, True)}
FE_STREAMS, FE_RATE, FE_SECONDS, FE_FRAMES = 8, 20.0, 5.0, 160
FLEET_STREAMS, FLEET_FRAMES, FLEET_KILL_AT = 8, 40, 24


def serve_sessions(model, backend, movies, all_k, reset, counts, rsum_k,
                   tmp, name) -> dict:
    """12 sessions of SERVE_N particles under SERVE_STARTS' churn on a
    capacity-8 server; two suspended to directories and resumed, one on
    a capacity-4 server.  Every session bit for bit its standalone
    filter and under the tracking gate; one B3 launch and one B2 (fused)
    or comb scan (composed) a tick for the whole tier."""
    import torch
    from repro_torch.core import ParallelParticleFilter, SIRConfig
    from repro_torch.launch import grid as launch_grid
    from repro_torch.serve import ParticleSessionServer
    sir = SIRConfig(n_particles=SERVE_N, ess_frac=0.5, step_backend=backend)
    seeds = [900 + i for i in range(len(SERVE_STARTS))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    srv = ParticleSessionServer(model, sir, capacity=SERVE_CAP)
    small = ParticleSessionServer(model, sir, capacity=4)
    where, parked, done = {}, {}, {}
    fed = [0] * len(seeds)
    ticks = 0
    reset()
    t0 = time.perf_counter()
    tick = 0
    while len(done) < len(seeds):
        for i, start in enumerate(SERVE_STARTS):
            if tick == start:
                where[i] = (srv, srv.attach(seeds[i]))
            if i in SERVE_SUSPEND:
                at, back, onto_small = SERVE_SUSPEND[i]
                if tick == at:
                    server_i, h = where.pop(i)
                    d = os.path.join(tmp, f"{backend}-session-{i}")
                    server_i.suspend(h, directory=d)
                    parked[i] = d
                if tick == back:
                    target = small if onto_small else srv
                    where[i] = (target, target.resume_from(parked.pop(i)))
        for i, (server_i, h) in where.items():
            server_i.submit(h, movies[i].frames[fed[i]])
            fed[i] += 1
        for server_i in (srv, small):
            ticks += server_i.step() > 0
        for i, (server_i, h) in list(where.items()):
            if fed[i] == FRAMES:
                done[i] = server_i.result(h)
                server_i.detach(h)
                del where[i]
        tick += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(all_k)
    row_sums = rsum_k.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    comb = "fused_weight_step" if backend == "fused" else "prefix_sum"
    want = {k: 0 for k in all_k}
    want.update({"patch_log_likelihood": ticks, comb: ticks})
    check(got == want, f"sessions {backend}: launches {got}, want {want} "
                       f"(one a tick)")
    for server_i in (srv, small):
        check(1 <= server_i.step_traces <= len(server_i.tiers),
              f"sessions {backend}: {server_i.step_traces} step programs "
              f"for tiers {server_i.tiers}")
    tracks = []
    kept = {}          # the composed standalone runs, for 5i proc-sessions
    for i, seed in enumerate(seeds):
        solo = ParallelParticleFilter(model=model, sir=sir).run(
            seed, movies[i].frames)
        if backend == "composed":
            kept[i] = {f: getattr(solo, f).cpu() for f in (
                "estimates", "ess", "log_marginal", "resampled")}
            kept[i]["final"] = launch_grid.digest({f: getattr(
                solo.final, f) for f in ("state", "log_weights", "counts")})
        res = done[i]
        for f in ("estimates", "ess", "log_marginal", "resampled"):
            check(same_bits(getattr(res, f), getattr(solo, f).cpu()),
                  f"sessions {backend}: session {i} {f} differs from its "
                  f"standalone filter")
        check(same_bits(res.final.state, solo.final.state)
              and same_bits(res.final.log_weights, solo.final.log_weights),
              f"sessions {backend}: session {i} final ensemble differs")
        tracks.append(track(solo, movies[i]))
    gate_tracks(tracks, f"sessions {backend}")
    rec = {"ticks": ticks, "launches": got, "row_sums": row_sums,
           "solo": kept,
           "tier_hits": {"capacity 8": dict(srv.tier_hits),
                         "capacity 4": dict(small.tier_hits)},
           "step_traces": [srv.step_traces, small.step_traces],
           "session_frames_per_s": len(seeds) * FRAMES / wall,
           "ticks_per_s": ticks / wall, "peak_gib": peak, "tracks": tracks}
    log(f"5h sessions {backend}: {len(seeds)} x 2^{SERVE_N.bit_length() - 1} "
        f"under churn (capacity "
        f"{SERVE_CAP}, sessions 2 and 5 suspended to directories, 5 resumed "
        f"on capacity 4): all bit for bit their standalone filters, "
        f"{fmt_tracks(tracks)}; {ticks} ticks, launches {got} (one a tick), "
        f"row sums {row_sums / ticks:.2f} a tick, tier hits "
        f"{rec['tier_hits']}, step programs {rec['step_traces']}; "
        f"{rec['session_frames_per_s']:.2f} session frames/s, "
        f"{rec['ticks_per_s']:.2f} ticks/s; peak {peak:.2f} GiB above the "
        f"script's own [{name}]")
    return rec


def serve_frontend(model, movies, tmp, name) -> dict:
    """The composed capacity-8 server under ParticleFrontend: FE_STREAMS
    Poisson clients at FE_RATE frames/s for FE_SECONDS.  Every frame is
    delivered, in order; streams 0 and 1 bit for bit their standalone
    runs over the frames they sent."""
    import asyncio
    import numpy as np
    from repro_torch.core import ParallelParticleFilter, SIRConfig
    from repro_torch.serve import (FrontendConfig, ParticleFrontend,
                                   ParticleSessionServer)
    sir = SIRConfig(n_particles=SERVE_N, ess_frac=0.5)
    seeds = [700 + i for i in range(FE_STREAMS)]

    async def main():
        server = ParticleSessionServer(model, sir, capacity=SERVE_CAP)
        cfg = FrontendConfig(max_delay=0.005,
                             park_dir=os.path.join(tmp, "park"))
        async with ParticleFrontend(server, cfg) as fe:
            await fe.warmup(movies[0].frames[0])
            loop = asyncio.get_running_loop()
            until = loop.time() + FE_SECONDS

            async def client(i):
                rng = np.random.default_rng(seeds[i])
                stream = await fe.open(seeds[i])
                futs = []
                while loop.time() < until and len(futs) < FE_FRAMES:
                    await asyncio.sleep(rng.exponential(1.0 / FE_RATE))
                    futs.append(await asyncio.wait_for(fe.submit(
                        stream, movies[i].frames[len(futs)]), 60))
                out = await asyncio.wait_for(asyncio.gather(*futs), 120)
                await fe.close(stream)
                return out

            results = await asyncio.gather(*(client(i)
                                             for i in range(FE_STREAMS)))
            return results, fe.snapshot(), server

    dog = watchdog(300, "5h frontend")
    results, snap, server = asyncio.run(main())
    dog.cancel()
    sent = [len(r) for r in results]
    check(snap["counters"]["frames"] == sum(sent),
          f"frontend: {snap['counters']['frames']} frames delivered of "
          f"{sum(sent)}")
    for i, res in enumerate(results):
        check(all(np.isfinite(r.estimate).all() and np.isfinite(r.ess)
                  for r in res), f"frontend stream {i}: non-finite result")
    for i in (0, 1):
        solo = ParallelParticleFilter(model=model, sir=sir).run(
            seeds[i], movies[i].frames[:sent[i]])
        est = np.stack([r.estimate for r in results[i]])
        check(np.array_equal(est.view(np.int32),
                             solo.estimates.cpu().numpy().view(np.int32))
              and np.array_equal(np.asarray([r.log_marginal for r in
                                             results[i]], np.float32),
                                 solo.log_marginal.cpu().numpy())
              and np.array_equal(np.asarray([r.resampled for r in
                                             results[i]]),
                                 solo.resampled.cpu().numpy()),
              f"frontend stream {i}: not bit for bit its standalone run "
              f"(or out of order)")
    lat = snap["series"]["latency"]
    rec = {"frames_sent": sent, "steps": snap["counters"]["steps"],
           "latency_p50_ms": lat["p50"] * 1e3,
           "latency_p99_ms": lat["p99"] * 1e3,
           "coalesce_mean": snap["series"]["coalesce"]["mean"],
           "park_events": snap["counters"].get("park_events", 0),
           "tier_hits": snap["tier_hits"],
           "step_traces": snap["step_traces"]}
    log(f"5h frontend: {FE_STREAMS} Poisson streams at {FE_RATE:.0f} "
        f"frames/s for {FE_SECONDS:.0f} s on the composed capacity-8 server "
        f"(2^{SERVE_N.bit_length() - 1} a slot): {sum(sent)} frames all "
        f"delivered in order "
        f"({sent}), streams 0 and 1 bit for bit their standalone runs; "
        f"latency p50 {rec['latency_p50_ms']:.3f} ms, p99 "
        f"{rec['latency_p99_ms']:.3f} ms, mean coalesced batch "
        f"{rec['coalesce_mean']:.3f}, {rec['steps']:.0f} steps, park "
        f"events {rec['park_events']:.0f}, tier hits {rec['tier_hits']} "
        f"[{name}]")
    return rec


def watchdog(seconds: float, what: str):
    """A timer that ends the process (exit code 3) if ``what`` is not done
    in ``seconds``: an asyncio phase that stops delivering can leave its
    shutdown waiting on futures that never resolve.  ``cancel()`` it when
    the phase is done."""
    import threading

    def fire():
        print(f"chip_smoke: {what} did not finish in {seconds:.0f} s",
              file=sys.stderr, flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def serve_fleet(model, movies, tmp, name) -> dict:
    """Two active banks of capacity 4 and a standby, FLEET_STREAMS streams
    with skew 4 (every 4th stream at 4x the rate); after its third frame
    stream 1 brings the standby up (``scale_out``) and is migrated onto
    it by hand, and bank "b" is killed at its FLEET_KILL_AT-th step, its
    streams re-homed.  No bank holds more streams than slots, so nothing
    parks (a park writes the session's 2^22-particle state to disk), and
    the controller neither scales nor rebalances on its own: every move
    is one of these.  Every stream, the migrated and the recovered ones
    among them, bit for bit its standalone run."""
    import asyncio
    import numpy as np
    from repro_torch.core import ParallelParticleFilter, SIRConfig
    from repro_torch.launch.registry import BankSpec, FleetRegistry
    from repro_torch.serve import (FleetConfig, FleetController,
                                   FrontendConfig, ParticleSessionServer)
    sir = SIRConfig(n_particles=SERVE_N, ess_frac=0.5)
    seeds = [800 + i for i in range(FLEET_STREAMS)]
    kill = {"calls": 0}

    def make_server(spec):
        server = ParticleSessionServer(model, sir, capacity=spec.capacity)
        if spec.name == "b":
            real = server.step

            def step():
                kill["calls"] += 1
                if kill["calls"] > FLEET_KILL_AT:
                    raise RuntimeError("bank b killed (phase 5h)")
                return real()

            server.step = step
        return server

    async def main():
        registry = FleetRegistry([BankSpec("a", 4), BankSpec("b", 4),
                                  BankSpec("spare", 4, standby=True)])
        cfg = FleetConfig(rebalance_interval=0.05, auto_scale=False,
                          imbalance_threshold=1.0, fail_timeout=60.0,
                          state_dir=os.path.join(tmp, "fleet"),
                          frontend=FrontendConfig(max_delay=0.005))
        async with FleetController(make_server, registry, cfg) as fleet:
            await fleet.warmup(movies[0].frames[0])
            streams = [await fleet.open(s) for s in seeds]
            homes = [fs.bank for fs in streams]

            async def client(i):
                fs = streams[i]
                rate = 4 * FE_RATE if i % 4 == 0 else FE_RATE
                futs = []
                for k in range(FLEET_FRAMES):
                    await asyncio.sleep(1.0 / rate)
                    futs.append(await asyncio.wait_for(fleet.submit(
                        fs, movies[i].frames[k]), 60))
                    if i == 1 and k == 2:
                        await asyncio.wait_for(fleet.scale_out("spare"), 60)
                        await asyncio.wait_for(fleet.migrate(fs, "spare"), 60)
                return await asyncio.wait_for(asyncio.gather(*futs), 120)

            results = await asyncio.gather(*(client(i)
                                             for i in range(FLEET_STREAMS)))
            snap = fleet.snapshot()
            placed = [fs.bank for fs in streams]
            for fs in streams:
                await fleet.close(fs)
            return results, snap, homes, placed

    dog = watchdog(300, "5h fleet")
    results, snap, homes, placed = asyncio.run(main())
    dog.cancel()
    c = snap["counters"]
    check(c.get("migrations", 0) == 1 and c.get("scale_out_events", 0) == 1,
          f"fleet: migrations {c.get('migrations')}, scale-outs "
          f"{c.get('scale_out_events')}")
    check(c.get("bank_failures", 0) == 1
          and c.get("sessions_recovered", 0) >= 1,
          f"fleet: failures {c.get('bank_failures')} recovered "
          f"{c.get('sessions_recovered')}")
    for i, seed in enumerate(seeds):
        solo = ParallelParticleFilter(model=model, sir=sir).run(
            seed, movies[i].frames[:FLEET_FRAMES])
        est = np.stack([r.estimate for r in results[i]])
        check(np.array_equal(est.view(np.int32),
                             solo.estimates.cpu().numpy().view(np.int32))
              and np.array_equal(np.asarray([r.log_marginal for r in
                                             results[i]], np.float32),
                                 solo.log_marginal.cpu().numpy()),
              f"fleet stream {i} (home {homes[i]}, now {placed[i]}): not "
              f"bit for bit its standalone run")
    rec = {"counters": c, "homes": homes, "placed": placed,
           "banks": {k: {"dead": v["dead"], "steps": v["frontend"][
               "counters"].get("steps", 0)} for k, v in snap["banks"].items()}}
    log(f"5h fleet: banks a, b (capacity 4) + standby, {FLEET_STREAMS} "
        f"streams (skew 4), the standby brought up and stream 1 migrated "
        f"onto it, bank b killed at step "
        f"{FLEET_KILL_AT}: all {FLEET_STREAMS} streams bit for bit their "
        f"standalone runs; homes {homes} -> {placed}; counters "
        f"{ {k: v for k, v in sorted(c.items())} } [{name}]")
    return rec


def serve_decode(model, prompt, all_k, reset, counts, name) -> dict:
    """Two of phase 5d's prompts decoded as resident sessions on a
    capacity-2 server (K = LM_K, LM_STEPS steps, 5d's weights): bit for
    bit ``smc_decode`` of the same prompts and seed; B6 launched as in
    5d (the prefill's wgmma once a layer, a split launch a layer and
    step)."""
    import torch
    from repro_torch.serve import (LMDecodeSSM, ParticleSessionServer,
                                   SMCDecodeConfig, smc_decode,
                                   suspended_decode_session)
    smc = SMCDecodeConfig(n_particles=LM_K, steps=LM_STEPS,
                          proposal_temperature=LM_TAU)
    seed = LM_SEED + 4
    ref = smc_decode(model, prompt, smc, key=seed)
    ssm = LMDecodeSSM(model=model, decode=smc, prompt_len=prompt.shape[1])
    server = ParticleSessionServer(ssm, smc.sir(), capacity=prompt.shape[0])
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    handles = [server.resume(s)
               for s in suspended_decode_session(ssm, seed, prompt)]
    for t in range(1, LM_STEPS):
        for h in handles:
            server.submit(h, torch.tensor(float(t)))
        server.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(all_k)
    want = {k: 0 for k in all_k}
    want.update({"flash_attention": LM_LAYERS * LM_STEPS,
                 "prefix_sum": LM_STEPS - 1})
    check(got == want, f"decode sessions launches {got}, want {want}")
    attn = all_k["flash_attention"]
    check(attn.variants == {"wgmma": LM_LAYERS,
                            "split": LM_LAYERS * (LM_STEPS - 1), "mma": 0,
                            "f32": 0},
          f"decode sessions B6 variants {attn.variants}")
    for i, h in enumerate(handles):
        r = server.result(h)
        check(torch.equal(r.final.state["tokens"], ref.sequences[i])
              and same_bits(r.final.log_weights, ref.log_weights[i])
              and same_bits(r.log_marginal, ref.log_marginal[:, i].cpu())
              and same_bits(r.ess, ref.ess[:, i].cpu())
              and torch.equal(r.ancestors, ref.ancestors[:, i].cpu())
              and torch.equal(r.resampled, ref.resampled[:, i].cpu()),
              f"decode session {i}: not bit for bit smc_decode")
    rec = {"launches": got, "variants": dict(attn.variants),
           "seconds": wall, "tier_hits": dict(server.tier_hits),
           "hypothesis_tokens_per_s":
               prompt.shape[0] * LM_K * (LM_STEPS - 1) / wall,
           "resample_events": int(ref.resampled.sum())}
    log(f"5h decode sessions: {prompt.shape[0]} x {prompt.shape[1]} prompts "
        f"of {LM_ARCH} x {LM_LAYERS}, K={LM_K}, {LM_STEPS} steps on a "
        f"capacity-{prompt.shape[0]} server: bit for bit smc_decode "
        f"({rec['resample_events']} resample events), launches {got}, B6 "
        f"{rec['variants']}; {wall:.3f} s with the prefill and the host "
        f"round trip of the caches [{name}]")
    del server, ref
    torch.cuda.empty_cache()
    return rec


def run_serving(dev, model, lm_model, lm_prompt, all_k, reset, counts,
                rsum_k, name) -> dict:
    """Phase 5h: resident sessions (fused and composed), the request plane,
    the fleet and session-hosted decoding, on movies made on the card;
    suspended sessions and the fleet's state go to a scratch directory
    of the checkout, removed at the end."""
    import shutil
    import torch
    tmp = os.path.join(ROOT, ".chip_scratch", "serve")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    t0 = time.perf_counter()
    movies = [make_movie(50 + i, model.cfg, dev)
              for i in range(len(SERVE_STARTS))]
    rec = {b: serve_sessions(model, b, movies, all_k, reset, counts, rsum_k,
                             tmp, name) for b in ("fused", "composed")}
    del movies
    movies = [make_movie(70 + i, model.cfg, dev, n_frames=FE_FRAMES)
              for i in range(FE_STREAMS)]
    rec["frontend"] = serve_frontend(model, movies, tmp, name)
    rec["fleet"] = serve_fleet(model, movies, tmp, name)
    del movies
    torch.cuda.empty_cache()
    rec["decode"] = serve_decode(lm_model, lm_prompt, all_k, reset, counts,
                                 name)
    rec["seconds"] = time.perf_counter() - t0
    shutil.rmtree(tmp)
    log(f"5h serving: {rec['seconds']:.1f} s")
    return rec


def make_movie(seed, cfg, dev, n_frames=FRAMES):
    from repro_torch.core.draws import TorchDraws
    from repro_torch.data.synthetic_movie import generate_movie
    return generate_movie(TorchDraws.from_seed(seed, dev), cfg,
                          n_frames=n_frames)


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
    from repro_torch.kernels.row_sum import row_sum_kernel as rsum_k
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
    patch_domain_check = check_patch_domain(dev)
    fused_check = check_fused(dev)
    sys_check = check_systematic(dev)
    new_shapes = check_new_shapes(dev, TrackingConfig())
    sums_check = check_invariant_sums(dev)
    row_check = check_row_sum(dev)
    scan_check = check_scan(dev)
    chain_check = check_chains(dev)
    attn_check = check_attention(dev)
    attn_check["kinds"] = check_attention_kinds(dev)
    attn_check["wgmma_sass"] = check_wgmma()
    ref.mha_ref.calls = 0        # from here on no path may run it
    all_k = {"patch_log_likelihood": patch_k, "fused_weight_step": fused_k,
             "systematic_ancestors": sys_k, "metropolis_ancestors": metro_k,
             "rejection_ancestors": rej_k, "flash_attention": attn_k,
             "prefix_sum": scan_k}

    # the row-sum kernel serves every float sum of core, so each phase's
    # count of it is recorded (row_sum_seen, one entry a counted run),
    # not held to a fixed number
    row_sum_seen = []

    def reset():
        for k in (*all_k.values(), rsum_k):
            k.launches = 0
        for k in (attn_k, metro_k, rej_k, patch_k, sys_k, fused_k):
            k.variants.update(dict.fromkeys(k.variants, 0))

    def counts(names=("patch_log_likelihood", "fused_weight_step")):
        torch.cuda.synchronize()
        row_sum_seen.append(rsum_k.launches)
        return {n: all_k[n].launches for n in names}

    # -- phase 5l: training stablelm-3b whole (runs while the card is empty)
    train = run_train(dev, all_k, reset, counts, rsum_k, name)
    # -- phase 5m: the other kinds, MoE and the codebook head in training
    train_kinds = run_train_kinds(dev, all_k, reset, counts, rsum_k, name)
    # -- phase 5n: the LM over a (data, model) process grid ----------------
    grid = run_grid(dev, name)

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
    row_sum_cells = {"single": row_sum_seen[-1] / FRAMES}
    t_single = time.perf_counter() - t0
    check(launches_single == {"patch_log_likelihood": FRAMES,
                              "fused_weight_step": FRAMES},
          f"single filter launches {launches_single}")
    check(patch_k.variants == {"separable": FRAMES, "direct": 0},
          f"single filter patch variants {patch_k.variants}")
    check(fused_k.variants == {"merge": FRAMES, "seven_pass": 0},
          f"single filter fused variants {fused_k.variants}")
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
    single_movies = movies

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
    row_sum_cells["bank"] = row_sum_seen[-1] / FRAMES
    t_bank = time.perf_counter() - t0
    check(launches_bank == {"patch_log_likelihood": FRAMES,
                            "fused_weight_step": FRAMES},
          f"bank launches {launches_bank}")
    check(fused_k.variants == {"merge": FRAMES, "seven_pass": 0},
          f"bank fused variants {fused_k.variants}")
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

    # -- phase 4b: the composed bank, member by member (C7) ---------------------
    composed_bank = run_composed_bank(model, frames, seeds, n_bank, all_k,
                                      reset, counts, rsum_k, name)
    row_sum_cells["bank-composed"] = composed_bank["row_sum_per_frame"]

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
        row_sum_cells["composed"] = row_sum_seen[-1] / FRAMES
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
        row_sum_cells[scheme] = row_sum_seen[-1] / FRAMES
        t_first = time.perf_counter() - t0
        want = {k: 0 for k in all_k}
        want.update({"patch_log_likelihood": FRAMES,
                     "fused_weight_step": FRAMES, kname: FRAMES})
        check(got == want, f"{scheme} filter launches {got}")
        check(all_k[kname].variants == {"tma": FRAMES, "lane": 0},
              f"{scheme} filter chain variants {all_k[kname].variants}")
        check(fused_k.variants == {"merge": FRAMES, "seven_pass": 0},
              f"{scheme} filter fused variants {fused_k.variants}")
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
                             slack=2.0),
            "arna": DRAConfig(kind="arna", q_min=0.05, q_max=0.5),
            "butterfly": DRAConfig(kind="butterfly", butterfly_cap=32)}
    stages = p_mesh.bit_length() - 1
    dist_runs = {}
    replicated = {}          # RNA's and RPA's results, for phase 5e
    for kind, dra in dras.items():
        dpf = ParallelParticleFilter(model=model, sir=SIRConfig(
            n_particles=p_mesh * c_mesh, ess_frac=0.5), mesh=EmulatedMesh(
            p_mesh), dra=dra)
        reset()
        t0 = time.perf_counter()
        dres = dpf.run(1, movie.frames)
        got = counts(all_k)
        row_sum_cells[kind] = row_sum_seen[-1] / FRAMES
        t_first = time.perf_counter() - t0
        want = dist_launches(kind, all_k, stages)
        check(got == want, f"{kind} launches {got}")
        check(patch_k.variants == {"separable": FRAMES, "direct": 0},
              f"{kind} patch variants {patch_k.variants}")
        check(sys_k.variants == {"merge": want["systematic_ancestors"],
                                 "seven_pass": 0},
              f"{kind} B1 variants {sys_k.variants}")
        if kind == "mpf":
            # B1's timing input (ii): the per-shard weights the next frame's
            # local resample would comb, the final log-weights plus the
            # final particles' likelihood of the last frame
            mpf_next = (dres.final.log_weights + patch_k(
                dres.final.state, movie.frames[-1].expand(
                    p_mesh, *movie.frames.shape[1:]),
                radius=cfg.patch_radius, sigma_psf=cfg.sigma_psf,
                sigma_like=cfg.sigma_like, i_bg=cfg.i_bg,
                matched=True)).contiguous()
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
        if kind == "arna":
            extra = (f", lost mode {int(dres.diag['lost'].sum())}/{FRAMES} "
                     f"frames, exchanged "
                     f"{int(dres.diag['exchanged'].min())}-"
                     f"{int(dres.diag['exchanged'].max())} slots/shard")
        if kind == "butterfly":
            check(int(dres.diag["overflow"].abs().sum()) == 0
                  and int(dres.diag["truncated"].abs().sum()) == 0,
                  "butterfly: overflow or truncated units")
            extra = (f", overflow 0, truncated 0, shipped units/shard "
                     f"{int(dres.diag['exchanged'].min())}-"
                     f"{int(dres.diag['exchanged'].max())}")
        if kind in ("rna", "rpa"):
            replicated[kind] = {
                f: getattr(dres, f) for f in ("estimates", "ess",
                                              "log_marginal", "resampled",
                                              "diag")}
            replicated[kind]["final"] = dres.final
        dist_runs[kind] = {
            "launches": got, "track": tr, "frames_per_s": fps,
            "first_run_frames_per_s": FRAMES / t_first,
            "comm_bytes": cb, "comm_stages": cs,
            "resampled": int(dres.resampled.sum()),
            "mean_ess": float(dres.ess.mean())}
        if kind == "arna":
            dist_runs[kind]["lost_frames"] = int(dres.diag["lost"].sum())
        log(f"{kind} 8 x 2^22 = 2^25 particles, 512x512: RMSE "
            f"{tr['rmse']:.4f} px after {WARMUP} (after 10: "
            f"{tr['rmse_after_10']:.4f}, lock-on frame {tr['lock_frame']}),"
            f" mean ESS {float(dres.ess.mean()):.0f}, resampled "
            f"{int(dres.resampled.sum())}/{FRAMES}, comm {cb} B / {cs} "
            f"stages per frame and shard (= formulas){extra}, launches "
            f"{got}, {fps:.2f} frames/s steady ({FRAMES / t_first:.2f} "
            f"first run) [{name}]")
        del dres, dres2

    # -- phase 5e: domain decomposition at full width --------------------------
    seen = len(row_sum_seen)
    domain_runs = run_domain(dev, model, movie, dras, replicated, all_k,
                             reset, counts, name)
    row_sum_cells["5e runs"] = [x / FRAMES for x in row_sum_seen[seen:]]

    # -- phase 5f: a FilterBank over the emulated mesh at full width ---------
    seen = len(row_sum_seen)
    bank_mesh, bank_b3 = run_bank_mesh(dev, model, movie, dras, replicated,
                                       all_k, reset, counts, name)
    for kind, x in zip(("bank-mesh-rna", "bank-mesh-rpa"),
                       row_sum_seen[seen:]):
        row_sum_cells[kind] = x / FRAMES

    # -- phase 5i: one process a shard over a gloo group, nccl at world 1 ---
    processes = run_processes(dev, movie, replicated, row_sum_cells, name)
    del replicated

    # -- phase 5g: ASIR, stochastic volatility, Lorenz-96, the smoothers -----
    seen = len(row_sum_seen)
    asir_run = run_asir(dev, model, single_movies, single, all_k, reset,
                        counts, name)
    del single_movies
    families = run_families(dev, all_k, reset, counts, name)
    smoothers = run_smoothers(dev, name)
    row_sum_cells["5g runs"] = row_sum_seen[seen:]

    # -- phase 5d: LM serving at qwen3-32b width ------------------------------
    lm, lm_model, lm_prompt = run_lm(dev, all_k, reset, counts, name)

    # -- phase 5h: serving: sessions, the request plane, the fleet, decode ----
    serving = run_serving(dev, model, lm_model, lm_prompt[:2], all_k, reset,
                          counts, rsum_k, name)
    del lm_model, lm_prompt
    torch.cuda.empty_cache()
    solo = serving["composed"].pop("solo")
    serving["fused"].pop("solo")

    # -- phase 5i (continued): proc-sessions, held to 5h's standalone runs ---
    processes["sessions"] = run_proc_sessions(dev, model, solo, name)
    del solo

    # -- phase 5j: the L, R, D, X kinds and the codebook head at full width --
    kinds = run_kinds(dev, all_k, reset, counts, name)

    # -- phase 5k: the M kind and MoE FFNs at full width ----------------------
    moe = run_kinds(dev, all_k, reset, counts, name, MOE, "5k", MOE_SEED)
    log(f"row-sum launches a frame by cell: "
        f"{ {k: v for k, v in row_sum_cells.items() if 'runs' not in k} }; "
        f"5e and 5g runs {row_sum_cells['5e runs']} / "
        f"{row_sum_cells['5g runs']}")

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
    patch_domain = time_patch_domain(state, frames1, rna_final,
                                     movie.frames[-1], cfg)
    log(f"times [{name}]: B3 per-member table on input (i), every row the "
        f"default geometry: {patch_domain['per_member_ms']:.4f} ms against "
        f"the shared geometry's {patch_domain['shared_ms']:.4f} (in turns, "
        f"same bits); at the domain shape {tuple(patch_domain['shape'])} "
        f"(RNA's final ensemble migrated to its owners, 8 slabs of 264x136):"
        f" {patch_domain['ms']:.4f} ms, device "
        f"{patch_domain['device_ms']:.4f}, bound "
        f"{patch_domain['bound_ms']:.4f} {patch_domain['bound_by']}")
    del patch_in, rna_final
    # B2's timing inputs: the single filter's call (with the comb), the
    # chain cells' call (comb=False) and the bank's
    lw, ll, fstate, u = fused_inputs(1, n_single, 5, dev)
    blw, bll, bst, bu = fused_inputs(b_bank, n_bank, 6, dev)
    fused_times = time_fused({
        "1x2^22": (lw, ll, fstate, u, True),
        "1x2^22 comb=False": (lw, ll, fstate, u, False),
        "bank 8x2^20": (blw, bll, bst, bu, True)})
    for label, t in fused_times.items():
        log(f"times [{name}]: B2 {label}: {t['ms']:.4f} ms (first design "
            f"{t['first_ms']:.4f}, {t['first_ms'] / t['ms']:.2f}x; device "
            f"{t['device_ms']:.4f}, first design's {t['first_device_ms']:.4f};"
            f" bound {t['bound_ms']:.4f} {t['bound_by']})")
    check(all(t["ms"] < t["first_ms"] for t in fused_times.values()),
          "B2: the redesign is not faster than the first design at every "
          "input")
    fused_ms = fused_times["1x2^22"]["ms"]
    fused_plain_ms = cuda_ms(lambda: fused_weight_step_ref(lw, ll, fstate, u))
    f_bound = fused_times["1x2^22"]["bound_ms"]
    f_by = fused_times["1x2^22"]["bound_by"]
    fused_bank_ms = fused_times["bank 8x2^20"]["ms"]
    patch_bank_ms = patch_times["bank"]["ms"]
    del blw, bll, bst, bu
    # B1's timing inputs: (i) a filter's post-likelihood weights, (ii) the
    # mpf cell's next-frame weights, (iii) a skewed input (one slot with
    # 99% of each member's mass, a dead run)
    slw, sll, _, su = fused_inputs(p_mesh, c_mesh, 7, dev, d=1)
    sys_in = {"i": ((slw + sll).contiguous(), su), "ii": (mpf_next, su),
              "iii": (skewed_log_weights(p_mesh, c_mesh, 36, dev), su)}
    del slw, sll, mpf_next
    sys_inputs_check = check_systematic_inputs(sys_in)
    sys_times = time_systematic(sys_in)
    for label, t in sys_times.items():
        ties = sys_inputs_check["cases"][f"timing input {label}"]
        t["tie_lanes"] = ties["tie_lanes"]
        log(f"times [{name}]: B1 input {label} {tuple(t['shape'])}: "
            f"{t['ms']:.4f} ms (first design {t['first_ms']:.4f}, "
            f"{t['first_ms'] / t['ms']:.2f}x; device {t['device_ms']:.4f}, "
            f"first design's {t['first_device_ms']:.4f}; bound "
            f"{t['bound_ms']:.4f} {t['bound_by']}; tie lanes "
            f"{t['tie_lanes']})")
    check(all(t["ms"] < t["first_ms"] for t in sys_times.values()),
          "B1: the redesign is not faster than the first design at every "
          "input")
    slw, su = sys_in["i"]
    sys_ms = sys_times["i"]["ms"]
    sys_plain_ms = cuda_ms(lambda: ref.systematic_ancestors_ref(
        slw, su, c_mesh))
    s_bound, s_by = sys_times["i"]["bound_ms"], sys_times["i"]["bound_by"]
    del sys_in, slw, su
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
    row_times = time_row_sum(dev)
    for label, t in row_times.items():
        log(f"times [{name}]: row sum {label}: {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}, with the shift {t['shift_ms']:.4f} / "
            f"{t['shift_device_ms']:.4f}; first design {t['first_ms']:.4f} "
            f"/ {t['first_device_ms']:.4f}, with the shift "
            f"{t['first_shift_ms']:.4f}; torch.sum {t['library_ms']:.4f} / "
            f"{t['library_device_ms']:.4f}; bound {t['bound_ms']:.4f} "
            f"{t['bound_by']}; {t['registers']} registers, "
            f"{t['blocks_per_sm']} blocks of {t['threads']} an SM)")
    check(all(t["device_ms"] < t["first_device_ms"]
              for t in row_times.values()),
          "row sum: the kernel is not faster than its first design")
    # this slice's shapes, recorded and not gated: B1 at the bank over the
    # mesh's 32 x 2^22, B3 there (RNA's final bank ensemble against each
    # member's last frame) and on ASIR's lattice, B2 at D = 1, 8 and 40
    new_sys = time_systematic({"bank-mesh 32x2^22":
                               new_shapes.pop("systematic_input")})
    new_patch = time_patch({"bank-mesh 32x2^22": bank_b3,
                            "ASIR lattice":
                                new_shapes["patch_inputs"]["ASIR lattice"]},
                           cfg)
    del bank_b3, new_shapes["patch_inputs"]
    new_fused = time_fused({f"1x2^22 D={d}": fused_inputs(
        1, 2 ** 22, 40 + d, dev, d=d) + (True,) for d in (1, 8, 40)})
    for label, t in {**{f"B1 {k}": v for k, v in new_sys.items()},
                     **{f"B3 {k}": v for k, v in new_patch.items()},
                     **{f"B2 {k}": v for k, v in new_fused.items()}}.items():
        log(f"times [{name}]: {label} {tuple(t['shape'])}: {t['ms']:.4f} ms "
            f"(first design {t['first_ms']:.4f}; device "
            f"{t['device_ms']:.4f}; bound {t['bound_ms']:.4f} "
            f"{t['bound_by']})")
    torch.cuda.empty_cache()
    attn_times = time_attention(dev)
    for label, t in attn_times.items():
        log(f"times [{name}]: B6 {label} [{t['variant']}] q{tuple(t['q'])} "
            f"kv{tuple(t['k'])}: {t['ms']:.4f} ms (mma.sync kernel "
            f"{t['mma_ms']:.4f}, plain {t['plain_ms']:.4f}, sdpa "
            f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} "
            f"{t['bound_by']})")
    attn_kinds = time_attention_kinds(dev)
    for label, t in attn_kinds.items():
        log(f"times [{name}]: B6 {t['phase']} {label} [{t['variant']}"
            f"{' x' + str(t['splits']) + ' from key ' + str(t['key0']) if t['variant'] == 'split' else ''}]"
            f" q{tuple(t['q'])} kv{tuple(t['k'])}"
            f"{' v head dim ' + str(t['dv']) if t['dv'] != t['k'][-1] else ''}"
            f"{' window ' + str(t['window']) if t['window'] else ''}"
            f"{'' if t['causal'] else ' non-causal'}: {t['ms']:.4f} ms "
            f"(plain {t['plain_ms']:.4f}, sdpa {t['library_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} {t['bound_by']})")
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
        {"name": "fused_weight_step", "variant": "merge", "route": "cuda",
         "source": "src/repro_torch/csrc/sir_fused.cu",
         "replaces": "src/repro/kernels/sir_fused.py:225",
         "launches": launches_single["fused_weight_step"],
         "max_abs_err": fused_check["max_abs_err"], "ms": fused_ms,
         "plain_ms": fused_plain_ms, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": None},
        {"name": "systematic_ancestors", "variant": "merge",
         "route": "cuda",
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
         "max_abs_err": max(attn_check["max_abs_err"],
                            attn_check["kinds"]["max_abs_err"]),
         "ms": attn_times["smc_decode"]["ms"],
         "plain_ms": attn_times["smc_decode"]["plain_ms"],
         "bound_ms": attn_times["smc_decode"]["bound_ms"],
         "bound_by": attn_times["smc_decode"]["bound_by"],
         "library_ms": attn_times["smc_decode"]["library_ms"]},
        # the composed step's float sums at its 1 x 2^22 rows; 8 and 32 x
        # 2^22 are in the record's "row_sum_times"
        {"name": "row_sum", "variant": "runs", "route": "cuda",
         "source": "src/repro_torch/csrc/row_sum.cu",
         "replaces": "src/repro/core/particles.py:95",
         "launches": int(row_sum_cells["composed"] * FRAMES),
         "max_abs_err": row_check["max_abs_err"],
         "ms": row_times["1x2^22"]["ms"],
         "plain_ms": row_times["1x2^22"]["plain_ms"],
         "bound_ms": row_times["1x2^22"]["bound_ms"],
         "bound_by": row_times["1x2^22"]["bound_by"],
         "library_ms": row_times["1x2^22"]["library_ms"],
         "first_design_ms": row_times["1x2^22"]["first_ms"]},
    ]
    fam_l = {f"5g {fam} {b}": families[fam][b]["launches"]
             for fam in families for b in ("fused", "composed")}
    new_launches = {
        "patch_log_likelihood": {
            "5f bank-mesh rna": bank_mesh["rna"]["launches"][
                "patch_log_likelihood"],
            "5f bank-mesh rpa": bank_mesh["rpa"]["launches"][
                "patch_log_likelihood"],
            "5g asir": asir_run["launches"]["patch_log_likelihood"]},
        "fused_weight_step": {
            "5g asir": asir_run["launches"]["fused_weight_step"],
            **{k: v["fused_weight_step"] for k, v in fam_l.items()
               if k.endswith("fused")}},
        "systematic_ancestors": {
            "5f bank-mesh rna": bank_mesh["rna"]["launches"][
                "systematic_ancestors"]},
        "prefix_sum": {
            "5f bank-mesh rpa": bank_mesh["rpa"]["launches"]["prefix_sum"],
            **{k: v["prefix_sum"] for k, v in fam_l.items()
               if k.endswith("composed")}}}
    for b in ("fused", "composed"):
        ticks = serving[b]["ticks"]
        new_launches["patch_log_likelihood"][f"5h sessions {b}"] = ticks
        comb = "fused_weight_step" if b == "fused" else "prefix_sum"
        new_launches[comb][f"5h sessions {b}"] = ticks
    new_launches["prefix_sum"]["5h decode sessions"] = \
        serving["decode"]["launches"]["prefix_sum"]
    new_launches["flash_attention"] = {
        "5h decode sessions": serving["decode"]["launches"]["flash_attention"]}
    for ph, runs in (("5j", kinds), ("5k", moe)):
        for arch, r in runs.items():
            for run in ("generate", "smc"):
                if f"{run}_launches" in r:
                    new_launches["flash_attention"][f"{ph} {arch} {run}"] = \
                        r[f"{run}_launches"]["flash_attention"]
                    if run == "smc":
                        new_launches["prefix_sum"][f"{ph} {arch} smc"] = r[
                            "smc_launches"]["prefix_sum"]
    new_launches["row_sum"] = {
        f"{k} (a frame)": v for k, v in row_sum_cells.items()
        if "runs" not in k}
    # phase 5i: every one of the 8 ranks launches these on its own shard
    for label, r in processes["runs"].items():
        for kname, n in r["launches_per_rank"].items():
            if n:
                new_launches[kname][f"5i {label} (each of "
                                    f"{processes['p']} ranks)"] = n
    for kname, n in processes["sessions"]["launches_per_rank"].items():
        if n:
            new_launches[kname][f"5i proc-sessions (each of "
                                f"{processes['sessions']['ranks']} ranks)"] = n
    for k in kernels:
        k["launches_new_phases"] = new_launches.get(k["name"], {})
        k["launches_new_phases"]["5l train"] = train["launches"][k["name"]]
        k["launches_new_phases"]["5m train"] = \
            train_kinds["launches"][k["name"]]
        k["launches_new_phases"]["5n train (each of 4 ranks)"] = \
            grid["train_launches"][k["name"]]
        k["launches_new_phases"]["5n c serve (each of 4 ranks)"] = \
            grid["serve"]["launches_per_rank"] \
            if k["name"] == "flash_attention" else 0
    record = {
        "card": name, "kernels": kernels,
        "bank_mesh": bank_mesh, "processes": processes, "asir": asir_run,
        "families": families,
        "smoothers": smoothers, "invariant_sums": sums_check,
        "row_sum": row_check, "row_sum_times": row_times,
        "row_sum_cells": row_sum_cells, "composed_bank": composed_bank,
        "serving": serving, "new_shapes": {
            "systematic_check": new_shapes["systematic"],
            "systematic": new_sys, "patch": new_patch, "fused": new_fused},
        "tie_lanes": fused_check["tie_lanes"],
        "comb_offset": fused_check["comb_offset"],
        "systematic_tie_lanes": sys_check["tie_lanes"],
        "systematic_comb_offset": sys_check["comb_offset"],
        "systematic_cases": sys_check["cases"],
        "systematic_inputs": sys_times,
        "systematic_inputs_check": sys_inputs_check,
        "fused_inputs": fused_times,
        "chains": chain_runs, "chain_check": chain_check,
        "chain_lane_ms": {"metropolis": lane_ms[False],
                          "rejection": lane_ms[True]},
        "composed": composed, "scan": scan_times, "scan_check": scan_check,
        "distributed": dist_runs, "domain": domain_runs, "lm": lm,
        "kinds": kinds, "moe": moe, "train": train,
        "train_kinds": train_kinds, "grid": grid,
        "patch_domain_check": patch_domain_check,
        "attention": attn_times, "attention_check": attn_check,
        "attention_kinds": attn_kinds,
        "patch_inputs": patch_times, "patch_domain_times": patch_domain,
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
