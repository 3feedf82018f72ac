#!/usr/bin/env python3
"""Where a frame (or a decode run) of the torch port goes on the card,
path by path.

    python3 tools/profile_port.py [--frames 12] [--only PREFIX] [--out FILE]

For each path of ``chip_smoke.py`` — the single tracking filter at
N = 2^22 (systematic, Metropolis and rejection resampling, fused step;
the default composed step with its systematic comb), the FilterBank of
8 members × 2^20 (fused),
the distributed filter on an emulated 8-shard mesh at 8 × 2^22 (MPF,
RNA, ARNA, RPA, butterfly; RNA and RPA also domain-decomposed over 2 × 4
tiles, ``domain-rna``/``domain-rpa``, where the migration's torch ops
show in the top kernels), the FilterBank of 4 members × 2^25 over the
same mesh (``bank-mesh-rna``, ``bank-mesh-rpa``: 2^27 particles, the
transition's ``cat`` and the gathers the rows to watch), ASIR on a
256 × 256 × 4 lattice at N = 2^22 (``asir``, fused), all on 512×512
frames, the LM serving cells at
qwen3-32b width with 16 layers (``generate`` and ``smc_decode``, at
chip_smoke.py's sizes) and phase 5k's (``moe-deepseek-*`` and
``moe-moonshot-*``: 4 and 16 layers at full width, one decoder held at
a time; each also splits its device time by region: the M layers'
prefill and absorbed decode and the MoE FFNs, ``REGIONS``), and phase
5l's train step (``train-stablelm-3b``: regions for the chunked
attention and loss forwards and the optimizer, then the attention alone
at the step's shape, forward and backward, ``attention_alone``) — it
runs the path once to warm up, then once
under ``torch.profiler`` (``--frames`` frames of a filter; one whole
call of an LM cell, one train step) and prints the wall time per frame,
call or step, the
device busy share (the sum of kernel times over the wall time: one
stream, so kernels do not overlap), the kernels that take the most
device time, the time of each of the port's own kernels, grouped by
source (``PORT_GROUPS``), wherever they rank, and for the tracking paths
one line with B3's, B1's, the comb scan's and the row sum's device ms a
frame.  The ``passes-``
paths time B1 and B2 alone, each design on chip_smoke.py's timing inputs
(B1 at 8 × 2^22, B2 at 1 × 2^22 with and without the comb and at the
bank's 8 × 2^20), ten calls under the profiler, and list each launch of
the design (its passes) with its device ms a call.  ``--only`` keeps the
paths whose name starts with it.
Needs one CUDA card; exits non-zero without.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


# the port's kernels by source: name prefixes inside csrc/'s anonymous
# namespaces
PORT_GROUPS = {
    "comb scan (comb_scan.cu)": ("k_scan_",),
    "B4/B5 chains (resample.cu)": ("k_chain", "k_tile_argmax",
                                   "k_member_argmax"),
    "B1 (resample.cu)": ("k_sys_",),
    "B2 (sir_fused.cu)": ("k_fw_", "k_tile_max", "k_member_max",
                          "k_tile_expsum", "k_member_sum", "k_tile_weights",
                          "k_member_finish", "k_commit"),
    "B3 (patch_likelihood.cu)": ("k_patch_sep", "patch_ll_kernel"),
    "B6 (flash_attention*.cu)": ("flash_",),
    "row sum (row_sum.cu)": ("k_row_sum",),
}


def port_group(key: str) -> str | None:
    """The PORT_GROUPS entry of a kernel name, or None for torch's own."""
    if "(anonymous namespace)::" not in key:
        return None
    local = key.split("(anonymous namespace)::", 1)[1]
    for group, prefixes in PORT_GROUPS.items():
        if local.startswith(prefixes):
            return group
    return None


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _device_total_us(evt) -> float:
    """A range's device time, its children's kernels included."""
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def lm_runs(dev) -> dict:
    """The LM cells at chip_smoke.py's sizes, sharing one decoder that is
    drawn when the first of them runs."""
    import chip_smoke as cs
    from repro_torch.models.lm import model as M
    from repro_torch.serve import SMCDecodeConfig, generate, smc_decode
    held = {}

    def setup():
        if "model" not in held:
            cfg = cs.lm_config()
            held["model"] = M.init_params(cfg, cs.LM_SEED, device=dev)
            held["prompt"] = cs.lm_prompts(cfg, dev)
        return held["model"], held["prompt"]

    def gen():
        model, prompt = setup()
        return lambda: generate(model, prompt, steps=cs.LM_STEPS)

    def smc():
        model, prompt = setup()
        knobs = SMCDecodeConfig(n_particles=cs.LM_K, steps=cs.LM_STEPS,
                                proposal_temperature=cs.LM_TAU)
        return lambda: smc_decode(model, prompt, knobs, key=cs.LM_SEED + 2)

    return {"lm-generate": (gen, 1, "call"),
            "lm-smc-decode": (smc, 1, "call")}


# phase 5k's and 5l's regions: (module, function) -> the profiler range
# its calls are recorded under, so a cell's device time splits by part
# (a training region holds the forward and the remat recompute; the
# backward's kernels run outside every region)
REGIONS = {("models.lm.mla", "mla_attention"): "mla prefill / train",
           ("models.lm.mla", "mla_decode_absorbed"): "mla absorbed decode",
           ("models.lm.moe", "apply_moe"): "moe ffn",
           ("models.lm.model", "_cross_attention"): "x cross-attention",
           ("models.lm.rglru", "_linear_scan"): "rg-lru scan",
           ("models.lm.ssm", "ssd_forward"): "ssd",
           ("models.lm.layers", "chunked_causal_attention"):
               "chunked attention (forward, recompute)",
           ("train.step", "chunked_xent"): "chunked xent (forward)",
           ("train.step", "adamw_update"): "adamw update"}


def train_config(arch: str):
    """The config chip_smoke.py trains ``arch`` at: 5l's stablelm-3b
    whole, or 5m's depth of a ``TRAIN_KINDS`` arch."""
    import dataclasses
    import chip_smoke as cs
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    layers = cs.TRAIN_KINDS.get(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def train_runs(dev, archs) -> dict:
    """Phase 5l's and 5m's train steps at chip_smoke.py's sizes (each of
    ``archs`` at its phase's depth), float32 masters, bf16 compute,
    remat, 8 x 1024 tokens in 2 microbatches; the weights and optimizer
    state drawn when a run starts."""
    import chip_smoke as cs
    from repro_torch.data.tokens import make_batch
    from repro_torch.models.lm import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    def make(arch):
        cfg = train_config(arch)
        seed = cs.TRAIN_SEED if arch == cs.TRAIN_ARCH else \
            cs.TRAIN_KINDS_SEED
        model = M.init_train_params(cfg, seed, device=dev)
        state = init_opt_state(model)
        step = make_train_step(cfg, OptConfig(**cs.TRAIN_OPT), TrainConfig(
            num_microbatches=cs.TRAIN_MICRO, xent_chunk=cs.TRAIN_XENT))
        batch = make_batch(seed, 0, cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                           device=dev)
        return lambda: step(model, state, batch)
    return {f"train-{arch}": (lambda arch=arch: make(arch), 1, "step")
            for arch in archs}


def alone_ms(dev, fn, args, grad_of) -> tuple[float, float]:
    """Device ms of ``fn(*args)`` forward, and forward + backward of
    ``(out * w).sum()`` into every input that requires grad (``grad_of``
    picks the output tensor to differentiate)."""
    import chip_smoke as cs
    import torch
    out = grad_of(fn(*args))
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    w = torch.randn(out.shape, generator=g, device=dev, dtype=out.dtype)
    leaves = [a for a in args if torch.is_tensor(a) and a.requires_grad]

    def fwd():
        with torch.no_grad():
            fn(*args)

    def fwd_bwd():
        for a in leaves:
            a.grad = None
        (grad_of(fn(*args)).float() * w.float()).sum().backward()

    return cs.cuda_ms(fwd, reps=5), cs.cuda_ms(fwd_bwd, reps=5)


def regions_alone(dev, arch) -> dict:
    """5m's new regions alone at a microbatch's shape (4 x 1024 tokens,
    bf16 operands from a seed, float32 where the model keeps them): each
    one's forward and forward + backward device ms, its layers, and what
    a step's add up to (2 microbatches, each a forward and a backward a
    layer, and a remat forward in a scanned layer)."""
    import chip_smoke as cs
    import torch
    from repro_torch.models.lm import layers as L
    from repro_torch.models.lm import mla, moe, rglru, ssm
    from repro_torch.models.lm.model import make_plan
    cfg = train_config(arch)
    plan = make_plan(cfg)
    remat = set(plan.scanned()) if cfg.remat else set()
    plan = plan.layers()
    kinds = [k for k, _ in plan]
    b, t = cs.TRAIN_BATCH // cs.TRAIN_MICRO, cs.TRAIN_SEQ
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(
            dtype).requires_grad_()

    def cast(p):
        return {k: cast(v) if isinstance(v, dict) else
                v.to(torch.bfloat16).requires_grad_() for k, v in p.items()}

    out = {}
    if "M" in kinds:
        p = cast(mla.mla_params(g, cfg.d_model, cfg.n_heads, cfg.mla,
                                torch.float32))
        pos = torch.arange(t, device=dev)
        out["mla attention (train)"] = (alone_ms(
            dev, lambda x: mla.mla_attention(
                p, x, cfg.n_heads, cfg.mla, positions=pos,
                theta=cfg.rope_theta, eps=cfg.norm_eps, chunk=cfg.attn_chunk),
            (rand(b, t, cfg.d_model),), lambda o: o), "M")
    if "X" in kinds:
        hd = cfg.resolved_head_dim
        kv = [rand(b, cfg.n_kv_heads, cfg.n_image_tokens, hd)
              for _ in range(2)]
        out["x attention (chunked, non-causal)"] = (alone_ms(
            dev, lambda q, k, v: L.chunked_causal_attention(
                q, k, v, chunk=cfg.attn_chunk, causal=False),
            (rand(b, cfg.n_heads, t, hd), *kv), lambda o: o), "X")
    if "R" in kinds:
        w = cfg.rglru.lru_width
        a = (0.9 + 0.1 * torch.rand((b, t, w), generator=g, device=dev)
             ).requires_grad_()
        out["rg-lru scan"] = (alone_ms(
            dev, rglru._linear_scan, (a, rand(b, t, w, dtype=torch.float32)),
            lambda o: o), "R")
    if "D" in kinds:
        p = cast(ssm.ssm_params(g, cfg.d_model, cfg.ssm, torch.float32))
        out["ssd (one layer)"] = (alone_ms(
            dev, lambda x: ssm.ssd_forward(p, x, cfg.ssm, cfg.d_model,
                                           cfg.norm_eps),
            (rand(b, t, cfg.d_model),), lambda o: o), "D")
    if any(f == "moe" for _, f in plan):
        p = cast(moe.moe_params(g, cfg.d_model, cfg.moe, torch.float32))
        out["moe ffn (one layer)"] = (alone_ms(
            dev, lambda x: moe.apply_moe(p, x, cfg.moe),
            (rand(b, t, cfg.d_model),), lambda o: o[0]), "moe")
    rec = {}
    for name, ((f, fb), part) in out.items():
        layers = [i for i, (k, ffn) in enumerate(plan) if part in (k, ffn)]
        n_remat = sum(i in remat for i in layers)
        rec[name] = {"fwd_ms": f, "fwd_bwd_ms": fb, "layers": len(layers),
                     "per_step_ms": cs.TRAIN_MICRO * (len(layers) * fb
                                                      + n_remat * f)}
    return rec


def attention_alone(dev) -> dict:
    """The training attention alone at a 5l microbatch's shape (q, k, v
    of (4, 32, 1024, 80) bf16, chunk 512): device ms of a forward and of
    a forward + backward, and what a step's 64 of each (2 microbatches x
    32 layers) plus 64 remat forwards add up to."""
    import chip_smoke as cs
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import layers as L
    cfg = get_config(cs.TRAIN_ARCH)
    shape = (cs.TRAIN_BATCH // cs.TRAIN_MICRO, cfg.n_heads, cs.TRAIN_SEQ,
             cfg.resolved_head_dim)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    grad = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            L.chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk)

    def fwd_bwd():
        L.chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk).backward(
            grad)

    f, fb = cs.cuda_ms(fwd), cs.cuda_ms(fwd_bwd)
    per_step = 2 * cfg.n_layers * (fb + f)
    return {"shape": list(shape), "fwd_ms": f, "fwd_bwd_ms": fb,
            "per_step_ms": per_step}


def moe_runs(dev) -> dict:
    """Phase 5k's cells at chip_smoke.py's sizes and seeds (``MOE``):
    ``generate`` and ``smc_decode`` of each arch, one decoder held at a
    time (the previous one freed first)."""
    import chip_smoke as cs
    import torch
    from repro_torch.models.lm import model as M
    from repro_torch.serve import SMCDecodeConfig, generate, smc_decode
    held = {}

    def setup(arch):
        if held.get("arch") != arch:
            held.clear()
            torch.cuda.empty_cache()
            i = list(cs.MOE).index(arch)
            cfg = cs.kinds_config(arch)
            g = torch.Generator(device=dev)
            g.manual_seed(cs.MOE_SEED + 100 + i)
            held.update(arch=arch, key=cs.MOE_SEED + 200 + i,
                        model=M.init_params(cfg, cs.MOE_SEED + i, device=dev))
            held["prompt"] = torch.randint(
                cfg.vocab_size, (cs.LM_BATCH, cs.MOE[arch][1]), generator=g,
                device=dev)
        return held["model"], held["prompt"]

    runs = {}
    for arch in cs.MOE:
        short = arch.split("-")[0]

        def gen(arch=arch):
            model, prompt = setup(arch)
            return lambda: generate(model, prompt, steps=cs.LM_STEPS)

        def smc(arch=arch):
            model, prompt = setup(arch)
            knobs = SMCDecodeConfig(n_particles=cs.LM_K, steps=cs.LM_STEPS,
                                    proposal_temperature=cs.LM_TAU)
            return lambda: smc_decode(model, prompt, knobs, key=held["key"])

        runs[f"moe-{short}-generate"] = (gen, 1, "call")
        runs[f"moe-{short}-smc-decode"] = (smc, 1, "call")
    return runs


class Regions:
    """While entered, the ``REGIONS`` functions run inside profiler
    ranges of their names (the model calls them through their modules'
    attributes, so the wrappers see every call)."""

    def __enter__(self):
        import importlib
        from torch.profiler import record_function
        self.saved = []
        for (mod, fn), label in REGIONS.items():
            m = importlib.import_module(f"repro_torch.{mod}")
            real = getattr(m, fn)

            def wrapped(*a, _real=real, _label=label, **kw):
                with record_function(_label):
                    return _real(*a, **kw)
            self.saved.append((m, fn, real))
            setattr(m, fn, wrapped)
        return self

    def __exit__(self, *exc):
        for m, fn, real in self.saved:
            setattr(m, fn, real)


PASS_CALLS = 10


def pass_runs(dev) -> dict:
    """B1 and B2 alone, each design, on chip_smoke.py's timing inputs: ten
    calls a run (the redesign through its wrapper, the first design through
    the wrapper module's ``_launch`` with the seven-pass plan)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import resample, sir_fused

    def b1(first):
        def make():
            lw, ll, _, u = cs.fused_inputs(8, 2 ** 22, 7, dev, d=1)
            lw = (lw + ll).contiguous()
            n = lw.shape[1]
            if first:
                p = resample.SysPlan("seven_pass")
                return lambda: [resample._sys_launch(p, lw, u, n)
                                for _ in range(PASS_CALLS)]
            return lambda: [resample.systematic_ancestors_kernel(lw, u, n)
                            for _ in range(PASS_CALLS)]
        return make

    def b2(first, b, n, comb):
        def make():
            lw, ll, st, u = cs.fused_inputs(b, n, 5, dev)
            if first:
                p = sir_fused.FusedPlan("seven_pass")
                return lambda: [sir_fused._launch(p, lw, ll, st, u, 0.5,
                                                  False, comb)
                                for _ in range(PASS_CALLS)]
            return lambda: [sir_fused.fused_weight_step_kernel(
                lw, ll, st, u, comb=comb) for _ in range(PASS_CALLS)]
        return make

    runs = {}
    for first, tag in ((False, "merge"), (True, "seven-pass")):
        runs[f"passes-b1-{tag}"] = (b1(first), PASS_CALLS, "call")
        for label, b, n, comb in (("single", 1, 2 ** 22, True),
                                  ("nocomb", 1, 2 ** 22, False),
                                  ("bank", 8, 2 ** 20, True)):
            runs[f"passes-b2-{label}-{tag}"] = (b2(first, b, n, comb),
                                                PASS_CALLS, "call")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--only", default="", help="path name prefix")
    ap.add_argument("--out", help="also write the record here (JSON)")
    ap.add_argument("--arch", nargs="+", default=["stablelm-3b"],
                    help="the train cells' archs: stablelm-3b (5l) and "
                         "chip_smoke.py's TRAIN_KINDS (5m)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import FilterBank, ParallelParticleFilter, SIRConfig
    from repro_torch.core.asir import ASIRConfig, make_asir_model
    from repro_torch.core.distributed import DRAConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.runtime import EmulatedMesh
    from repro_torch.data.synthetic_movie import generate_movie
    from repro_torch.models.tracking import (TrackingConfig, TrackingSSM,
                                             make_domain_spec)

    dev = torch.device("cuda")
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = TrackingConfig()
    model = TrackingSSM(cfg)
    frames = generate_movie(TorchDraws.from_seed(0, dev), cfg,
                            n_frames=args.frames).frames
    single = dict(n_particles=2 ** 22, ess_frac=0.5, step_backend="fused")
    paths = {
        "single-systematic": dict(sir=SIRConfig(**single)),
        "single-metropolis": dict(sir=SIRConfig(**single,
                                                resampler="metropolis")),
        "single-rejection": dict(sir=SIRConfig(**single,
                                               resampler="rejection")),
        "single-composed": dict(sir=SIRConfig(n_particles=2 ** 22,
                                              ess_frac=0.5)),
    }
    for kind in ("mpf", "rna", "arna", "rpa", "butterfly"):
        paths[f"dist8-{kind}"] = dict(
            sir=SIRConfig(n_particles=8 * 2 ** 22, ess_frac=0.5),
            mesh=EmulatedMesh(8), dra=DRAConfig(kind=kind))
    for kind in ("rna", "rpa"):
        paths[f"domain-{kind}"] = dict(paths[f"dist8-{kind}"],
                                       domain=make_domain_spec(cfg, 8))
    runs = {}
    for label, kw in paths.items():
        def run(kw=kw):
            pf = ParallelParticleFilter(model=model, **kw)
            return lambda: pf.run(1, frames)
        runs[label] = (run, args.frames, "frame")

    def bank():
        # chip_smoke.py's bank: 8 members x 2^20, fused, one movie each
        movies = torch.stack([generate_movie(
            TorchDraws.from_seed(10 + i, dev), cfg,
            n_frames=args.frames).frames for i in range(8)])
        fb = FilterBank(model=model, sir=SIRConfig(
            n_particles=2 ** 20, ess_frac=0.5, step_backend="fused"))
        return lambda: fb.run([100 + i for i in range(8)], movies)
    runs["bank"] = (bank, args.frames, "frame")

    def bank_mesh(kind):
        # chip_smoke.py's phase 5f: 4 members x 2^25 over EmulatedMesh(8)
        def make():
            movies = torch.stack([frames] + [generate_movie(
                TorchDraws.from_seed(20 + i, dev), cfg,
                n_frames=args.frames).frames for i in range(3)])
            fb = FilterBank(model=model, sir=SIRConfig(
                n_particles=8 * 2 ** 22, ess_frac=0.5), mesh=EmulatedMesh(8),
                dra=DRAConfig(kind=kind))
            return lambda: fb.run([1, 201, 202, 203], movies)
        return make
    for kind in ("rna", "rpa"):
        runs[f"bank-mesh-{kind}"] = (bank_mesh(kind), args.frames, "frame")

    def asir():
        # chip_smoke.py's phase 5g: 2-px cells, 4 intensity bins, fused
        am = make_asir_model(model, cfg, ASIRConfig(grid=256,
                                                    intensity_bins=4))
        pf = ParallelParticleFilter(model=am, sir=SIRConfig(**single))
        return lambda: pf.run(1, frames)
    runs["asir"] = (asir, args.frames, "frame")
    runs.update(lm_runs(dev))
    runs.update(moe_runs(dev))
    runs.update(train_runs(dev, args.arch))
    runs.update(pass_runs(dev))
    record = {"card": name, "frames": args.frames, "paths": {}}
    for label, (make, per, unit) in runs.items():
        if not label.startswith(args.only):
            continue
        fn = make()
        fn()                                           # warm-up (and build)
        torch.cuda.synchronize()
        with Regions() if label.startswith(("moe-", "train-")) \
                else nullcontext(), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device events, less the ranges of ``Regions`` (the profiler also
        # records each as a device-side annotation spanning its kernels)
        kernels = [e for e in prof.key_averages()
                   if e.device_type is not None
                   and "CUDA" in str(e.device_type) and _device_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)
                   and e.key not in REGIONS.values()]
        busy_us = sum(_device_us(e) for e in kernels)
        top = sorted(kernels, key=_device_us, reverse=True)[:12]
        groups, launches = {}, {}
        for e in kernels:
            g = port_group(e.key)
            if g is not None:
                groups[g] = groups.get(g, 0.0) + _device_us(e) / 1e3 / per
                launches[g] = launches.get(g, 0) + e.count
        ms_frame = wall * 1e3 / per
        # a region's host-side range: the kernels launched inside it
        regions = {e.key: {"calls": e.count,
                           "device_ms_per_unit": _device_total_us(e) / 1e3
                           / per}
                   for e in prof.key_averages()
                   if e.key in REGIONS.values()
                   and "CPU" in str(e.device_type)}
        rec = {"unit": unit, "ms_per_unit": ms_frame, "regions": regions,
               "device_busy_ms_per_unit": busy_us / 1e3 / per,
               "device_busy_share": busy_us / 1e6 / wall,
               "top": [{"kernel": e.key[:90], "calls": e.count,
                        "ms_per_unit": _device_us(e) / 1e3 / per}
                       for e in top],
               "port_kernels_ms_per_unit": groups,
               "port_kernel_launches": launches}
        record["paths"][label] = rec
        print(f"{label}: {ms_frame:.3f} ms/{unit} wall, device busy "
              f"{rec['device_busy_ms_per_unit']:.3f} ms/{unit} "
              f"({rec['device_busy_share']:.1%}) [{name}]", flush=True)
        for t in rec["top"]:
            print(f"    {t['ms_per_unit']:8.4f} ms/{unit}  {t['calls']:5d}x "
                  f" {t['kernel']}")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    port kernel {g}: {ms:.4f} ms/{unit} "
                  f"({launches[g]} launches)")
        for r, v in regions.items():
            print(f"    region {r}: {v['device_ms_per_unit']:.4f} ms/{unit}"
                  f" of device time ({v['calls']} calls) [{name}]")
        if unit == "frame":
            b3, cs = "B3 (patch_likelihood.cu)", "comb scan (comb_scan.cu)"
            b1, rs = "B1 (resample.cu)", "row sum (row_sum.cu)"
            print(f"    B3 {groups.get(b3, 0.0):.4f} ms/frame "
                  f"({launches.get(b3, 0)} launches), B1 "
                  f"{groups.get(b1, 0.0):.4f} ms/frame "
                  f"({launches.get(b1, 0)} launches), comb scan "
                  f"{groups.get(cs, 0.0):.4f} ms/frame "
                  f"({launches.get(cs, 0)} launches), row sum "
                  f"{groups.get(rs, 0.0):.4f} ms/frame "
                  f"({launches.get(rs, 0)} launches) [{name}]")
        del fn
        torch.cuda.empty_cache()
        if label == "train-stablelm-3b":
            rec["attention_alone"] = a = attention_alone(dev)
            print(f"    chunked attention alone {tuple(a['shape'])}: "
                  f"forward {a['fwd_ms']:.3f} ms, forward + backward "
                  f"{a['fwd_bwd_ms']:.3f} ms; a step's 64 of each "
                  f"{a['per_step_ms']:.1f} ms of {ms_frame:.1f} "
                  f"({a['per_step_ms'] / ms_frame:.1%}) [{name}]")
        elif unit == "step":
            rec["alone"] = regions_alone(dev, label[len("train-"):])
            for r, a in rec["alone"].items():
                print(f"    {r} alone: forward {a['fwd_ms']:.3f} ms, "
                      f"forward + backward {a['fwd_bwd_ms']:.3f} ms over "
                      f"{a['layers']} layers; a step's "
                      f"{a['per_step_ms']:.1f} ms of "
                      f"{ms_frame:.1f} ({a['per_step_ms'] / ms_frame:.1%})"
                      f" [{name}]")
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
