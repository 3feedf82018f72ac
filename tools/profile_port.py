#!/usr/bin/env python3
"""Where a frame (or a decode run) of the torch port goes on the card,
path by path.

    python3 tools/profile_port.py [--frames 12] [--only PREFIX] [--out FILE]

For each path of ``chip_smoke.py`` — the single tracking filter at
N = 2^22 (systematic, Metropolis and rejection resampling, fused step),
the distributed filter on an emulated 8-shard mesh at 8 × 2^22 (MPF,
RNA, RPA), all on 512×512 frames, and the LM serving cells at
qwen3-32b width with 16 layers (``generate`` and ``smc_decode``, at
chip_smoke.py's sizes) — it runs the path once to warm up, then once
under ``torch.profiler`` (``--frames`` frames of a filter; one whole
call of an LM cell) and prints the wall time per frame or call, the
device busy share (the sum of kernel times over the wall time: one
stream, so kernels do not overlap) and the kernels that take the most
device time.  ``--only`` keeps the paths whose name starts with it.
Needs one CUDA card; exits non-zero without.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--only", default="", help="path name prefix")
    ap.add_argument("--out", help="also write the record here (JSON)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import ParallelParticleFilter, SIRConfig
    from repro_torch.core.distributed import DRAConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.runtime import EmulatedMesh
    from repro_torch.data.synthetic_movie import generate_movie
    from repro_torch.models.tracking import TrackingConfig, TrackingSSM

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
    }
    for kind in ("mpf", "rna", "rpa"):
        paths[f"dist8-{kind}"] = dict(
            sir=SIRConfig(n_particles=8 * 2 ** 22, ess_frac=0.5),
            mesh=EmulatedMesh(8), dra=DRAConfig(kind=kind))
    runs = {}
    for label, kw in paths.items():
        def run(kw=kw):
            pf = ParallelParticleFilter(model=model, **kw)
            return lambda: pf.run(1, frames)
        runs[label] = (run, args.frames, "frame")
    runs.update(lm_runs(dev))
    record = {"card": name, "frames": args.frames, "paths": {}}
    for label, (make, per, unit) in runs.items():
        if not label.startswith(args.only):
            continue
        fn = make()
        fn()                                           # warm-up (and build)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type is not None
                   and "CUDA" in str(e.device_type) and _device_us(e) > 0]
        busy_us = sum(_device_us(e) for e in kernels)
        top = sorted(kernels, key=_device_us, reverse=True)[:12]
        ms_frame = wall * 1e3 / per
        rec = {"unit": unit, "ms_per_unit": ms_frame,
               "device_busy_ms_per_unit": busy_us / 1e3 / per,
               "device_busy_share": busy_us / 1e6 / wall,
               "top": [{"kernel": e.key[:90], "calls": e.count,
                        "ms_per_unit": _device_us(e) / 1e3 / per}
                       for e in top]}
        record["paths"][label] = rec
        print(f"{label}: {ms_frame:.3f} ms/{unit} wall, device busy "
              f"{rec['device_busy_ms_per_unit']:.3f} ms/{unit} "
              f"({rec['device_busy_share']:.1%}) [{name}]", flush=True)
        for t in rec["top"]:
            print(f"    {t['ms_per_unit']:8.4f} ms/{unit}  {t['calls']:5d}x "
                  f" {t['kernel']}")
        del fn
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
