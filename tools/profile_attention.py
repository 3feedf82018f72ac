#!/usr/bin/env python3
"""B6 (flash attention) at the LM path's four shapes: device time per
kernel and host time per call, for the port's kernel, its mma.sync
kernel and PyTorch's scaled_dot_product_attention.

    python3 tools/profile_attention.py [--out FILE]

The shapes are chip_smoke.py's ``time_attention`` ones (qwen3-32b, 64/8
heads of 128: the smc and generate prefills of 1024 tokens, and their
decode steps over a 1040-slot view of a 1057-slot cache).  For each
function it prints the host time of one call (the mean over a run of
back-to-back calls, before the closing synchronize), the wall time per
call of that run, and each kernel's device time per call from
``torch.profiler`` over 10 calls.  A decode step is host-bound when the
host time exceeds the device time.  Needs one CUDA card; exits non-zero
without.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

SHAPES = {
    "smc_prefill": ((32, 64, 1024, 128), (32, 8, 1024, 128), None),
    "generate_prefill": ((4, 64, 1024, 128), (4, 8, 1024, 128), None),
    "smc_decode": ((32, 64, 1, 128), (32, 8, 1057, 128), 1040),
    "generate_decode": ((4, 64, 1, 128), (4, 8, 1057, 128), 1040),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the record here (JSON)")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_attention: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from profile_port import _device_us
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    name = cs.card()
    record = {"card": name, "shapes": {}}
    for label, (qs, ks, lk) in SHAPES.items():
        q, k, v = cs.attn_inputs(qs, ks, torch.bfloat16, 7, dev, lk)
        # B6's causal rule aligns the last query with the last key, so a
        # decode step (Lq = 1) sees every key; SDPA's aligns the first
        # ones, so it takes a decode step as non-causal
        causal = q.shape[2] == k.shape[2]
        scale = qs[-1] ** -0.5
        fns = {
            fa.plan(q.shape, k.shape, q.dtype).variant:
                lambda: fa.flash_attention_kernel(q, k, v),
            "mma": lambda: fa._launch(fa.Plan("mma"), q, k, v, True, scale,
                                      0.0),
            "sdpa": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale, enable_gqa=True)}
        rec = record["shapes"][label] = {}
        for fname, fn in fns.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            n = 200 if q.shape[2] == 1 else 20
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            kernels = {e.key[:70]: _device_us(e) / 10
                       for e in prof.key_averages() if _device_us(e) > 0}
            rec[fname] = {"host_us": (t1 - t0) / n * 1e6,
                          "wall_us": (t2 - t0) / n * 1e6,
                          "device_us": kernels}
            print(f"{label} {fname}: host {rec[fname]['host_us']:.1f} us, "
                  f"wall {rec[fname]['wall_us']:.1f} us per call; device "
                  + ", ".join(f"{kn} {us:.2f} us"
                              for kn, us in kernels.items())
                  + f" [{name}]", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
