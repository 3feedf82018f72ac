#!/usr/bin/env python3
"""B6's mma.sync and float32 kernels against another tree's, bit for bit.

    git archive <commit> src/repro_torch/csrc | tar -x -C <dir>
    python3 tools/b6_parent_bits.py --parent <dir>

Builds ``<dir>/src/repro_torch/csrc/flash_attention.cu`` (an earlier
commit's, whose C entry has no v head dim) with ``nvcc`` beside this
tree's library, and launches both on the same inputs for every head dim
the bf16 kernel takes (q, k and v of one head dim), in bf16 and float32:
ragged and soft-capped, a decode offset on a strided cache view, a
sliding window, one query row and a non-causal call, each grouped.
Every output must be the earlier tree's, bit for bit: the (Dqk, Dv)
template left each (D, D) kernel's arithmetic as it was.  Prints the
count of cases and a JSON record as the last line.  Needs one CUDA card
and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 256)


def cases(d):
    """(q shape, k shape, view length, soft-cap, window, causal)."""
    return (((2, 8, 37, d), (2, 2, 100, d), None, 30.0, 0, True),
            ((2, 16, 300, d), (2, 2, 333, d), 320, 0.0, 0, True),
            ((2, 16, 200, d), (2, 2, 200, d), None, 0.0, 64, True),
            ((4, 8, 1, d), (4, 2, 500, d), 400, 0.0, 0, True),
            ((2, 8, 50, d), (2, 2, 77, d), None, 0.0, 0, False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a directory holding the earlier tree's "
                         "src/repro_torch/csrc")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("b6_parent_bits: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, flash_attention as fa

    src = os.path.join(os.path.abspath(args.parent), "src", "repro_torch",
                       "csrc")
    out = os.path.join(str(build.build_all()), "libflash_attention_parent.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", src, "-o",
                    out, os.path.join(src, "flash_attention.cu")],
                   check=True, capture_output=True, timeout=600)
    c_p, c_ll, c_i, c_f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_float)
    old = ctypes.CDLL(out)
    old.ppf_flash_attention.argtypes = ([c_p] * 4 + [c_ll] * 9 + [c_i] * 9
                                        + [c_f, c_f, c_p])
    new = fa._lib()
    dev = torch.device("cuda")
    n = 0
    for d in HEAD_DIMS:
        for dt in (torch.bfloat16, torch.float32):
            for qs, ks, lk, cap, window, causal in cases(d):
                q, k, v = cs.attn_inputs(qs, ks, dt, d, dev, lk)
                b, hq, lq, _ = q.shape
                hkv, keys = k.shape[1], k.shape[2]
                outs = []
                for lib, dv in ((old, ()), (new, (d,))):
                    o = q.new_empty((b, hq, lq, d))
                    err = lib.ppf_flash_attention(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                        *v.stride()[:3], b, hq, hkv, lq, keys, d, *dv,
                        int(dt == torch.bfloat16), int(causal), window,
                        d ** -0.5, cap,
                        torch.cuda.current_stream().cuda_stream)
                    cs.check(err == 0, f"launch error {err}")
                    outs.append(o)
                torch.cuda.synchronize()
                cs.check(torch.equal(outs[0], outs[1]),
                         f"D={d} {dt} q{qs} kv{ks}: not the earlier bits")
                n += 1
    print(f"B6 (D, D) outputs bit for bit the earlier tree's: {n} cases, "
          f"head dims {HEAD_DIMS}, bf16 and float32 [{cs.card()}]")
    print(json.dumps({"cases": n, "equal": n, "card": cs.card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
