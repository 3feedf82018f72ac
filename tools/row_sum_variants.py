#!/usr/bin/env python3
"""The row-sum kernel's tile and occupancy, compared on the card.

    python3 tools/row_sum_variants.py [--variants 4096:8,8192:6,...]
                                      [--out FILE]

Each variant ``TILE:BLOCKS`` is ``csrc/row_sum.cu`` with its tile
(``RS_TILE``, elements of a row a block) and its inner = 1 register cap
(``rs_min_blocks(1)``, resident blocks an SM) set to those values, built
here with ``nvcc`` into ``src/repro_torch/_build/row_sum_variants/`` and
never part of the port.  A tile is another order of additions, so each
variant is first held bit for bit to ``row_sum_emulated`` with its tile;
then every variant and ``torch.sum`` are timed in turns (forward, then
reversed) at 1, 8 and 32 x 2^22, at (2^22, 5) and at 8 x (2^22 - 3),
whose rows start off 16-byte boundaries: device ms behind a
``torch.cuda._sleep`` (``chip_smoke.queued_device_ms``) and host-inclusive
ms (``chip_smoke.cuda_ms``), beside the byte bound.  Registers and blocks
an SM come from the CUDA occupancy API.

Prints one line per shape and a JSON record as the last line.  Needs one
CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

TILE_LINE = "constexpr int RS_TILE = 4096;"
BLOCKS_LINE = "return inner == 1 ? 8 :"
SHAPES = [(1, 2 ** 22, 1), (8, 2 ** 22, 1), (32, 2 ** 22, 1),
          (1, 2 ** 22, 5), (8, 2 ** 22 - 3, 1)]
CHECKS = [(8, 2 ** 22, 1), (3, 2 ** 22 - 3, 1), (4, 2 ** 20 + 7, 5),
          (2, 99999, 8), (300, 4, 1), (2, 5000, 11)]


def build(variants: dict) -> dict:
    """``{name: ctypes library}``, one nvcc per variant in parallel."""
    from repro_torch.kernels import build as kbuild
    src = (kbuild.CSRC / "row_sum.cu").read_text()
    assert TILE_LINE in src and BLOCKS_LINE in src, "row_sum.cu changed"
    out = kbuild.BUILD_ROOT / "row_sum_variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = kbuild.find_nvcc()
    procs = {}
    for name, (tile, blocks) in variants.items():
        path = out / f"{name}.cu"
        path.write_text(src.replace(TILE_LINE, f"constexpr int RS_TILE = "
                                               f"{tile};")
                        .replace(BLOCKS_LINE, f"return inner == 1 ? "
                                              f"{blocks} :"))
        procs[name] = subprocess.Popen(
            [nvcc, *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC), "-o",
             str(out / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn in (lib.ppf_row_sum, lib.ppf_row_sum_v1):
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ppf_row_sum_occupancy.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.ppf_row_sum_occupancy.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants",
                    default="4096:4,4096:6,4096:8,8192:4,8192:6,8192:8",
                    help="comma-separated TILE:BLOCKS (TILE a multiple of "
                         "4096)")
    ap.add_argument("--out", help="also write the record here (JSON)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("row_sum_variants: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card, cuda_ms, queued_device_ms
    from repro_torch.kernels import row_sum as rs
    name = card()
    variants = {}
    for item in args.variants.split(","):
        tile, blocks = (int(v) for v in item.split(":"))
        variants[f"t{tile}b{blocks}"] = (tile, blocks)
    libs = build(variants)

    def use(v):
        rs._lib = lambda: libs[v]
        rs.TILE = variants[v][0]

    dev = torch.device("cuda")
    record = {"card": name, "variants": {}, "shapes": {}}
    g = torch.Generator(device=dev)
    for v in libs:
        use(v)
        for i, shape in enumerate(CHECKS):
            g.manual_seed(i)
            x = torch.randn(shape, generator=g, device=dev)
            shift = x.amax(1)
            same = (torch.equal(rs.row_sum_kernel(x), rs.row_sum_emulated(x))
                    and torch.equal(rs.row_sum_kernel(x, shift),
                                    rs.row_sum_emulated(x, shift)))
            if not same:
                raise SystemExit(f"{v} {shape}: differs from its emulation")
        record["variants"][v] = {
            "tile": variants[v][0], "min_blocks": variants[v][1],
            **{f"inner {i}": rs.occupancy(i) for i in (1, 5)}}
        print(f"{v}: bit for bit its emulation at {CHECKS}; occupancy "
              f"{record['variants'][v]}", flush=True)
    for rows, n, inner in SHAPES:
        x = torch.rand((rows, n, inner), generator=g, device=dev)
        # a variant's call is the same wrapper on the library `use` binds
        fns = {v: (lambda: rs.row_sum_kernel(x)) for v in libs}
        fns["torch.sum"] = lambda: x.sum(1)
        dev_t, host = {k: [] for k in fns}, {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                if k in libs:
                    use(k)
                dev_t[k].append(queued_device_ms(fns[k]))
                host[k].append(cuda_ms(fns[k]))
        bound = rows * n * inner * 4 / 3.35e12 * 1e3
        rec = {k: {"device_ms": statistics.mean(dev_t[k]),
                   "ms": statistics.mean(host[k])} for k in fns}
        label = f"{rows}x{n}x{inner}"
        record["shapes"][label] = {"bound_ms": bound, **rec}
        print(f"{label}: bound {bound:.4f} ms; " + "; ".join(
            f"{k} {r['device_ms']:.4f} device / {r['ms']:.4f}"
            for k, r in rec.items()) + f" [{name}]", flush=True)
        del x
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
