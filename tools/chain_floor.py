#!/usr/bin/env python3
"""The two floors of the chain kernels (B4/B5) on the card.

    python3 tools/chain_floor.py [--n 4194304] [--iters 32]

A chain lane reads its ``iters`` int32 proposals and float32 log-us (the
byte bound) and gathers ``iters`` random float32 weights from a table of
``n`` (16 MB at 2^22, resident in L2): one 32-byte L2 sector each, which
the byte bound does not count.  Two measurement kernels, built here with
``nvcc`` from the source below and never part of the port, time each floor
alone at the chain shape (median of 20 CUDA-event timings):

* ``gather`` — every lane sums ``iters`` weights at hashed indices (no
  draws read); a sweep over block sizes and gathers kept in flight, the
  best of which is the gather floor;
* ``stream`` — every thread sums 16-byte chunks of the two draw tables,
  coalesced, with an evict-first L2 policy (no gathers): the rate the
  draws can move at.

Prints one line per measurement and a JSON record as the last line.
Needs one CUDA card and nvcc.
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

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t mix(uint32_t x) {   // murmur3 finalizer
  x ^= x >> 16; x *= 0x85ebca6bu; x ^= x >> 13; x *= 0xc2b2ae35u;
  return x ^ (x >> 16);
}

// IN_FLIGHT gathers issued before their sum; lanes * iters in all
template <int IN_FLIGHT>
__global__ void gather(const float* __restrict__ w, uint32_t mask, int lanes,
                       int iters, float* out) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  float acc = 0.f;
  for (int r0 = 0; r0 < iters; r0 += IN_FLIGHT) {
    float v[IN_FLIGHT];
#pragma unroll
    for (int i = 0; i < IN_FLIGHT; ++i)
      v[i] = __ldg(w + (mix((uint32_t)l * 64u + r0 + i) & mask));
#pragma unroll
    for (int i = 0; i < IN_FLIGHT; ++i) acc += v[i];
  }
  out[l] = acc;
}

__global__ void stream(const int4* __restrict__ p, const float4* __restrict__ q,
                       long long chunks, float* out) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  float acc = 0.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * blockDim.x) {
    int4 a;
    float4 b;
    asm volatile("ld.global.nc.L2::cache_hint.v4.s32 {%0,%1,%2,%3}, [%4], %5;"
                 : "=r"(a.x), "=r"(a.y), "=r"(a.z), "=r"(a.w)
                 : "l"(p + i), "l"(policy));
    asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0,%1,%2,%3}, [%4], %5;"
                 : "=f"(b.x), "=f"(b.y), "=f"(b.z), "=f"(b.w)
                 : "l"(q + i), "l"(policy));
    acc += (float)(a.x ^ a.y ^ a.z ^ a.w) + b.x + b.y + b.z + b.w;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int run_gather(const float* w, int n, int lanes, int iters,
                          float* out, int threads, int in_flight,
                          void* stream_) {
  cudaStream_t st = (cudaStream_t)stream_;
  int grid = (lanes + threads - 1) / threads;
  uint32_t mask = (uint32_t)n - 1u;
  if (in_flight == 32)
    gather<32><<<grid, threads, 0, st>>>(w, mask, lanes, iters, out);
  else if (in_flight == 8)
    gather<8><<<grid, threads, 0, st>>>(w, mask, lanes, iters, out);
  else
    gather<1><<<grid, threads, 0, st>>>(w, mask, lanes, iters, out);
  return (int)cudaGetLastError();
}

extern "C" int run_stream(const void* p, const void* q, long long chunks,
                          float* out, int grid, int threads, void* stream_) {
  stream<<<grid, threads, 0, (cudaStream_t)stream_>>>(
      (const int4*)p, (const float4*)q, chunks, out);
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    out = kbuild.BUILD_ROOT / "tools"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "chain_floor.cu", out / "libchain_floor.so"
    src.write_text(SOURCE)
    subprocess.run([kbuild.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True, timeout=600)
    cl = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    cl.run_gather.argtypes = [p, i, i, i, p, i, i, p]
    cl.run_stream.argtypes = [p, p, ctypes.c_longlong, p, i, i, p]
    return cl


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2 ** 22)
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chain_floor: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    if args.n & (args.n - 1):
        raise SystemExit("--n must be a power of two")
    name = cs.card()
    dev = torch.device("cuda")
    lib = build()
    st = torch.cuda.current_stream().cuda_stream
    n, lanes, iters = args.n, args.n, args.iters
    w = torch.randn(n, device=dev)
    out = torch.empty(lanes, device=dev)
    sectors = lanes * iters
    rec = {"card": name, "n": n, "iters": iters, "sectors": sectors,
           "gather": {}}

    def launched(err):
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")

    for threads in (128, 256, 512):
        for in_flight in (1, 8, 32):
            ms = cs.cuda_ms(lambda: launched(lib.run_gather(
                w.data_ptr(), n, lanes, iters, out.data_ptr(), threads,
                in_flight, st)))
            rec["gather"][f"{threads}x{in_flight}"] = ms
            print(f"gather {threads} threads, {in_flight} in flight: "
                  f"{ms:.4f} ms, {sectors / ms / 1e6:.1f} G sectors/s "
                  f"[{name}]", flush=True)
    rec["gather_floor_ms"] = min(rec["gather"].values())
    prop = torch.randint(n, (lanes, iters), device=dev, dtype=torch.int32)
    logu = torch.rand((lanes, iters), device=dev)
    chunks = prop.numel() // 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    part = torch.empty(sms * 8 * 256, device=dev)
    ms = cs.cuda_ms(lambda: launched(lib.run_stream(
        prop.data_ptr(), logu.data_ptr(), chunks, part.data_ptr(), sms * 8,
        256, st)))
    nbytes = prop.numel() * 8
    rec["stream_ms"], rec["stream_bytes"] = ms, nbytes
    bound, _ = cs.chain_bound(1, n, lanes, iters)
    rec["byte_bound_ms"] = bound
    print(f"stream of the draws ({nbytes / 1e9:.3f} GB): {ms:.4f} ms, "
          f"{nbytes / ms / 1e9:.1f} TB/s; byte bound {bound:.4f} ms; "
          f"gather floor {rec['gather_floor_ms']:.4f} ms [{name}]",
          flush=True)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
