// Fixed-order tile reductions shared by the port's Hopper kernels
// (csrc/sir_fused.cu, csrc/resample.cu, csrc/comb_scan.cu).
//
// One block of TILE threads covers one tile of TILE elements.  Every
// reduction is a fixed tree — warp shuffles, then the warp results in warp
// order — with no atomics, so two runs give the same bits and a member's
// result never depends on how many other members share the launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 1024;   // particles per tile == threads per block
constexpr int WARPS = TILE / 32;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int n_tiles(int N) { return (N + TILE - 1) / TILE; }

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(FULL, v, o));
  return v;
}

// Fixed-order block reductions over TILE threads; the result is valid in
// thread 0.  `sh` holds WARPS floats and may be reused after the call.
__device__ float block_sum(float v, float* sh) {
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  v = (threadIdx.x < WARPS) ? sh[threadIdx.x] : 0.f;
  if (wid == 0) v = warp_sum(v);
  return v;
}

__device__ float block_max(float v, float* sh) {
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  v = (threadIdx.x < WARPS) ? sh[threadIdx.x] : -INFINITY;
  if (wid == 0) v = warp_max(v);
  return v;
}

// Inclusive scan over TILE threads; every thread gets its prefix and the
// block total (bitwise equal to the last thread's prefix).  T is float (the
// fused weight phase, B1) or double (the comb scan, comb_scan.cu).
template <typename T>
__device__ T block_scan(T v, T* sh, T* total) {
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    T n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  __syncthreads();
  if (lane == 31) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    T t = sh[lane];
    for (int o = 1; o < 32; o <<= 1) {
      T n = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += n;
    }
    sh[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v += sh[wid - 1];
  *total = sh[WARPS - 1];
  return v;
}

}  // namespace
