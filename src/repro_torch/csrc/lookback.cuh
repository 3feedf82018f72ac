// The fixed-order one-launch look-back scan of a tile, shared by the comb
// scan (comb_scan.cu), B1's CDF (resample.cu) and B2's (sir_fused.cu).
//
// A row is cut into tiles of SPAN elements.  A block takes the next tile
// from an integer ticket, row-major, so it only ever waits on tiles whose
// blocks are already running.  Thread t owns the tile's elements 16t ..
// 16t + 15, held in shared memory as float4s at pad4(4t) .. pad4(4t + 3);
// it sums them in double, in sequence, and a Kogge-Stone scan over the
// block gives its exclusive prefix in the tile.  The tile's offset is a
// sum, in a tree fixed by the tile's index alone, of totals other tiles
// published: the totals of the tiles before it in its group of GROUP
// tiles, and the group sums of the groups before that (each published by
// the group's last tile).  So the order of every sum is the same in every
// run, a row never depends on the other rows, and each prefix is a double
// rounded to float32 once.  A published value travels with its call's
// epoch in one 16-byte word, so the scratch needs no reset between calls.
//
// The kernels that use it differ only in how a tile is loaded (comb_scan:
// x itself; B1: w = exp(lw - m) / s; B2: B2's weights) and in what else a
// tile does while its predecessors publish.
#pragma once

#include <stdint.h>

#include "tile_reduce.cuh"

namespace {
namespace lb {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 16;                       // elements a thread scans
constexpr int SPAN = THREADS * PER;           // elements a tile
constexpr int CHUNKS = SPAN / 4;              // float4s a tile
constexpr int GROUP = 32;                     // tiles a group sum covers
constexpr int BUF = CHUNKS + CHUNKS / 8;      // padded float4s a tile

// a published double and the epoch of the call that published it, in one
// 16-byte word: written and read by single 16-byte accesses, so a reader
// that sees the epoch sees the value (the packing CUB's single-pass scan
// uses for 8-byte values), and no fence or acquire is needed
struct __align__(16) Slot {
  double v;
  unsigned long long epoch;
};

__device__ __forceinline__ void publish(Slot* s, double v, unsigned epoch) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};"
               :: "l"(s), "l"(__double_as_longlong(v)),
                  "l"((unsigned long long)epoch) : "memory");
}

__device__ __forceinline__ double wait_for(const Slot* s, unsigned epoch) {
  unsigned long long v, e;
  while (true) {
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(v), "=l"(e) : "l"(s) : "memory");
    if (e == epoch) return __longlong_as_double(v);
    __nanosleep(32);
  }
}

// lane 0's sum of the warp's 32 values, in the fixed tree of shfl_down
__device__ __forceinline__ double warp_tree(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// a padded float4 index: one float4 of padding every 8, so that thread t
// reading its 4 consecutive float4s (t*4 ..) hits no bank twice
__device__ __forceinline__ int pad4(int c) { return c + (c >> 3); }

// element i of a tile held in `buf`
__device__ __forceinline__ float at(const float4* buf, int i) {
  return reinterpret_cast<const float*>(&buf[pad4(i >> 2)])[i & 3];
}

__host__ __device__ inline long long tiles(long long n) {
  return (n + SPAN - 1) / SPAN;
}

__host__ __device__ inline long long groups(long long nt) {
  return (nt + GROUP - 1) / GROUP;
}

// The block's ticket (thread 0 draws it; every thread reads it after the
// barrier).  The block that draws the last ticket resets the counter for
// the next call.
__device__ __forceinline__ unsigned draw_ticket(unsigned* ticket,
                                                unsigned blocks,
                                                unsigned* s_ticket) {
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == blocks - 1) atomicExch(ticket, 0u);   // every block has drawn
    *s_ticket = t;
  }
  __syncthreads();
  return *s_ticket;
}

// The tile of row `xr` (len elements from its start), coalesced: chunk c of
// 4 elements at float4 pad4(c), each in-range element v stored as f(v),
// each element past len as 0.  16-byte loads when `vec`.
template <class F>
__device__ __forceinline__ void load_tile(const float* xr, int len, int vec,
                                          float4* buf, F f) {
#pragma unroll
  for (int k = 0; k < PER / 4; ++k) {
    const int c = k * THREADS + threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec && 4 * c + 3 < len) {
      v = reinterpret_cast<const float4*>(xr)[c];
      v = make_float4(f(v.x), f(v.y), f(v.z), f(v.w));
    } else {
      if (4 * c + 0 < len) v.x = f(xr[4 * c + 0]);
      if (4 * c + 1 < len) v.y = f(xr[4 * c + 1]);
      if (4 * c + 2 < len) v.z = f(xr[4 * c + 2]);
      if (4 * c + 3 < len) v.w = f(xr[4 * c + 3]);
    }
    buf[pad4(c)] = v;
  }
}

// After the tile is in `buf` (and a barrier): the thread's exclusive
// prefix in the tile; *total is the tile's sum.  `sh` holds WARPS doubles.
__device__ __forceinline__ double tile_prefix(const float4* buf, double* sh,
                                              double* total) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  // the thread's PER consecutive elements, summed in sequence
  double sum = 0.0;
#pragma unroll
  for (int k = 0; k < PER / 4; ++k) {
    const float4 v = buf[pad4(4 * tid + k)];
    sum += (double)v.x;
    sum += (double)v.y;
    sum += (double)v.z;
    sum += (double)v.w;
  }
  // inclusive Kogge-Stone scan of the thread sums: in the warp, then over
  // the warp totals (warp 0)
  double incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const double m = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += m;
  }
  if (lane == 31) sh[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    double t = lane < WARPS ? sh[lane] : 0.0;
    for (int o = 1; o < WARPS; o <<= 1) {
      const double m = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += m;
    }
    if (lane < WARPS) sh[lane] = t;
  }
  __syncthreads();
  // the previous thread's inclusive prefix (an earlier warp's total for a
  // warp's first thread)
  const double prev = __shfl_up_sync(FULL, incl, 1);
  *total = sh[WARPS - 1];
  return lane > 0 ? (wid > 0 ? sh[wid - 1] + prev : prev)
                  : (wid > 0 ? sh[wid - 1] : 0.0);
}

// Warp 0, after the tile's total is published: the tile's offset (valid in
// lane 0).  `ar` and `gr` are the row's tile and group slots.
__device__ __forceinline__ double offset(Slot* ar, Slot* gr, int tile, int nt,
                                         double total, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  const int g = tile / GROUP, r = tile - g * GROUP;
  const Slot* gs = ar + g * GROUP;
  double a = lane < r ? wait_for(&gs[lane], epoch) : 0.0;
  // the group's sum, from its last tile, for the tiles after it
  if (r == GROUP - 1 && tile + 1 < nt) {
    const double gsum = warp_tree(lane == r ? total : a);
    if (lane == 0) publish(&gr[g], gsum, epoch);
  }
  const double in_group = warp_tree(a);
  // the groups before: lane l sums groups l, l + 32, ... in order
  double before = 0.0;
  for (int j = lane; j < g; j += 32) before += wait_for(&gr[j], epoch);
  before = warp_tree(before);
  return before + in_group;
}

// Warp 0: publish the tile's total, then return its offset (lane 0).
__device__ __forceinline__ double look_back(Slot* ar, Slot* gr, int tile,
                                            int nt, double total,
                                            unsigned epoch) {
  if ((threadIdx.x & 31) == 0) publish(&ar[tile], total, epoch);
  return offset(ar, gr, tile, nt, total, epoch);
}

// y of the tile: (offset + the thread's exclusive prefix) + its running
// sum, rounded to float32 once, written coalesced through `buf`.
__device__ __forceinline__ void store_tile(float4* buf, float* yr, int len,
                                           int vec, double base) {
  const int tid = threadIdx.x;
  double p = 0.0;
#pragma unroll
  for (int k = 0; k < PER; k += 4) {
    const int at = pad4(4 * tid + k / 4);
    const float4 v = buf[at];
    float4 o;
    p += (double)v.x; o.x = (float)(base + p);
    p += (double)v.y; o.y = (float)(base + p);
    p += (double)v.z; o.z = (float)(base + p);
    p += (double)v.w; o.w = (float)(base + p);
    buf[at] = o;           // only this thread reads or writes these
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER / 4; ++k) {
    const int c = k * THREADS + tid;
    const float4 v = buf[pad4(c)];
    if (vec && 4 * c + 3 < len) {
      reinterpret_cast<float4*>(yr)[c] = v;
    } else {
      if (4 * c + 0 < len) yr[4 * c + 0] = v.x;
      if (4 * c + 1 < len) yr[4 * c + 1] = v.y;
      if (4 * c + 2 < len) yr[4 * c + 2] = v.z;
      if (4 * c + 3 < len) yr[4 * c + 3] = v.w;
    }
  }
}

// One tile of the scan, every step: the body of comb_scan.cu's
// k_scan_lookback and of B1's CDF pass.  The tile's element v is loaded as
// f(v); `agg` and `grp` are every row's tile and group slots.
template <class F>
__device__ __forceinline__ void scan_tile(const float* x, float* y, int n,
                                          int nt, int ng, long long row,
                                          int tile, Slot* agg, Slot* grp,
                                          unsigned epoch, int vec, float4* buf,
                                          double* sh, double* s_off, F f) {
  const long long start = (long long)tile * SPAN;
  const int len = (int)min((long long)SPAN, (long long)n - start);
  load_tile(x + row * n + start, len, vec, buf, f);
  __syncthreads();
  double total;
  const double excl = tile_prefix(buf, sh, &total);
  if ((threadIdx.x >> 5) == 0) {
    const double off = look_back(agg + row * nt, grp + row * ng, tile, nt,
                                 total, epoch);
    if (threadIdx.x == 0) *s_off = off;
  }
  __syncthreads();
  store_tile(buf, y + row * n + start, len, vec, *s_off + excl);
}

}  // namespace lb
}  // namespace
