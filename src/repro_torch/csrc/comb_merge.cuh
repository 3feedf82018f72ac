// The two halves of a comb that B1 (resample.cu) and B2 (sir_fused.cu)
// share around the look-back scan of lookback.cuh: the member's normalizer
// in one launch, and the comb by a load-balanced merge of the CDF with the
// comb points.
//
// The normalizer.  A tile of lb::SPAN values publishes its part: its max
// m_t and, in double, s_t = sum exp(v - m_t) (and, for B2, q_t = sum of the
// squares).  Thread t holds chunks t, t + 256, t + 512, t + 768 of 4 values
// and sums its 16 in that order; the block sums the threads in the fixed
// tree of lb::warp_tree (lanes, then warps).  The block that finishes a
// member's last tile (an integer ticket per member) combines the member's
// parts in a tree fixed by tile index: the max M of the m_t, then the sum of
// s_t * exp(m_t - M) (thread t takes tiles t, t + 256, ... in order), so the
// sum's order never depends on which block came last.  No float atomics.
//
// The merge.  The comb points pos_i = ((float)i + u) / n_out are sorted, and
// so is the CDF (or it is NaN throughout, for a member with no finite
// weight), so the ancestors are a merge: CDF value k comes before point i
// iff cdf[k] <= pos_i, and ancestor i is the number of CDF values before
// point i, clamped to n_in - 1 — the first design's upper-bound bisection,
// exactly.  The merged sequence (n_in + n_out items) is cut into diagonals
// of MERGE_SPAN items, one block each, so every block does the same work
// whatever the weights: one slot holding all the mass, long dead runs,
// n_out != n_in.  Where each diagonal starts (its split: how many CDF
// values precede it) comes first, in a launch of its own, a warp a split,
// by a 32-way search in two levels: over the CDF's every COARSE-th value,
// which the CDF pass writes beside the CDF (an array the L2 holds), then
// over the at most COARSE values left.  (Searched inside the merge blocks,
// the searches' dependent loads held each block up.)  A merge block reads
// its two splits, loads its CDF slice into shared memory with all its
// loads in flight, and each thread merges a sub-diagonal of MERGE_PER
// items after a bisection of the slice in shared memory; the ancestors
// leave through shared memory, coalesced.
#pragma once

#include <stdint.h>

#include "lookback.cuh"

namespace {
namespace cm {

using lb::THREADS;
using lb::WARPS;
using lb::SPAN;

constexpr int MERGE_THREADS = 128;
constexpr int MERGE_PER = 32;                        // items a thread merges
constexpr int MERGE_SPAN = MERGE_THREADS * MERGE_PER;  // items a block
constexpr int COARSE = 64;                 // CDF values a coarse sample covers
// a block's shared words: its slice and its ancestors, one padding word
// every 32 (pad()), and the 16-byte loads' lead
constexpr int MERGE_WORDS = MERGE_SPAN + MERGE_SPAN / 32 + 16;

// Thread t walks its own MERGE_PER consecutive items, so without padding
// the threads of a warp would read and write words 16 or 32 apart: one
// bank.  A padding word every 32 puts them in distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// a tile's part of the normalizer (32 bytes)
struct __align__(16) Part {
  double s;      // sum exp(v - m) over the tile
  double q;      // sum exp(v - m)^2 (B2's ESS)
  float m;       // the tile's max
  float pad[3];
};

// chunk c of a tile of len values at xr: 4 values, `fill` past len
__device__ __forceinline__ float4 load4(const float* xr, int len, int vec,
                                        int c, float fill) {
  float4 v = make_float4(fill, fill, fill, fill);
  if (vec && 4 * c + 3 < len) {
    v = reinterpret_cast<const float4*>(xr)[c];
  } else {
    if (4 * c + 0 < len) v.x = xr[4 * c + 0];
    if (4 * c + 1 < len) v.y = xr[4 * c + 1];
    if (4 * c + 2 < len) v.z = xr[4 * c + 2];
    if (4 * c + 3 < len) v.w = xr[4 * c + 3];
  }
  return v;
}

// the block's max of one float a thread, in every thread
__device__ __forceinline__ float block_max_all(float v, float* shf) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) shf[wid] = v;
  __syncthreads();
  float m = shf[0];
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, shf[w]);
  __syncthreads();          // shf may be reused
  return m;
}

// the block's sum of one double a thread in the fixed tree (lanes, then the
// warps' sums in lane order, zeros above), valid in thread 0
__device__ __forceinline__ double block_tree(double v, double* shd) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = lb::warp_tree(v);
  if (lane == 0) shd[wid] = v;
  __syncthreads();
  if (wid == 0) v = lb::warp_tree(lane < WARPS ? shd[lane] : 0.0);
  __syncthreads();          // shd may be reused
  return v;
}

// A tile's part from its 16 values a thread (v[4k + j] = element
// 4(k * THREADS + tid) + j; -inf past the tile's end).  Valid in thread 0.
template <bool Q>
__device__ __forceinline__ Part tile_part(const float (&v)[16], float* shf,
                                          double* shd) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) m = fmaxf(m, v[j]);
  m = block_max_all(m, shf);
  double s = 0.0, q = 0.0;
  if (m != -INFINITY) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float e = expf(v[j] - m);
      s += (double)e;
      if (Q) q += (double)e * (double)e;
    }
  }
  Part p;
  p.s = block_tree(s, shd);
  p.q = Q ? block_tree(q, shd) : 0.0;
  p.m = m;
  return p;
}

// Thread 0 publishes the tile's part; returns, in every thread, whether
// this block finished the member's last tile (then the member's parts are
// all visible to it, and its counter is reset for the next call).
__device__ __forceinline__ bool publish_part(const Part& p, Part* slot,
                                             unsigned* count, unsigned nt,
                                             unsigned* s_last) {
  if (threadIdx.x == 0) {
    *slot = p;
    __threadfence();
    const unsigned done = atomicAdd(count, 1u);
    *s_last = done == nt - 1;
    if (done == nt - 1) *count = 0u;
  }
  __syncthreads();
  const bool last = *s_last != 0u;
  if (last) __threadfence();
  return last;
}

// The last block: the member's M (the max of its tiles' maxima) and, in
// the fixed order, S = sum s_t * exp(m_t - shift) and Q = sum q_t *
// exp(2 (m_t - shift)) over the tiles with a finite max, where shift is M
// (B1) or M if finite else 0 (B2).  Valid in thread 0; M in every thread.
// A thread's first CACHED parts are loaded at once, into registers; the
// block that runs this is the member's last, so its latency is the call's.
constexpr int CACHED = 4;

template <bool Q>
__device__ __forceinline__ void combine_parts(const Part* parts, int nt,
                                              bool finite_shift, float* M,
                                              double* S, double* Qs,
                                              float* shf, double* shd) {
  float mc[CACHED];
  double sc[CACHED], qc[CACHED];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < CACHED; ++k) {
    const int t = threadIdx.x + k * THREADS;
    mc[k] = t < nt ? __ldcg(&parts[t].m) : -INFINITY;
    sc[k] = t < nt ? __ldcg(&parts[t].s) : 0.0;
    qc[k] = Q && t < nt ? __ldcg(&parts[t].q) : 0.0;
    m = fmaxf(m, mc[k]);
  }
  for (int t = threadIdx.x + CACHED * THREADS; t < nt; t += THREADS)
    m = fmaxf(m, __ldcg(&parts[t].m));
  m = block_max_all(m, shf);
  *M = m;
  const double shift = (finite_shift && !isfinite(m)) ? 0.0 : (double)m;
  // thread t's tiles t, t + THREADS, ... in order
  double s = 0.0, q = 0.0;
#pragma unroll
  for (int k = 0; k < CACHED; ++k) {
    if (mc[k] != -INFINITY) {
      const double dm = (double)mc[k] - shift;
      s = __dadd_rn(s, __dmul_rn(sc[k], exp(dm)));
      if (Q) q = __dadd_rn(q, __dmul_rn(qc[k], exp(2.0 * dm)));
    }
  }
  for (int t = threadIdx.x + CACHED * THREADS; t < nt; t += THREADS) {
    const float mt = __ldcg(&parts[t].m);
    if (mt != -INFINITY) {
      const double dm = (double)mt - shift;
      s = __dadd_rn(s, __dmul_rn(__ldcg(&parts[t].s), exp(dm)));
      if (Q) q = __dadd_rn(q, __dmul_rn(__ldcg(&parts[t].q), exp(2.0 * dm)));
    }
  }
  *S = block_tree(s, shd);
  *Qs = Q ? block_tree(q, shd) : 0.0;
}

// The reference's comb point ((float)i + u) / n_out, in f32 exactly as
// written there.  For n_out a power of two (every call on the main path)
// the quotient is the product with 1 / n_out, exactly, so the same bits
// come at a fraction of a division's instructions: the merge is bound by
// its instructions, most of them comb points.
template <bool POW2>
struct Comb {
  float u, n, inv;
  __device__ __forceinline__ float at(int i) const {
    const float x = (float)i + u;
    return POW2 ? x * inv : x / n;
  }
};

// (warp) The least a in [lo, hi) with pred(a), or hi if there is none, for
// a predicate that stays true once true: the lanes probe 32 points of the
// range, a ballot keeps the span between the last probe before the answer
// and the first after it.
template <class Pred>
__device__ __forceinline__ long long warp_least(long long lo, long long hi,
                                                Pred pred) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long a = lo + ((hi - lo) * (lane + 1)) / 33;   // < hi
    const unsigned hit = __ballot_sync(FULL, pred(a));
    if (hit) {
      const int f = __ffs(hit) - 1;
      const long long first = __shfl_sync(FULL, a, f);
      const long long before = __shfl_sync(FULL, a, f > 0 ? f - 1 : 0);
      lo = f > 0 ? before + 1 : lo;
      hi = first;
    } else {
      lo = __shfl_sync(FULL, a, 31) + 1;
    }
  }
  return lo;
}

// (warp) The number of CDF values among the first d items of the merge:
// the least a in [max(0, d - n_out), min(d, n_in)] such that cdf[a] comes
// after comb point d - 1 - a (or a is the top of the range).  First over
// the coarse samples (coarse[j] = cdf[COARSE j]) to a window of at most
// COARSE values, then over the window.
template <bool POW2>
__device__ __forceinline__ int merge_split(const float* cdf,
                                           const float* coarse, int n_in,
                                           int n_out, Comb<POW2> cb,
                                           long long d) {
  const long long lo = d - n_out > 0 ? d - n_out : 0;
  const long long hi = d < n_in ? d : n_in;
  const long long jlo = (lo + COARSE - 1) / COARSE;
  const long long jhi = (hi + COARSE - 1) / COARSE;
  const long long j = warp_least(jlo, jhi, [&](long long jj) {
    return !(coarse[jj] <= cb.at((int)(d - 1 - jj * COARSE)));
  });
  const long long flo = j > jlo ? (j - 1) * COARSE + 1 : lo;
  const long long fhi = j < jhi ? j * COARSE : hi;
  return (int)warp_least(flo, fhi, [&](long long a) {
    return !(cdf[a] <= cb.at((int)(d - 1 - a)));
  });
}

// (warp) Split j of a member's merge (j = 0 .. merge_blocks): the number
// of CDF values before diagonal min(j * MERGE_SPAN, n_in + n_out).
__device__ __forceinline__ void split_of(const float* cdf, const float* coarse,
                                         int n_in, int n_out, float u,
                                         long long j, int* split) {
  const long long total = (long long)n_in + n_out;
  const long long d = j * MERGE_SPAN < total ? j * MERGE_SPAN : total;
  const float n = (float)n_out;
  const int a = (n_out & (n_out - 1)) == 0
      ? merge_split(cdf, coarse, n_in, n_out, Comb<true>{u, n, 1.0f / n}, d)
      : merge_split(cdf, coarse, n_in, n_out, Comb<false>{u, n, 0.f}, d);
  if ((threadIdx.x & 31) == 0) *split = a;
}

// One block's diagonal j, [j * MERGE_SPAN, (j + 1) * MERGE_SPAN), of a
// member's merge: the ancestors of the comb points in it.  `cdf`,
// `splits` and `anc` are the member's rows; `vec` says the CDF row is
// 16-byte aligned; `sm` holds MERGE_WORDS 4-byte words.
template <bool POW2>
__device__ __forceinline__ void merge_block(const float* cdf,
                                            const int* splits, int n_in,
                                            int n_out, Comb<POW2> cb,
                                            long long j, int vec, int* anc,
                                            float* sm) {
  const int tid = threadIdx.x;
  const long long total = (long long)n_in + n_out;
  const long long d0 = j * MERGE_SPAN;
  const long long d1 = d0 + MERGE_SPAN < total ? d0 + MERGE_SPAN : total;
  const int a0 = splits[j], a1 = splits[j + 1];
  const int b0 = (int)(d0 - a0);          // a comb index: below 2^31
  const int na = a1 - a0, nb = (int)(d1 - a1 - b0);
  // the slice cdf[a0, a1): aligned float4s from a0 rounded down, every load
  // issued before the first is stored (slice value i, cdf[a0 + i], at
  // sm[pad(lead + i)]); the ancestors after it, at sm[pad(at_out + b)]
  const int lead = vec ? (a0 & 3) : 0;
  const float* base = cdf + (a0 - lead);
  constexpr int LOADS = (MERGE_SPAN + 4) / 4 / MERGE_THREADS + 1;
  if (vec) {
    const int nq = (na + lead + 3) >> 2;
    float4 v[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int q = tid + k * MERGE_THREADS;
      if (q < nq) v[k] = __ldcs(reinterpret_cast<const float4*>(base) + q);
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int q = tid + k * MERGE_THREADS;
      if (q < nq) {
        const int at = pad(4 * q);       // 4q .. 4q + 3 share a 32-word row
        sm[at] = v[k].x;
        sm[at + 1] = v[k].y;
        sm[at + 2] = v[k].z;
        sm[at + 3] = v[k].w;
      }
    }
  } else {
    for (int i = tid; i < na; i += MERGE_THREADS) sm[pad(i)] = __ldcs(&base[i]);
  }
  __syncthreads();
  const int at_out = na + lead + 4;
  int* out = reinterpret_cast<int*>(sm);
  const int k0 = tid * MERGE_PER;
  if (k0 < na + nb) {
    // the thread's split of the slice, by bisection in shared memory
    int lo = k0 - nb > 0 ? k0 - nb : 0, hi = k0 < na ? k0 : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sm[pad(lead + mid)] <= cb.at(b0 + k0 - 1 - mid)) lo = mid + 1;
      else hi = mid;
    }
    int a = lo, b = k0 - lo;
    const int k1 = k0 + MERGE_PER < na + nb ? k0 + MERGE_PER : na + nb;
    // each step takes the comb point b (its ancestor: the CDF values
    // before it) or the CDF value a, without a branch
    for (int k = k0; k < k1; ++k) {
      const bool take = b < nb && (a >= na || !(sm[pad(lead + (a < na ? a
                                                                 : 0))] <=
                                                 cb.at(b0 + b)));
      if (take) out[pad(at_out + b)] = min(a0 + a, n_in - 1);
      a += take ? 0 : 1;
      b += take ? 1 : 0;
    }
  }
  __syncthreads();
  for (int i = tid; i < nb; i += MERGE_THREADS)
    __stcs(&anc[b0 + i], out[pad(at_out + i)]);
}

// The block's merge, in the comb point's power-of-two form when n_out is
// one.
__device__ __forceinline__ void merge(const float* cdf, const int* splits,
                                      int n_in, int n_out, float u,
                                      long long j, int vec, int* anc,
                                      float* sm) {
  const float n = (float)n_out;
  if ((n_out & (n_out - 1)) == 0)
    merge_block(cdf, splits, n_in, n_out, Comb<true>{u, n, 1.0f / n}, j, vec,
                anc, sm);
  else
    merge_block(cdf, splits, n_in, n_out, Comb<false>{u, n, 0.f}, j, vec,
                anc, sm);
}

// After a tile of the CDF is stored (its final values still in `buf`):
// the tile's coarse samples, cdf[COARSE k] for the tile's k
__device__ __forceinline__ void store_coarse(const float4* buf, int len,
                                             long long start, float* coarse) {
  const int t = threadIdx.x;
  if (t < SPAN / COARSE && t * COARSE < len)
    coarse[start / COARSE + t] = lb::at(buf, t * COARSE);
}

__host__ __device__ inline long long coarse_samples(long long n) {
  return (n + COARSE - 1) / COARSE;
}

__host__ __device__ inline long long merge_blocks(long long n_in,
                                                  long long n_out) {
  return (n_in + n_out + MERGE_SPAN - 1) / MERGE_SPAN;
}

}  // namespace cm
}  // namespace
