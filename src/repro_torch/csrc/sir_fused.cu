// Fused SIR weight phase on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sir_fused.py::fused_weight_step_kernel (the
// Pallas TPU megakernel, body `_fused_kernel`).  Same function, per bank
// member b of B:
//   lw' = isfinite(lw) ? lw + ll : -inf;  m = max lw';  mg = finite(m) ? m : 0
//   e = exp(lw' - mg);  s = sum e;  w = s > 0 ? e / s : 1/n
//   ess = 1/sum w^2;  log_z = mg + log s;  resampled = ess < thr || always
//   est = sum w*x (f32);  skew = n * max w;  cdf = inclusive scan of w
//   anc[i] = resampled && comb ? min(upper_bound(cdf, (i + u)/n), n-1) : i
//   new_lw[i] = resampled ? -log n : lw'[i] - log_z
//   stats = [ess, log_z, resampled, mg, s, skew]
//
// The Pallas kernel leans on the TPU's sequential grid: step 0 builds lw',
// the CDF and the scalars in VMEM scratch and later steps read them.  CUDA
// blocks run in no order, so the same result is built in launches over
// tiles.  What bounds it on the H100: memory.  It must read lw, ll (8 B)
// and the state (4*D B) and write anc and new_lw (8 B) per particle — 36 B
// at D=5, about 151 MB at N = 2^22.  Two designs:
//
// k_fw_norm, k_fw_tile, k_fw_split, k_fw_merge (every call):
//   1 the normalizer (comb_merge.cuh): each tile of lb::SPAN particles
//     publishes (its max of lw', the double sums of e = exp(lw' - max) and
//     of e^2); the block that finishes a member's last tile combines them in
//     a tree fixed by tile index into mg, s (rounded to f32 once) and
//     sum e^2, and from them the member's scalars: ess = s^2 / sum e^2
//     (= 1 / sum w^2), log_z, the decision, skew = n * (1 / s) (the max
//     weight is the max slot's, whose e is exp(0) = 1);
//   2 the tile pass, which knows the decision from launch 1: w from lw and
//     ll, new_lw, the identity ancestors of a member that does not comb,
//     the tile's double sums of w * x (thread t's particles t, t + 256, ...
//     in order, then the fixed tree; the member's last tile sums the tiles
//     in a fixed tree into the estimate and writes the stats row), and, for
//     a member that resampled with comb, comb_scan.cu's look-back scan of w
//     (lookback.cuh) into the CDF, each tile's total published before it
//     reads the state;
//   3, 4 (comb only) the merge comb of comb_merge.cuh for the members that
//     resampled: its splits (from every 64th CDF value, which the tile pass
//     writes), then the merge; the others' blocks return at once.
//   About 52 B a particle when it combs, 44 without: lw and ll twice, the
//   state, new_lw, and the CDF written and read or the identity written.
//
// The first design (seven launches, same-run timing only):
//   1 tile max of lw'              2 member max -> mg (one block per member)
//   3 tile sum of exp(lw' - mg)    4 member sum -> s
//   5 w, tile sums of w and w^2, tile max w, tile sum of w*x, and the
//     tile-local inclusive scan of w into the CDF scratch
//   6 member finish: tile offsets (exclusive scan of the tile totals), ess,
//     log_z, the decision, skew, the estimate and the stats row
//   7 commit: a per-lane comb bisection over cdf(k) = offset[tile(k)] +
//     local[k], the ancestors and the new log-weights.
//   The tile total used for the offsets is the last element of the tile's
//   own scan, so the CDF is monotone inside a tile and across the tile
//   boundary it meets.
//
// In both, every reduction is a fixed tree with no float atomics, so two
// runs give identical bits and a member's result never depends on B or on
// the other members.
//
// The wrapper (repro_torch/kernels/sir_fused.py) checks its inputs,
// allocates the outputs, keeps the redesign's scratch (its plan() lays it
// out) and raises on a non-zero return.

#include <stdint.h>

#include "comb_merge.cuh"
#include "lookback.cuh"
#include "tile_reduce.cuh"

namespace {

struct Layout {
  float *cdf, *tmax, *tsum, *tw, *tw2, *tmaxw, *toff, *test, *scal;
};

__host__ __device__ inline Layout layout(float* base, int B, int N, int D) {
  long long nt = n_tiles(N);
  Layout L;
  L.cdf = base;
  L.tmax = L.cdf + (long long)B * N;
  L.tsum = L.tmax + B * nt;
  L.tw = L.tsum + B * nt;
  L.tw2 = L.tw + B * nt;
  L.tmaxw = L.tw2 + B * nt;
  L.toff = L.tmaxw + B * nt;
  L.test = L.toff + B * nt;
  L.scal = L.test + B * nt * D;   // per member: mg, s, log_z, resampled
  return L;
}

__device__ inline float post_lw(const float* lw, const float* ll, long long k) {
  float a = lw[k];
  return isfinite(a) ? a + ll[k] : -INFINITY;
}

__global__ void k_tile_max(const float* lw, const float* ll, int N, Layout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.y, t = blockIdx.x, nt = gridDim.x;
  int i = t * TILE + threadIdx.x;
  float v = i < N ? post_lw(lw, ll, (long long)b * N + i) : -INFINITY;
  v = block_max(v, sh);
  if (threadIdx.x == 0) L.tmax[(long long)b * nt + t] = v;
}

__global__ void k_member_max(int nt, Layout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.x;
  float v = -INFINITY;
  for (int t = threadIdx.x; t < nt; t += TILE)
    v = fmaxf(v, L.tmax[(long long)b * nt + t]);
  v = block_max(v, sh);
  if (threadIdx.x == 0) L.scal[b * 4 + 0] = isfinite(v) ? v : 0.f;
}

__global__ void k_tile_expsum(const float* lw, const float* ll, int N,
                              Layout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.y, t = blockIdx.x, nt = gridDim.x;
  int i = t * TILE + threadIdx.x;
  float mg = L.scal[b * 4 + 0];
  float e = i < N ? expf(post_lw(lw, ll, (long long)b * N + i) - mg) : 0.f;
  e = block_sum(e, sh);
  if (threadIdx.x == 0) L.tsum[(long long)b * nt + t] = e;
}

__global__ void k_member_sum(int nt, Layout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.x;
  float v = 0.f;
  for (int t = threadIdx.x; t < nt; t += TILE) v += L.tsum[(long long)b * nt + t];
  v = block_sum(v, sh);
  if (threadIdx.x == 0) L.scal[b * 4 + 1] = v;
}

__global__ void k_tile_weights(const float* lw, const float* ll,
                               const float* x, int N, int D, Layout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.y, t = blockIdx.x, nt = gridDim.x;
  int i = t * TILE + threadIdx.x;
  long long k = (long long)b * N + i;
  float mg = L.scal[b * 4 + 0], s = L.scal[b * 4 + 1];
  float w = 0.f;
  if (i < N) {
    float e = expf(post_lw(lw, ll, k) - mg);
    w = s > 0.f ? e / s : 1.0f / (float)N;
  }
  float total;
  float c = block_scan(w, sh, &total);
  if (i < N) L.cdf[k] = c;
  long long tix = (long long)b * nt + t;
  if (threadIdx.x == 0) L.tw[tix] = total;
  float w2 = block_sum(w * w, sh);
  if (threadIdx.x == 0) L.tw2[tix] = w2;
  float wmax = block_max(i < N ? w : -INFINITY, sh);
  if (threadIdx.x == 0) L.tmaxw[tix] = wmax;
  for (int d = 0; d < D; ++d) {
    float wx = i < N ? w * x[k * D + d] : 0.f;
    wx = block_sum(wx, sh);
    if (threadIdx.x == 0) L.test[tix * D + d] = wx;
  }
}

__global__ void k_member_finish(int N, int D, int nt, float ess_thresh,
                                int always, Layout L, float* est,
                                float* stats) {
  __shared__ float sh[WARPS];
  __shared__ float prefix[TILE];
  int b = blockIdx.x, tid = threadIdx.x;
  const long long base = (long long)b * nt;
  // tile offsets: each thread owns `per` consecutive tiles; scan the chunk
  // totals across the block, then walk the chunk
  int per = (nt + TILE - 1) / TILE;
  int t0 = tid * per;
  float chunk = 0.f;
  for (int j = 0; j < per; ++j)
    if (t0 + j < nt) chunk += L.tw[base + t0 + j];
  float total;
  float incl = block_scan(chunk, sh, &total);
  prefix[tid] = incl;
  __syncthreads();
  float run = tid > 0 ? prefix[tid - 1] : 0.f;
  for (int j = 0; j < per; ++j)
    if (t0 + j < nt) {
      L.toff[base + t0 + j] = run;
      run += L.tw[base + t0 + j];
    }
  float w2 = 0.f, wmax = -INFINITY;
  for (int t = tid; t < nt; t += TILE) {
    w2 += L.tw2[base + t];
    wmax = fmaxf(wmax, L.tmaxw[base + t]);
  }
  w2 = block_sum(w2, sh);
  wmax = block_max(wmax, sh);
  for (int d = 0; d < D; ++d) {
    float e = 0.f;
    for (int t = tid; t < nt; t += TILE) e += L.test[(base + t) * D + d];
    e = block_sum(e, sh);
    if (tid == 0) est[(long long)b * D + d] = e;
  }
  if (tid == 0) {
    float mg = L.scal[b * 4 + 0], s = L.scal[b * 4 + 1];
    float ess = 1.0f / w2;
    float log_z = mg + logf(s);
    bool resampled = (ess < ess_thresh) || (always != 0);
    L.scal[b * 4 + 2] = log_z;
    L.scal[b * 4 + 3] = resampled ? 1.f : 0.f;
    float* st = stats + (long long)b * 6;
    st[0] = ess;
    st[1] = log_z;
    st[2] = resampled ? 1.f : 0.f;
    st[3] = mg;
    st[4] = s;
    st[5] = (float)N * wmax;
  }
}

__global__ void k_commit(const float* lw, const float* ll, const float* u,
                         int N, int comb, float neg_log_n, Layout L,
                         int* anc, float* new_lw) {
  int b = blockIdx.y, t = blockIdx.x, nt = gridDim.x;
  int i = t * TILE + threadIdx.x;
  if (i >= N) return;
  long long k = (long long)b * N + i;
  bool resampled = L.scal[b * 4 + 3] > 0.f;
  int a = i;
  if (resampled && comb) {
    // the reference's comb point, in f32 exactly as written there
    float pos = ((float)i + u[b]) / (float)N;
    const float* cdf = L.cdf + (long long)b * N;
    const float* off = L.toff + (long long)b * nt;
    int lo = 0, hi = N;
    while (lo < hi) {                 // upper bound: first cdf > pos
      int mid = (lo + hi) >> 1;
      float c = off[mid / TILE] + cdf[mid];
      if (c <= pos) lo = mid + 1; else hi = mid;
    }
    a = min(lo, N - 1);
  }
  anc[k] = a;
  new_lw[k] = resampled ? neg_log_n : post_lw(lw, ll, k) - L.scal[b * 4 + 2];
}

// ---------------------------------------------------------------------------
// The redesign: normalizer, tile pass, merge comb
// ---------------------------------------------------------------------------

// a member's scalars, written by the normalizer's last block
struct __align__(16) Scal {
  float mg, s, log_z, resampled, ess, skew, pad[2];
};

__device__ __forceinline__ float post(float a, float l) {
  return isfinite(a) ? a + l : -INFINITY;
}

// launch 1: a block a (tile, member), from the last tile of the last member
// down, so the first tiles the tile pass reads are the ones still in L2
__global__ void __launch_bounds__(cm::THREADS)
k_fw_norm(const float* __restrict__ lw, const float* __restrict__ ll, int n,
          int nt, int vec, float ess_thresh, int always, cm::Part* parts,
          unsigned* count, Scal* scal) {
  __shared__ float shf[cm::WARPS];
  __shared__ double shd[cm::WARPS];
  __shared__ unsigned s_last;
  const int b = gridDim.y - 1 - blockIdx.y, t = nt - 1 - blockIdx.x;
  const long long start = (long long)t * cm::SPAN;
  const int len = (int)min((long long)cm::SPAN, (long long)n - start);
  const long long off = (long long)b * n + start;
  float v[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = k * cm::THREADS + threadIdx.x;
    const float4 a = cm::load4(lw + off, len, vec, c, -INFINITY);
    const float4 l = cm::load4(ll + off, len, vec, c, 0.f);
    v[4 * k + 0] = post(a.x, l.x); v[4 * k + 1] = post(a.y, l.y);
    v[4 * k + 2] = post(a.z, l.z); v[4 * k + 3] = post(a.w, l.w);
  }
  const cm::Part p = cm::tile_part<true>(v, shf, shd);
  const long long row = (long long)b * nt;
  if (!cm::publish_part(p, &parts[row + t], &count[b], nt, &s_last)) return;
  float m;
  double S, Q;
  cm::combine_parts<true>(parts + row, nt, true, &m, &S, &Q, shf, shd);
  if (threadIdx.x == 0) {
    const float mg = isfinite(m) ? m : 0.f;
    const float s = (float)S;
    const float wn = 1.0f / (float)n;
    const float ess =
        s > 0.f ? (float)(((double)s * (double)s) / Q)
                : (float)(1.0 / ((double)n * ((double)wn * (double)wn)));
    const float log_z = mg + logf(s);
    const bool resampled = (ess < ess_thresh) || (always != 0);
    scal[b] = Scal{mg, s, log_z, resampled ? 1.f : 0.f, ess,
                   (float)n * (s > 0.f ? 1.0f / s : wn), {0.f, 0.f}};
  }
}

constexpr int EST_DIMS = 8;    // state dims a pass over the tile sums

// launch 2: a block a tile, by ticket (the look-back's order)
__global__ void __launch_bounds__(lb::THREADS)
k_fw_tile(const float* __restrict__ lw, const float* __restrict__ ll,
          const float* __restrict__ x, int n, int D, int nt, int ng,
          unsigned* ticket, lb::Slot* agg, lb::Slot* grp, unsigned epoch,
          unsigned blocks, int vec, int comb, float neg_log_n,
          const Scal* __restrict__ scal, double* est_parts, unsigned* count,
          float* __restrict__ est, float* __restrict__ stats,
          float* __restrict__ cdf, float* __restrict__ coarse,
          int* __restrict__ anc, float* __restrict__ new_lw) {
  __shared__ __align__(16) float4 buf[lb::BUF];
  __shared__ double sh[lb::WARPS];
  __shared__ double she[lb::WARPS][EST_DIMS];
  __shared__ unsigned s_ticket, s_last;
  __shared__ double s_off;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned tk = lb::draw_ticket(ticket, blocks, &s_ticket);
  const long long row = tk / (unsigned)nt;
  const int tile = (int)(tk - row * nt);
  const long long start = (long long)tile * lb::SPAN;
  const int len = (int)min((long long)lb::SPAN, (long long)n - start);
  const long long off = row * n + start;
  const Scal sc = scal[row];
  const bool resampled = sc.resampled > 0.f;
  const bool scan = comb && resampled;
  const float wn = 1.0f / (float)n;

  // w into buf (0 past the tile), new_lw and the identity ancestors out
#pragma unroll
  for (int k = 0; k < lb::PER / 4; ++k) {
    const int c = k * lb::THREADS + tid;
    const float4 a = cm::load4(lw + off, len, vec, c, -INFINITY);
    const float4 l = cm::load4(ll + off, len, vec, c, 0.f);
    const float p[4] = {post(a.x, l.x), post(a.y, l.y), post(a.z, l.z),
                        post(a.w, l.w)};
    float w[4], nl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = 4 * c + j < len;
      w[j] = !in ? 0.f : (sc.s > 0.f ? expf(p[j] - sc.mg) / sc.s : wn);
      nl[j] = resampled ? neg_log_n : p[j] - sc.log_z;
    }
    buf[lb::pad4(c)] = make_float4(w[0], w[1], w[2], w[3]);
    const int i0 = (int)start + 4 * c;
    // written once, read by the next step: streaming stores, so the L2
    // keeps lw, ll and the CDF for the passes that read them again
    if (vec && 4 * c + 3 < len) {
      __stcs(reinterpret_cast<float4*>(new_lw + off) + c,
             make_float4(nl[0], nl[1], nl[2], nl[3]));
      if (!scan)
        __stcs(reinterpret_cast<int4*>(anc + off) + c,
               make_int4(i0, i0 + 1, i0 + 2, i0 + 3));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * c + j < len) {
          __stcs(&new_lw[off + 4 * c + j], nl[j]);
          if (!scan) __stcs(&anc[off + 4 * c + j], i0 + j);
        }
    }
  }
  __syncthreads();

  // the scan's tile total, published before the state is read
  double excl = 0.0, total = 0.0;
  if (scan) {
    excl = lb::tile_prefix(buf, sh, &total);
    if (tid == 0) lb::publish(&agg[row * nt + tile], total, epoch);
  }

  // the tile's sums of w * x, EST_DIMS dims a pass
  double* part = est_parts + (row * nt + tile) * D;
  for (int d0 = 0; d0 < D; d0 += EST_DIMS) {
    double acc[EST_DIMS];
#pragma unroll
    for (int j = 0; j < EST_DIMS; ++j) acc[j] = 0.0;
#pragma unroll 4
    for (int k = 0; k < lb::PER; ++k) {
      const int i = tid + k * lb::THREADS;
      if (i < len) {
        const double w = (double)lb::at(buf, i);
        const float* xr = x + (off + i) * D + d0;
#pragma unroll
        for (int j = 0; j < EST_DIMS; ++j)
          if (d0 + j < D) acc[j] += w * (double)__ldcs(&xr[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < EST_DIMS; ++j) {
      const double v = lb::warp_tree(acc[j]);
      if (lane == 0) she[wid][j] = v;
    }
    __syncthreads();
    if (wid == 0) {
#pragma unroll
      for (int j = 0; j < EST_DIMS; ++j) {
        const double v = lb::warp_tree(lane < lb::WARPS ? she[lane][j] : 0.0);
        if (lane == 0 && d0 + j < D) part[d0 + j] = v;
      }
    }
    __syncthreads();
  }

  // the CDF: the tile's offset, then the store
  if (scan) {
    if (wid == 0) {
      const double o = lb::offset(agg + row * nt, grp + row * ng, tile, nt,
                                  total, epoch);
      if (tid == 0) s_off = o;
    }
    __syncthreads();
    lb::store_tile(buf, cdf + off, len, vec, s_off + excl);
    cm::store_coarse(buf, len, start, coarse + row * cm::coarse_samples(n));
  }

  // the member's last tile sums the tiles' parts into the estimate and
  // writes the stats row
  if (tid == 0) {
    __threadfence();
    const unsigned done = atomicAdd(&count[row], 1u);
    s_last = done == (unsigned)nt - 1;
    if (s_last) count[row] = 0u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // per dim: thread t sums tiles t, t + 256, ... in order, then the tree of
  // cm::block_tree, EST_DIMS dims a pass (one barrier a pass)
  const double* parts = est_parts + row * nt * D;
  for (int d0 = 0; d0 < D; d0 += EST_DIMS) {
    double v[EST_DIMS];
#pragma unroll
    for (int j = 0; j < EST_DIMS; ++j) v[j] = 0.0;
    for (int t = tid; t < nt; t += lb::THREADS) {
      const double* pt = parts + (long long)t * D + d0;
#pragma unroll
      for (int j = 0; j < EST_DIMS; ++j)
        if (d0 + j < D) v[j] += __ldcg(&pt[j]);
    }
#pragma unroll
    for (int j = 0; j < EST_DIMS; ++j) {
      const double w = lb::warp_tree(v[j]);
      if (lane == 0) she[wid][j] = w;
    }
    __syncthreads();
    if (wid == 0) {
#pragma unroll
      for (int j = 0; j < EST_DIMS; ++j) {
        const double w = lb::warp_tree(lane < lb::WARPS ? she[lane][j] : 0.0);
        if (lane == 0 && d0 + j < D) est[row * D + d0 + j] = (float)w;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    float* st = stats + row * 6;
    st[0] = sc.ess;
    st[1] = sc.log_z;
    st[2] = sc.resampled;
    st[3] = sc.mg;
    st[4] = sc.s;
    st[5] = sc.skew;
  }
}

// launch 3 (comb only): the merge's splits of the members that resampled,
// a warp a split (B x (diagonals + 1))
__global__ void __launch_bounds__(256)
k_fw_split(const float* __restrict__ cdf, const float* __restrict__ coarse,
           const float* __restrict__ u, int n, int diags, int B,
           const Scal* __restrict__ scal, int* __restrict__ splits) {
  const long long s = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const long long per = diags + 1;
  if (s >= (long long)B * per) return;
  const int b = (int)(s / per);
  if (!(scal[b].resampled > 0.f)) return;
  cm::split_of(cdf + (long long)b * n, coarse + b * cm::coarse_samples(n), n,
               n, u[b], s - b * per, &splits[s]);
}

// launch 4 (comb only): a block a (diagonal, member) of the merge, from the
// last diagonal of the last member down (the CDF written last is what L2
// still holds); the members that did not resample return at once
__global__ void __launch_bounds__(cm::MERGE_THREADS)
k_fw_merge(const float* __restrict__ cdf, const int* __restrict__ splits,
           const float* __restrict__ u, int n, int vec,
           const Scal* __restrict__ scal, int* __restrict__ anc) {
  __shared__ float sm[cm::MERGE_WORDS];
  const int b = gridDim.y - 1 - blockIdx.y;
  if (!(scal[b].resampled > 0.f)) return;
  const long long j = gridDim.x - 1 - blockIdx.x;
  cm::merge(cdf + (long long)b * n, splits + (long long)b * (gridDim.x + 1),
            n, n, u[b], j, vec, anc + (long long)b * n, sm);
}

}  // namespace

// The redesign, every call, in two calls: ppf_fused_normalize (launch 1),
// then ppf_fused_commit (launch 2, and with the comb launches 3-4), so
// that the wrapper allocates the outputs while the normalizer runs.  The
// scratch pointers are the wrapper's (repro_torch/kernels/sir_fused.py's
// plan() lays them out): the look-back ticket, two counters a member (normalizer,
// estimate), B * nt normalizer parts, B scalar rows, B * nt * D estimate
// parts, B * nt tile slots, B * ng group slots, the B * N CDF, its
// B * ceil(N / 64) coarse samples (after the CDF: the merge's 16-byte
// loads may read 3 floats past a row) and B * (diagonals + 1) merge
// splits, with the ticket, counters and slots zeroed when the wrapper made
// them; `epoch` is the call's flag value
// (never 0, different from every earlier call's on this scratch).
extern "C" int ppf_fused_normalize(const float* lw, const float* ll,
                                   unsigned* count, void* parts, void* scal,
                                   int B, int N, float ess_thresh, int always,
                                   void* stream) {
  if (B == 0 || N == 0) return 0;
  const long long nt = lb::tiles(N);
  if ((long long)B * nt > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)lw % 16 == 0 && (uintptr_t)ll % 16 == 0 &&
                   (B == 1 || N % 4 == 0));
  k_fw_norm<<<dim3((unsigned)nt, B), cm::THREADS, 0, (cudaStream_t)stream>>>(
      lw, ll, N, (int)nt, vec, ess_thresh, always, (cm::Part*)parts, count,
      (Scal*)scal);
  return (int)cudaGetLastError();
}

extern "C" int ppf_fused_commit(
    const float* lw, const float* ll, const float* x, const float* u,
    int* anc, float* new_lw, float* est, float* stats, unsigned* ticket,
    unsigned* count, const void* scal, double* est_parts, void* agg,
    void* grp, float* cdf, float* coarse, int* splits, int B, int N, int D,
    int comb, float neg_log_n, unsigned epoch, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (epoch == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = lb::tiles(N), ng = lb::groups(nt);
  const long long blocks = (long long)B * nt;
  const long long diags = cm::merge_blocks(N, N);
  const long long warps = (long long)B * (diags + 1);
  if (blocks > INT32_MAX || diags >= INT32_MAX || warps > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores when every tile's start is 16-byte aligned
  const int vec = ((uintptr_t)lw % 16 == 0 && (uintptr_t)ll % 16 == 0 &&
                   (uintptr_t)anc % 16 == 0 && (uintptr_t)new_lw % 16 == 0 &&
                   (uintptr_t)cdf % 16 == 0 && (B == 1 || N % 4 == 0));
  k_fw_tile<<<(unsigned)blocks, lb::THREADS, 0, st>>>(
      lw, ll, x, N, D, (int)nt, (int)ng, ticket, (lb::Slot*)agg,
      (lb::Slot*)grp, epoch, (unsigned)blocks, vec, comb, neg_log_n,
      (const Scal*)scal, est_parts, count + B, est, stats, cdf, coarse, anc,
      new_lw);
  if (comb) {
    k_fw_split<<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(
        cdf, coarse, u, N, (int)diags, B, (const Scal*)scal, splits);
    k_fw_merge<<<dim3((unsigned)diags, B), cm::MERGE_THREADS, 0, st>>>(
        cdf, splits, u, N,
        ((uintptr_t)cdf % 16 == 0 && (B == 1 || N % 4 == 0)),
        (const Scal*)scal, anc);
  }
  return (int)cudaGetLastError();
}

extern "C" long long ppf_fused_seven_pass_scratch_floats(int B, int N,
                                                         int D) {
  long long nt = n_tiles(N);
  return (long long)B * N + (long long)B * nt * (6 + D) + 4LL * B;
}

// The first design, for same-run timing: seven launches.
extern "C" int ppf_fused_weight_step_seven_pass(
    const float* lw, const float* ll, const float* x, const float* u,
    int* anc, float* new_lw, float* est, float* stats, float* scratch, int B,
    int N, int D, float ess_thresh, int always, int comb, float neg_log_n,
    void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  Layout L = layout(scratch, B, N, D);
  int nt = n_tiles(N);
  dim3 tiles(nt, B);
  k_tile_max<<<tiles, TILE, 0, st>>>(lw, ll, N, L);
  k_member_max<<<B, TILE, 0, st>>>(nt, L);
  k_tile_expsum<<<tiles, TILE, 0, st>>>(lw, ll, N, L);
  k_member_sum<<<B, TILE, 0, st>>>(nt, L);
  k_tile_weights<<<tiles, TILE, 0, st>>>(lw, ll, x, N, D, L);
  k_member_finish<<<B, TILE, 0, st>>>(N, D, nt, ess_thresh, always, L, est,
                                      stats);
  k_commit<<<tiles, TILE, 0, st>>>(lw, ll, u, N, comb, neg_log_n, L, anc,
                                   new_lw);
  return (int)cudaGetLastError();
}
