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
// blocks run in no order, so the same result is built in passes over tiles
// of TILE particles, each pass one launch on the caller's stream:
//   1 tile max of lw'              2 member max -> mg (one block per member)
//   3 tile sum of exp(lw' - mg)    4 member sum -> s
//   5 w, tile sums of w and w^2, tile max w, tile sum of w*x, and the
//     tile-local inclusive scan of w into the CDF scratch
//   6 member finish: tile offsets (exclusive scan of the tile totals), ess,
//     log_z, the decision, skew, the estimate and the stats row
//   7 commit: comb search over cdf(k) = offset[tile(k)] + local[k], the
//     ancestors and the new log-weights.
// Every reduction is a fixed tree (warp shuffles, then the warp results in
// warp order; member passes walk the tiles in a fixed per-thread order), with
// no float atomics, so two runs give identical bits and a member's result
// never depends on B or on the other members.  The tile total used for the
// offsets is the last element of the tile's own scan, so the CDF is
// monotone inside a tile and across the tile boundary it meets.
//
// What bounds it on the H100: memory.  It must read lw, ll (8 B) and the
// state (4*D B) and write anc and new_lw (8 B) per particle — 36 B at D=5,
// about 151 MB at N = 2^22 — and the passes re-read lw and ll (passes 1, 3,
// 5, 7) and write and search the CDF scratch, about twice that traffic; the
// per-tile partials are a few KB and stay in L2.  The search reads the
// 16 MB CDF at N = 2^22 from L2.  A single-pass decoupled look-back would
// remove the re-reads; that is later work.
//
// The wrapper (repro_torch/kernels/sir_fused.py) checks its inputs,
// allocates the outputs and the scratch (ppf_fused_scratch_floats), and
// raises on a non-zero return.

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

}  // namespace

extern "C" long long ppf_fused_scratch_floats(int B, int N, int D) {
  long long nt = n_tiles(N);
  return (long long)B * N + (long long)B * nt * (6 + D) + 4LL * B;
}

extern "C" int ppf_fused_weight_step(const float* lw, const float* ll,
                                     const float* x, const float* u,
                                     int* anc, float* new_lw, float* est,
                                     float* stats, float* scratch, int B,
                                     int N, int D, float ess_thresh,
                                     int always, int comb, float neg_log_n,
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
