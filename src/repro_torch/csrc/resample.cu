// Resampling ancestors on Hopper (sm_90a): the systematic comb (B1) and the
// collective-free Metropolis (B4) and rejection (B5) chains.
//
// Replaces: src/repro/kernels/resample.py — systematic_ancestors_kernel
// (`_kernel`), metropolis_ancestors_kernel (`_metropolis_kernel`) and
// rejection_ancestors_kernel (`_rejection_kernel`), the Pallas TPU kernels.
// Every kernel here takes a leading batch dim B (bank members or DRA
// shards) and any length; tails are masked.
//
// B1, per member b of B, exactly the reference's numerics:
//   m = max lw;  w = exp(lw - m) / sum exp(lw - m)   (normalize BEFORE scan)
//   cdf = inclusive scan of w;  pos_i = ((float)i + u[b]) / (float)n_out
//   anc[i] = min(first k with cdf[k] > pos_i, n_in - 1)
// The TPU kernel builds the CDF once in VMEM at grid step 0 and searches it
// at later (sequential) steps.  CUDA blocks run in no order, so the build is
// explicit passes over tiles of TILE weights, one launch each, with the
// fixed-order reductions of tile_reduce.cuh (the design of sir_fused.cu):
//   1 tile max   2 member max   3 tile sum of exp(lw - m)   4 member sum
//   5 w, the tile-local inclusive scan into the CDF scratch, the tile total
//   6 member offsets: exclusive scan of the tile totals
//   7 search: bisection over cdf(k) = offset[tile(k)] + local[k].
// No float atomics: two runs give the same bits, and a member never depends
// on B.  Bound on the H100: bytes — lw read (4 B), anc written (4 B) per
// particle, plus the scan's CDF scratch written once and searched from L2;
// passes 1, 3 and 5 re-read lw.
//
// B4 / B5, per member b and output lane l:
//   B4: a = l % n_in; for r < iters: j = prop[l][r];
//       a = (logu[l][r] < lw[j] - lw[a]) ? j : a
//   B5: the first iters/2 draws are rejection against m = max lw, keeping
//       the first j with logu < lw[j] - m; the rest a Metropolis chain from
//       l % n_in; lanes with no accept take the chain's end
//   both: a lane that ends on a -inf slot takes the member's argmax (the
//       FIRST index of the max, as jnp.argmax; 0 for an all -inf member).
// `lw[j] - lw[a]` is one IEEE subtraction and the test a float compare, so
// the result is bitwise equal to the plain version.  The argmax (and B5's
// max) comes from a per-member reduction of two launches (tile, member)
// before the chain launch.  Bound on the H100: bytes — each lane reads its
// (iters) int32 proposals and f32 log-u row once, (8·iters + 4) B per lane.
// A second floor the bytes do not count: iters random 4-B gathers of lw a
// lane, one 32-B L2 sector each (134 M at 2^22 x 32); lw (16 MB a member at
// 2^22) stays in L2 while the draws stream past it with an evict-first
// policy.  Two chain kernels:
//   k_chain_tma — the reference's budget (32) on 16-B aligned draws.  The
//       draw tables are read as (B·lanes, 32) rows: a persistent grid of
//       TMA_BLOCKS_PER_SM blocks an SM walks tiles of TMA_LANES consecutive
//       rows, one thread a row; thread 0 keeps TMA_STAGES tiles of both
//       tables in flight (cp.async.bulk.tensor with an evict-first L2 hint,
//       completion on an mbarrier), so the draws move as whole 16 KB tiles,
//       coalesced, and a tile's gathers and compares run while the next
//       tile lands.  The tensor map's 128-byte swizzle puts 16-B chunk c of
//       row t at chunk c ^ (t % 8), so the 8 threads of each quarter-warp
//       read 8 distinct bank groups when they read chunk c of their own
//       rows, in order.  A thread reads its 32 proposals, starts all 32
//       gathers, then runs the compares in order r.  The shared-memory
//       carveout is set to what the blocks' rings need and no more: the
//       rest of the SM stays L1, which holds the gathers' outstanding
//       misses (the default carveout, at three blocks an SM, leaves too
//       little L1 for them, and the kernel runs slower).  Staging the draws
//       changes nothing of the draws contract: the layout is
//       resampling_draws' own.
//   k_chain (the first design) — one thread a lane reading its own 128-B rows with
//       16-B streaming loads (any budget; 16-B vector loads for 32 aligned).
//       A warp's load then touches 32 lines, 16 B in each.  It serves every
//       other budget and misaligned draws.
// The wrapper's plan() chooses between them by the same rule as
// ppf_chain_tma_ancestors, which refuses what it does not take.
//
// The wrappers (repro_torch/kernels/resample.py) check their inputs,
// allocate outputs and scratch (the *_scratch_floats functions) and raise
// on a non-zero return.

#include <stdint.h>

#include "tile_reduce.cuh"
#include "tma.cuh"

namespace {

using namespace tma;

// ---------------------------------------------------------------------------
// B1: systematic ancestors
// ---------------------------------------------------------------------------

struct SysLayout {
  float *cdf, *tmax, *tsum, *tw, *toff, *scal;   // scal: per member m, s
};

__host__ __device__ inline SysLayout sys_layout(float* base, int B, int N) {
  long long nt = n_tiles(N);
  SysLayout L;
  L.cdf = base;
  L.tmax = L.cdf + (long long)B * N;
  L.tsum = L.tmax + B * nt;
  L.tw = L.tsum + B * nt;
  L.toff = L.tw + B * nt;
  L.scal = L.toff + B * nt;
  return L;
}

__global__ void k_sys_tile_max(const float* lw, int N, SysLayout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.y, t = blockIdx.x, nt = gridDim.x;
  int i = t * TILE + threadIdx.x;
  float v = i < N ? lw[(long long)b * N + i] : -INFINITY;
  v = block_max(v, sh);
  if (threadIdx.x == 0) L.tmax[(long long)b * nt + t] = v;
}

__global__ void k_sys_member_max(int nt, SysLayout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.x;
  float v = -INFINITY;
  for (int t = threadIdx.x; t < nt; t += TILE)
    v = fmaxf(v, L.tmax[(long long)b * nt + t]);
  v = block_max(v, sh);
  if (threadIdx.x == 0) L.scal[b * 2 + 0] = v;
}

__global__ void k_sys_tile_expsum(const float* lw, int N, SysLayout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.y, t = blockIdx.x, nt = gridDim.x;
  int i = t * TILE + threadIdx.x;
  float m = L.scal[b * 2 + 0];
  float e = i < N ? expf(lw[(long long)b * N + i] - m) : 0.f;
  e = block_sum(e, sh);
  if (threadIdx.x == 0) L.tsum[(long long)b * nt + t] = e;
}

__global__ void k_sys_member_sum(int nt, SysLayout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.x;
  float v = 0.f;
  for (int t = threadIdx.x; t < nt; t += TILE)
    v += L.tsum[(long long)b * nt + t];
  v = block_sum(v, sh);
  if (threadIdx.x == 0) L.scal[b * 2 + 1] = v;
}

__global__ void k_sys_tile_scan(const float* lw, int N, SysLayout L) {
  __shared__ float sh[WARPS];
  int b = blockIdx.y, t = blockIdx.x, nt = gridDim.x;
  int i = t * TILE + threadIdx.x;
  long long k = (long long)b * N + i;
  float m = L.scal[b * 2 + 0], s = L.scal[b * 2 + 1];
  float w = i < N ? expf(lw[k] - m) / s : 0.f;
  float total;
  float c = block_scan(w, sh, &total);
  if (i < N) L.cdf[k] = c;
  if (threadIdx.x == 0) L.tw[(long long)b * nt + t] = total;
}

// tile offsets: each thread owns `per` consecutive tiles; scan the chunk
// totals across the block, then walk the chunk (as sir_fused.cu's finish)
__global__ void k_sys_member_offsets(int nt, SysLayout L) {
  __shared__ float sh[WARPS];
  __shared__ float prefix[TILE];
  int b = blockIdx.x, tid = threadIdx.x;
  const long long base = (long long)b * nt;
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
}

__global__ void k_sys_search(const float* u, int N, int n_out, SysLayout L,
                             int* anc) {
  int b = blockIdx.y;
  int i = blockIdx.x * TILE + threadIdx.x;
  if (i >= n_out) return;
  int nt = n_tiles(N);
  // the reference's comb point, in f32 exactly as written there
  float pos = ((float)i + u[b]) / (float)n_out;
  const float* cdf = L.cdf + (long long)b * N;
  const float* off = L.toff + (long long)b * nt;
  int lo = 0, hi = N;
  while (lo < hi) {                   // upper bound: first cdf > pos
    int mid = (lo + hi) >> 1;
    float c = off[mid / TILE] + cdf[mid];
    if (c <= pos) lo = mid + 1; else hi = mid;
  }
  anc[(long long)b * n_out + i] = min(lo, N - 1);
}

// ---------------------------------------------------------------------------
// B4 / B5: argmax reduction, then one thread per chain lane
// ---------------------------------------------------------------------------

// (value, index) of the argmax so far: a larger value wins, a NaN beats any
// number (jnp.argmax and torch.argmax both report the NaN), and a tie goes
// to the smaller index, so the result is the first index of the max in any
// reduction order.
__device__ inline bool beats(float v, int i, float w, int j) {
  bool vn = isnan(v), wn = isnan(w);
  if (vn || wn) return vn && (!wn || i < j);
  return v > w || (v == w && i < j);
}

__device__ inline void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_down_sync(FULL, v, o);
    int j = __shfl_down_sync(FULL, i, o);
    if (beats(w, j, v, i)) { v = w; i = j; }
  }
}

// block argmax over TILE threads, valid in thread 0
__device__ void block_argmax(float& v, int& i, float* shv, int* shi) {
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  warp_argmax(v, i);
  __syncthreads();
  if (lane == 0) { shv[wid] = v; shi[wid] = i; }
  __syncthreads();
  v = threadIdx.x < WARPS ? shv[threadIdx.x] : -INFINITY;
  i = threadIdx.x < WARPS ? shi[threadIdx.x] : INT32_MAX;
  if (wid == 0) warp_argmax(v, i);
}

struct ChainLayout {
  float* tval;   // (B, nt) tile max
  int* tidx;     // (B, nt) tile argmax
  float* mval;   // (B,) member max
  int* midx;     // (B,) member argmax
};

__host__ __device__ inline ChainLayout chain_layout(float* base, int B,
                                                    int N) {
  long long nt = n_tiles(N);
  ChainLayout L;
  L.tval = base;
  L.tidx = (int*)(L.tval + B * nt);
  L.mval = (float*)(L.tidx + B * nt);
  L.midx = (int*)(L.mval + B);
  return L;
}

__global__ void k_tile_argmax(const float* lw, int N, ChainLayout L) {
  __shared__ float shv[WARPS];
  __shared__ int shi[WARPS];
  int b = blockIdx.y, t = blockIdx.x, nt = gridDim.x;
  int i = t * TILE + threadIdx.x;
  float v = i < N ? lw[(long long)b * N + i] : -INFINITY;
  int idx = i < N ? i : INT32_MAX;
  block_argmax(v, idx, shv, shi);
  if (threadIdx.x == 0) {
    L.tval[(long long)b * nt + t] = v;
    L.tidx[(long long)b * nt + t] = idx;
  }
}

__global__ void k_member_argmax(int nt, ChainLayout L) {
  __shared__ float shv[WARPS];
  __shared__ int shi[WARPS];
  int b = blockIdx.x;
  float v = -INFINITY;
  int idx = INT32_MAX;
  for (int t = threadIdx.x; t < nt; t += TILE) {
    float w = L.tval[(long long)b * nt + t];
    int j = L.tidx[(long long)b * nt + t];
    if (beats(w, j, v, idx)) { v = w; idx = j; }
  }
  block_argmax(v, idx, shv, shi);
  if (threadIdx.x == 0) {
    L.mval[b] = v;
    L.midx[b] = idx;
  }
}

constexpr int CHAIN_THREADS = 256;

// ITERS > 0: the draw budget is the compile-time constant (loops fully
// unrolled, rows read with 16 B vector loads); ITERS == 0: any budget.
template <int ITERS, bool REJECT>
__global__ void k_chain(const float* __restrict__ lw,
                        const int* __restrict__ prop,
                        const float* __restrict__ logu, int N, int n_out,
                        int iters_dyn, ChainLayout L, int* anc) {
  const int iters = ITERS > 0 ? ITERS : iters_dyn;
  int b = blockIdx.y;
  int l = blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (l >= n_out) return;
  const float* w = lw + (long long)b * N;
  long long row = ((long long)b * n_out + l) * iters;
  const int* p = prop + row;
  const float* q = logu + row;
  int a;
  if constexpr (ITERS > 0) {
    int pj[ITERS];
    float qj[ITERS];
#pragma unroll
    for (int r = 0; r < ITERS; r += 4) {
      int4 pv = __ldcs(reinterpret_cast<const int4*>(p + r));
      float4 qv = __ldcs(reinterpret_cast<const float4*>(q + r));
      pj[r] = pv.x; pj[r + 1] = pv.y; pj[r + 2] = pv.z; pj[r + 3] = pv.w;
      qj[r] = qv.x; qj[r + 1] = qv.y; qj[r + 2] = qv.z; qj[r + 3] = qv.w;
    }
    // every proposal's weight is known before the chain starts: start all
    // the gathers at once, then run the compares from registers
    float wj[ITERS];
#pragma unroll
    for (int r = 0; r < ITERS; ++r) wj[r] = __ldg(w + pj[r]);
    if constexpr (REJECT) {
      float m = L.mval[b];
      int ar = 0;
      bool any = false;
#pragma unroll
      for (int r = 0; r < ITERS / 2; ++r) {
        bool acc = qj[r] < wj[r] - m;
        if (acc && !any) ar = pj[r];
        any = any || acc;
      }
      int c = l % N;
      float wc = __ldg(w + c);
#pragma unroll
      for (int r = ITERS / 2; r < ITERS; ++r)
        if (qj[r] < wj[r] - wc) { c = pj[r]; wc = wj[r]; }
      a = any ? ar : c;
    } else {
      a = l % N;
      float wa = __ldg(w + a);
#pragma unroll
      for (int r = 0; r < ITERS; ++r)
        if (qj[r] < wj[r] - wa) { a = pj[r]; wa = wj[r]; }
    }
  } else {
    if constexpr (REJECT) {
      float m = L.mval[b];
      int ar = 0;
      bool any = false;
      int half = iters / 2;
      for (int r = 0; r < half; ++r) {
        int j = __ldcs(p + r);
        bool acc = __ldcs(q + r) < __ldg(w + j) - m;
        if (acc && !any) ar = j;
        any = any || acc;
      }
      int c = l % N;
      float wc = __ldg(w + c);
      for (int r = half; r < iters; ++r) {
        int j = __ldcs(p + r);
        float wj = __ldg(w + j);
        if (__ldcs(q + r) < wj - wc) { c = j; wc = wj; }
      }
      a = any ? ar : c;
    } else {
      a = l % N;
      float wa = __ldg(w + a);
      for (int r = 0; r < iters; ++r) {
        int j = __ldcs(p + r);
        float wj = __ldg(w + j);
        if (__ldcs(q + r) < wj - wa) { a = j; wa = wj; }
      }
    }
  }
  anc[(long long)b * n_out + l] = isfinite(__ldg(w + a)) ? a : L.midx[b];
}

template <bool REJECT>
void launch_chain(bool vec, dim3 grid, cudaStream_t st, const float* lw,
                  const int* prop, const float* logu, int N, int n_out,
                  int iters, ChainLayout L, int* anc) {
  if (vec)
    k_chain<32, REJECT><<<grid, CHAIN_THREADS, 0, st>>>(
        lw, prop, logu, N, n_out, iters, L, anc);
  else
    k_chain<0, REJECT><<<grid, CHAIN_THREADS, 0, st>>>(
        lw, prop, logu, N, n_out, iters, L, anc);
}

// -- k_chain_tma: draws staged through shared memory by TMA -----------------

constexpr int TMA_ITERS = 32;                  // the budget it is built for
constexpr int TMA_LANES = 128;                 // rows a tile, threads a block
constexpr int TMA_STAGES = 2;
constexpr int TMA_BLOCKS_PER_SM = 2;
constexpr int TMA_TABLE = TMA_LANES * TMA_ITERS * 4;   // 16 KB: one table
constexpr int TMA_SMEM = TMA_STAGES * 2 * TMA_TABLE + 1024;   // + alignment

// one box of a 2-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`, under the L2 policy `policy`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "l"(policy)
      : "memory");
}

// thread 0: both tables of tile `tile` into stage s
__device__ __forceinline__ void load_tile(uint8_t* ring, uint64_t* full,
                                          int s, long long tile,
                                          const CUtensorMap* tm_prop,
                                          const CUtensorMap* tm_logu,
                                          uint64_t policy) {
  uint8_t* dst = ring + s * 2 * TMA_TABLE;
  mbar_expect_tx(&full[s], 2 * TMA_TABLE);
  tma_load_2d(dst, tm_prop, &full[s], 0, (int)(tile * TMA_LANES), policy);
  tma_load_2d(dst + TMA_TABLE, tm_logu, &full[s], 0,
              (int)(tile * TMA_LANES), policy);
}

template <bool REJECT>
__global__ void __launch_bounds__(TMA_LANES)
    k_chain_tma(const __grid_constant__ CUtensorMap tm_prop,
                const __grid_constant__ CUtensorMap tm_logu,
                const float* __restrict__ lw, int N, int n_out,
                long long rows, ChainLayout L, int* __restrict__ anc) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t full[TMA_STAGES];
  const int tid = threadIdx.x;
  const long long n_tile = (rows + TMA_LANES - 1) / TMA_LANES;
  uint64_t policy = 0;
  if (tid == 0) {
    for (int s = 0; s < TMA_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    for (int s = 0; s < TMA_STAGES; ++s) {
      const long long tile = blockIdx.x + (long long)s * gridDim.x;
      if (tile < n_tile)
        load_tile(ring, full, s, tile, &tm_prop, &tm_logu, policy);
    }
  }
  __syncthreads();
  // chunk c (4 draws, 16 B) of this thread's row: at c ^ (row % 8)
  const int sw = tid & 7;
  int k = 0;
  for (long long tile = blockIdx.x; tile < n_tile;
       tile += gridDim.x, ++k) {
    const int s = k % TMA_STAGES;
    mbar_wait(&full[s], (uint32_t)((k / TMA_STAGES) & 1));
    const long long row = tile * TMA_LANES + tid;
    if (row < rows) {
      const uint8_t* stage = ring + s * 2 * TMA_TABLE + tid * 128;
      const int4* pr = reinterpret_cast<const int4*>(stage);
      const float4* qr = reinterpret_cast<const float4*>(stage + TMA_TABLE);
      const int b = (int)(row / n_out);
      const int l = (int)(row - (long long)b * n_out);
      const float* w = lw + (long long)b * N;
      // every proposal's weight is known before the chain starts: read
      // the proposals, start all the gathers, then run the compares
      int pj[TMA_ITERS];
      float wj[TMA_ITERS];
#pragma unroll
      for (int c = 0; c < TMA_ITERS / 4; ++c) {
        const int4 v = pr[c ^ sw];
        pj[4 * c] = v.x; pj[4 * c + 1] = v.y;
        pj[4 * c + 2] = v.z; pj[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < TMA_ITERS; ++r) wj[r] = __ldg(w + pj[r]);
      int a = l % N;
      float wa = __ldg(w + a);
      if constexpr (REJECT) {
        const float m = L.mval[b];
        int ar = 0;
        float wr = 0.f;
        bool any = false;
#pragma unroll
        for (int c = 0; c < TMA_ITERS / 8; ++c) {
          const float4 q = qr[c ^ sw];
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 4 * c + i;
            const bool acc = qv[i] < wj[r] - m;
            if (acc && !any) { ar = pj[r]; wr = wj[r]; }
            any = any || acc;
          }
        }
#pragma unroll
        for (int c = TMA_ITERS / 8; c < TMA_ITERS / 4; ++c) {
          const float4 q = qr[c ^ sw];
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 4 * c + i;
            if (qv[i] < wj[r] - wa) { a = pj[r]; wa = wj[r]; }
          }
        }
        if (any) { a = ar; wa = wr; }
      } else {
#pragma unroll
        for (int c = 0; c < TMA_ITERS / 4; ++c) {
          const float4 q = qr[c ^ sw];
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 4 * c + i;
            if (qv[i] < wj[r] - wa) { a = pj[r]; wa = wj[r]; }
          }
        }
      }
      anc[row] = isfinite(wa) ? a : L.midx[b];
    }
    __syncthreads();                 // every thread is done with stage s
    if (tid == 0) {
      const long long next = tile + (long long)TMA_STAGES * gridDim.x;
      if (next < n_tile)
        load_tile(ring, full, s, next, &tm_prop, &tm_logu, policy);
    }
  }
}

// the tensor map of a (rows, 32) table of 4-byte draws: boxes of 32 x
// TMA_LANES, 128-byte swizzle, zeros past the last row.  Returns 0, or an
// error code for the wrapper to report.
int draws_map(CUtensorMap* map, const void* base, long long rows,
              CUtensorMapDataType type) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[2] = {(cuuint64_t)TMA_ITERS, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)TMA_ITERS * 4};
  const cuuint32_t box[2] = {TMA_ITERS, TMA_LANES};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + (int)res;
}

template <bool REJECT>
int launch_chain_tma(const float* lw, const int* prop, const float* logu,
                     int N, int n_out, long long rows, ChainLayout L,
                     int* anc, cudaStream_t st) {
  CUtensorMap tp, tq;
  int err = draws_map(&tp, prop, rows, CU_TENSOR_MAP_DATA_TYPE_INT32);
  if (err == 0)
    err = draws_map(&tq, logu, rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != 0) return err;
  // the blocks need no more shared memory than their ring: the rest of the
  // SM's 256 KB stays L1, which holds the gathers' outstanding misses
  static int sms[64];
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess && dev >= 64) cerr = cudaErrorInvalidDevice;
  if (cerr == cudaSuccess && sms[dev] == 0) {
    int sm_smem = 0, n = 0;
    cerr = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (cerr == cudaSuccess)
      cerr = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    // percent of the SM's shared memory the blocks' rings need (1 KB of
    // each block is the system's)
    const int carveout =
        sm_smem > 0 ? (100 * TMA_BLOCKS_PER_SM * (TMA_SMEM + 1024) +
                       sm_smem - 1) / sm_smem
                    : 100;
    if (cerr == cudaSuccess)
      cerr = cudaFuncSetAttribute(
          k_chain_tma<REJECT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          TMA_SMEM);
    if (cerr == cudaSuccess)
      cerr = cudaFuncSetAttribute(
          k_chain_tma<REJECT>, cudaFuncAttributePreferredSharedMemoryCarveout,
          carveout < 100 ? carveout : 100);
    if (cerr == cudaSuccess) sms[dev] = n;
  }
  if (cerr != cudaSuccess) return (int)cerr;
  // persistent: TMA_BLOCKS_PER_SM blocks an SM, or one per tile
  const long long tiles = (rows + TMA_LANES - 1) / TMA_LANES;
  const long long most = (long long)TMA_BLOCKS_PER_SM * sms[dev];
  const int grid = (int)(tiles < most ? tiles : most);
  k_chain_tma<REJECT><<<grid, TMA_LANES, TMA_SMEM, st>>>(
      tp, tq, lw, N, n_out, rows, L, anc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long ppf_systematic_scratch_floats(int B, int n_in) {
  long long nt = n_tiles(n_in);
  return (long long)B * n_in + 4LL * B * nt + 2LL * B;
}

extern "C" int ppf_systematic_ancestors(const float* lw, const float* u,
                                        int* anc, float* scratch, int B,
                                        int n_in, int n_out, void* stream) {
  if (B == 0 || n_out == 0) return 0;
  if (n_in == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SysLayout L = sys_layout(scratch, B, n_in);
  int nt = n_tiles(n_in);
  dim3 tiles(nt, B);
  k_sys_tile_max<<<tiles, TILE, 0, st>>>(lw, n_in, L);
  k_sys_member_max<<<B, TILE, 0, st>>>(nt, L);
  k_sys_tile_expsum<<<tiles, TILE, 0, st>>>(lw, n_in, L);
  k_sys_member_sum<<<B, TILE, 0, st>>>(nt, L);
  k_sys_tile_scan<<<tiles, TILE, 0, st>>>(lw, n_in, L);
  k_sys_member_offsets<<<B, TILE, 0, st>>>(nt, L);
  k_sys_search<<<dim3(n_tiles(n_out), B), TILE, 0, st>>>(u, n_in, n_out, L,
                                                         anc);
  return (int)cudaGetLastError();
}

extern "C" long long ppf_chain_scratch_floats(int B, int n_in) {
  long long nt = n_tiles(n_in);
  return 2LL * B * nt + 2LL * B;
}

extern "C" int ppf_chain_ancestors(const float* lw, const int* prop,
                                   const float* logu, int* anc,
                                   float* scratch, int B, int n_in, int n_out,
                                   int iters, int reject, void* stream) {
  if (B == 0 || n_out == 0) return 0;
  if (n_in == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ChainLayout L = chain_layout(scratch, B, n_in);
  int nt = n_tiles(n_in);
  k_tile_argmax<<<dim3(nt, B), TILE, 0, st>>>(lw, n_in, L);
  k_member_argmax<<<B, TILE, 0, st>>>(nt, L);
  bool vec = iters == 32 && ((uintptr_t)prop % 16 == 0) &&
             ((uintptr_t)logu % 16 == 0);
  dim3 grid((n_out + CHAIN_THREADS - 1) / CHAIN_THREADS, B);
  if (reject)
    launch_chain<true>(vec, grid, st, lw, prop, logu, n_in, n_out, iters, L,
                       anc);
  else
    launch_chain<false>(vec, grid, st, lw, prop, logu, n_in, n_out, iters, L,
                        anc);
  return (int)cudaGetLastError();
}

// k_chain_tma's rule, which the wrapper's plan() repeats: the budget 32,
// both tables 16-B aligned, fewer than 2^31 rows in all
extern "C" int ppf_chain_tma_ancestors(const float* lw, const int* prop,
                                       const float* logu, int* anc,
                                       float* scratch, int B, int n_in,
                                       int n_out, int iters, int reject,
                                       void* stream) {
  if (B == 0 || n_out == 0) return 0;
  if (n_in == 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * n_out;
  if (iters != TMA_ITERS || ((uintptr_t)prop % 16) != 0 ||
      ((uintptr_t)logu % 16) != 0 || rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ChainLayout L = chain_layout(scratch, B, n_in);
  int nt = n_tiles(n_in);
  k_tile_argmax<<<dim3(nt, B), TILE, 0, st>>>(lw, n_in, L);
  k_member_argmax<<<B, TILE, 0, st>>>(nt, L);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reject ? launch_chain_tma<true>(lw, prop, logu, n_in, n_out, rows,
                                         L, anc, st)
                : launch_chain_tma<false>(lw, prop, logu, n_in, n_out, rows,
                                          L, anc, st);
}
