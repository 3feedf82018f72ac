// Fixed-order float32 row sums on Hopper (sm_90a): the sum over the middle
// dim of an (outer, n, inner) array, optionally of exp(x - shift).
//
// Replaces: XLA's reductions behind the reference's jnp.sum / logsumexp over
// the particle axis (src/repro/core/particles.py: normalized weights, ESS,
// log-sum of weights, the MMSE estimate; src/repro/core/distributed.py: the
// global normalizer and ESS).  No pallas_call: the reference leaves these
// sums to XLA.  In the port every float row sum of core/ on the card comes
// here (repro_torch/core/particles.py: invariant_sum, invariant_logsumexp).
// torch's own CUDA sum splits a long row by the whole tensor's shape, so a
// bank member's row and the same row alone would sum in different orders;
// here the order of every addition depends on the row's shape (n, inner)
// alone, never on outer, the grid or the SM count.
//
// Order (what kernels/row_sum.py's row_sum_emulated writes out in torch),
// on logical indices:
//   - a row is cut into tiles of RS_TILE = 4096 elements; a tile is
//     RS_TILE * inner contiguous floats, read as quads of 4 floats.  Thread
//     t of the RS_THREADS = 256 takes quads j * 256 + t, j = 0 .. 4*inner - 1
//     (a warp's quads are neighbours: 16-byte loads, coalesced).  Float f of
//     the tile belongs to column f % inner; the thread adds its elements of
//     each column in (quad, float) order into a float32 run starting at 0
//     (0.0 past the row's end).
//   - a column's 256 runs go through a fixed tree: each warp's shuffle tree
//     (offsets 16 .. 1), then the 8 warp sums by offsets 4, 2, 1.  The tile
//     partial is float32.
//   - the row's tile partials are combined in FLOAT64: thread j of the
//     combining block adds partials j, j + 256, j + 512, ... in sequence
//     from 0.0, then the same fixed tree in double; the total is rounded to
//     float32 once (a one-tile row's partial is its total, bit for bit).
//   - with a shift (one float a row and column), each element is first
//     expf(x - shift): the pass that logsumexp's sum needs, without writing
//     exp(x - max) to memory.
// No float atomics: two runs give the same bits, and a row's bits never
// depend on how many rows share the launch.  A row whose start is not 16-byte
// aligned (n * inner not a multiple of 4), and a row's last tile, read the
// same elements in the same order with scalar loads: the bits do not change.
//
// One launch a call, one block a (row, tile) item: the row is found by one
// division a block.  After its partials are written, an integer ticket a row
// (atomicAdd on a counter) picks the row's last finishing block, which
// combines the row's partials and resets the counter for the next call.
// Nothing waits on another block, so a partly resident grid cannot hang.
//
// Bound on the H100: bytes — each input element read once (4 B; the
// partials are inner floats a 4096 elements).  A thread keeps a batch of
// quads in flight (all 4 of its quads at inner = 1, 8 blocks an SM) and a
// tile of 16 KB pays one barrier pair and one ticket, where the first
// design paid a tree, two barriers, a fence and a ticket every 1024
// elements, read them one float a thread and divided 64-bit integers every
// element.  inner = 1 .. 8 are compiled with their columns known (the
// thread's runs stay in registers, indexed relative to its first quad's
// column); any other inner keeps its runs in shared memory, RS_GEN_COLS
// columns a pass over the tile, in the same order.
//
// k_row_sum_v1 is the first design (1024-element tiles, one element a
// thread a tile, a tree every 1024 elements), kept launchable for same-run
// timing only (ppf_row_sum_v1); nothing on the main path calls it.
//
// The wrapper (repro_torch/kernels/row_sum.py) checks its inputs, allocates
// the output, keeps the zeroed counters and the partials per device and
// stream, and raises on a non-zero return.

#include <stdint.h>

#include "tile_reduce.cuh"

namespace {

constexpr int RS_THREADS = 256;
constexpr int RS_WARPS = RS_THREADS / 32;   // 8
constexpr int RS_TILE = 4096;               // elements of a row a tile
constexpr int RS_QUADS = RS_TILE / (4 * RS_THREADS);  // a thread's quads
constexpr int RS_BATCH = 4;                 // quads in flight (inner | 1024)
constexpr int RS_COLS = 8;                  // inner compiled with its columns
constexpr int RS_GEN_COLS = 40;             // columns a pass, any other inner
constexpr int RS_MAX_INNER = 65536;

// resident blocks an SM the registers must allow: 8 (32 registers) for the
// rows of weights, 4 for the estimate's columns (more spill), 2 at inner = 7
// (its batch of 7 quads spills at 3 and 4)
constexpr int rs_min_blocks(int inner) {
  return inner == 1 ? 8 : inner == 7 ? 2 : 4;
}

// lane 0: the tree over lanes 0 .. 7 (offsets 4, 2, 1)
template <typename T>
__device__ inline T tree8(T v) {
  for (int o = 4; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// tree8's result for 8 values held by one thread
__device__ inline float tree8_of(const float (&s)[RS_WARPS]) {
  return ((s[0] + s[4]) + (s[2] + s[6])) + ((s[1] + s[5]) + (s[3] + s[7]));
}

__device__ inline double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

template <bool SHIFT>
__device__ inline float term(float v, float s) {
  return SHIFT ? expf(v - s) : v;
}

// The thread's runs of a tile for INNER = 1 .. 8 columns: a[r] holds the
// run of column (c0 + r) % INNER, c0 = 4t % INNER the column of its first
// quad's first float, so every index is known at compile time.  Quads go in
// batches whose column pattern repeats (RS_BATCH quads when INNER divides
// 1024, else INNER quads), one batch in flight.
template <int INNER, bool SHIFT>
__device__ inline void tile_runs(const float* __restrict__ xt, bool fast,
                                 int valid, const float (&s)[INNER],
                                 float (&a)[INNER]) {
  constexpr int J = RS_QUADS * INNER;                     // quads a thread
  constexpr int B = (4 * RS_THREADS) % INNER == 0 ? RS_BATCH : INNER;
  static_assert(J % B == 0, "a thread's quads are whole batches");
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < INNER; ++r) a[r] = 0.f;
  if (fast) {                  // a whole tile on a 16-byte aligned row
#pragma unroll 1
    for (int j0 = 0; j0 < J; j0 += B) {
      float4 q[B];
#pragma unroll
      for (int b = 0; b < B; ++b)
        q[b] = __ldg(reinterpret_cast<const float4*>(xt) +
                     (j0 + b) * RS_THREADS + t);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float v[4] = {q[b].x, q[b].y, q[b].z, q[b].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = (b * RS_THREADS * 4 + k) % INNER;
          a[r] += term<SHIFT>(v[k], s[r]);
        }
      }
    }
  } else {                     // the row's last tile, or a misaligned row
#pragma unroll 1
    for (int j0 = 0; j0 < J; j0 += B) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int f = ((j0 + b) * RS_THREADS + t) * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = (b * RS_THREADS * 4 + k) % INNER;
          if (f + k < valid) a[r] += term<SHIFT>(__ldg(xt + f + k), s[r]);
        }
      }
    }
  }
}

// The fixed tree of the tile's columns: a[c] is the thread's run of column
// c; warp c's lane 0 returns column c's tile sum (others 0).
__device__ inline float tile_tree(const float (&a)[RS_COLS], int ncols,
                                  float (*sh)[RS_WARPS]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < RS_COLS; ++c) {
    if (c < ncols) {
      const float w = warp_sum(a[c]);
      if (lane == 0) sh[c][wid] = w;
    }
  }
  __syncthreads();
  return wid < ncols ? tree8(lane < RS_WARPS ? sh[wid][lane] : 0.f) : 0.f;
}

// block_sum's tree in double over RS_THREADS (valid in thread 0)
__device__ double block_sum_d256(double v, double* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum_d(v);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  return tree8(lane < RS_WARPS ? sh[lane] : 0.0);
}

// INNER = 1 .. 8: columns known at compile time, runs in registers;
// INNER = 0: any inner, runs in shared memory (`runs`, RS_THREADS floats a
// column), RS_GEN_COLS columns a pass.
template <int INNER, bool SHIFT>
__global__ void __launch_bounds__(RS_THREADS, rs_min_blocks(INNER)) k_row_sum(
    const float* __restrict__ x, const float* __restrict__ shift,
    float* __restrict__ out, float* part, unsigned* count, int n, int inner_rt,
    int tiles) {
  __shared__ float sh[RS_COLS][RS_WARPS];
  __shared__ double shd[RS_WARPS];
  __shared__ int last;
  extern __shared__ float runs[];
  const int inner = INNER > 0 ? INNER : inner_rt;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int row = (int)(blockIdx.x / (unsigned)tiles);
  const int tile = (int)blockIdx.x - row * tiles;
  const long long row0 = (long long)row * n * inner;
  const float* __restrict__ xt = x + row0 + (long long)tile * RS_TILE * inner;
  const int valid = min(RS_TILE, n - tile * RS_TILE) * inner;
  const bool aligned = (reinterpret_cast<uintptr_t>(xt) & 15) == 0;
  const float* srow = SHIFT ? shift + (long long)row * inner : nullptr;
  float* dst = tiles == 1 ? out + (long long)row * inner
                          : part + ((long long)row * tiles + tile) * inner;
  if constexpr (INNER > 0) {
    const int c0 = (4 * t) % INNER;
    float s[INNER], a[INNER];
#pragma unroll
    for (int r = 0; r < INNER; ++r) {
      const int c = (c0 + r) % INNER;
      s[r] = SHIFT ? __ldg(srow + c) : 0.f;
    }
    tile_runs<INNER, SHIFT>(xt, aligned && valid == RS_TILE * INNER, valid,
                            s, a);
    float col[RS_COLS];
#pragma unroll
    for (int c = 0; c < RS_COLS; ++c) {
      int r = c - c0;
      if (r < 0) r += INNER;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < INNER; ++q)
        if (q == r) v = a[q];
      col[c] = v;
    }
    const float p = tile_tree(col, INNER, sh);
    if (wid < INNER && lane == 0) {
      dst[wid] = p;
      __threadfence();
    }
  } else {
    const int J = RS_QUADS * inner;
    const int step = (4 * RS_THREADS) % inner;   // column shift a quad row
    for (int cb = 0; cb < inner; cb += RS_GEN_COLS) {
      const int ncols = min(RS_GEN_COLS, inner - cb);
      for (int c = 0; c < ncols; ++c) runs[c * RS_THREADS + t] = 0.f;
      int c4 = (4 * t) % inner;                  // quad j's first column
      for (int j = 0; j < J; ++j) {
        const int f = (j * RS_THREADS + t) * 4;
        float v[4];
        if (aligned && f + 4 <= valid) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(xt + f));
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = f + k < valid ? __ldg(xt + f + k) : 0.f;
        }
        int c = c4;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = c - cb;
          if (f + k < valid && r >= 0 && r < ncols)
            runs[r * RS_THREADS + t] +=
                term<SHIFT>(v[k], SHIFT ? __ldg(srow + c) : 0.f);
          c = c + 1 == inner ? 0 : c + 1;
        }
        c4 += step;
        if (c4 >= inner) c4 -= inner;
      }
      __syncthreads();
      for (int c = wid; c < ncols; c += RS_WARPS) {   // tile_tree's order
        float w[RS_WARPS];
#pragma unroll
        for (int g = 0; g < RS_WARPS; ++g)
          w[g] = warp_sum(runs[c * RS_THREADS + g * 32 + lane]);
        if (lane == 0) {
          dst[cb + c] = tree8_of(w);
          __threadfence();
        }
      }
      __syncthreads();       // runs is rewritten by the next pass
    }
  }
  if (tiles == 1) return;
  __syncthreads();
  if (t == 0)
    last = atomicAdd(count + row, 1u) == (unsigned)(tiles - 1);
  __syncthreads();
  if (!last) return;           // uniform over the block
  __threadfence();
  const float* rp = part + (long long)row * tiles * inner;
  for (int c = 0; c < inner; ++c) {
    double acc = 0.0;
    for (int i = t; i < tiles; i += RS_THREADS)
      acc += (double)__ldcg(rp + (long long)i * inner + c);
    acc = block_sum_d256(acc, shd);
    if (t == 0) out[(long long)row * inner + c] = (float)acc;
  }
  if (t == 0) count[row] = 0u;
}

// ---- the first design, for same-run timing only --------------------------

// block_sum's tree in double over TILE threads (valid in thread 0)
__device__ double block_sum_d(double v, double* sh) {
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum_d(v);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  v = (threadIdx.x < WARPS) ? sh[threadIdx.x] : 0.0;
  if (wid == 0) v = warp_sum_d(v);
  return v;
}

// GROUP tiles of 1024 an iteration: a thread loads one element of each,
// every warp reduces each tile's 32 values by shuffles, and after one
// barrier warp k finishes tile k's tree over the 32 warp sums.
constexpr int GROUP = 8;

__global__ void __launch_bounds__(TILE) k_row_sum_v1(
    const float* __restrict__ x, const float* __restrict__ shift,
    float* __restrict__ out, float* part, unsigned* count, int n, int inner,
    int tiles, long long items) {
  __shared__ float shf[GROUP][WARPS];
  __shared__ double shd[WARPS];
  __shared__ int last[GROUP];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long groups = (items + GROUP - 1) / GROUP;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long w0 = g * GROUP;
    for (int c = 0; c < inner; ++c) {
      float v[GROUP];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const long long w = w0 + k;
        const long long row = w / tiles;
        const int i = (int)(w - row * tiles) * TILE + (int)threadIdx.x;
        v[k] = 0.f;
        if (w < items && i < n) {
          v[k] = __ldg(x + (row * n + i) * (long long)inner + c);
          if (shift != nullptr)
            v[k] = expf(v[k] - __ldg(shift + row * inner + c));
        }
      }
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const float s = warp_sum(v[k]);
        if (lane == 0) shf[k][wid] = s;
      }
      __syncthreads();
      if (wid < GROUP && w0 + wid < items) {
        const float s = warp_sum(shf[wid][lane]);
        if (lane == 0) part[(w0 + wid) * inner + c] = s;
      }
      __syncthreads();   // shf is rewritten by the next column
    }
    if (wid < GROUP && lane == 0) {
      const long long w = w0 + wid;
      int is_last = 0;
      if (w < items) {
        __threadfence();
        is_last = atomicAdd(count + w / tiles, 1u) == (unsigned)(tiles - 1);
      }
      last[wid] = is_last;
    }
    __syncthreads();
    for (int k = 0; k < GROUP; ++k) {
      if (!last[k]) continue;        // uniform over the block
      __threadfence();
      const long long row = (w0 + k) / tiles;
      const float* rp = part + row * tiles * (long long)inner;
      for (int c = 0; c < inner; ++c) {
        double acc = 0.0;
        for (int t = threadIdx.x; t < tiles; t += TILE)
          acc += (double)__ldcg(rp + (long long)t * inner + c);
        acc = block_sum_d(acc, shd);
        if (threadIdx.x == 0) out[row * inner + c] = (float)acc;
      }
      if (threadIdx.x == 0) count[row] = 0u;
    }
    __syncthreads();   // `last` is rewritten by the next group
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

using Kernel = void (*)(const float*, const float*, float*, float*,
                        unsigned*, int, int, int);

template <bool SHIFT>
Kernel pick(int inner) {
  switch (inner) {
    case 1: return k_row_sum<1, SHIFT>;
    case 2: return k_row_sum<2, SHIFT>;
    case 3: return k_row_sum<3, SHIFT>;
    case 4: return k_row_sum<4, SHIFT>;
    case 5: return k_row_sum<5, SHIFT>;
    case 6: return k_row_sum<6, SHIFT>;
    case 7: return k_row_sum<7, SHIFT>;
    case 8: return k_row_sum<8, SHIFT>;
    default: return k_row_sum<0, SHIFT>;
  }
}

Kernel pick(int inner, bool shift) {
  return shift ? pick<true>(inner) : pick<false>(inner);
}

// the generic kernel's shared runs
size_t runs_bytes(int inner) {
  return inner > RS_COLS
             ? sizeof(float) * RS_THREADS * (size_t)min(inner, RS_GEN_COLS)
             : 0;
}

}  // namespace

// One launch: out (outer, inner) = the sum over n of x (outer, n, inner), of
// expf(x - shift) when `shift` (outer, inner) is given.  `part` holds outer *
// ceil(n / 4096) * inner floats (written before read; unused when a row is
// one tile); `count` holds outer unsigned counters, zero on entry and left
// zero.
extern "C" int ppf_row_sum(const float* x, const float* shift, float* out,
                           float* part, unsigned* count, long long outer,
                           int n, int inner, void* stream) {
  if (outer == 0 || inner == 0) return 0;
  if (n <= 0 || inner < 0 || inner > RS_MAX_INNER)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + RS_TILE - 1) / RS_TILE;
  const long long items = outer * tiles;
  if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  pick(inner, shift != nullptr)<<<(unsigned)items, RS_THREADS,
                                  runs_bytes(inner), (cudaStream_t)stream>>>(
      x, shift, out, part, count, n, inner, tiles);
  return (int)cudaGetLastError();
}

// The first design, same contract; `part` holds outer * ceil(n / 1024) *
// inner floats.
extern "C" int ppf_row_sum_v1(const float* x, const float* shift, float* out,
                              float* part, unsigned* count, long long outer,
                              int n, int inner, void* stream) {
  if (outer == 0 || inner == 0) return 0;
  if (n <= 0 || inner < 0) return (int)cudaErrorInvalidValue;
  const int tiles = n_tiles(n);
  const long long items = outer * tiles;
  const long long groups = (items + GROUP - 1) / GROUP;
  const long long grid = groups < 2LL * sm_count() ? groups
                                                   : 2LL * sm_count();
  k_row_sum_v1<<<(unsigned)grid, TILE, 0, (cudaStream_t)stream>>>(
      x, shift, out, part, count, n, inner, tiles, items);
  return (int)cudaGetLastError();
}

// Registers a thread and resident blocks an SM of the kernel a call with
// this inner (and shift) launches; 0 on success.
extern "C" int ppf_row_sum_occupancy(int inner, int shift, int* regs,
                                     int* blocks) {
  const Kernel k = pick(inner, shift != 0);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, RS_THREADS, runs_bytes(inner));
}
