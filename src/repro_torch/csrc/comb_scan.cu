// The comb's CDF on Hopper (sm_90a): a fixed-order inclusive float32 scan
// along the last dim of a (rows, n) array.
//
// Replaces: torch.cumsum on a CUDA tensor in the port's comb schemes
// (repro_torch/core/resampling.py: the CDF of the systematic and stratified
// comb, the multinomial comb's CDF and its exponential spacings), which
// compute the reference's jnp.cumsum (src/repro/core/resampling.py:64,
// :109, :116).  No pallas_call: the reference leaves the scan to XLA.
// torch's CUDA scan of one long row is CUB's device scan, whose float32
// result changes from run to run; this one repeats bit for bit.
//
// Every sum is in double, in a fixed order, and each prefix is rounded to
// float32 once: what torch's CPU cumsum of float32 computes (a double
// accumulator), so the card and the CPU plain version agree to the
// rounding of a double sum, far inside one float32 ulp.  No float atomics:
// two runs give the same bits, and a row never depends on how many rows
// share the launch.
//
// Bound on the H100: bytes — x read once, y written once (8 B an element).
//
// k_scan_lookback, the kernel every call takes: one launch, one pass.
//   - A row is cut into tiles of LB_SPAN elements (a fixed span, whatever
//     the number of rows or SMs).  A block takes the next tile from an
//     integer ticket, row-major, so it only ever waits on tiles whose
//     blocks are already running: no hang when part of the grid is
//     resident.  The block that draws the last ticket resets the counter
//     for the next call.
//   - A block reads its tile once (16-byte loads where the row allows),
//     scans it in double (a thread's LB_PER elements in sequence, then a
//     fixed shuffle tree over the block) and publishes the tile's total at
//     once, in one 16-byte word with the call's epoch.
//   - The tile's offset is a sum, in a tree fixed by the tile's index
//     alone, of totals that other tiles published: the totals of the tiles
//     before it in its group of LB_GROUP tiles, and the group sums of the
//     groups before that.  The last tile of a group publishes its group's
//     sum (a fixed tree of the group's LB_GROUP totals) as soon as it has
//     them.  No tile reads a prefix that another tile happened to finish,
//     so the order of every sum is the same in every run; no tile waits on
//     more than one hop of publication.
//   - The tile adds its offset and writes y once.
//   - The epoch changes every call, so the scratch (kept per device and
//     stream by the wrapper) needs no reset between calls.
//
// The first design (k_scan_totals, k_scan_offsets, k_scan_apply: tile
// totals, a one-block-per-row offset walk, then the apply pass; 12 B an
// element and three launches for a row of more than one tile) stays
// launchable through ppf_prefix_sum_three_pass, for same-run timing only.
//
// The wrapper (repro_torch/kernels/scan.py) checks its input, allocates the
// output, keeps the scratch and its epoch, and raises on a non-zero return.

#include <stdint.h>

#include "tile_reduce.cuh"

namespace {

// ---------------------------------------------------------------------------
// k_scan_lookback
// ---------------------------------------------------------------------------

constexpr int LB_THREADS = 256;
constexpr int LB_WARPS = LB_THREADS / 32;
constexpr int LB_PER = 16;                       // elements a thread scans
constexpr int LB_SPAN = LB_THREADS * LB_PER;     // elements a tile
constexpr int LB_CHUNKS = LB_SPAN / 4;           // float4s a tile
constexpr int LB_GROUP = 32;                     // tiles a group sum covers

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

__global__ void __launch_bounds__(LB_THREADS)
k_scan_lookback(const float* __restrict__ x, float* __restrict__ y, int n,
                int nt, int ng, unsigned* ticket, Slot* agg, Slot* grp,
                unsigned epoch, unsigned blocks, int vec) {
  __shared__ __align__(16) float4 buf[LB_CHUNKS + LB_CHUNKS / 8];
  __shared__ double sh[LB_WARPS];
  __shared__ unsigned s_ticket;
  __shared__ double s_off;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  if (tid == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == blocks - 1) atomicExch(ticket, 0u);   // every block has drawn
    s_ticket = t;
  }
  __syncthreads();
  const long long row = s_ticket / (unsigned)nt;
  const int tile = (int)(s_ticket - row * nt);
  const long long start = (long long)tile * LB_SPAN;
  const int len = (int)min((long long)LB_SPAN, (long long)n - start);
  const float* xr = x + row * n + start;
  float* yr = y + row * n + start;

  // the tile, coalesced: chunk c of 4 elements at float4 pad4(c)
#pragma unroll
  for (int k = 0; k < LB_PER / 4; ++k) {
    const int c = k * LB_THREADS + tid;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec && 4 * c + 3 < len) {
      v = reinterpret_cast<const float4*>(xr)[c];
    } else {
      if (4 * c + 0 < len) v.x = xr[4 * c + 0];
      if (4 * c + 1 < len) v.y = xr[4 * c + 1];
      if (4 * c + 2 < len) v.z = xr[4 * c + 2];
      if (4 * c + 3 < len) v.w = xr[4 * c + 3];
    }
    buf[pad4(c)] = v;
  }
  __syncthreads();

  // the thread's LB_PER consecutive elements, summed in sequence
  double sum = 0.0;
#pragma unroll
  for (int k = 0; k < LB_PER / 4; ++k) {
    const float4 v = buf[pad4(4 * tid + k)];
    sum += (double)v.x;
    sum += (double)v.y;
    sum += (double)v.z;
    sum += (double)v.w;
  }
  // inclusive Kogge-Stone scan of the thread sums: in the warp, then over
  // the warp totals (warp 0), as block_scan in tile_reduce.cuh
  double incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const double m = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += m;
  }
  if (lane == 31) sh[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    double t = lane < LB_WARPS ? sh[lane] : 0.0;
    for (int o = 1; o < LB_WARPS; o <<= 1) {
      const double m = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += m;
    }
    if (lane < LB_WARPS) sh[lane] = t;
  }
  __syncthreads();
  // the thread's exclusive prefix in the tile: the previous thread's
  // inclusive one (an earlier warp's total for a warp's first thread)
  const double prev = __shfl_up_sync(FULL, incl, 1);
  const double excl = lane > 0 ? (wid > 0 ? sh[wid - 1] + prev : prev)
                               : (wid > 0 ? sh[wid - 1] : 0.0);
  const double total = sh[LB_WARPS - 1];

  // publish the tile's total, then find its offset (warp 0)
  Slot* ar = agg + row * nt;
  if (wid == 0) {
    if (lane == 0) publish(&ar[tile], total, epoch);
    const int g = tile / LB_GROUP, r = tile - g * LB_GROUP;
    const Slot* gs = ar + g * LB_GROUP;
    double a = lane < r ? wait_for(&gs[lane], epoch) : 0.0;
    // the group's sum, from its last tile, for the tiles after it
    if (r == LB_GROUP - 1 && tile + 1 < nt) {
      const double gsum = warp_tree(lane == r ? total : a);
      if (lane == 0) publish(&grp[row * ng + g], gsum, epoch);
    }
    const double in_group = warp_tree(a);
    // the groups before: lane l sums groups l, l + 32, ... in order
    double before = 0.0;
    for (int j = lane; j < g; j += 32)
      before += wait_for(&grp[row * ng + j], epoch);
    before = warp_tree(before);
    if (lane == 0) s_off = before + in_group;
  }
  __syncthreads();

  // y: (offset + the thread's exclusive prefix) + its running sum
  const double base = s_off + excl;
  double p = 0.0;
#pragma unroll
  for (int k = 0; k < LB_PER; k += 4) {
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
  for (int k = 0; k < LB_PER / 4; ++k) {
    const int c = k * LB_THREADS + tid;
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

__host__ __device__ inline long long lb_tiles(long long n) {
  return (n + LB_SPAN - 1) / LB_SPAN;
}

__host__ __device__ inline long long lb_groups(long long nt) {
  return (nt + LB_GROUP - 1) / LB_GROUP;
}

// ---------------------------------------------------------------------------
// The first design: three passes for a row of more than one tile
// ---------------------------------------------------------------------------

constexpr int PER = 4;               // elements a thread scans in sequence
constexpr int SPAN = TILE * PER;     // elements a tile (one block)

__host__ __device__ inline long long span_tiles(long long n) {
  return (n + SPAN - 1) / SPAN;
}

// The tile of row `xr` at `start`, read coalesced into `buf`; thread t's
// PER consecutive elements as prefix sums p[] from the thread's start.
// Returns the thread's exclusive offset within the tile and sets *total
// to the tile's sum.
__device__ double tile_scan(const float* xr, int n, long long start,
                            float* buf, double* sh, double (&p)[PER],
                            double* total) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    long long i = start + k * TILE + tid;
    buf[k * TILE + tid] = i < n ? xr[i] : 0.f;
  }
  __syncthreads();
  const float4 v = reinterpret_cast<const float4*>(buf)[tid];
  p[0] = (double)v.x;
  p[1] = p[0] + (double)v.y;
  p[2] = p[1] + (double)v.z;
  p[3] = p[2] + (double)v.w;
  const double incl = block_scan(p[PER - 1], sh, total);
  // the previous thread's prefix; a warp's first thread takes the earlier
  // warps' total, which block_scan left in sh (nothing writes sh before
  // the next block_scan's first barrier)
  const double prev = __shfl_up_sync(FULL, incl, 1);
  return lane > 0 ? prev : (wid > 0 ? sh[wid - 1] : 0.0);
}

// pass A: one block per (row, tile), flattened row-major
__global__ void k_scan_totals(const float* __restrict__ x, int n, int nt,
                              double* tot) {
  __shared__ __align__(16) float buf[SPAN];
  __shared__ double sh[WARPS];
  const long long blk = blockIdx.x;
  const long long row = blk / nt;
  const int t = (int)(blk - row * nt);
  double p[PER], total;
  tile_scan(x + row * n, n, (long long)t * SPAN, buf, sh, p, &total);
  if (threadIdx.x == 0) tot[blk] = total;
}

// pass B: one block per row; each thread owns `per` consecutive tiles: the
// chunk totals are scanned across the block, then each chunk is walked in
// order, overwriting the totals with the exclusive offsets
__global__ void k_scan_offsets(int nt, double* tot) {
  __shared__ double sh[WARPS];
  __shared__ double prefix[TILE];
  const int tid = threadIdx.x;
  double* t = tot + (long long)blockIdx.x * nt;
  const int per = (nt + TILE - 1) / TILE;
  const int t0 = tid * per;
  double chunk = 0.0;
  for (int j = 0; j < per; ++j)
    if (t0 + j < nt) chunk += t[t0 + j];
  double total;
  prefix[tid] = block_scan(chunk, sh, &total);
  __syncthreads();
  double run = tid > 0 ? prefix[tid - 1] : 0.0;
  for (int j = 0; j < per; ++j)
    if (t0 + j < nt) {
      const double v = t[t0 + j];
      t[t0 + j] = run;
      run += v;
    }
}

// pass C (the only pass for a row of one tile: off == nullptr)
__global__ void k_scan_apply(const float* __restrict__ x,
                             float* __restrict__ y, int n, int nt,
                             const double* __restrict__ off) {
  __shared__ __align__(16) float buf[SPAN];
  __shared__ double sh[WARPS];
  const long long blk = blockIdx.x;
  const long long row = blk / nt;
  const long long start = (blk - row * nt) * SPAN;
  double p[PER], total;
  const double excl =
      tile_scan(x + row * n, n, start, buf, sh, p, &total);
  const double base = (off != nullptr ? off[blk] : 0.0) + excl;
  // each thread rewrites only the float4 it read, so no barrier before
  reinterpret_cast<float4*>(buf)[threadIdx.x] =
      make_float4((float)(base + p[0]), (float)(base + p[1]),
                  (float)(base + p[2]), (float)(base + p[3]));
  __syncthreads();
  float* yr = y + row * n;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    long long i = start + k * TILE + threadIdx.x;
    if (i < n) yr[i] = buf[k * TILE + threadIdx.x];
  }
}

}  // namespace

// One launch of k_scan_lookback.  `scratch` holds the ticket (16 B), then
// a slot per tile and a slot per group of every row, zeroed when the
// wrapper made it (repro_torch/kernels/scan.py's plan() sizes it);
// `epoch` is the call's flag value (never 0, different from every earlier
// call's on this scratch), so flags of an earlier call never match.
extern "C" int ppf_prefix_sum(const float* x, float* y, void* scratch,
                              int rows, int n, unsigned epoch,
                              void* stream) {
  if (rows == 0 || n == 0) return 0;
  const long long nt = lb_tiles(n), ng = lb_groups(nt);
  const long long blocks = (long long)rows * nt;
  if (blocks > INT32_MAX || epoch == 0) return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores when every tile's start is 16-byte aligned
  const int vec = ((uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                   (rows == 1 || n % 4 == 0));
  unsigned* ticket = (unsigned*)scratch;
  Slot* agg = (Slot*)((char*)scratch + 16);
  Slot* grp = agg + rows * nt;
  k_scan_lookback<<<(unsigned)blocks, LB_THREADS, 0,
                    (cudaStream_t)stream>>>(x, y, n, (int)nt, (int)ng,
                                            ticket, agg, grp, epoch,
                                            (unsigned)blocks, vec);
  return (int)cudaGetLastError();
}

extern "C" long long ppf_prefix_sum_three_pass_scratch_bytes(int rows,
                                                             int n) {
  long long nt = span_tiles(n);
  return nt > 1 ? (long long)rows * nt * (long long)sizeof(double) : 0;
}

// The first design, for same-run timing: three launches (one for a row of
// one tile).
extern "C" int ppf_prefix_sum_three_pass(const float* x, float* y,
                                         void* scratch, int rows, int n,
                                         void* stream) {
  if (rows == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = span_tiles(n);
  const long long blocks = (long long)rows * nt;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (nt == 1) {
    k_scan_apply<<<(unsigned)blocks, TILE, 0, st>>>(x, y, n, 1, nullptr);
  } else {
    double* tot = (double*)scratch;
    k_scan_totals<<<(unsigned)blocks, TILE, 0, st>>>(x, n, (int)nt, tot);
    k_scan_offsets<<<rows, TILE, 0, st>>>((int)nt, tot);
    k_scan_apply<<<(unsigned)blocks, TILE, 0, st>>>(x, y, n, (int)nt, tot);
  }
  return (int)cudaGetLastError();
}
