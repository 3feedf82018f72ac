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
// Per row, in three launches when the row spans more than one tile of SPAN
// elements, in one when it does not:
//   A  tile totals: the tile-local scan of pass C, keeping only its total
//   B  tile offsets: an exclusive scan of the row's tile totals, in place
//   C  the tile-local scan plus the tile's offset, rounded to float32.
// Every sum is in double, in a fixed order (a thread's PER elements in
// sequence, then the fixed shuffle tree of tile_reduce.cuh), and each
// prefix is rounded to float32 once: what torch's CPU cumsum of float32
// computes (a double accumulator), so the card and the CPU plain version
// agree to the rounding of a double sum, far inside one float32 ulp.  No
// atomics and no look-back: two runs give the same bits, and a row never
// depends on how many rows share the launch.
//
// Bound on the H100: bytes — x read once, y written once (8 B an element);
// the design moves 12 (pass A reads x, pass C reads it again).  Loads and
// stores go through shared memory so that a warp touches 128 consecutive
// bytes, and a thread then scans PER consecutive elements from there.
//
// The wrapper (repro_torch/kernels/scan.py) checks its input, allocates the
// output and the scratch (ppf_prefix_sum_scratch_bytes) and raises on a
// non-zero return.

#include <stdint.h>

#include "tile_reduce.cuh"

namespace {

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

extern "C" long long ppf_prefix_sum_scratch_bytes(int rows, int n) {
  long long nt = span_tiles(n);
  return nt > 1 ? (long long)rows * nt * (long long)sizeof(double) : 0;
}

extern "C" int ppf_prefix_sum(const float* x, float* y, void* scratch,
                              int rows, int n, void* stream) {
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
