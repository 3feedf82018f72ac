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
// here the order of every addition depends on n alone.
//
// Order (what kernels/row_sum.py's row_sum_emulated writes out in torch):
//   - a row is cut into tiles of TILE = 1024 elements (tile_reduce.cuh); a
//     tile's sum, for each of the inner columns, is one element a thread
//     (0.0f past the row's end), then block_sum's fixed tree: warp shuffles,
//     then the 32 warp sums in warp order.  Tile partials are float32.
//   - the row's tile partials are combined in FLOAT64: thread j of the
//     combining block adds partials j, j + 1024, j + 2048, ... in sequence,
//     starting from 0.0, then the same fixed shuffle tree in double; the
//     total is rounded to float32 once.
//   - with a shift (one float a row and column), each element is first
//     expf(x - shift): the pass that logsumexp's sum needs, without writing
//     exp(x - max) to memory.
// No float atomics: two runs give the same bits, and a row's bits never
// depend on how many rows share the launch.
//
// One launch a call.  Blocks walk the (row, tile) items, GROUP at a time, in
// a grid-stride loop; after a tile's partials are written, an integer ticket
// per row (atomicAdd on a counter) picks the row's last finishing block,
// which combines the row's partials and resets the counter for the next
// call.
// Nothing waits on another block, so a partly resident grid cannot hang.
//
// Bound on the H100: bytes — each input element read once (4 B; the
// partials and the output are n / 256 of that).  A thread holds one element
// of each of GROUP tiles, so GROUP loads are in flight and a tile tree's
// two barriers are shared by GROUP tiles (with one tile an iteration the
// barriers set the time: 0.040 ms at 2^22, against 0.015 for torch.sum).
//
// The wrapper (repro_torch/kernels/row_sum.py) checks its inputs, allocates
// the output and the partials, keeps the zeroed counters per device and
// stream, and raises on a non-zero return.

#include <stdint.h>

#include "tile_reduce.cuh"

namespace {

__device__ inline double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// block_sum's tree in double (valid in thread 0)
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

// GROUP tiles an iteration: a thread loads one element of each (GROUP
// loads in flight), every warp reduces each tile's 32 values by shuffles,
// and after one barrier warp k finishes tile k's tree over the 32 warp sums.
// The order of every sum is block_sum's; the barriers are shared by GROUP
// tiles.
constexpr int GROUP = 8;

__global__ void __launch_bounds__(TILE) k_row_sum(
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

}  // namespace

// One launch: out (outer, inner) = the sum over n of x (outer, n, inner), of
// expf(x - shift) when `shift` (outer, inner) is given.  `part` holds outer *
// tiles * inner floats (written before read); `count` holds outer unsigned
// counters, zero on entry and left zero.
extern "C" int ppf_row_sum(const float* x, const float* shift, float* out,
                           float* part, unsigned* count, long long outer,
                           int n, int inner, void* stream) {
  if (outer == 0 || inner == 0) return 0;
  if (n <= 0 || inner < 0) return (int)cudaErrorInvalidValue;
  const int tiles = n_tiles(n);
  const long long items = outer * tiles;
  const long long groups = (items + GROUP - 1) / GROUP;
  const long long grid = groups < 2LL * sm_count() ? groups
                                                   : 2LL * sm_count();
  k_row_sum<<<(unsigned)grid, TILE, 0, (cudaStream_t)stream>>>(
      x, shift, out, part, count, n, inner, tiles, items);
  return (int)cudaGetLastError();
}
