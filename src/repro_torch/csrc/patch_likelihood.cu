// Gaussian-PSF patch log-likelihood on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/patch_likelihood.py::patch_log_likelihood_kernel
// (the Pallas TPU kernel, body `_kernel`).  Same function: for every
// particle, round the centre half to even, clamp it to the centre bounds,
// gather the (2R+1)^2 window at an offset of the frame origin, evaluate the
// PSF model i0*exp(-d^2/2s^2)+i_bg and accumulate the matched form
// sum(z*m - m*m/2) or the Eq. 4 form -sum((z-m)^2)/2, over dy then dx in the
// Pallas kernel's order, and divide by sigma_like^2.
//
// What bounds it on the H100: the arithmetic.  Per particle (R=4) it runs
// 81 exp on the special-function units and ~10 FP32 operations per pixel,
// against 12 bytes of state read and 4 written; the 81 pixel reads hit the
// cache, because a 512x512 f32 frame (1 MB) stays resident in the 50 MB L2
// and a converged, clustered posterior reuses the same lines from L1.  So
// the design is one thread per (member, particle) with the pixels gathered
// through the read-only path (__ldg) straight from the member's frame in
// device memory — no shared-memory staging, which could not hold the frame
// anyway — and the radius-4 loop fully unrolled so the row offsets and the
// dy^2 term stay in registers.  The state is read in place from the
// strided (B, N, S) ensemble (columns 0, 1, 4), so no column copies exist.
//
// Frames are addressed by member and row strides, so a halo slab that is a
// view of a larger frame needs no copy.  The wrapper
// (repro_torch/kernels/patch_likelihood.py) checks devices, types, shapes,
// strides and that the geometry keeps every window inside
// the frame, allocates the output, and raises on a non-zero return.

#include <cuda_runtime.h>

namespace {

template <int RT, bool MATCHED>
__global__ void patch_ll_kernel(const float* __restrict__ state,
                                long long s_b, long long s_n,
                                const float* __restrict__ frames,
                                long long f_b, long long f_row,
                                float* __restrict__ out, int B, int N,
                                int r_dyn, float inv2s2,
                                float sl2, float i_bg, int lo_y, int hi_y,
                                int lo_x, int hi_x, int oy, int ox) {
  const int R = RT > 0 ? RT : r_dyn;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * N) return;
  int b = (int)(idx / N);
  int i = (int)(idx - (long long)b * N);
  const float* s = state + b * s_b + i * s_n;
  float y = __ldg(s + 0), x = __ldg(s + 1), i0 = __ldg(s + 4);
  // jnp.round is round-half-to-even: rintf, not roundf
  int cy = min(max((int)rintf(y), lo_y), hi_y);
  int cx = min(max((int)rintf(x), lo_x), hi_x);
  const float* img = frames + b * f_b;
  float acc = 0.f;
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
    int py = cy + dy;
    float ddy = (float)py - y;
    float ddy2 = ddy * ddy;
    const float* row = img + (long long)(py - oy) * f_row;
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      int px = cx + dx;
      float z = __ldg(row + (px - ox));
      float ddx = (float)px - x;
      float d2 = ddy2 + ddx * ddx;
      float model = i0 * expf(-d2 * inv2s2) + i_bg;
      if (MATCHED) {
        acc += z * model - 0.5f * model * model;
      } else {
        float res = z - model;
        acc += -0.5f * res * res;
      }
    }
  }
  out[idx] = acc / sl2;
}

template <int RT>
void launch(bool matched, dim3 grid, dim3 block, cudaStream_t st,
            const float* state, long long s_b, long long s_n,
            const float* frames, long long f_b, long long f_row, float* out,
            int B, int N, int R, float inv2s2, float sl2, float i_bg, int lo_y,
            int hi_y, int lo_x, int hi_x, int oy, int ox) {
  if (matched)
    patch_ll_kernel<RT, true><<<grid, block, 0, st>>>(
        state, s_b, s_n, frames, f_b, f_row, out, B, N, R, inv2s2, sl2, i_bg,
        lo_y, hi_y, lo_x, hi_x, oy, ox);
  else
    patch_ll_kernel<RT, false><<<grid, block, 0, st>>>(
        state, s_b, s_n, frames, f_b, f_row, out, B, N, R, inv2s2, sl2, i_bg,
        lo_y, hi_y, lo_x, hi_x, oy, ox);
}

}  // namespace

extern "C" int ppf_patch_log_likelihood(
    const float* state, long long s_b, long long s_n, const float* frames,
    long long f_b, long long f_row, float* out, int B, int N, int R,
    float inv2s2, float sl2, float i_bg, int matched, int lo_y, int hi_y,
    int lo_x, int hi_x, int oy, int ox, void* stream) {
  long long total = (long long)B * N;
  if (total == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((total + threads - 1) / threads));
  cudaStream_t st = (cudaStream_t)stream;
  if (R == 4)
    launch<4>(matched != 0, grid, threads, st, state, s_b, s_n, frames, f_b,
              f_row, out, B, N, R, inv2s2, sl2, i_bg, lo_y, hi_y, lo_x, hi_x,
              oy, ox);
  else
    launch<0>(matched != 0, grid, threads, st, state, s_b, s_n, frames, f_b,
              f_row, out, B, N, R, inv2s2, sl2, i_bg, lo_y, hi_y, lo_x, hi_x,
              oy, ox);
  return (int)cudaGetLastError();
}
