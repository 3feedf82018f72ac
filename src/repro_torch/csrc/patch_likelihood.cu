// Gaussian-PSF patch log-likelihood on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/patch_likelihood.py::patch_log_likelihood_kernel
// (the Pallas TPU kernel, body `_kernel`).  Same function: for every
// particle, round the centre half to even, clamp it to the centre bounds,
// gather the (2R+1)^2 window at an offset of the frame origin, evaluate the
// PSF model i0*exp(-d^2/2s^2)+i_bg and take the matched form
// sum(z*m - m*m/2) or the Eq. 4 form -sum((z-m)^2)/2, divided by
// sigma_like^2.
//
// k_patch_sep, the kernel every call takes: one thread per (member,
// particle), the arithmetic cut to what the function needs.
//   - The PSF is separable: exp(-(dy^2 + dx^2) k) = e_y(dy) * e_x(dx), so a
//     particle takes 2R+1 exps for its rows and 4*NQ(R) for its columns
//     (R = 4: 9 + 12 on the special-function units, against 81), and the
//     model is one FMA a pixel.
//   - Matched form: sum(z*m) = i0 * sum_dy e_y sum_dx e_x z + i_bg * sum z,
//     and sum(m^2) = i0^2 (sum e_y^2)(sum e_x^2) + 2 i0 i_bg (sum e_y)(sum
//     e_x) + (2R+1)^2 i_bg^2 needs no pixel.  A window row costs one FMA a
//     pixel (and one add for sum z when i_bg != 0).
//   - Eq. 4 form: the residual z - m stays a pixel's own, and r^2 is summed
//     in float32.  Expanding it into sum z^2 - 2 sum z m + sum m^2 would
//     cancel catastrophically in float32 near a close fit; the sum of
//     squares has no cancellation (every term is >= 0), so float32 keeps it
//     to a few ulp of the sum.  Both forms add a row's pixels first, in
//     column order, then the rows, so no sum runs over more than 2R+1
//     terms (slots off the window add an exact 0), and the order does not
//     depend on where the row's columns fall in the float4s: a slab view
//     gives the full frame's bits at any origin.
//   - Gathers: a window row of 2R+1 pixels starting at column c lies inside
//     the NQ = (2R+7)/4 aligned float4s from column c & ~3, read whole
//     (R = 4: 27 loads a particle, against 81).  Slots outside the window
//     are selected to 0, never multiplied by 0, so whatever lies beside the
//     window cannot reach the sums.
//   - Slot order: a warp whose 32 windows lie apart (an ensemble whose
//     slots are not in ancestor order: the Metropolis and rejection
//     chains, RNA's exchange) costs a cache line per lane and load.  So a
//     block first folds its 256 windows' bounds (integer warp reductions),
//     and where at least a quarter of them fit one box of at most BOX_CAP
//     floats — their bounding box, or else a BOX_W-wide box around their
//     mean — it copies that box of the frame into shared memory with
//     coalesced loads and reads those windows from there.  A converged
//     cloud fits whatever its slot order; a spread ensemble takes the
//     frame in device memory (L2), with 16-byte loads where the frames
//     allow (16-byte aligned base and strides, width a multiple of 4) and
//     4-byte loads of the window's pixels elsewhere.  Every path puts the
//     same values in the same slots, so the sums, and the bits, are the
//     same on all of them (a slab view and the full frame agree bit for
//     bit).
//   - R = 4 (the tracking model's) is unrolled with the column weights in
//     registers; any other R takes the same arithmetic in loops,
//     recomputing the column weights a row.
//
// What bounds it on the H100: the instructions and their latency for a
// converged cloud (~460 a particle at R = 4, 21 of them exps on the SFU),
// the L2's sectors for a spread one (two 32-byte sectors a window row).
// Per particle it reads its 20-byte state row and the window's 2R+1 rows
// (1 MB frames stay in the 50 MB L2), and writes 4 bytes.
//
// The first design (patch_ll_kernel: 81 exps and 81 4-byte gathers a
// particle, the reference's per-pixel order) stays launchable through
// ppf_patch_log_likelihood_direct, for same-run timing only.
//
// The wrapper (repro_torch/kernels/patch_likelihood.py) checks devices,
// types, shapes, strides and that the geometry keeps every window inside
// the frame, picks the loads, allocates the output, and raises on a
// non-zero return.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int PL_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

// float4 chunks that hold a (2R+1)-column window at any start column
__host__ __device__ constexpr int nq(int r) { return (2 * r + 7) / 4; }

constexpr int PL_WARPS = PL_THREADS / 32;
// a block's staged window box: at most BOX_CAP floats (16 KB), and when
// the block's windows do not fit, a BOX_W-column box around their mean
constexpr int BOX_CAP = 4096;
constexpr int BOX_W = 64;
// stage only for at least this many of the block's windows
constexpr int BOX_MIN = PL_THREADS / 4;

// One call's arguments, packed by the wrapper in this order (one pointer
// costs a fraction of the host time of 22 ctypes arguments); the kernels
// take it by value.
struct PatchCall {
  const float* state;
  long long s_b, s_n;
  const float* frames;
  long long f_b, f_row;
  float* out;
  void* stream;
  int B, N, R, h, w, matched, vec, lo_y, hi_y, lo_x, hi_x, oy, ox;
  float inv2s2, sl2, i_bg;
};

// One particle's value, its window rows read through load(ry, q, a): the
// float4 chunk q (columns a + 4q ..) of window row ry, for every chunk that
// holds a window column.
template <int RT, bool MATCHED, bool BG, class Load>
__device__ __forceinline__ float sep_value(const PatchCall& c, float y,
                                           float x, float i0, int cy,
                                           int cx, Load load) {
  constexpr bool FIXED = RT >= 0;
  const int R = FIXED ? RT : c.R;
  const int W = 2 * R + 1;
  const int NQ = nq(R);
  const float k2 = c.inv2s2;
  // the window's first column in the frame array (>= 0: the wrapper
  // checks the geometry), the aligned column of slot 0 and the window's
  // first slot
  const int c0 = cx - R - c.ox;
  const int a = c0 & ~3;
  const int sft = c0 - a;

  // slot j holds frame column a + ox + j; its weight, 0 off the window
  auto in_window = [&](int j) {
    return (j >= 3 || j >= sft) && (j < W || j < sft + W);
  };
  auto col_weight = [&](int j) {
    const float d = (float)(a + c.ox + j) - x;
    const float e = __expf(-d * d * k2);
    return in_window(j) ? e : 0.f;
  };
  constexpr int SLOTS = FIXED ? 4 * nq(RT) : 1;
  float ex[SLOTS];
  float sex = 0.f, sex2 = 0.f;
  if constexpr (FIXED) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      ex[j] = col_weight(j);
      sex = __fadd_rn(sex, ex[j]);
      sex2 = __fmaf_rn(ex[j], ex[j], sex2);
    }
  } else {
    for (int j = 0; j < 4 * NQ; ++j) {
      const float e = col_weight(j);
      sex = __fadd_rn(sex, e);
      sex2 = __fmaf_rn(e, e, sex2);
    }
  }

  float sey = 0.f, sey2 = 0.f, szm = 0.f, sz = 0.f, acc = 0.f;
#pragma unroll
  for (int ry = 0; ry < W; ++ry) {
    const float dy = (float)(cy - R + ry) - y;
    const float ey = __expf(-dy * dy * k2);
    sey = __fadd_rn(sey, ey);
    sey2 = __fmaf_rn(ey, ey, sey2);
    const float i0ey = __fmul_rn(i0, ey);
    float rs = 0.f, rz = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      // a chunk with no window column is not read (it may lie past the
      // frame or the box); the others hold at least one
      const float4 v = (4 * q < sft + W) ? load(ry, q, a, sft, W)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
      const float z[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        const bool in = in_window(j);
        const float w = FIXED ? ex[FIXED ? j : 0] : col_weight(j);
        if constexpr (MATCHED) {
          const float zz = in ? z[e] : 0.f;
          rs = __fmaf_rn(w, zz, rs);
          if constexpr (BG) rz = __fadd_rn(rz, zz);
        } else {
          const float m = __fmaf_rn(i0ey, w, c.i_bg);
          const float r = in ? __fsub_rn(z[e], m) : 0.f;
          rs = __fmaf_rn(r, r, rs);
        }
      }
    }
    if constexpr (MATCHED) {
      szm = __fmaf_rn(ey, rs, szm);
      if constexpr (BG) sz = __fadd_rn(sz, rz);
    } else {
      acc = __fadd_rn(acc, rs);
    }
  }
  float val;
  if constexpr (MATCHED) {
    // sum(z m) - sum(m^2) / 2, with sum(m^2) from the weight sums
    float zm = __fmul_rn(i0, szm);
    float mm = __fmul_rn(__fmul_rn(i0, i0), __fmul_rn(sey2, sex2));
    if constexpr (BG) {
      const float bg = c.i_bg;
      zm = __fmaf_rn(bg, sz, zm);
      mm = __fmaf_rn(__fmul_rn(__fmul_rn(2.f, i0), bg),
                     __fmul_rn(sey, sex), mm);
      mm = __fmaf_rn((float)(W * W), __fmul_rn(bg, bg), mm);
    }
    val = __fmaf_rn(-0.5f, mm, zm);
  } else {
    val = __fmul_rn(-0.5f, acc);
  }
  return __fdiv_rn(val, c.sl2);
}

template <int RT, bool MATCHED, bool BG, bool VEC>
__global__ void __launch_bounds__(PL_THREADS) k_patch_sep(PatchCall c) {
  __shared__ __align__(16) float box[BOX_CAP];
  __shared__ int red[8][PL_WARPS];
  __shared__ int s_box[5];   // first row, first column, rows, columns, member
  const int R = RT >= 0 ? RT : c.R;
  const int W = 2 * R + 1;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long idx = (long long)blockIdx.x * PL_THREADS + tid;
  const bool valid = idx < (long long)c.B * c.N;
  const int b = valid ? (int)(idx / c.N) : 0;
  const int i = valid ? (int)(idx - (long long)b * c.N) : 0;
  float y = 0.f, x = 0.f, i0 = 0.f;
  if (valid) {
    const float* s = c.state + b * c.s_b + i * c.s_n;
    y = __ldg(s + 0);
    x = __ldg(s + 1);
    i0 = __ldg(s + 4);
  }
  // jnp.round is round-half-to-even: rintf, not roundf
  const int cy = min(max((int)rintf(y), c.lo_y), c.hi_y);
  const int cx = min(max((int)rintf(x), c.lo_x), c.hi_x);
  // the window's top-left pixel in the frame array
  const int wy = cy - R - c.oy, wx = cx - R - c.ox;

  // the block's windows: their bounds, mean and members
  int v[8] = {valid ? wy : INT_MAX, valid ? -wy : INT_MAX,
              valid ? wx : INT_MAX, valid ? -wx : INT_MAX,
              valid ? b : INT_MAX,  valid ? -b : INT_MAX,
              valid ? wy : 0,       valid ? wx : 0};
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = __reduce_min_sync(FULL_MASK, v[k]);
  v[6] = __reduce_add_sync(FULL_MASK, v[6]);
  v[7] = __reduce_add_sync(FULL_MASK, v[7]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) red[k][wid] = v[k];
  }
  __syncthreads();
  if (wid == 0) {
    // warp 0 folds the warps' partials: m = min of the bounds and members,
    // sum of the corners
    int m[6], sum[2];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      m[k] = __reduce_min_sync(FULL_MASK,
                               lane < PL_WARPS ? red[k][lane] : INT_MAX);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      sum[k] = __reduce_add_sync(FULL_MASK,
                                 lane < PL_WARPS ? red[6 + k][lane] : 0);
    if (lane == 0) {
      const long long left = (long long)c.B * c.N -
                             (long long)blockIdx.x * PL_THREADS;
      const int nv = (int)min((long long)PL_THREADS, left);
      // the windows' rows and aligned columns
      int r0 = m[0], rows = -m[1] - m[0] + W;
      int a0 = m[2] & ~3, cols = ((-m[3] + W + 3) & ~3) - a0;
      if (rows * (long long)cols > BOX_CAP) {
        // BOX_W columns around the windows' mean, inside the frame
        const int wpad = (c.w + 3) & ~3;
        cols = min(BOX_W, wpad);
        rows = min(BOX_CAP / BOX_W, c.h);
        const int my = sum[0] / nv + R, mx = sum[1] / nv + R;
        r0 = min(max(my - rows / 2, 0), c.h - rows);
        a0 = min(max((mx - cols / 2) & ~3, 0), wpad - cols);
      }
      s_box[0] = r0;
      s_box[1] = a0;
      s_box[2] = m[4] == -m[5] ? rows : 0;        // one member only
      s_box[3] = cols;
      s_box[4] = m[4];
    }
  }
  __syncthreads();
  const int r0 = s_box[0], a0 = s_box[1], rows = s_box[2], cols = s_box[3];
  // inside: the window's rows and the columns of its chunks
  const bool inside = valid && rows > 0 && wy >= r0 && wy + W <= r0 + rows &&
                      (wx & ~3) >= a0 && ((wx + W + 3) & ~3) <= a0 + cols;
  const bool staged = __syncthreads_count(inside) >= BOX_MIN;
  if (staged) {
    const float* img = c.frames + s_box[4] * c.f_b;
    for (int e = tid; e < rows * cols; e += PL_THREADS) {
      const int r = e / cols, col = a0 + (e - r * cols);
      box[e] = col < c.w ? __ldg(img + (long long)(r0 + r) * c.f_row + col)
                         : 0.f;
    }
    __syncthreads();
  }
  if (!valid) return;
  float val;
  if (staged && inside) {
    const int top = (wy - r0) * cols - a0;
    val = sep_value<RT, MATCHED, BG>(c, y, x, i0, cy, cx,
        [&](int ry, int q, int a, int, int) {
          return reinterpret_cast<const float4*>(box + top + ry * cols +
                                                 a)[q];
        });
  } else {
    const float* top = c.frames + b * c.f_b + (long long)wy * c.f_row;
    val = sep_value<RT, MATCHED, BG>(c, y, x, i0, cy, cx,
        [&](int ry, int q, int a, int sft, int w) {
          const float* rp = top + (long long)ry * c.f_row + a;
          if constexpr (VEC) {
            return __ldg(reinterpret_cast<const float4*>(rp) + q);
          } else {
            float z[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 4 * q + e;
              z[e] = (j >= sft && j < sft + w) ? __ldg(rp + j) : 0.f;
            }
            return make_float4(z[0], z[1], z[2], z[3]);
          }
        });
  }
  c.out[idx] = val;
}

template <int RT>
void launch_sep(const PatchCall& c, bool matched, bool vec, dim3 grid,
                cudaStream_t st) {
  const bool bg = c.i_bg != 0.f;
  if (vec) {
    if (!matched)
      k_patch_sep<RT, false, false, true><<<grid, PL_THREADS, 0, st>>>(c);
    else if (bg)
      k_patch_sep<RT, true, true, true><<<grid, PL_THREADS, 0, st>>>(c);
    else
      k_patch_sep<RT, true, false, true><<<grid, PL_THREADS, 0, st>>>(c);
  } else {
    if (!matched)
      k_patch_sep<RT, false, false, false><<<grid, PL_THREADS, 0, st>>>(c);
    else if (bg)
      k_patch_sep<RT, true, true, false><<<grid, PL_THREADS, 0, st>>>(c);
    else
      k_patch_sep<RT, true, false, false><<<grid, PL_THREADS, 0, st>>>(c);
  }
}

// ---------------------------------------------------------------------------
// The first design: the reference's per-pixel order
// ---------------------------------------------------------------------------

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
void launch_direct(bool matched, dim3 grid, cudaStream_t st,
                   const PatchCall& c) {
  if (matched)
    patch_ll_kernel<RT, true><<<grid, PL_THREADS, 0, st>>>(
        c.state, c.s_b, c.s_n, c.frames, c.f_b, c.f_row, c.out, c.B, c.N,
        c.R, c.inv2s2, c.sl2, c.i_bg, c.lo_y, c.hi_y, c.lo_x, c.hi_x, c.oy,
        c.ox);
  else
    patch_ll_kernel<RT, false><<<grid, PL_THREADS, 0, st>>>(
        c.state, c.s_b, c.s_n, c.frames, c.f_b, c.f_row, c.out, c.B, c.N,
        c.R, c.inv2s2, c.sl2, c.i_bg, c.lo_y, c.hi_y, c.lo_x, c.hi_x, c.oy,
        c.ox);
}

}  // namespace

// k_patch_sep.  `vec` asks for the 16-byte window loads: the frames' base
// is 16-byte aligned and their member and row strides and width are
// multiples of 4 (the wrapper's rule; the base and strides are checked
// again here).
extern "C" int ppf_patch_log_likelihood(const void* call) {
  const PatchCall* a = static_cast<const PatchCall*>(call);
  const long long total = (long long)a->B * a->N;
  if (total == 0) return 0;
  if (a->vec && ((uintptr_t)a->frames % 16 || a->f_b % 4 || a->f_row % 4))
    return (int)cudaErrorInvalidValue;
  const PatchCall& c = *a;
  const dim3 grid((unsigned)((total + PL_THREADS - 1) / PL_THREADS));
  cudaStream_t st = (cudaStream_t)a->stream;
  const bool m = a->matched != 0, v = a->vec != 0;
  if (a->R == 4)
    launch_sep<4>(c, m, v, grid, st);
  else
    launch_sep<-1>(c, m, v, grid, st);
  return (int)cudaGetLastError();
}

// The first design, for same-run timing (`vec` is not read).
extern "C" int ppf_patch_log_likelihood_direct(const void* call) {
  const PatchCall* a = static_cast<const PatchCall*>(call);
  const long long total = (long long)a->B * a->N;
  if (total == 0) return 0;
  const PatchCall& c = *a;
  const dim3 grid((unsigned)((total + PL_THREADS - 1) / PL_THREADS));
  cudaStream_t st = (cudaStream_t)a->stream;
  if (a->R == 4)
    launch_direct<4>(a->matched != 0, grid, st, c);
  else
    launch_direct<0>(a->matched != 0, grid, st, c);
  return (int)cudaGetLastError();
}
