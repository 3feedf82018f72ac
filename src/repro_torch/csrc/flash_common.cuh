// What B6's kernels share (flash_attention.cu and flash_attention_sm90.cu):
// the call's arguments, cp.async, mma.sync and ldmatrix wrappers, the
// logit rule and the visibility rule of a causal, optionally windowed,
// call.  Everything is internal to the including translation unit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace flash {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  int b, hq, hkv, lq, lk, group, causal;
  int window;         // > 0: a causal query sees its last `window` keys
  float scale, softcap;
};

using tma::smem_u32;

// 16-byte global -> shared copy; zero-fills when !valid (no bytes read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D (16x8, f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lane L gives the address of
// row L % 8 of matrix L / 8 and receives, of matrix i, register r[i] =
// (row L / 4, cols 2 (L % 4), +1) — with .trans, (rows 2 (L % 4), +1;
// col L / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a query at absolute position pos (its row's position plus Lk - Lq) sees
// key j iff j <= pos and, with a window, pos - j < window; a non-causal
// call sees every key (the host sets window only on causal calls)
__device__ __forceinline__ bool visible(const Args& a, int key, int pos) {
  return !a.causal || (key <= pos && (a.window <= 0 || pos - key < a.window));
}

// the first key a causal query at position pos sees
__device__ __forceinline__ int first_key(const Args& a, int pos) {
  return a.causal && a.window > 0 ? max(0, pos - a.window + 1) : 0;
}

// the m16n16 A fragment of rows 0..15, columns 0..15 of a row-major bf16
// tile in shared memory with `ld` elements a row (ldmatrix: matrices
// (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) are a0..a3)
__device__ __forceinline__ void ldmatrix_a(uint32_t (&r)[4],
                                           const __nv_bfloat16* tile, int ld,
                                           int lane) {
  ldmatrix_x4(r, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                     (lane >> 4) * 8);
}

__device__ __forceinline__ float logit(float s, const Args& a) {
  float x = s * a.scale;
  if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
  return x;
}

}  // namespace flash
