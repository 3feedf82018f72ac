// B6 on Hopper: causal (optionally sliding-window) GQA flash attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel l.33, pallas_call l.110).  Computes, for q (B, Hq, Lq, D), k
// (B, Hkv, Lk, D) and v (B, Hkv, Lk, DV), DV = D but for latent attention
// (below), o = softmax(scale * q k^T [soft-capped, causal]) v
// with query head h reading KV head h / (Hq / Hkv), a causal query i at
// position p = i + Lk - Lq (the decode offset) seeing keys j <= p, and with
// a window W the keys p - W < j <= p alone, an online softmax (m, l, acc)
// in float32, and the output in q's dtype.  q, k and v are strided views
// (a decode call passes the KV cache's [..., :pos+1, :] view as it lies in
// memory); o is a contiguous (B, Hq, Lq, DV) tensor.
//
// bf16 (the general path): one block of four warps per (batch row, KV head,
// tile of 64 query rows).  The rows of a KV head are its G query heads at
// each query position, position-major (row r = position r / G, head
// r % G), so a K/V tile staged in shared memory serves every head of the
// group, and a decode step (Lq = 1) puts the G heads of a KV head in one
// tile.  Each warp owns 16 rows and keeps its Q fragments, scores and
// output accumulator in registers; QK^T and PV are mma.sync m16n8k16 bf16
// products with float32 accumulation, their K and V fragments read with
// ldmatrix (V transposed), and the unnormalized probabilities are
// rounded to bf16 for PV, as the TPU kernel rounds p to v's dtype.
// K/V tiles of 64 keys are double-buffered with cp.async, zero-filled past
// Lk.  Keys are walked in order from 0 and a causal block stops at the
// last key its rows can see, so every tile it walks holds a visible key
// for each row it owns; masked scores are -inf and add exactly 0.  With a
// window a block starts at the tile of the first key its first row sees,
// so a query tile walks about W + 64 / G keys, not its position: the
// bounds are per block, uniform across its warps.  Only the edge tiles
// (past Lk, across the diagonal, across the window's lower edge) are
// masked.  At D = 256 the output accumulator takes 128 registers a
// thread, so Q stays in shared memory and its fragments are read with
// ldmatrix for each tile instead of being held in registers (64 more).
// No split over keys and no float atomics: results repeat bit for bit.
//
// What bounds it: at prefill (Lq = Lk = 1024) the products, 4·Lq·Lk·D
// FLOP per head halved by the causal mask, against 989 TFLOP/s of dense
// bf16; at decode (Lq = 1) the bytes of the KV cache view, read once,
// against 3.35 TB/s.  mma.sync reaches a fraction of the wgmma rate, the
// loads are not warp-specialized, and a decode walks all keys in one block
// per KV head.  So the LM path's shapes go to flash_attention_sm90.cu
// instead (kernels/flash_attention.py's plan()): bf16 prefill at D = 64 and
// 128 to its wgmma/TMA kernel, every call of at most 64 query rows per KV
// head to its split-key kernel.  This kernel serves the rest of bf16: more
// than 64 rows per KV head at D = 16, 32, 48, 80, 96, 112 or 256 (the
// prefill of recurrentgemma's local attention, 10 heads over one KV head),
// and K/V views that step a dim by 0, which TMA cannot load.
//
// Latent attention (deepseek-v2's M layer) decompresses K to a head dim of
// 192 (128 nope + 64 rope) beside a V head dim of 128, so both variants
// here also take the pair (D, DV) = (192, 128): the output is (B, Hq, Lq,
// DV).  The bf16 kernel's template splits the score's k-steps (DQK / 16)
// from the output's n-tiles (DV / 8), keeps Q and K rows of DQK + 8 and V
// rows of DV + 8 in shared memory (111,616 bytes at (192, 128), against
// 139,264 at D = 256) and, as at D = 256, reads Q's fragments from shared
// memory for each tile (DQK > 128).  Every (D, D) instantiation does the
// same arithmetic in the same order as before the pair existed.
//
// float32 (the tests' and the f32 models' path): one warp per query row,
// one key per lane, plain FMA; same online softmax and key order.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BM = 64;        // query rows per block (4 warps x 16)
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 128;
constexpr int F32_WARPS = 4;
constexpr int F32_MAX_D = 256;

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * gr + tq.
//   A: a0 (gr, 2tq..+1), a1 (gr+8, 2tq..), a2 (gr, 2tq+8..), a3 (gr+8, 2tq+8..)
//   B: b0 (k 2tq..+1, n gr), b1 (k 2tq+8..+9, n gr)
//   C: c0, c1 (gr, 2tq..+1), c2, c3 (gr+8, 2tq..+1)
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS) flash_bf16(Args a) {
  static_assert(DV <= DQK, "V's rows are loaded beside K's");
  constexpr int LD = DQK + 8;   // padded Q/K smem row (elements): no bank
  constexpr int LDV = DV + 8;   // conflicts; V's padded row
  constexpr int KC = DQK / 16;  // k-steps of QK^T
  constexpr int DN = DV / 8;    // n-tiles of the output
  constexpr int SN = BN / 8;    // n-tiles of the scores
  constexpr int VEC = DQK / 8;  // 16-byte vectors per Q/K row
  constexpr int VEC_V = DV / 8; // 16-byte vectors per V row
  constexpr bool Q_REGS = DQK <= 128;   // Q's fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + BM * LD;       // 2 stages of BN x LD
  __nv_bfloat16* sv = sk + 2 * BN * LD;   // 2 stages of BN x LDV

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int n_rows = a.group * a.lq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int off = a.lk - a.lq;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int idx = tid; idx < BM * VEC; idx += THREADS) {
    const int r = idx / VEC, c = idx % VEC, row = row0 + r;
    const bool ok = row < n_rows;
    const __nv_bfloat16* src = qg;
    if (ok) {
      const int head = hk * a.group + row % a.group;
      src = qg + head * a.q_sh + (long long)(row / a.group) * a.q_sl + c * 8;
    }
    cp_async16(sq + r * LD + c * 8, src, ok);
  }

  // the keys the block's rows see: from the first row's first key to the
  // last row's position
  const int first_pos = row0 / a.group + off;
  const int last_pos = (min(row0 + BM, n_rows) - 1) / a.group + off;
  int kend = a.lk;
  if (a.causal) kend = min(a.lk, last_pos + 1);
  const int kt0 = first_key(a, first_pos) / BN;
  const int n_kt = (kend + BN - 1) / BN;
  // keys below this one are hidden from some row of the block
  const int win_edge = first_key(a, last_pos);

  auto load_kv = [&](int stage, int kt) {
    __nv_bfloat16* dk = sk + stage * BN * LD;
    __nv_bfloat16* dv = sv + stage * BN * LDV;
    for (int idx = tid; idx < BN * VEC; idx += THREADS) {
      const int r = idx / VEC, c = idx % VEC, key = kt * BN + r;
      const bool ok = key < a.lk;
      const long long ko = ok ? key * a.k_sl + c * 8 : 0;
      cp_async16(dk + r * LD + c * 8, kg + ko, ok);
      if (VEC_V == VEC || c < VEC_V) {     // V's row is the first VEC_V
        const long long vo = ok ? key * a.v_sl + c * 8 : 0;
        cp_async16(dv + r * LDV + c * 8, vg + vo, ok);
      }
    }
  };
  if (kt0 < n_kt) load_kv(0, kt0);
  cp_async_commit();                        // group 0: Q and the first tile

  const int r0 = row0 + warp * 16 + gr, r1 = r0 + 8;
  const int pos0 = r0 / a.group + off, pos1 = r1 / a.group + off;
  const bool live = row0 + warp * 16 < n_rows;   // warp-uniform
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t qa[Q_REGS ? KC : 1][4];
  const __nv_bfloat16* qw = sq + warp * 16 * LD;

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int stage = (kt - kt0) & 1;
    if (kt + 1 < n_kt) load_kv(stage ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();                     // tile kt (and Q) have landed
    __syncthreads();
    if (live) {
      if constexpr (Q_REGS) {
        if (kt == kt0) {
#pragma unroll
          for (int kc = 0; kc < KC; ++kc)
            ldmatrix_a(qa[kc], qw + kc * 16, LD, lane);
        }
      }
      const __nv_bfloat16* ks = sk + stage * BN * LD;
      const __nv_bfloat16* vs = sv + stage * BN * LDV;
      float s[SN][4];
#pragma unroll
      for (int n = 0; n < SN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      // K's B fragments, two key n-tiles per ldmatrix: matrices (keys
      // 8n.., d 16kc..), (8n.., 16kc+8..), (8n+8.., 16kc..), (8n+8..,
      // 16kc+8..) give b0, b1 of n-tile n, then of n + 1
      const __nv_bfloat16* krow =
          ks + ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qf[4];
        if constexpr (Q_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[e] = qa[kc][e];
        } else {
          ldmatrix_a(qf, qw + kc * 16, LD, lane);
        }
#pragma unroll
        for (int n = 0; n < SN; n += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, krow + n * 8 * LD + kc * 16);
          mma_bf16(s[n], qf, kb[0], kb[1]);
          mma_bf16(s[n + 1], qf, kb[2], kb[3]);
        }
      }
      // only a tile past Lk, across the diagonal or across the window's
      // lower edge needs the mask (a block-uniform test)
      const bool edge = kt * BN + BN > a.lk ||
                        (a.causal && kt * BN + BN - 1 > first_pos) ||
                        kt * BN < win_edge;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt * BN + n * 8 + tq * 2 + (e & 1);
          const int pos = e < 2 ? pos0 : pos1;
          const bool ok = !edge || (key < a.lk && visible(a, key, pos));
          const float x = ok ? logit(s[n][e], a) : -INFINITY;
          s[n][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      // a row with nothing visible yet keeps m = -inf; shift by 0 there
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = expf(m0 - mu0), al1 = expf(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        s[n][0] = expf(s[n][0] - mu0);
        s[n][1] = expf(s[n][1] - mu0);
        s[n][2] = expf(s[n][2] - mu1);
        s[n][3] = expf(s[n][3] - mu1);
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      // per-lane partial row sums; the quad adds them up at the end
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        o[dn][0] *= al0;
        o[dn][1] *= al0;
        o[dn][2] *= al1;
        o[dn][3] *= al1;
      }
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        // the score C fragments of keys 16kc..16kc+15 are P's A fragment
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kc][0], s[2 * kc][1]),
            pack_bf16(s[2 * kc][2], s[2 * kc][3]),
            pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
        // V's B fragments, transposed, two d n-tiles per ldmatrix:
        // matrices (keys 16kc.., d 8dn..), (16kc+8.., 8dn..), (16kc..,
        // 8dn+8..), (16kc+8.., 8dn+8..)
        const __nv_bfloat16* vrow =
            vs + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDV +
            (lane >> 4) * 8;
#pragma unroll
        for (int dn = 0; dn < DN; dn += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + dn * 8);
          mma_bf16(o[dn], pa, vb[0], vb[1]);
          mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                        // stage kt & 1 is free again
  }

  if (!live) return;
  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o);
  if (r0 < n_rows) {
    const int head = hk * a.group + r0 % a.group;
    __nv_bfloat16* orow =
        og + (((long long)b * a.hq + head) * a.lq + r0 / a.group) * DV;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + tq * 2) =
          __floats2bfloat162_rn(o[dn][0] / d0, o[dn][1] / d0);
  }
  if (r1 < n_rows) {
    const int head = hk * a.group + r1 % a.group;
    __nv_bfloat16* orow =
        og + (((long long)b * a.hq + head) * a.lq + r1 / a.group) * DV;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + tq * 2) =
          __floats2bfloat162_rn(o[dn][2] / d1, o[dn][3] / d1);
  }
}

// float32: one warp per query row (b, head, i), one key per lane; q and k
// rows of d, v and o rows of dv <= d
__global__ void __launch_bounds__(F32_WARPS * 32) flash_f32(Args a, int d,
                                                            int dv) {
  constexpr int C = F32_MAX_D / 32;
  __shared__ float sq[F32_WARPS][F32_MAX_D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * F32_WARPS + warp;
  if (row >= (long long)a.b * a.hq * a.lq) return;     // warp-uniform
  const int i = row % a.lq;
  const int head = (row / a.lq) % a.hq;
  const int b = row / ((long long)a.lq * a.hq);
  const int hk = head / a.group;
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb +
                    head * a.q_sh + i * a.q_sl;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  for (int t = lane; t < d; t += 32) sq[warp][t] = qp[t];
  __syncwarp();
  const int kend = a.causal ? min(a.lk, i + a.lk - a.lq + 1) : a.lk;
  const int kbeg = first_key(a, i + a.lk - a.lq);
  float m = -INFINITY, l = 0.f, acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int j0 = kbeg; j0 < kend; j0 += 32) {
    const int key = j0 + lane;
    float x = -INFINITY;
    if (key < kend) {
      const float* kr = kb + key * a.k_sl;
      float dot = 0.f;
      for (int t = 0; t < d; ++t) dot = fmaf(sq[warp][t], kr[t], dot);
      x = logit(dot, a);
    }
    float mx = x;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float mn = fmaxf(m, mx);
    const float mu = mn == -INFINITY ? 0.f : mn;
    const float al = expf(m - mu);
    const float p = expf(x - mu);
    float ps = p;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, w);
    l = l * al + ps;
    m = mn;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= al;
    const int nk = min(32, kend - j0);
    for (int jj = 0; jj < nk; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const float* vr = vb + (long long)(j0 + jj) * a.v_sl;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int t = lane + 32 * c;
        if (t < dv) acc[c] = fmaf(pj, vr[t], acc[c]);
      }
    }
  }
  const float den = fmaxf(l, 1e-30f);
  float* orow = static_cast<float*>(a.o) +
                (((long long)b * a.hq + head) * a.lq + i) * dv;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = lane + 32 * c;
    if (t < dv) orow[t] = acc[c] / den;
  }
}

template <int DQK, int DV = DQK>
int launch_bf16(const Args& a, cudaStream_t stream) {
  const int smem = ((BM + 2 * BN) * (DQK + 8) + 2 * BN * (DV + 8)) *
                   (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.group * a.lq + BM - 1) / BM, a.hkv, a.b);
  flash_bf16<DQK, DV><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o (B, Hq, Lq, DV) contiguous; q, k (.., D) and v (.., DV) strided
// (element strides, last dim contiguous).  bf16 takes D = DV = 16, 32,
// ..., 128 or 256, or (D, DV) = (192, 128), and 16-byte aligned rows;
// float32 takes D = DV <= 256 or (192, 128).  window > 0 (causal calls
// only) limits each query to its last `window` keys.  Returns the CUDA
// error of the launch, or -1 for head dims the kernel does not take.
int ppf_flash_attention(const void* q, const void* k, const void* v, void* o,
                        long long q_sb, long long q_sh, long long q_sl,
                        long long k_sb, long long k_sh, long long k_sl,
                        long long v_sb, long long v_sh, long long v_sl,
                        int b, int hq, int hkv, int lq, int lk, int d,
                        int dv, int is_bf16, int causal, int window,
                        float scale, float softcap, void* stream) {
  Args a{q,    k,    v,    o,    q_sb, q_sh,   q_sl,  k_sb,  k_sh,
         k_sl, v_sb, v_sh, v_sl, b,    hq,     hkv,   lq,    lk,
         hq / hkv, causal, causal ? window : 0, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mla = d == 192 && dv == 128;   // latent attention's pair
  if (dv != d && !mla) return -1;
  if (!is_bf16) {
    if (d < 1 || d > F32_MAX_D) return -1;
    const long long rows = (long long)b * hq * lq;
    const unsigned blocks = (unsigned)((rows + F32_WARPS - 1) / F32_WARPS);
    flash_f32<<<blocks, F32_WARPS * 32, 0, st>>>(a, d, dv);
    return cudaGetLastError();
  }
  if (mla) return launch_bf16<192, 128>(a, st);
  switch (d) {
    case 16: return launch_bf16<16>(a, st);
    case 32: return launch_bf16<32>(a, st);
    case 48: return launch_bf16<48>(a, st);
    case 64: return launch_bf16<64>(a, st);
    case 80: return launch_bf16<80>(a, st);
    case 96: return launch_bf16<96>(a, st);
    case 112: return launch_bf16<112>(a, st);
    case 128: return launch_bf16<128>(a, st);
    case 256: return launch_bf16<256>(a, st);
    default: return -1;
  }
}

}  // extern "C"
