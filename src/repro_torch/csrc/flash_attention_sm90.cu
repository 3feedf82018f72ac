// B6 on Hopper: the two bf16 variants that serve the LM path's shapes, a
// wgmma/TMA prefill kernel and a split-key decode kernel with its
// combine pass.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (l.84, pallas_call l.110), as flash_attention.cu does for the shapes
// these variants do not take.  The function is the same: causal or full
// GQA, the decode offset Lk - Lq, an optional sliding window (a causal query
// at position p sees keys p - W < j <= p), the optional tanh soft-cap, strided
// q/k/v views with 16-byte aligned rows, an online float32 softmax, P
// rounded to bf16 unnormalized before P V.  kernels/flash_attention.py's
// plan() chooses the variant from the shapes alone.
//
// Prefill, flash_wgmma<D> (D = 64 or 128, G·Lq > 64 query rows per KV
// head).  Bound: the products, 4·D FLOP per visible (query, key) pair,
// against 989 TFLOP/s of dense bf16, a rate only wgmma reaches.  One block
// of three warpgroups per (batch row, KV head, 128 query rows), the rows
// position-major over the G heads of the KV head (row r = position r / G,
// head r % G), longest rows first.  Warpgroup 0 is the producer: it gives
// its registers to the consumers (setmaxnreg), and one thread keeps a ring
// of K/V tiles of 128 keys in flight with TMA (cp.async.bulk.tensor,
// 128-byte swizzle, zero-filled past Lk) on full/empty mbarrier pairs.
// Warpgroups 1 and 2 own 64 rows each.  They load their Q rows once (per
// row addressing, any G) into the same swizzled layout; then per tile
// S = Q K^T is wgmma m64n128k16 with Q and K read from shared memory, the
// online softmax runs on the f32 accumulator in registers, and P, rounded
// to bf16 in registers, is the A operand of O += P V (the accumulator
// layout is the A fragment layout), with V read key-major as it lies
// through wgmma's transpose bit.  The two consumers take turns at issuing
// their products (named barriers), and a tile's P V goes out with the next
// tile's Q K^T, so one warpgroup's products run under the other's
// softmax; the ring holds three tiles, as a tile's V stays in use until
// the next tile's turn.  A K/V tile serves 128 rows (16 positions at
// G = 8), twice the mma.sync kernel's 64.  Every branch around a wgmma is
// warpgroup-uniform in a way ptxas can see, and nothing divides: either
// makes ptxas serialize the products.  Keys are walked in order, with no
// split and no atomics: results repeat bit for bit.  With a window an item
// walks the tiles from the one holding its first row's first key: the
// producer and both consumers compute the same range from the item, so
// the ring's turns stay in step, and a warpgroup skips (as a whole) a tile
// its rows cannot see.  Only the edge tiles (past Lk, across the diagonal,
// across the window's lower edge) are masked.
//
// Decode, flash_split<D> (G·Lq <= 64 rows per KV head, every bf16 D).
// Bound: the bytes of the K/V rows its queries see, read once, against
// 3.35 TB/s.  One block of four warps per (split, KV head, batch row); a
// split is a contiguous range of keys, and plan() picks the count from
// (B, Hkv, the keys seen) so that the card holds about two blocks per SM.  The rows fill
// ceil(G·Lq / 16) m16 tiles; the warps of a row tile take turns at the
// split's 16-key tiles, each streaming its own two-stage cp.async ring
// (mma.sync m16n8k16, ldmatrix fragments), so no warp idles on a decode
// step.  They combine in the block in warp order.  The splits cut the
// keys from the first one a row of the call can see (key0, from the
// window; 0 without one), so a windowed decode reads O(W) keys and never
// loads one outside its rows' windows; as in the prefill, only edge
// tiles are masked.  At D = 256 a warp keeps its Q rows
// in shared memory (ldmatrix each tile) instead of 64 registers, which
// the 128-register accumulator leaves no room for.  Each split
// writes its rows' (m, l) and unnormalized f32 accumulator to scratch,
// and flash_combine reduces the splits in split order (a split that sees
// no key of a row adds exactly 0 to it) and writes o; a single split
// writes o itself.  The split count depends on the shapes alone, so a
// second call repeats bit for bit.  Softmax exponents are base 2 with
// log2(e) folded into the logits.

#include "flash_common.cuh"
#include "tma.cuh"

// One call of the C entry points below, as the wrapper packs it
// (struct.Struct("@6Q9q11i2f")): one pointer crosses ctypes instead of 26
// arguments.  Outside the anonymous namespace: a C entry point's
// parameter type must not have internal linkage.
struct FlashCall {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* part;        // the split variant's scratch, or null
  float* lse;        // the split variant's (B, Hq, Lq) log-sum-exp, or null
  void* stream;
  long long strides[9];   // q, k, v: batch, head, row (elements)
  int b, hq, hkv, lq, lk, d, causal, split_keys, n_split;
  int window;        // > 0 on causal calls: a query sees its last window keys
  int key0;          // the split variant's first key (the splits start there)
  float scale, softcap;
};

namespace {

using namespace flash;
using namespace tma;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// -- mbarrier, TMA and wgmma ------------------------------------------------

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor with the 128-byte swizzle: the start
// address, the leading byte offset (between the 64-element column blocks
// of an MN-major operand; K-major operands do not read it) and the stride
// byte offset (between 8-row groups), the offsets in 16-byte units.  Tiles
// start 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// 2^x, denormal results flushed to 0 (2^-126 of a row's largest term
// is below bf16's reach of P anyway); 2^-inf = 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1/x to ~1 ulp.  The kernels divide only through this: an IEEE division
// brings a slow-path subroutine call, and a call makes ptxas serialize
// every wgmma of the kernel.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// raw scores -> base-2 logits in place, the soft-cap branch taken once
// per tile and not per score
template <int N>
__device__ __forceinline__ void to_log2_logits(float (&s)[N],
                                               const Args& a) {
  if (a.softcap > 0.f) {
    const float in = a.scale * rcp_approx(a.softcap);
    const float out = a.softcap * LOG2E;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = out * tanhf(s[i] * in);
  } else {
    const float k = a.scale * LOG2E;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= k;
  }
}

// d (64 x 128, f32) (+)= A (64 x 16, shared, K-major) * B (16 x 128,
// shared, K-major); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n64(o, a, db);
  }
}

// -- prefill: wgmma, TMA, warp-specialized ------------------------------------

constexpr int WG_BM = 128;          // query rows per block (2 x 64)
constexpr int WG_BN = 128;          // keys per K/V tile
constexpr int WG_STAGES = 3;        // K/V tiles in the ring
constexpr int WG_THREADS = 384;     // producer + two consumer warpgroups
constexpr int BOX = 64;             // bf16 columns of one 128-byte swizzle box
constexpr int BOX_BYTES = 128 * 128;    // a box of 128 rows (Q or a K/V tile)
// a block takes a whole SM, as the register split of setmaxnreg assumes
constexpr int WG_MIN_SMEM = 120 * 1024;

template <int D>
constexpr int wgmma_smem() {
  return (D / BOX) * BOX_BYTES * (1 + 2 * WG_STAGES) + 1024 +
         2 * WG_STAGES * 8;
}

// Accumulator layout of wgmma m64nN (per warp w of the warpgroup, lane =
// 4 gr + tq): d[4 n + e] is row 16 w + gr (e < 2) or 16 w + gr + 8
// (e >= 2), column 8 n + 2 tq + (e & 1) — the m16n8 C fragment of each
// 8-column block, and for k = 16 kc the A fragment of P is
// {d[8kc], d[8kc+1]}, {d[8kc+2], d[8kc+3]}, {d[8kc+4], d[8kc+5]},
// {d[8kc+6], d[8kc+7]} packed to bf16x2.
//
// Work item j of the grid: the (batch row, KV head) pair j / n_rt, its
// tiles of 128 rows longest first; block c takes items c, c + gridDim.x,
// ..., so the blocks at work at any time share a few pairs' K/V in L2.
struct WgItem {
  int row0, hk, b, kt0, n_kt;
};

__device__ __forceinline__ WgItem wg_item(const Args& a, int j, int n_rt) {
  const int n_rows = a.group * a.lq, pair = j / n_rt;
  WgItem it;
  it.row0 = (n_rt - 1 - j % n_rt) * WG_BM;
  it.hk = pair % a.hkv;
  it.b = pair / a.hkv;
  int kend = a.lk;                 // keys the item's last row can see
  if (a.causal)
    kend = min(a.lk, (min(it.row0 + WG_BM, n_rows) - 1) / a.group + a.lk -
                         a.lq + 1);
  // the tiles from the one holding the first row's first key
  it.kt0 = first_key(a, it.row0 / a.group + a.lk - a.lq) / WG_BN;
  it.n_kt = (kend + WG_BN - 1) / WG_BN;
  return it;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, Args a) {
  constexpr int NB = D / BOX;              // swizzle boxes per row
  constexpr int KV_BYTES = NB * BOX_BYTES; // one K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sk = sq + KV_BYTES;                 // [stage][box]
  unsigned char* sv = sk + WG_STAGES * KV_BYTES;     // [stage][box]
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + WG_STAGES * KV_BYTES);
  uint64_t* empty = full + WG_STAGES;

  // the warpgroup, broadcast so that ptxas sees it uniform: every branch
  // around a wgmma must be, or ptxas serializes the products
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int n_rows = a.group * a.lq;
  const int n_rt = (n_rows + WG_BM - 1) / WG_BM;
  const int n_items = n_rt * a.hkv * a.b;
  const int off = a.lk - a.lq;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: one thread issues every K/V load, item after item, so
    // the next item's first tiles load under this item's last products --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      int g = 0;                     // tiles issued, over all items
      for (int j = blockIdx.x; j < n_items; j += gridDim.x) {
        const WgItem it = wg_item(a, j, n_rt);
        for (int kt = it.kt0; kt < it.n_kt; ++kt, ++g) {
          const int s = g % WG_STAGES, round = g / WG_STAGES;
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          mbar_expect_tx(&full[s], 2 * KV_BYTES);
#pragma unroll
          for (int box = 0; box < NB; ++box) {
            tma_load(sk + s * KV_BYTES + box * BOX_BYTES, &tm_k, &full[s],
                     box * BOX, kt * WG_BN, it.hk, it.b);
            tma_load(sv + s * KV_BYTES + box * BOX_BYTES, &tm_v, &full[s],
                     box * BOX, kt * WG_BN, it.hk, it.b);
          }
        }
      }
    }
  } else {
    // -- consumers: 64 rows of each item per warpgroup ----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1, ctid = tid - 128 * wg;
    const int warp = ctid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tq = lane & 3;
    const bf16* qg = static_cast<const bf16*>(a.q);

    // an item's Q rows of this warpgroup, 16-byte chunks, read into
    // registers one item ahead; rows past G·Lq are zeros
    constexpr int VEC = D / 8, QV = 64 * VEC / 128;
    uint4 qv[QV];
    auto fetch_q = [&](int j) {
      const WgItem it = wg_item(a, j, n_rt);
#pragma unroll
      for (int x = 0; x < QV; ++x) {
        const int idx = ctid + 128 * x, row = it.row0 + 64 * cw + idx / VEC;
        qv[x] = make_uint4(0u, 0u, 0u, 0u);
        if (row < n_rows)
          qv[x] = *reinterpret_cast<const uint4*>(
              qg + it.b * a.q_sb + (it.hk * a.group + row % a.group) * a.q_sh +
              (long long)(row / a.group) * a.q_sl + (idx % VEC) * 8);
      }
    };
    // chunk c of row r goes to chunk (c % 8) ^ (r % 8) of box c / 8 (the
    // 128-byte swizzle); generic-proxy stores, then a fence for wgmma's
    // async proxy
    auto store_q = [&] {
#pragma unroll
      for (int x = 0; x < QV; ++x) {
        const int idx = ctid + 128 * x, c = idx % VEC;
        const int lr = 64 * cw + idx / VEC;
        *reinterpret_cast<uint4*>(sq + (c >> 3) * BOX_BYTES + lr * 128 +
                                  (((c & 7) ^ (lr & 7)) << 4)) = qv[x];
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    };

    float o[D / 2];
    float sc[64];
    uint32_t pa[WG_BN / 16][4];      // P of the last tile, for its P V
    int pv_stage = -1;               // that tile's stage, while P V is due
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    };
    auto issue_pv = [&] {
#pragma unroll
      for (int kc = 0; kc < WG_BN / 16; ++kc) {
        // keys 16 kc.. of the tile: two 8-key groups 1024 bytes apart
        // (SBO), the column boxes BOX_BYTES apart (LBO)
        wgmma_pv<D>(o, pa[kc],
                    sw128_desc(sv + pv_stage * KV_BYTES + kc * 16 * 128,
                               BOX_BYTES, 1024));
      }
    };

    // the consumers take turns (named barriers 3 and 4) at issuing their
    // products, so one warpgroup's products run under the other's softmax;
    // a tile's P V is issued with the next tile's Q K^T
    if (cw == 1)
      asm volatile("bar.arrive 3, 256;\n" ::: "memory");   // 0 goes first
    if (blockIdx.x < n_items) fetch_q(blockIdx.x);
    int g = 0;                       // tiles consumed, over all items
    for (int j = blockIdx.x; j < n_items; j += gridDim.x) {
      const WgItem it = wg_item(a, j, n_rt);
      const bool last_item = j + gridDim.x >= n_items;
      store_q();
      if (!last_item) fetch_q(j + gridDim.x);

      const int wrow0 = it.row0 + 64 * cw;
      const bool live = wrow0 < n_rows;             // warpgroup-uniform
      const int r0 = wrow0 + warp * 16 + gr, r1 = r0 + 8;
      const int pos0 = r0 / a.group + off, pos1 = r1 / a.group + off;
      const int first_pos = wrow0 / a.group + off;
      const int last_pos = (min(wrow0 + 64, n_rows) - 1) / a.group + off;
      int wend = a.lk;               // keys this warpgroup's rows can see
      if (a.causal && live) wend = min(a.lk, last_pos + 1);
      // the first key a row of this warpgroup sees, and the key below which
      // some row is blind (the window's lower edges)
      const int wbeg = first_key(a, first_pos);
      const int win_edge = first_key(a, last_pos);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

      for (int kt = it.kt0; kt < it.n_kt; ++kt, ++g) {
        const int s = g % WG_STAGES;
        const int k0 = kt * WG_BN;
        // warpgroup-uniform
        const bool work = live && k0 < wend && k0 + WG_BN > wbeg;
        mbar_wait(&full[s], (g / WG_STAGES) & 1);
        asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");
        fence_regs(sc);
        fence_regs(o);
        wgmma_fence();
        if (work) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t in_box = (kk & 3) * 32;
            wgmma_ss_n128(
                sc,
                sw128_desc(sq + (kk >> 2) * BOX_BYTES + cw * 64 * 128 +
                               in_box, 16, 1024),
                sw128_desc(sk + s * KV_BYTES + (kk >> 2) * BOX_BYTES + in_box,
                           16, 1024),
                kk > 0);
          }
        }
        if (pv_stage >= 0) issue_pv();
        wgmma_commit();
        // the other warpgroup's turn (warpgroup 1's very last pass would
        // find no one waiting)
        if (cw == 0 || !last_item || kt + 1 < it.n_kt)
          asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(o);
        if (pv_stage >= 0) release(pv_stage);
        pv_stage = -1;
        if (!work) {
          release(s);
          continue;
        }

        to_log2_logits(sc, a);
        // only a tile past Lk, across the diagonal or across the window's
        // lower edge needs the mask
        if (k0 + WG_BN > a.lk || (a.causal && k0 + WG_BN - 1 > first_pos) ||
            k0 < win_edge) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int key = k0 + (i >> 2) * 8 + tq * 2 + (i & 1);
            const int pos = (i & 2) ? pos1 : pos0;
            if (key >= a.lk || !visible(a, key, pos)) sc[i] = -INFINITY;
          }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        // a row with nothing visible yet keeps m = -inf; shift by 0 there
        const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
        const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
        const float al0 = exp2_ftz(m0 - mu0), al1 = exp2_ftz(m1 - mu1);
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          sc[4 * n] = exp2_ftz(sc[4 * n] - mu0);
          sc[4 * n + 1] = exp2_ftz(sc[4 * n + 1] - mu0);
          sc[4 * n + 2] = exp2_ftz(sc[4 * n + 2] - mu1);
          sc[4 * n + 3] = exp2_ftz(sc[4 * n + 3] - mu1);
          ps0 += sc[4 * n] + sc[4 * n + 1];
          ps1 += sc[4 * n + 2] + sc[4 * n + 3];
        }
        // per-lane partial row sums; the quad adds them up at the end
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          o[4 * dn] *= al0;
          o[4 * dn + 1] *= al0;
          o[4 * dn + 2] *= al1;
          o[4 * dn + 3] *= al1;
        }
#pragma unroll
        for (int kc = 0; kc < WG_BN / 16; ++kc) {
          pa[kc][0] = pack_bf16(sc[8 * kc], sc[8 * kc + 1]);
          pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
          pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
          pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
        }
        pv_stage = s;
      }
      if (pv_stage >= 0) {                          // the last tile's P V
        fence_regs(o);
        wgmma_fence();
        issue_pv();
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        release(pv_stage);
        pv_stage = -1;
      }

      if (live) {
        const float d0 = rcp_approx(fmaxf(quad_sum(l0), 1e-30f));
        const float d1 = rcp_approx(fmaxf(quad_sum(l1), 1e-30f));
        bf16* og = static_cast<bf16*>(a.o);
        if (r0 < n_rows) {
          const int head = it.hk * a.group + r0 % a.group;
          bf16* orow = og + (((long long)it.b * a.hq + head) * a.lq +
                             r0 / a.group) * D;
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn)
            *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + tq * 2) =
                __floats2bfloat162_rn(o[4 * dn] * d0, o[4 * dn + 1] * d0);
        }
        if (r1 < n_rows) {
          const int head = it.hk * a.group + r1 % a.group;
          bf16* orow = og + (((long long)it.b * a.hq + head) * a.lq +
                             r1 / a.group) * D;
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn)
            *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + tq * 2) =
                __floats2bfloat162_rn(o[4 * dn + 2] * d1, o[4 * dn + 3] * d1);
        }
      }
    }
  }
}

// -- decode: split keys, then combine ----------------------------------------

constexpr int SP_WARPS = 4;
constexpr int SP_KEYS = 16;         // keys per warp tile
constexpr int SP_STAGES = 2;        // tiles in each warp's cp.async ring
constexpr int SP_MAX_ROWS = 16 * SP_WARPS;

// Q rows in shared memory instead of registers (each warp its 16 rows)
template <int D>
__host__ __device__ constexpr bool split_q_smem() {
  return D > 128;
}

template <int D>
__host__ __device__ constexpr int split_ring() {
  return SP_WARPS * SP_STAGES * 2 * SP_KEYS * (D + 8) * 2;
}

template <int D>
constexpr int split_smem() {
  constexpr int ring =
      split_ring<D>() + (split_q_smem<D>() ? SP_WARPS * 16 * (D + 8) * 2 : 0);
  constexpr int red = SP_WARPS * (32 + 16 * D) * 4;
  return ring > red ? ring : red;
}

// a row's log-sum-exp in natural-log units from its max mu (log2 units of
// the scaled logits, 0 for a row that saw no key) and its sum l of
// 2^(s - mu): -inf for a row that saw no key
__device__ __forceinline__ float log_sum_exp(float mu, float l) {
  return l > 0.f ? (mu + log2f(l)) * 0.69314718055994531f : -INFINITY;
}

// Fragment layouts as in flash_attention.cu (mma.m16n8k16, lane = 4 gr +
// tq).  With `lse` the kernel (or the combine) also writes each row's
// log-sum-exp (B6's partials, for a sequence-parallel decode).  Scratch
// `part` holds, per (batch row, KV head, split, row), the
// record {m, l, acc[D]}: m in log2 units, acc unnormalized against m.
template <int D>
__global__ void __launch_bounds__(SP_WARPS * 32)
    flash_split(Args a, int key0, int split_keys, int n_split, float* part,
                float* lse) {
  constexpr int LD = D + 8;       // padded smem row (elements)
  constexpr bool QS = split_q_smem<D>();
  constexpr int KC = D / 16, DN = D / 8, VEC = D / 8;
  constexpr int TILE = SP_KEYS * LD;
  constexpr int REC = 32 + 16 * D;    // a warp's m[16], l[16], acc[16][D]
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rows = a.group * a.lq;
  const int n_rt = (n_rows + 15) / 16, n_kw = SP_WARPS / n_rt;
  const int rt = warp % n_rt, kw = warp / n_rt;   // row tile, key share
  const int s0 = key0 + split * split_keys, s1 = min(a.lk, s0 + split_keys);
  const int n_tiles = (s1 - s0 + SP_KEYS - 1) / SP_KEYS;
  const int off = a.lk - a.lq;        // the first query's position
  // keys below this one are hidden from the last query (its window)
  const int win_edge = first_key(a, a.lk - 1);

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (kw < n_kw) {                                  // warp-uniform
    bf16* ring = reinterpret_cast<bf16*>(smem) + warp * SP_STAGES * 2 * TILE;
    const bf16* kg =
        static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
    const bf16* vg =
        static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
    // this warp's tiles: kw, kw + n_kw, ... of the split
    const int my_n = n_tiles > kw ? (n_tiles - kw + n_kw - 1) / n_kw : 0;
    auto load = [&](int i) {
      bf16* dk = ring + (i % SP_STAGES) * 2 * TILE;
      bf16* dv = dk + TILE;
      const int tkey = s0 + (kw + i * n_kw) * SP_KEYS;
      for (int idx = lane; idx < SP_KEYS * VEC; idx += 32) {
        const int r = idx / VEC, c = idx % VEC, key = tkey + r;
        const bool ok = key < s1;
        cp_async16(dk + r * LD + c * 8, kg + (ok ? key * a.k_sl + c * 8 : 0),
                   ok);
        cp_async16(dv + r * LD + c * 8, vg + (ok ? key * a.v_sl + c * 8 : 0),
                   ok);
      }
    };
#pragma unroll
    for (int i = 0; i < SP_STAGES - 1; ++i) {
      if (i < my_n) load(i);
      cp_async_commit();
    }

    // Q's A fragments straight from global memory; rows past G·Lq are 0
    const int r0 = rt * 16 + gr, r1 = r0 + 8;
    const int pos0 = r0 / a.group + off, pos1 = r1 / a.group + off;
    const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb;
    const bf16* q0 =
        r0 < n_rows ? qg + (hk * a.group + r0 % a.group) * a.q_sh +
                          (long long)(r0 / a.group) * a.q_sl
                    : nullptr;
    const bf16* q1 =
        r1 < n_rows ? qg + (hk * a.group + r1 % a.group) * a.q_sh +
                          (long long)(r1 / a.group) * a.q_sl
                    : nullptr;
    auto ld32 = [](const bf16* p) {
      return p ? *reinterpret_cast<const uint32_t*>(p) : 0u;
    };
    uint32_t qa[QS ? 1 : KC][4];
    // at D > 128: the warp's 16 rows, row-major with LD, zeros past G·Lq
    bf16* sq = reinterpret_cast<bf16*>(smem + split_ring<D>()) +
               warp * 16 * LD;
    if constexpr (QS) {
      for (int idx = lane; idx < 16 * VEC; idx += 32) {
        const int r = idx / VEC, c = idx % VEC, row = rt * 16 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < n_rows)
          val = *reinterpret_cast<const uint4*>(
              qg + (hk * a.group + row % a.group) * a.q_sh +
              (long long)(row / a.group) * a.q_sl + c * 8);
        *reinterpret_cast<uint4*>(sq + r * LD + c * 8) = val;
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int c = kc * 16 + tq * 2;
        qa[kc][0] = ld32(q0 ? q0 + c : nullptr);
        qa[kc][1] = ld32(q1 ? q1 + c : nullptr);
        qa[kc][2] = ld32(q0 ? q0 + c + 8 : nullptr);
        qa[kc][3] = ld32(q1 ? q1 + c + 8 : nullptr);
      }
    }

    for (int i = 0; i < my_n; ++i) {
      if (i + SP_STAGES - 1 < my_n) load(i + SP_STAGES - 1);
      cp_async_commit();
      cp_async_wait<SP_STAGES - 1>();               // tile i has landed
      __syncwarp();
      const bf16* ks = ring + (i % SP_STAGES) * 2 * TILE;
      const bf16* vs = ks + TILE;
      const int tkey = s0 + (kw + i * n_kw) * SP_KEYS;
      // scores of keys tkey + 8 n + 2 tq + (e & 1): s[4 n + e], rows r0
      // (e < 2) and r1
      float s[8] = {};
      // K's B fragments of both 8-key n-tiles per ldmatrix
      const bf16* krow =
          ks + ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qf[4];
        if constexpr (QS) {
          ldmatrix_a(qf, sq + kc * 16, LD, lane);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[e] = qa[kc][e];
        }
        uint32_t kb[4];
        ldmatrix_x4(kb, krow + kc * 16);
        mma_bf16(*reinterpret_cast<float(*)[4]>(s), qf, kb[0], kb[1]);
        mma_bf16(*reinterpret_cast<float(*)[4]>(s + 4), qf, kb[2], kb[3]);
      }
      to_log2_logits(s, a);
      // only a tile past the split's end, across the diagonal or across
      // the window's lower edge needs the mask (a warp-uniform test)
      if (tkey + SP_KEYS > s1 || (a.causal && tkey + SP_KEYS - 1 > off) ||
          tkey < win_edge) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int key = tkey + (i >> 2) * 8 + tq * 2 + (i & 1);
          const int pos = (i & 2) ? pos1 : pos0;
          if (key >= s1 || !visible(a, key, pos)) s[i] = -INFINITY;
        }
      }
      const float mx0 = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[4], s[5]));
      const float mx1 = fmaxf(fmaxf(s[2], s[3]), fmaxf(s[6], s[7]));
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = exp2_ftz(m0 - mu0), al1 = exp2_ftz(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = exp2_ftz(s[i] - ((i & 2) ? mu1 : mu0));
      l0 = l0 * al0 + s[0] + s[1] + s[4] + s[5];
      l1 = l1 * al1 + s[2] + s[3] + s[6] + s[7];
      const uint32_t pa[4] = {pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]),
                              pack_bf16(s[4], s[5]), pack_bf16(s[6], s[7])};
      // V's B fragments, transposed, two d n-tiles per ldmatrix
      const bf16* vrow =
          vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        o[dn][0] *= al0;
        o[dn][1] *= al0;
        o[dn][2] *= al1;
        o[dn][3] *= al1;
      }
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + dn * 8);
        mma_bf16(o[dn], pa, vb[0], vb[1]);
        mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
      }
      __syncwarp();                         // the stage may be refilled
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
  }
  __syncthreads();                          // every ring is spent

  // each warp's partial: m and l of its 16 rows, then acc
  float* red = reinterpret_cast<float*>(smem);
  if (kw < n_kw) {
    float* mine = red + warp * REC;
    if (tq == 0) {
      mine[gr] = m0;
      mine[gr + 8] = m1;
      mine[16 + gr] = l0;
      mine[24 + gr] = l1;
    }
    float* acc = mine + 32;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[gr * D + dn * 8 + tq * 2] = o[dn][0];
      acc[gr * D + dn * 8 + tq * 2 + 1] = o[dn][1];
      acc[(gr + 8) * D + dn * 8 + tq * 2] = o[dn][2];
      acc[(gr + 8) * D + dn * 8 + tq * 2 + 1] = o[dn][3];
    }
  }
  __syncthreads();

  // the block's rows: the key shares of a row tile in warp order
  bf16* og = static_cast<bf16*>(a.o);
  float* rec = n_split == 1 ? nullptr
                            : part + ((((long long)b * a.hkv + hk) * n_split +
                                       split) * n_rows) * (D + 2);
  for (int idx = threadIdx.x; idx < n_rows * D; idx += SP_WARPS * 32) {
    const int r = idx / D, c = idx % D, t = r >> 4, rr = r & 15;
    float m = -INFINITY;
    for (int w = 0; w < n_kw; ++w)
      m = fmaxf(m, red[(t + w * n_rt) * REC + rr]);
    // a share that saw no key of the row weighs 2^-inf = 0
    const float mu = m == -INFINITY ? 0.f : m;
    float l = 0.f, acc = 0.f;
    for (int w = 0; w < n_kw; ++w) {
      const float* p = red + (t + w * n_rt) * REC;
      const float wt = exp2_ftz(p[rr] - mu);
      l += wt * p[16 + rr];
      acc += wt * p[32 + rr * D + c];
    }
    if (n_split == 1) {
      const int head = hk * a.group + r % a.group;
      const long long row = ((long long)b * a.hq + head) * a.lq + r / a.group;
      og[row * D + c] =
          __float2bfloat16_rn(acc * rcp_approx(fmaxf(l, 1e-30f)));
      if (lse != nullptr && c == 0) lse[row] = log_sum_exp(mu, l);
    } else {
      rec[(long long)r * (D + 2) + 2 + c] = acc;
      if (c == 0) {
        rec[(long long)r * (D + 2)] = m;
        rec[(long long)r * (D + 2) + 1] = l;
      }
    }
  }
}

// o of each (batch row, KV head, row) from its splits' records, in split
// order: one warp per row, lane t taking columns t, t + 32, ...
__global__ void __launch_bounds__(128)
    flash_combine(Args a, int d, int n_split, const float* part, float* lse) {
  constexpr int C = 256 / 32;               // d <= 256
  const int n_rows = a.group * a.lq;
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= (long long)a.b * a.hkv * n_rows) return;        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int r = row % n_rows;
  const long long bh = row / n_rows;                 // b * hkv + hk
  const int hk = bh % a.hkv, b = bh / a.hkv;
  const long long stride = (long long)n_rows * (d + 2);     // next split
  const float* p = part + (bh * n_split * n_rows + r) * (d + 2);
  // the splits' maxima, 32 at a time across the lanes
  float m = -INFINITY;
  for (int s = lane; s < n_split; s += 32) m = fmaxf(m, p[s * stride]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, w));
  // a split that saw no key of the row has m = -inf, l = 0 and acc = 0:
  // its weight is 2^-inf = 0 and it adds exactly 0
  const float mu = m == -INFINITY ? 0.f : m;
  float l = 0.f, acc[C] = {};
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float* q = p + s * stride;
    const float wt = exp2_ftz(q[0] - mu);
    l += wt * q[1];
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (lane + 32 * c < d) acc[c] += wt * q[2 + lane + 32 * c];
  }
  const float den = rcp_approx(fmaxf(l, 1e-30f));
  const int head = hk * a.group + r % a.group;
  const long long orow_i = ((long long)b * a.hq + head) * a.lq + r / a.group;
  if (lse != nullptr && lane == 0) lse[orow_i] = log_sum_exp(mu, l);
  bf16* orow = static_cast<bf16*>(a.o) + orow_i * d;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane + 32 * c < d)
      orow[lane + 32 * c] = __float2bfloat16_rn(acc[c] * den);
}

// -- host side ---------------------------------------------------------------

// The tensor map of a (B, H, L, D) bf16 view with element strides sb, sh,
// sl (last dim contiguous): dims innermost first, boxes of 64 columns x
// WG_BN rows, 128-byte swizzle, zeros past the ends.  A dim of extent 1
// is never stepped; it gets the contiguous stride, which TMA accepts.
// Returns 0, or an error code for the wrapper to report.
int kv_map(CUtensorMap* map, const void* base, int b, int h, int l, int d,
           long long sb, long long sh, long long sl) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)l, (cuuint64_t)h,
                              (cuuint64_t)b};
  const long long given[3] = {sl, sh, sb};
  cuuint64_t strides[3];
  cuuint64_t contiguous = (cuuint64_t)d * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? contiguous : (cuuint64_t)given[i] * 2;
    contiguous = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {BOX, WG_BN, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + (int)res;
}

// a kernel's dynamic shared memory limit, raised once per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && !done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    done[dev] = err == cudaSuccess;
  }
  return err;
}

template <int D>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap tk, tv;
  int err = kv_map(&tk, a.k, a.b, a.hkv, a.lk, D, a.k_sb, a.k_sh, a.k_sl);
  if (err == 0)
    err = kv_map(&tv, a.v, a.b, a.hkv, a.lk, D, a.v_sb, a.v_sh, a.v_sl);
  if (err != 0) return err;
  constexpr int smem =
      wgmma_smem<D>() > WG_MIN_SMEM ? wgmma_smem<D>() : WG_MIN_SMEM;
  static bool done[64];
  const cudaError_t attr = allow_smem(flash_wgmma<D>, smem, done);
  if (attr != cudaSuccess) return attr;
  // persistent: one block per SM, or one per item when there are fewer
  int dev = 0, sms = 0;
  cudaError_t derr = cudaGetDevice(&dev);
  if (derr == cudaSuccess)
    derr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (derr != cudaSuccess) return derr;
  const long long items =
      (long long)((a.group * a.lq + WG_BM - 1) / WG_BM) * a.hkv * a.b;
  const int grid = (int)(items < sms ? items : sms);
  flash_wgmma<D><<<grid, WG_THREADS, smem, stream>>>(tk, tv, a);
  return cudaGetLastError();
}

template <int D>
int launch_split(const Args& a, int key0, int split_keys, int n_split,
                 float* part, float* lse, cudaStream_t stream) {
  constexpr int smem = split_smem<D>();
  static bool done[64];
  const cudaError_t attr = allow_smem(flash_split<D>, smem, done);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_split, a.hkv, a.b);
  flash_split<D><<<grid, SP_WARPS * 32, smem, stream>>>(a, key0, split_keys,
                                                        n_split, part, lse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const long long rows = (long long)a.b * a.hkv * a.group * a.lq;
  flash_combine<<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      a, D, n_split, part, lse);
  return cudaGetLastError();
}

Args args_of(const FlashCall& c) {
  const long long* s = c.strides;
  return Args{c.q,  c.k,  c.v,  c.o,          s[0],     s[1],  s[2],
              s[3], s[4], s[5], s[6],         s[7],     s[8],  c.b,
              c.hq, c.hkv, c.lq, c.lk,        c.hq / c.hkv, c.causal,
              c.causal ? c.window : 0,        c.scale,  c.softcap};
}

}  // namespace

extern "C" {

// bf16 only; o (B, Hq, Lq, D) contiguous; q, k, v strided (last dim
// contiguous, 16-byte aligned rows).  Each returns the CUDA error of its
// launches, -1 for a shape the variant does not take, -2 without the
// driver's tensor-map encoder, or 10000 + the encoder's CUresult.

// the prefill variant: D = 64 or 128; k and v need nonzero strides on
// every dim of extent > 1 (TMA)
int ppf_flash_wgmma(const FlashCall* c) {
  const Args a = args_of(*c);
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  switch (c->d) {
    case 64: return launch_wgmma<64>(a, st);
    case 128: return launch_wgmma<128>(a, st);
    default: return -1;
  }
}

// the decode variant: G·Lq <= 64 rows per KV head, D = 16, 32, ..., 128
// or 256; n_split splits of split_keys keys (a multiple of 16) from key0,
// each holding a key; `part` holds B·Hkv·n_split·G·Lq·(D + 2) floats when
// n_split > 1; with `lse` set, each row's float32 log-sum-exp too
int ppf_flash_split(const FlashCall* c) {
  const Args a = args_of(*c);
  const int sk = c->split_keys, ns = c->n_split, k0 = c->key0;
  const long long keys = (long long)a.lk - k0;
  if (a.group * a.lq > SP_MAX_ROWS || sk % SP_KEYS || ns < 1 || k0 < 0 ||
      (long long)(ns - 1) * sk >= keys || (long long)ns * sk < keys ||
      (ns > 1 && c->part == nullptr))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  float* p = static_cast<float*>(c->part);
  switch (c->d) {
    case 16: return launch_split<16>(a, k0, sk, ns, p, c->lse, st);
    case 32: return launch_split<32>(a, k0, sk, ns, p, c->lse, st);
    case 48: return launch_split<48>(a, k0, sk, ns, p, c->lse, st);
    case 64: return launch_split<64>(a, k0, sk, ns, p, c->lse, st);
    case 80: return launch_split<80>(a, k0, sk, ns, p, c->lse, st);
    case 96: return launch_split<96>(a, k0, sk, ns, p, c->lse, st);
    case 112: return launch_split<112>(a, k0, sk, ns, p, c->lse, st);
    case 128: return launch_split<128>(a, k0, sk, ns, p, c->lse, st);
    case 256: return launch_split<256>(a, k0, sk, ns, p, c->lse, st);
    default: return -1;
  }
}

}  // extern "C"
