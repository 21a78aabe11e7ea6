// flash_attention: GQA attention with an online softmax, causal or not,
// with an optional sliding window and an optional int8 K / V cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention_pallas,
// whose grid walks KV blocks in order and carries (m, l, acc) across them.
//
// Bound on the card: tensor-core FLOPs.  A causal square call does
// 4*B*H*hd*S(S+1)/2 operations (QK^T and PV over the lower triangle) on
// 2*(B*S*H*hd + 2*B*S*K*hd) bytes of bf16 in and out; at Yi-9B's attention
// (H=32, K=4, hd=128) and S=4096 that is 1.37e11 operations against 75.5 MB,
// 0.139 ms at 989 TFLOP/s against 0.023 ms at 3.35 TB/s.
//
// A bf16 call with one query row (a decode step's) does not come here:
// its 128-row query tile would hold one real row, so ops.py sends it to
// the decode body (flash_attention_decode.cu: a KV head's query heads in
// one tile, the cache split over blocks).  A float32 one still does.
//
// Semantics: one block per (query tile, head, batch); a loop over KV tiles
// takes the place of the TPU's sequential grid dimension.  Query row i
// sits at key position q_off + i (q_off = 0 in training and prefill,
// kv_len - 1 in decode).  Under causal the loop stops at the last tile
// that meets the diagonal; under a sliding window (key p visible to a
// query at position q iff q - p < window, the reference's mask) it starts
// at the tile of the block's first row's oldest visible key, so a decode
// step reads `window` rows, not kv_len.  The diagonal, the window's band
// and the ragged tail k_pos >= Skv are masked in the kernel, so the
// wrapper pads nothing.  A row whose first tiles are all masked adds
// nothing (its probabilities are zero until it meets a visible key).
// q, k, v and the output are read and written in place in the
// models' (B, S, heads, hd) layout; query head h reads KV head h / (H / K).
// K and V may hold more rows than the Skv keys that are visible (a decode
// step reads the first L + 1 rows of a (B, S_max, K, hd) cache): batch b
// starts at row b * kv_rows, and no row at or past Skv is read.
// Masked logits are -1e30, m / l / acc stay float32, the output is
// acc / max(l, 1e-30), as in the TPU kernel and its oracle.  Given an lse
// buffer, a call also writes each query row's m + log(l) (in units of the
// scaled scores), the statistics the TPU kernel's pallas_call returns
// beside acc; the backward (flash_attention_bwd.cu) rebuilds P from it,
// and a sequence-parallel decode combines its ranks' outputs by it.
// An int8 cache (K and V int8 with a bf16 scale per (row, KV head), the
// reference's quantize_kv) is dequantised on the fly: a score is q . k8
// times its key's scale in float32, and V's scale is folded into P's
// column before the PV product, so the scales stay float32 as in the
// reference's chunked dequantisation; the only new rounding is P * s_v
// to bf16 (P is bf16 in the PV product already).
//  * bf16: a Hopper kernel (sm_90a).  A block owns 128 query rows of one
//    (head, batch) and walks KV tiles of 128 keys.  A producer warp issues
//    TMA loads, Q once and then K and V into a two-stage shared-memory
//    ring; "full" and "empty" mbarriers pace it against two consumer
//    warpgroups of 64 query rows each, which setmaxnreg gives the
//    producer's registers.  S = Q K^T is wgmma m64n128k16 with both
//    operands K-major in shared memory.  The f32 scores are masked (only
//    on diagonal, band and ragged tiles), go through exp2 with scale *
//    log2(e) folded into one FMA, and are packed to bf16 in registers,
//    where they already are wgmma's A fragment: O += P V takes A from
//    registers and V from shared memory as an MN-major operand (the
//    transpose bit).  TMA's 128-byte swizzle is the layout the wgmma
//    descriptors read, so a 128-wide head loads as two 64-column boxes.
//    The 4-D tensor maps (hd, heads, S, B) zero-fill rows past Sq or Skv
//    and never read into the next batch: K and V's maps have Skv rows and
//    the buffer's batch stride, so the rows of a cache past Skv are never
//    loaded.  Blocks start with the query tiles that have the most KV
//    tiles, which shortens the causal tail.
//    int8 K / V (flash_wgmma_kernel<HD, true>): TMA loads each tile's
//    int8 rows unswizzled into the two-stage ring (half the bytes of
//    bf16), while the producer warpgroup's 128 threads put the tile's K
//    and V scales (one key a thread) into shared memory as float32.  The
//    two consumer warpgroups widen the staged K tile to bf16 (exact:
//    |x| <= 127) into the 128-byte swizzled layout TMA writes for bf16,
//    and V's the same way before the PV product; a named barrier over
//    the 256 consumer threads publishes each widened tile, and since
//    each warpgroup has finished its previous product with a tile before
//    it reaches the barrier of the next, one bf16 K and one V tile
//    suffice.
//  * f32: FMA on the CUDA cores (the tensor cores' TF32 would miss the
//    oracle's float32 by more than 1e-5).  A 16 x 16 thread grid owns a
//    64 x 64 score tile, 4 x 4 each; P goes through shared memory.  int8
//    K / V are dequantised (times their scales, in float32) as a tile is
//    loaded.
// The Hopper helpers (mbarriers, TMA, wgmma, the tensor maps) are in
// hopper_common.cuh, shared with the backward.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int B, Sq, Skv, H, K, group;  // group = H / K; Skv = the visible keys
  int kv_rows;                  // rows of K / V per batch (>= Skv)
  int causal;
  int window;                   // 0: no sliding window
  int q_off;                    // key position of query row 0
  float scale;                  // 1 / sqrt(hd)
  // int8 K / V: their (B, kv_rows, K, 1) bf16 scales; else null
  const __nv_bfloat16* k_scale;
  const __nv_bfloat16* v_scale;
  // when not null, {key rows loaded summed over blocks, blocks, the most
  // one block loads}: each block adds the rows of its KV tiles below Skv
  unsigned long long* rows_read;
};

__device__ __forceinline__ bool visible(int key, int row, const Shape& s) {
  const int pos = row + s.q_off;
  return key < s.Skv && (!s.causal || key <= pos) &&
         (s.window == 0 || pos - key < s.window);
}

// The KV tiles of `bk` keys that rows row0 .. row_last can see: the first
// (under a window, the tile of row0's oldest visible key) and one past
// the last (under causal, the tile of row_last's diagonal).
__device__ __forceinline__ int first_tile(int row0, const Shape& s, int bk) {
  const int key = row0 + s.q_off - s.window + 1;
  return s.window > 0 && key > 0 ? key / bk : 0;
}
__device__ __forceinline__ int end_tile(int row_last, const Shape& s,
                                        int bk) {
  const int n = (s.Skv + bk - 1) / bk;
  return s.causal ? min(n, (row_last + s.q_off) / bk + 1) : n;
}

// A block's KV tiles [tile0, tile_end) of `bk` keys into s.rows_read:
// the rows below Skv that its loads read (past Skv they read nothing).
__device__ __forceinline__ void count_rows(const Shape& s, int tile0,
                                           int tile_end, int bk) {
  const unsigned long long n =
      (unsigned long long)max(0, min(tile_end * bk, s.Skv) - tile0 * bk);
  atomicAdd(s.rows_read, n);
  atomicAdd(s.rows_read + 1, 1ull);
  atomicMax(s.rows_read + 2, n);
}

// The scale of key `key` of KV head kh in batch b as a float; 0 past Skv.
__device__ __forceinline__ float kv_scale(const __nv_bfloat16* sc, int b,
                                          int key, int kh, const Shape& s) {
  return key < s.Skv ? __bfloat162float(
                           sc[((long long)b * s.kv_rows + key) * s.K + kh])
                     : 0.f;
}

// ------------------------------------------------------------------ bf16

constexpr int kBQ = 128;          // query rows per block, 64 per consumer
constexpr int kBK = 128;          // keys per KV tile
constexpr int kStages = 2;        // K/V tiles in the ring
constexpr int kThreads = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int kBoxBytes = kBoxCols * 2 * kBK;   // one 128-row box, 16 KB
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1024-byte aligned base (the 128-byte swizzle's
// period): Q, then K and V of each stage, each tile HD/64 boxes; then the
// mbarriers q_full, k_full[kStages], v_full[kStages], empty[kStages].
// int8 (Q8): Q, one widened bf16 K and one V tile, the int8 K and V of
// each stage (kBK rows of HD bytes each), the K and V scales of each
// stage (kBK float32 each), then the mbarriers.
template <int HD>
__host__ __device__ constexpr int tile_bytes() { return HD * 2 * kBK; }
template <int HD>
__host__ __device__ constexpr int tile8_bytes() { return HD * kBK; }
template <int HD>
__host__ __device__ constexpr int scale_offset() {
  return tile_bytes<HD>() * 3 + 2 * kStages * tile8_bytes<HD>();
}
template <int HD, bool Q8>
__host__ __device__ constexpr int bar_offset() {
  return Q8 ? scale_offset<HD>() + 2 * kStages * kBK * 4
            : tile_bytes<HD>() * (1 + 2 * kStages);
}
template <int HD, bool Q8>
constexpr size_t wgmma_smem_bytes() {
  return bar_offset<HD, Q8>() + 8 * (1 + 3 * kStages) + 1024;  // + alignment
}

// Named barrier `id` (1 ..) over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// A staged int8 tile (kBK rows of HD bytes) widened to bf16 into the
// 128-byte swizzled box layout TMA writes for a bf16 tile, by the 256
// consumer threads (c = 0 .. 255): 16-byte chunk ch of row r of a box
// lands on chunk ch ^ (r % 8).  wgmma (the async proxy) reads the tile,
// hence the proxy fence, and so does the other warpgroup, hence the
// barrier.
template <int HD>
__device__ __forceinline__ void widen_tile(uint32_t src, uint32_t dst,
                                           int c) {
  constexpr int kChunks = HD / 8;              // 8 values per bf16 chunk
#pragma unroll
  for (int i = c; i < kBK * kChunks; i += 256) {
    const int r = i / kChunks, ch = i % kChunks;
    uint32_t w0, w1;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w0), "=r"(w1) : "r"(src + r * HD + ch * 8));
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t word = e < 2 ? w0 : w1;
      const int sh = 16 * (e & 1);
      o[e] = pack_bf16((float)(int8_t)(word >> sh),
                       (float)(int8_t)(word >> (sh + 8)));
    }
    const uint32_t at = dst + (ch / 8) * kBoxBytes + r * 128 +
                        (((ch % 8) ^ (r % 8)) * 16);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(at), "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3])
                 : "memory");
  }
  fence_proxy_async_shared();
  named_sync(1, 256);
}

// A 1-D grid over (query tile, batch, head), head fastest and the last
// query tile (under causal, the one with the most KV tiles) first; the
// heads of one tile share their KV heads in L2.  Thread 0 loads;
// warpgroups 1 and 2 own query rows 0-63 and 64-127 of the tile.  Their
// accumulator fragments: warp w, lane (g = lane / 4, t = lane % 4) holds
// rows 16w + g and 16w + g + 8, columns 8i + 2t and 8i + 2t + 1.
template <int HD, bool Q8>
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, uint16_t* __restrict__ o,
    float* __restrict__ lse, Shape s) {
  constexpr int kTile = tile_bytes<HD>();
  // bytes that land on a "full" barrier per tile: bf16 or int8 rows
  constexpr int kLoad = Q8 ? tile8_bytes<HD>() : kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + bar_offset<HD, Q8>();
  const uint32_t k_full = q_full + 8;                 // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;
  // Where stage st's K / V land (int8: the staging ring), and (int8) the
  // widened tiles and the scales.
  auto k_dst = [&](int st) -> uint32_t {
    return Q8 ? base + 3 * kTile + 2 * st * tile8_bytes<HD>()
              : base + kTile * (1 + 2 * st);
  };
  auto v_dst = [&](int st) -> uint32_t {
    return Q8 ? k_dst(st) + tile8_bytes<HD>() : k_dst(st) + kTile;
  };
  float* const scales = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + scale_offset<HD>());

  const int h = blockIdx.x % s.H, b = (blockIdx.x / s.H) % s.B;
  const int qt = (s.Sq + kBQ - 1) / kBQ - 1 - blockIdx.x / (s.H * s.B);
  const int q0 = qt * kBQ;
  const int j0 = first_tile(q0, s, kBK);
  const int n_tiles = end_tile(q0 + kBQ - 1, s, kBK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      // int8: the scales' arrival beside the TMA's
      mbar_init(k_full + 8 * st, Q8 ? 2 : 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load; under int8
    // every thread also writes one key's scales
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int kh = h / s.group;
    if (threadIdx.x == 0) {
      if (s.rows_read != nullptr) count_rows(s, j0, n_tiles, kBK);
      mbar_expect_tx(q_full, kTile);
#pragma unroll
      for (int c = 0; c < HD / kBoxCols; ++c)
        tma_load(base + c * kBoxBytes, &q_map, q_full, c * kBoxCols, h, q0,
                 b);
    }
    if (Q8 || threadIdx.x == 0) {
      for (int j = j0; j < n_tiles; ++j) {
        const int it = j - j0, st = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * st, (it / kStages - 1) & 1);
        if (Q8) {
          const int key = j * kBK + threadIdx.x;
          float* sc = scales + 2 * kBK * st;
          sc[threadIdx.x] = kv_scale(s.k_scale, b, key, kh, s);
          sc[kBK + threadIdx.x] = kv_scale(s.v_scale, b, key, kh, s);
          named_sync(2, 128);
        }
        if (threadIdx.x == 0) {
          if (Q8) mbar_arrive(k_full + 8 * st);
          mbar_expect_tx(k_full + 8 * st, kLoad);
          if (Q8) {
            tma_load(k_dst(st), &k_map, k_full + 8 * st, 0, kh, j * kBK, b);
          } else {
#pragma unroll
            for (int c = 0; c < HD / kBoxCols; ++c)
              tma_load(k_dst(st) + c * kBoxBytes, &k_map, k_full + 8 * st,
                       c * kBoxCols, kh, j * kBK, b);
          }
          mbar_expect_tx(v_full + 8 * st, kLoad);
          if (Q8) {
            tma_load(v_dst(st), &v_map, v_full + 8 * st, 0, kh, j * kBK, b);
          } else {
#pragma unroll
            for (int c = 0; c < HD / kBoxCols; ++c)
              tma_load(v_dst(st) + c * kBoxBytes, &v_map, v_full + 8 * st,
                       c * kBoxCols, kh, j * kBK, b);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_lo = q0 + 64 * wg;
    const int r0 = row_lo + 16 * warp + g, r1 = r0 + 8;
    const float sl = s.scale * kLog2e;
    // This warpgroup's 64 rows of Q: 64 rows x 128 B into each box.
    const uint32_t q_rows = base + wg * 64 * 128;
    // int8: the widened tiles
    const uint32_t k_wide = base + kTile, v_wide = base + 2 * kTile;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: lane's part

    mbar_wait(q_full, 0);
    for (int j = j0; j < n_tiles; ++j) {
      const int it = j - j0, st = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      const uint32_t ks = Q8 ? k_wide : k_dst(st);
      const uint32_t vs = Q8 ? v_wide : v_dst(st);
      const int k0 = j * kBK;

      // S = Q K^T over HD / 16 steps of 16 head dims (32 B of a 128-B row).
      float sc[64];
      mbar_wait(k_full + 8 * st, phase);
      if (Q8) widen_tile<HD>(k_dst(st), k_wide, threadIdx.x - 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, sw128_desc(q_rows + off, 16, 1024),
                      sw128_desc(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      fence_acc(sc);
      wgmma_wait_all();
      fence_acc(sc);

      // Fragment i holds keys k0 + 8i + 2t (+1) of rows r0 (e < 2), r1.
      const float* ksc = scales + 2 * kBK * st;
      if (Q8) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * i + e] *= ksc[8 * i + 2 * t + (e & 1)];
      }
      if (k0 + kBK > s.Skv || (s.causal && k0 + kBK - 1 > row_lo + s.q_off) ||
          (s.window > 0 && row_lo + 63 + s.q_off - k0 >= s.window)) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(k0 + 8 * i + 2 * t + (e & 1), e < 2 ? r0 : r1, s))
              sc[4 * i + e] = kNegInf;
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      // Raw (unscaled) maxima; scale > 0, so exp(scale * (x - m)) is
      // exp2(x * sl - m * sl), one FMA per score.  A row that has seen
      // only masked keys (its maximum still -1e30) gets probabilities 0:
      // its bias is -inf (the FMA's rounding at 1e30 would give a
      // probability of ex2 of +-1e21).
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = ex2((m0 - mn0) * sl), c1 = ex2((m1 - mn1) * sl);
      const float b0 = mn0 == kNegInf ? -INFINITY : -mn0 * sl;
      const float b1 = mn1 == kNegInf ? -INFINITY : -mn1 * sl;
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sc[4 * i] = ex2(fmaf(sc[4 * i], sl, b0));
        sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], sl, b0));
        sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], sl, b1));
        sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], sl, b1));
        ps0 += sc[4 * i] + sc[4 * i + 1];
        ps1 += sc[4 * i + 2] + sc[4 * i + 3];
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
      if (Q8) {     // V's scales into P's columns
        const float* vsc = ksc + kBK;
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * i + e] *= vsc[8 * i + 2 * t + (e & 1)];
      }
      // P in bf16: fragments 2kk and 2kk + 1 are the A fragment of keys
      // 16kk .. 16kk + 15 (rows g, g + 8; keys 2t.. and 2t + 8..).
      uint32_t pa[32];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[4 * kk] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[4 * i] *= c0;
        acc[4 * i + 1] *= c0;
        acc[4 * i + 2] *= c1;
        acc[4 * i + 3] *= c1;
      }

      // O += P V over 8 steps of 16 keys: V's rows are 16 keys x 128 B,
      // 2048 B per step; the next 64 head dims are the next box (LBO), the
      // next 8 keys the next 1024 B (SBO).
      mbar_wait(v_full + 8 * st, phase);
      if (Q8) widen_tile<HD>(v_dst(st), v_wide, threadIdx.x - 128);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs(acc, pa + 4 * kk, sw128_desc(vs + kk * 2048, kBoxBytes,
                                              1024));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait_all();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(kFull, l0, off);
      l1 += __shfl_xor_sync(kFull, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const long long row_stride = (long long)s.H * HD;
    uint16_t* ob = o + ((long long)b * s.Sq * s.H + h) * HD + 2 * t;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      if (r0 < s.Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + 8 * i) =
            pack_bf16(acc[4 * i] / d0, acc[4 * i + 1] / d0);
      if (r1 < s.Sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * row_stride + 8 * i) =
            pack_bf16(acc[4 * i + 2] / d1, acc[4 * i + 3] / d1);
    }
    // The row's log-sum-exp of the scaled scores, for the backward: m is
    // the raw maximum and l sums exp(scale * (x - m)).
    if (lse != nullptr && t == 0) {
      float* lb = lse + ((long long)b * s.H + h) * s.Sq;
      if (r0 < s.Sq) lb[r0] = m0 * s.scale + logf(d0);
      if (r1 < s.Sq) lb[r1] = m1 * s.scale + logf(d1);
    }
  }
}

// ------------------------------------------------------------------- f32

constexpr int kFmaBQ = 64;
constexpr int kFmaBK = 64;
constexpr int kFmaThreads = 256;   // 16 x 16

template <int HD>
constexpr size_t fma_smem_bytes() {
  // q * scale and K with a padded row (HD + 1), V, P with a padded row.
  return sizeof(float) * ((size_t)(kFmaBQ + kFmaBK) * (HD + 1) +
                          (size_t)kFmaBK * HD + (size_t)kFmaBQ * (kFmaBK + 1));
}

// KV: float, or int8_t (an int8 cache, dequantised by s.k_scale /
// s.v_scale as a tile is loaded).
template <int HD, typename KV>
__global__ void __launch_bounds__(kFmaThreads) flash_fma_kernel(
    const float* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, Shape s) {
  constexpr int LQ = HD + 1, LP = kFmaBK + 1, RQ = kFmaBQ / 16, C = HD / 16;
  constexpr bool kQ8 = sizeof(KV) == 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][LQ]
  float* ks = qs + kFmaBQ * LQ;      // [BK][LQ]
  float* vs = ks + kFmaBK * LQ;      // [BK][HD]
  float* ps = vs + kFmaBK * HD;      // [BQ][LP]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.z, h = blockIdx.y, kh = h / s.group;
  const int q0 = blockIdx.x * kFmaBQ;
  const long long q_stride = (long long)s.H * HD;
  const long long kv_stride = (long long)s.K * HD;
  const float* qb = q + (long long)b * s.Sq * q_stride + (long long)h * HD;
  const KV* kb = k + (long long)b * s.kv_rows * kv_stride + (long long)kh * HD;
  const KV* vb = v + (long long)b * s.kv_rows * kv_stride + (long long)kh * HD;
  float* ob = o + (long long)b * s.Sq * q_stride + (long long)h * HD;

  for (int i = threadIdx.x; i < kFmaBQ * HD; i += kFmaThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * LQ + d] = q0 + r < s.Sq ? qb[(q0 + r) * q_stride + d] * s.scale : 0.f;
  }
  // Rows ty + 16i, columns (keys or head dims) tx + 16j of each tile.
  float m[RQ], l[RQ], acc[RQ][C];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int t0 = first_tile(q0, s, kFmaBK);
  const int n_tiles = end_tile(q0 + kFmaBQ - 1, s, kFmaBK);
  if (s.rows_read != nullptr && threadIdx.x == 0)
    count_rows(s, t0, n_tiles, kFmaBK);
  for (int tile = t0; tile < n_tiles; ++tile) {
    const int k0 = tile * kFmaBK;
    for (int i = threadIdx.x; i < kFmaBK * HD; i += kFmaThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < s.Skv;
      float kx = in ? (float)kb[(k0 + r) * kv_stride + d] : 0.f;
      float vx = in ? (float)vb[(k0 + r) * kv_stride + d] : 0.f;
      if (kQ8) {
        kx *= kv_scale(s.k_scale, b, k0 + r, kh, s);
        vx *= kv_scale(s.v_scale, b, k0 + r, kh, s);
      }
      ks[r * LQ + d] = kx;
      vs[r * HD + d] = vx;
    }
    __syncthreads();

    float sc[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(ty + 16 * i) * LQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LQ + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(k0 + tx + 16 * j, row, s)) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a row that has seen only masked keys adds nothing
        const float p = mn == kNegInf ? 0.f : expf(sc[i][j] - mn);
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int key = 0; key < kFmaBK; ++key) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vs[key * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = ps[(ty + 16 * i) * LP + key];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) ob[row * q_stride + tx + 16 * c] = acc[i][c] / den;
    // m is the maximum of the scaled scores here (q was scaled on load)
    if (lse != nullptr && tx == 0)
      lse[((long long)b * s.H + h) * s.Sq + row] = m[i] + logf(den);
  }
}

template <int HD, typename KV>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, const Shape& s,
                       cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<HD, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.Sq + kFmaBQ - 1) / kFmaBQ, s.H, B);
  flash_fma_kernel<HD, KV><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<float*>(o), lse, s);
  return cudaGetLastError();
}

// Returns a cudaError_t, or minus the CUresult of a failed tensor-map
// encode.
template <int HD, bool Q8>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, const Shape& s, cudaStream_t stream) {
  const long long blocks = (long long)((s.Sq + kBQ - 1) / kBQ) * B * s.H;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm;
  CUresult res = encode_map(encode, &qm, q, B, s.Sq, s.Sq, s.H, HD, kBK);
  if (res == CUDA_SUCCESS)
    res = Q8 ? encode_map8(encode, &km, k, B, s.Skv, s.kv_rows, s.K, HD, kBK)
             : encode_map(encode, &km, k, B, s.Skv, s.kv_rows, s.K, HD, kBK);
  if (res == CUDA_SUCCESS)
    res = Q8 ? encode_map8(encode, &vm, v, B, s.Skv, s.kv_rows, s.K, HD, kBK)
             : encode_map(encode, &vm, v, B, s.Skv, s.kv_rows, s.K, HD, kBK);
  if (res != CUDA_SUCCESS) return -(int)res;
  constexpr size_t smem = wgmma_smem_bytes<HD, Q8>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_wgmma_kernel<HD, Q8><<<(unsigned)blocks, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<uint16_t*>(o), lse, s);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, kv_rows, K, hd), of which the first Skv
// rows of each batch are the keys; all contiguous, 16-byte aligned.  dtype
// 0 = float32, 1 = bfloat16 (q and o); hd 64 or 128.  k and v are of q's
// dtype, or int8 when k_scale and v_scale ((B, kv_rows, K, 1) bf16) are
// given.  Query row i sits at key position q_off + i; window > 0 hides
// keys `window` or more positions before it.  lse, when not null, is (B,
// H, Sq) float32 and takes each query row's log-sum-exp of its scaled
// scores, m + log(l), which the backward (flash_attention_bwd.cu) reads;
// the output's bits are the same either way.  rows_read, when not null,
// is 3 zeroed int64s that take the key rows below Skv that the launch's
// blocks load, summed, the blocks, and the most one block loads.  Returns
// 0, a cudaError_t, or minus the CUresult of a failed tensor-map encode.
extern "C" int attn_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    const void* k_scale, const void* v_scale,
                                    void* rows_read, int B, int H, int K,
                                    int Sq, int Skv, int kv_rows, int hd,
                                    int causal, int window, int q_off,
                                    int dtype, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || H < K || H % K != 0 || H > 65535 ||
      Sq < 0 || Skv < 1 || kv_rows < Skv || window < 0 || q_off < 0 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  const Shape s{B, Sq, Skv, H, K, H / K, kv_rows, causal ? 1 : 0, window,
                q_off, (float)(1.0 / sqrt((double)hd)),
                static_cast<const __nv_bfloat16*>(k_scale),
                static_cast<const __nv_bfloat16*>(v_scale),
                static_cast<unsigned long long*>(rows_read)};
  const bool q8 = k_scale != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  int err = (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16 && hd == 64)
    err = q8 ? launch_wgmma<64, true>(q, k, v, o, l, B, s, st)
             : launch_wgmma<64, false>(q, k, v, o, l, B, s, st);
  if (dtype == kDtypeBF16 && hd == 128)
    err = q8 ? launch_wgmma<128, true>(q, k, v, o, l, B, s, st)
             : launch_wgmma<128, false>(q, k, v, o, l, B, s, st);
  if (dtype == kDtypeF32 && hd == 64)
    err = (int)(q8 ? launch_fma<64, int8_t>(q, k, v, o, l, B, s, st)
                   : launch_fma<64, float>(q, k, v, o, l, B, s, st));
  if (dtype == kDtypeF32 && hd == 128)
    err = (int)(q8 ? launch_fma<128, int8_t>(q, k, v, o, l, B, s, st)
                   : launch_fma<128, float>(q, k, v, o, l, B, s, st));
  return err;
}
