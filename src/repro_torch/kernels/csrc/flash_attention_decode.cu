// flash_attention_decode: B5's body for one query row a head (Sq = 1) in
// bf16, the call a decode step makes once a layer.  flash_attention.cu's
// entry point keeps every other call (prefill, float32).
//
// Replaces, with flash_attention.cu, the TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_pallas at Sq = 1:
// the same online softmax, one query row per head over the visible keys.
//
// Bound on the card: bytes.  A call reads each visible K and V row of a
// KV head once (B * K * keys * hd * 2 * 2 bytes in bf16, half that in
// int8) and does 4 * B * H * hd * keys operations: at G = H / K query
// heads a KV head that is 2 * G operations a byte, far below the ~295 a
// byte where the tensor cores would bind.  Yi-9B's step (B = 4, K = 4, hd
// 128, 513 keys) reads 4.2 MB, 1.3 us at 3.35 TB/s.
//
// Design.  The prefill body (flash_attention.cu) runs one block per query
// head with a 128-row query tile: at Sq = 1 the tile holds one real row,
// each of a KV head's G query heads reads its K and V again, and B * H
// blocks walk the whole visible cache serially.  Here:
//  * A block owns one (batch, KV head, split): its rows are the G query
//    heads that read the KV head (16 at most; a larger G is cut into row
//    chunks of 16, each its own block), so K and V are read once for all
//    G.  The products are mma.sync m16n8k16 (bf16 in, float32 out) with
//    the G rows padded to 16: a 64-row wgmma would waste 52 of 64 rows at
//    G = 12, and CUDA-core dot products at G = 12, hd 128 need 12
//    operations a byte, ~40 TFLOP/s of float32 FMA at the card's byte
//    rate, most of its 67; the tensor cores take that off the path.
//  * The visible keys [lo, hi] are cut into tiles of kBK = 64 keys from
//    the tile that holds lo, and the tiles into `splits` contiguous spans
//    of `per_split` tiles (the last may be shorter), one block each.  The
//    caller chooses the split from the call's shape alone
//    (ops.py / ref.decode_split: B, H, K and the visible tiles, never the
//    device), so one call always gives the same bits.
//  * Loads: thread 0 keeps kStages tiles of K and V in flight with TMA
//    through the 4-D maps of hopper_common.cuh (bf16 128-byte swizzled,
//    64 head dims a box; int8 unswizzled), one "full" mbarrier a stage;
//    a __syncthreads at the end of each tile frees its stage.  An int8
//    tile is widened to bf16 (exact: |x| <= 127) into one swizzled K and V
//    tile in shared memory, the K scales multiply the float32 scores and
//    the V scales P's columns before P is rounded to bf16, as in the
//    prefill body's int8 path.
//  * Each of the 4 warps takes 16 keys of every tile: S = Q K^T is two
//    n8 tiles a warp (ldmatrix of K, Q's fragments in registers), the
//    online softmax runs on the fragments (scale * log2(e) in one FMA,
//    ex2), and P, packed to bf16, is the A fragment of O += P V (ldmatrix
//    .trans of V).  The 4 warps' (m, l, acc) are combined in warp order
//    through shared memory into the split's float32 partial (m, l,
//    acc[hd]) per query head, in the workspace the caller allocates.
//  * decode_combine_kernel, launched from the same entry point, reads a
//    query head's partials in split order 0 .. splits - 1 (a split that
//    saw no key has m = -1e30 and l = 0 and weighs 0) and writes the bf16
//    output and, when asked, lse = M * scale + log(L).  Every sum has a
//    fixed order, so two calls on the same inputs give the same bits.
// Masks as in flash_attention.cu: key p is visible to the query at
// position q_off iff p < Skv (kv_len), p <= q_off under causal, and
// q_off - p < window under a window; rows at or past Skv are never read.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;             // keys per tile
constexpr int kRows = 16;           // query rows per block: an mma's M
constexpr int kWarps = 4;           // each takes 16 keys of a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;          // tiles in flight
constexpr int kBox = 128 * kBK;     // one 64-column bf16 box of a tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Decode {
  int B, H, K, group;     // group = H / K query heads a KV head
  int Skv;                // visible keys end: rows at or past it unread
  int kv_rows;            // rows of K / V per batch (>= Skv)
  int lo, hi;             // the query's visible keys [lo, hi]
  int tile0, tile_end;    // their tiles [tile0, tile_end)
  int splits, per_split;  // spans of per_split tiles from tile0
  int chunks;             // row chunks of kRows a KV head
  float scale;            // 1 / sqrt(hd)
  const __nv_bfloat16* k_scale;   // int8 K / V: (B, kv_rows, K, 1)
  const __nv_bfloat16* v_scale;
  // when not null, {key rows loaded summed over blocks, blocks, the most
  // one block loads}
  unsigned long long* rows_read;
};

// Shared memory from a 1024-byte aligned base.  bf16: K and V of each
// stage.  int8: one widened bf16 K and V tile, the int8 K and V of each
// stage, then the tile's K and V scales (kBK float32 each).  Then the
// stages' mbarriers.  After the loop the first bytes hold the warps'
// (m, l, acc) for the block's combine.
template <int HD>
__host__ __device__ constexpr int tile_bytes() { return kBK * HD * 2; }
template <int HD, bool Q8>
__host__ __device__ constexpr int ring_bytes() {
  return Q8 ? 2 * tile_bytes<HD>() + kStages * 2 * kBK * HD
            : kStages * 2 * tile_bytes<HD>();
}
template <int HD, bool Q8>
__host__ __device__ constexpr int bar_offset() {
  return ring_bytes<HD, Q8>() + (Q8 ? 2 * kBK * 4 : 0);
}
template <int HD, bool Q8>
__host__ __device__ constexpr size_t decode_smem_bytes() {
  return bar_offset<HD, Q8>() + 8 * kStages + 1024;   // + alignment
}
template <int HD>
__host__ __device__ constexpr int combine_bytes() {
  return kWarps * kRows * (HD + 2) * 4;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16 row) b (16 x 8, bf16 col).  Lane
// (g = lane / 4, t = lane % 4): a = rows g / g + 8, columns 2t.. / 2t + 8..;
// b = rows 2t.. / 2t + 8.., column g; d = rows g (d[0], d[1]) and g + 8,
// columns 2t, 2t + 1.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shared address of 8 head dims from `d0` (a multiple of 8) of key
// row r of a swizzled bf16 tile: box d0 / 64, 16-byte chunk (d0 % 64) / 8
// at chunk ^ (r % 8).
__device__ __forceinline__ uint32_t tile_at(uint32_t tile, int r, int d0) {
  return tile + (d0 / 64) * kBox + r * 128 + ((((d0 % 64) / 8) ^ (r % 8)) *
                                              16);
}

// A staged int8 tile (kBK rows of HD bytes) widened to bf16 into the
// swizzled layout TMA writes for a bf16 tile, by the block's threads.
template <int HD>
__device__ __forceinline__ void widen(uint32_t src, uint32_t dst, int c) {
  constexpr int kChunks = HD / 8;              // 8 values a 16-byte chunk
#pragma unroll 4
  for (int i = c; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    uint32_t w[2];
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w[0]), "=r"(w[1]) : "r"(src + r * HD + ch * 8));
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sh = 16 * (e & 1);
      o[e] = pack_bf16((float)(int8_t)(w[e / 2] >> sh),
                       (float)(int8_t)(w[e / 2] >> (sh + 8)));
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(tile_at(dst, r, ch * 8)), "r"(o[0]), "r"(o[1]),
                    "r"(o[2]), "r"(o[3])
                 : "memory");
  }
}

__device__ __forceinline__ float kv_scale(const __nv_bfloat16* sc, int b,
                                          int key, int kh, const Decode& s) {
  return key < s.Skv ? __bfloat162float(
                           sc[((long long)b * s.kv_rows + key) * s.K + kh])
                     : 0.f;
}

// A 1-D grid over (batch, KV head, row chunk, split), split fastest.
// part: the workspace, (B * H * splits) x HD partial accumulators, then
// (B * H * splits) x (m, l).
template <int HD, bool Q8>
__global__ void __launch_bounds__(kThreads, 2) flash_decode_kernel(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const uint16_t* __restrict__ q, float* __restrict__ part, Decode s) {
  constexpr int kT = tile_bytes<HD>();
  constexpr int kLoad = Q8 ? kBK * HD : kT;    // one tensor's tile a stage
  static_assert(combine_bytes<HD>() <= ring_bytes<HD, Q8>(),
                "the combine's scratch must fit the ring");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + bar_offset<HD, Q8>();
  float* const scales =
      reinterpret_cast<float*>(base_ptr + ring_bytes<HD, Q8>());
  auto k_dst = [&](int st) -> uint32_t {
    return Q8 ? base + 2 * kT + st * 2 * kLoad : base + st * 2 * kT;
  };
  auto v_dst = [&](int st) -> uint32_t { return k_dst(st) + kLoad; };

  int idx = blockIdx.x;
  const int sp = idx % s.splits;
  idx /= s.splits;
  const int rc = idx % s.chunks;
  idx /= s.chunks;
  const int kh = idx % s.K, b = idx / s.K;
  const int t_begin = s.tile0 + sp * s.per_split;
  const int n = min(s.per_split, s.tile_end - t_begin);   // >= 1
  const int tid = threadIdx.x;

  auto issue = [&](int it) {
    const int st = it % kStages, j = t_begin + it;
    const uint32_t bar = full + 8 * st;
    mbar_expect_tx(bar, 2 * kLoad);
    if (Q8) {
      tma_load(k_dst(st), &k_map, bar, 0, kh, j * kBK, b);
      tma_load(v_dst(st), &v_map, bar, 0, kh, j * kBK, b);
    } else {
#pragma unroll
      for (int c = 0; c < HD / kBoxCols; ++c) {
        tma_load(k_dst(st) + c * kBox, &k_map, bar, c * kBoxCols, kh,
                 j * kBK, b);
        tma_load(v_dst(st) + c * kBox, &v_map, bar, c * kBoxCols, kh,
                 j * kBK, b);
      }
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (s.rows_read != nullptr) {
      const unsigned long long rows = (unsigned long long)max(
          0, min((t_begin + n) * kBK, s.Skv) - t_begin * kBK);
      atomicAdd(s.rows_read, rows);
      atomicAdd(s.rows_read + 1, 1ull);
      atomicMax(s.rows_read + 2, rows);
    }
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < min(n, kStages); ++it) issue(it);

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = rc * kRows + g, row1 = row0 + 8;   // rows in the group
  const int h0 = b * s.H + (kh * s.group);            // first (b, h) row
  // Q's A fragments (rows past the group are zeros), 16 head dims a step.
  uint32_t qa[HD / 16][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + (long long)(h0 + row0) * HD);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
        q + (long long)(h0 + row1) * HD);
    const bool in0 = row0 < s.group, in1 = row1 < s.group;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = in0 ? q0[8 * kk + t] : 0u;
      qa[kk][1] = in1 ? q1[8 * kk + t] : 0u;
      qa[kk][2] = in0 ? q0[8 * kk + 4 + t] : 0u;
      qa[kk][3] = in1 ? q1[8 * kk + 4 + t] : 0u;
    }
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: lane's part
  const float sl = s.scale * kLog2e;
  const int key0 = 16 * warp;               // this warp's keys of a tile
  // ldmatrix row addresses: lane / 8 picks the 8 x 8 matrix
  const int mi = lane / 8, mr = lane % 8;

  for (int it = 0; it < n; ++it) {
    const int st = it % kStages, j = t_begin + it;
    mbar_wait(full + 8 * st, (it / kStages) & 1);
    uint32_t kt = k_dst(st), vt = v_dst(st);
    if (Q8) {
      widen<HD>(k_dst(st), base, tid);
      widen<HD>(v_dst(st), base + kT, tid);
      if (tid < kBK) {
        scales[tid] = kv_scale(s.k_scale, b, j * kBK + tid, kh, s);
        scales[kBK + tid] = kv_scale(s.v_scale, b, j * kBK + tid, kh, s);
      }
      __syncthreads();
      kt = base;
      vt = base + kT;
    }

    // S = Q K^T: n8 tiles 0 and 1 hold keys key0 .. key0 + 7 and + 8 ..
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kb[4];
      ldsm_x4(tile_at(kt, key0 + (mi / 2) * 8 + mr, 16 * kk + (mi % 2) * 8),
              kb);
      mma16816(sc[0], qa[kk], kb[0], kb[1]);
      mma16816(sc[1], qa[kk], kb[2], kb[3]);
    }
    // Fragment e of n8 tile nt: key key0 + 8 nt + 2t + (e & 1), row g
    // (e < 2) or g + 8.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kx = key0 + 8 * nt + 2 * t + (e & 1);
        const int key = j * kBK + kx;
        if (Q8) sc[nt][e] *= scales[kx];
        if (key < s.lo || key > s.hi) sc[nt][e] = kNegInf;
      }
    float mx0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
    float mx1 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    // Raw maxima; exp(scale * (x - m)) = exp2(x * sl - m * sl).  A row
    // that has seen only masked keys gets probabilities 0 (bias -inf).
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = ex2((m0 - mn0) * sl), c1 = ex2((m1 - mn1) * sl);
    const float b0 = mn0 == kNegInf ? -INFINITY : -mn0 * sl;
    const float b1 = mn1 == kNegInf ? -INFINITY : -mn1 * sl;
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      sc[nt][0] = ex2(fmaf(sc[nt][0], sl, b0));
      sc[nt][1] = ex2(fmaf(sc[nt][1], sl, b0));
      sc[nt][2] = ex2(fmaf(sc[nt][2], sl, b1));
      sc[nt][3] = ex2(fmaf(sc[nt][3], sl, b1));
      ps0 += sc[nt][0] + sc[nt][1];
      ps1 += sc[nt][2] + sc[nt][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c0;
      acc[i][2] *= c1;
      acc[i][3] *= c1;
    }
    if (Q8) {     // V's scales into P's columns
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] *= scales[kBK + key0 + 8 * nt + 2 * t + (e & 1)];
    }
    // P in bf16 is the A fragment of the warp's 16 keys.
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
    // O += P V, two n8 tiles of head dims a step (ldmatrix.trans of V:
    // matrices keys +0 / +8, head dims +0 / +8).
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      uint32_t vb[4];
      ldsm_x4_t(tile_at(vt, key0 + (mi % 2) * 8 + mr, 16 * jj + (mi / 2) * 8),
                vb);
      mma16816(acc[2 * jj], pa, vb[0], vb[1]);
      mma16816(acc[2 * jj + 1], pa, vb[2], vb[3]);
    }
    __syncthreads();            // every warp is done with the stage
    if (tid == 0 && it + kStages < n) issue(it + kStages);
  }

  // The block's combine: the warps' (m, l, acc) in warp order.  No load
  // is in flight (every issued tile was waited on), so the ring is free.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  float* const wm = reinterpret_cast<float*>(base_ptr);   // [warp][row]
  float* const wl = wm + kWarps * kRows;
  float* const wacc = wl + kWarps * kRows;                // [warp][row][HD]
  if (t == 0) {
    wm[warp * kRows + g] = m0;
    wm[warp * kRows + g + 8] = m1;
    wl[warp * kRows + g] = l0;
    wl[warp * kRows + g + 8] = l1;
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    float* r0 = wacc + (warp * kRows + g) * HD + 8 * i + 2 * t;
    r0[0] = acc[i][0];
    r0[1] = acc[i][1];
    r0[8 * HD] = acc[i][2];
    r0[8 * HD + 1] = acc[i][3];
  }
  __syncthreads();
  const int rows = min(kRows, s.group - rc * kRows);
  const long long n_parts = (long long)s.B * s.H * s.splits;
  for (int x = tid; x < rows * HD; x += kThreads) {
    const int r = x / HD, d = x % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * kRows + r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * kRows + r];
      const float e = mw == kNegInf ? 0.f : ex2((mw - mm) * sl);
      ll += wl[w * kRows + r] * e;
      aa += wacc[(w * kRows + r) * HD + d] * e;
    }
    const long long p = (long long)(h0 + rc * kRows + r) * s.splits + sp;
    part[p * HD + d] = aa;
    if (d == 0) {
      part[n_parts * HD + 2 * p] = mm;
      part[n_parts * HD + 2 * p + 1] = ll;
    }
  }
}

// One block per (batch, query head), one thread per head dim: the
// splits' partials in split order, the bf16 output and lse.
template <int HD>
__global__ void __launch_bounds__(HD) decode_combine_kernel(
    const float* __restrict__ part, uint16_t* __restrict__ o,
    float* __restrict__ lse, Decode s) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const long long n_parts = (long long)s.B * s.H * s.splits;
  const float* ml = part + n_parts * HD + (long long)bh * s.splits * 2;
  const float* acc = part + (long long)bh * s.splits * HD + d;
  const float sl = s.scale * kLog2e;
  float mm = kNegInf;
  for (int sp = 0; sp < s.splits; ++sp) mm = fmaxf(mm, ml[2 * sp]);
  float ll = 0.f, aa = 0.f;
  for (int sp = 0; sp < s.splits; ++sp) {
    const float mw = ml[2 * sp];
    const float e = mw == kNegInf ? 0.f : ex2((mw - mm) * sl);
    ll += ml[2 * sp + 1] * e;
    aa += acc[(long long)sp * HD] * e;
  }
  const float den = fmaxf(ll, 1e-30f);
  const __nv_bfloat16 y = __float2bfloat16(aa / den);
  o[(long long)bh * HD + d] = *reinterpret_cast<const uint16_t*>(&y);
  // m is the raw maximum and l sums exp(scale * (x - m))
  if (lse != nullptr && d == 0) lse[bh] = mm * s.scale + logf(den);
}

// Returns a cudaError_t, or minus the CUresult of a failed tensor-map
// encode.
template <int HD, bool Q8>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  float* lse, float* work, const Decode& s,
                  cudaStream_t stream) {
  const long long blocks = (long long)s.B * s.K * s.chunks * s.splits;
  if (blocks > 0x7fffffff || (long long)s.B * s.H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap km, vm;
  CUresult res = Q8 ? encode_map8(encode, &km, k, s.B, s.Skv, s.kv_rows, s.K,
                                  HD, kBK)
                    : encode_map(encode, &km, k, s.B, s.Skv, s.kv_rows, s.K,
                                 HD, kBK);
  if (res == CUDA_SUCCESS)
    res = Q8 ? encode_map8(encode, &vm, v, s.B, s.Skv, s.kv_rows, s.K, HD,
                           kBK)
             : encode_map(encode, &vm, v, s.B, s.Skv, s.kv_rows, s.K, HD,
                          kBK);
  if (res != CUDA_SUCCESS) return -(int)res;
  constexpr size_t smem = decode_smem_bytes<HD, Q8>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<HD, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_kernel<HD, Q8><<<(unsigned)blocks, kThreads, smem, stream>>>(
      km, vm, static_cast<const uint16_t*>(q), work, s);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  decode_combine_kernel<HD><<<(unsigned)(s.B * s.H), HD, 0, stream>>>(
      work, static_cast<uint16_t*>(o), lse, s);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, 1, H, hd) bf16; k, v: (B, kv_rows, K, hd) bf16, or int8 with
// k_scale / v_scale ((B, kv_rows, K, 1) bf16); all contiguous, 16-byte
// aligned; hd 64 or 128.  The query sits at key position q_off; keys at or
// past Skv are masked, keys after q_off under causal, keys `window` or
// more positions before it when window > 0.  The visible keys' tiles of
// 64 keys are cut into `splits` spans of `per_split` tiles, which must
// cover them with no empty span.  work: (B * H * splits) x (hd + 2)
// float32 of scratch.  lse, when not null, is (B, H) float32; rows_read as
// in attn_flash_attention.  Returns 0, a cudaError_t, or minus the
// CUresult of a failed tensor-map encode.
extern "C" int attn_flash_decode(const void* q, const void* k, const void* v,
                                 void* o, void* lse, const void* k_scale,
                                 const void* v_scale, void* rows_read,
                                 void* work, int B, int H, int K, int Skv,
                                 int kv_rows, int hd, int causal, int window,
                                 int q_off, int splits, int per_split,
                                 void* stream) {
  if (B < 1 || K < 1 || H < K || H % K != 0 || Skv < 1 || kv_rows < Skv ||
      window < 0 || q_off < 0 || splits < 1 || per_split < 1 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int hi = causal && q_off < Skv - 1 ? q_off : Skv - 1;
  const int lo = window > 0 && q_off - window + 1 > 0 ? q_off - window + 1
                                                      : 0;
  if (lo > hi) return (int)cudaErrorInvalidValue;
  const int tile0 = lo / kBK, tile_end = hi / kBK + 1;
  const long long n_tiles = tile_end - tile0;
  if ((long long)(splits - 1) * per_split >= n_tiles ||
      (long long)splits * per_split < n_tiles)
    return (int)cudaErrorInvalidValue;
  const int group = H / K;
  const Decode s{B, H, K, group, Skv, kv_rows, lo, hi, tile0, tile_end,
                 splits, per_split, (group + kRows - 1) / kRows,
                 (float)(1.0 / sqrt((double)hd)),
                 static_cast<const __nv_bfloat16*>(k_scale),
                 static_cast<const __nv_bfloat16*>(v_scale),
                 static_cast<unsigned long long*>(rows_read)};
  const bool q8 = k_scale != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  float* w = static_cast<float*>(work);
  if (hd == 64)
    return q8 ? launch_decode<64, true>(q, k, v, o, l, w, s, st)
              : launch_decode<64, false>(q, k, v, o, l, w, s, st);
  if (hd == 128)
    return q8 ? launch_decode<128, true>(q, k, v, o, l, w, s, st)
              : launch_decode<128, false>(q, k, v, o, l, w, s, st);
  return (int)cudaErrorInvalidValue;
}
