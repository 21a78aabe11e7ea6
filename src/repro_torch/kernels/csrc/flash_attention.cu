// flash_attention: GQA attention with an online softmax, causal or not.
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
// Decode (one query over a cache) is bound by bytes: B * Skv * K * hd * 2 * 2
// of K and V, ~4.4 MB at B=4, Skv=540, K=4, hd=128, 1.3 us at 3.35 TB/s; the
// 128-row query tile holds one real row, so the call is bound by its launch
// and its serial KV loop, not by the bound.
//
// Semantics: one block per (query tile, head, batch); a loop over KV tiles
// takes the place of the TPU's sequential grid dimension.  Under causal it
// stops at the last tile that meets the diagonal; the diagonal and the
// ragged tail k_pos >= Skv are masked in the kernel, so the wrapper pads
// nothing.  q, k, v and the output are read and written in place in the
// models' (B, S, heads, hd) layout; query head h reads KV head h / (H / K).
// K and V may hold more rows than the Skv keys that are visible (a decode
// step reads the first L + 1 rows of a (B, S_max, K, hd) cache): batch b
// starts at row b * kv_rows, and no row at or past Skv is read.
// Masked logits are -1e30, m / l / acc stay float32, the output is
// acc / max(l, 1e-30), as in the TPU kernel and its oracle.  Given an lse
// buffer, a call also writes each query row's m + log(l) (in units of the
// scaled scores), the statistics the TPU kernel's pallas_call returns
// beside acc; the backward (flash_attention_bwd.cu) rebuilds P from it.
//  * bf16: a Hopper kernel (sm_90a).  A block owns 128 query rows of one
//    (head, batch) and walks KV tiles of 128 keys.  A producer warp issues
//    TMA loads, Q once and then K and V into a two-stage shared-memory
//    ring; "full" and "empty" mbarriers pace it against two consumer
//    warpgroups of 64 query rows each, which setmaxnreg gives the
//    producer's registers.  S = Q K^T is wgmma m64n128k16 with both
//    operands K-major in shared memory.  The f32 scores are masked (only
//    on diagonal and ragged tiles), go through exp2 with scale * log2(e)
//    folded into one FMA, and are packed to bf16 in registers, where they
//    already are wgmma's A fragment: O += P V takes A from registers and V
//    from shared memory as an MN-major operand (the transpose bit).  TMA's
//    128-byte swizzle is the layout the wgmma descriptors read, so a
//    128-wide head loads as two 64-column boxes.  The 4-D tensor maps
//    (hd, heads, S, B) zero-fill rows past Sq or Skv and never read into
//    the next batch: K and V's maps have Skv rows and the buffer's batch
//    stride, so the rows of a cache past Skv are never loaded.  Blocks
//    start with the query tiles that have the most KV tiles, which
//    shortens the causal tail.
//  * f32: FMA on the CUDA cores (the tensor cores' TF32 would miss the
//    oracle's float32 by more than 1e-5).  A 16 x 16 thread grid owns a
//    64 x 64 score tile, 4 x 4 each; P goes through shared memory.
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
  float scale;               // 1 / sqrt(hd)
};

__device__ __forceinline__ bool visible(int key, int row, const Shape& s) {
  return key < s.Skv && (!s.causal || key <= row);
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
template <int HD>
__host__ __device__ constexpr int tile_bytes() { return HD * 2 * kBK; }
template <int HD>
__host__ __device__ constexpr int bar_offset() {
  return tile_bytes<HD>() * (1 + 2 * kStages);
}
template <int HD>
constexpr size_t wgmma_smem_bytes() {
  return bar_offset<HD>() + 8 * (1 + 3 * kStages) + 1024;  // + alignment
}

// A 1-D grid over (query tile, batch, head), head fastest and the last
// query tile (under causal, the one with the most KV tiles) first; the
// heads of one tile share their KV heads in L2.  Thread 0 loads;
// warpgroups 1 and 2 own query rows 0-63 and 64-127 of the tile.  Their
// accumulator fragments: warp w, lane (g = lane / 4, t = lane % 4) holds
// rows 16w + g and 16w + g + 8, columns 8i + 2t and 8i + 2t + 1.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, uint16_t* __restrict__ o,
    float* __restrict__ lse, Shape s) {
  constexpr int kTile = tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + bar_offset<HD>();
  const uint32_t k_full = q_full + 8;                 // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int h = blockIdx.x % s.H, b = (blockIdx.x / s.H) % s.B;
  const int qt = (s.Sq + kBQ - 1) / kBQ - 1 - blockIdx.x / (s.H * s.B);
  const int q0 = qt * kBQ;
  int n_tiles = (s.Skv + kBK - 1) / kBK;
  if (s.causal) n_tiles = min(n_tiles, qt + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int kh = h / s.group;
      mbar_expect_tx(q_full, kTile);
#pragma unroll
      for (int c = 0; c < HD / kBoxCols; ++c)
        tma_load(base + c * kBoxBytes, &q_map, q_full, c * kBoxCols, h, q0,
                 b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * st, (j / kStages - 1) & 1);
        const uint32_t ks = base + kTile * (1 + 2 * st), vs = ks + kTile;
        mbar_expect_tx(k_full + 8 * st, kTile);
#pragma unroll
        for (int c = 0; c < HD / kBoxCols; ++c)
          tma_load(ks + c * kBoxBytes, &k_map, k_full + 8 * st,
                   c * kBoxCols, kh, j * kBK, b);
        mbar_expect_tx(v_full + 8 * st, kTile);
#pragma unroll
        for (int c = 0; c < HD / kBoxCols; ++c)
          tma_load(vs + c * kBoxBytes, &v_map, v_full + 8 * st,
                   c * kBoxCols, kh, j * kBK, b);
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

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: lane's part

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t phase = (j / kStages) & 1;
      const uint32_t ks = base + kTile * (1 + 2 * st), vs = ks + kTile;
      const int k0 = j * kBK;

      // S = Q K^T over HD / 16 steps of 16 head dims (32 B of a 128-B row).
      float sc[64];
      mbar_wait(k_full + 8 * st, phase);
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
      if (k0 + kBK > s.Skv || (s.causal && k0 + kBK - 1 > row_lo)) {
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
      // exp2(x * sl - m * sl), one FMA per score.
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = ex2((m0 - mn0) * sl), c1 = ex2((m1 - mn1) * sl);
      const float b0 = -mn0 * sl, b1 = -mn1 * sl;
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

template <int HD>
__global__ void __launch_bounds__(kFmaThreads) flash_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, Shape s) {
  constexpr int LQ = HD + 1, LP = kFmaBK + 1, RQ = kFmaBQ / 16, C = HD / 16;
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
  const float* kb = k + (long long)b * s.kv_rows * kv_stride + (long long)kh * HD;
  const float* vb = v + (long long)b * s.kv_rows * kv_stride + (long long)kh * HD;
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

  int n_tiles = (s.Skv + kFmaBK - 1) / kFmaBK;
  if (s.causal) n_tiles = min(n_tiles, (q0 + kFmaBQ - 1) / kFmaBK + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kFmaBK;
    for (int i = threadIdx.x; i < kFmaBK * HD; i += kFmaThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < s.Skv;
      ks[r * LQ + d] = in ? kb[(k0 + r) * kv_stride + d] : 0.f;
      vs[r * HD + d] = in ? vb[(k0 + r) * kv_stride + d] : 0.f;
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
        const float p = expf(sc[i][j] - mn);
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

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, const Shape& s,
                       cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.Sq + kFmaBQ - 1) / kFmaBQ, s.H, B);
  flash_fma_kernel<HD><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, s);
  return cudaGetLastError();
}

// Returns a cudaError_t, or minus the CUresult of a failed tensor-map
// encode.
template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, const Shape& s, cudaStream_t stream) {
  const long long blocks = (long long)((s.Sq + kBQ - 1) / kBQ) * B * s.H;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm;
  CUresult res = encode_map(encode, &qm, q, B, s.Sq, s.Sq, s.H, HD, kBK);
  if (res == CUDA_SUCCESS)
    res = encode_map(encode, &km, k, B, s.Skv, s.kv_rows, s.K, HD, kBK);
  if (res == CUDA_SUCCESS)
    res = encode_map(encode, &vm, v, B, s.Skv, s.kv_rows, s.K, HD, kBK);
  if (res != CUDA_SUCCESS) return -(int)res;
  constexpr size_t smem = wgmma_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_wgmma_kernel<HD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<uint16_t*>(o), lse, s);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, kv_rows, K, hd), of which the first Skv
// rows of each batch are the keys; all contiguous, 16-byte aligned.  dtype
// 0 = float32, 1 = bfloat16; hd 64 or 128.  lse, when not null, is (B, H,
// Sq) float32 and takes each query row's log-sum-exp of its scaled
// scores, m + log(l), which the backward (flash_attention_bwd.cu) reads;
// the output's bits are the same either way.  Returns 0, a cudaError_t,
// or minus the CUresult of a failed tensor-map encode.
extern "C" int attn_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    int B, int H, int K, int Sq, int Skv,
                                    int kv_rows, int hd, int causal,
                                    int dtype, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || H < K || H % K != 0 || H > 65535 ||
      Sq < 0 || Skv < 1 || kv_rows < Skv)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  const Shape s{B, Sq, Skv, H, K, H / K, kv_rows, causal ? 1 : 0,
                (float)(1.0 / sqrt((double)hd))};
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  int err = (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16 && hd == 64) err = launch_wgmma<64>(q, k, v, o, l, B, s, st);
  if (dtype == kDtypeBF16 && hd == 128) err = launch_wgmma<128>(q, k, v, o, l, B, s, st);
  if (dtype == kDtypeF32 && hd == 64) err = (int)launch_fma<64>(q, k, v, o, l, B, s, st);
  if (dtype == kDtypeF32 && hd == 128) err = (int)launch_fma<128>(q, k, v, o, l, B, s, st);
  return err;
}
