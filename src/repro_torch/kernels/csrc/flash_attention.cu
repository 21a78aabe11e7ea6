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
// Design: one block per (query tile, head, batch); a loop over KV tiles
// takes the place of the TPU's sequential grid dimension.  Under causal it
// stops at the last tile that meets the diagonal; every tile masks the
// diagonal and the ragged tail k_pos >= Skv itself, so the wrapper pads
// nothing.  q, k, v and the output are read and written in place in the
// models' (B, S, heads, hd) layout; query head h reads KV head h / (H / K).
// Masked logits are -1e30, m / l / acc stay float32, the output is
// acc / max(l, 1e-30), as in the TPU kernel and its oracle.
//  * bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate).  Four warps own 16
//    query rows each; q stays in registers as A fragments for the whole
//    loop, K and V tiles are staged in shared memory, the scores' C
//    fragments are rescaled in f32 and repacked in registers as the A
//    fragments of P.V.  Loads are not pipelined (no cp.async / TMA /
//    wgmma): the simple form first.
//  * f32: FMA on the CUDA cores (the tensor cores' TF32 would miss the
//    oracle's float32 by more than 1e-5).  A 16 x 16 thread grid owns a
//    64 x 64 score tile, 4 x 4 each; P goes through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int Sq, Skv, H, K, group;  // group = H / K
  int causal;
  float scale;               // 1 / sqrt(hd)
};

__device__ __forceinline__ bool visible(int key, int row, const Shape& s) {
  return key < s.Skv && (!s.causal || key <= row);
}

// ------------------------------------------------------------------ bf16

constexpr int kMmaBQ = 64;       // 4 warps x 16 query rows
constexpr int kMmaBK = 64;
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16x2, `lo` in the low half (the lower k or column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, uint16_t* __restrict__ o, Shape s) {
  constexpr int LD = HD + 8;   // staged row stride (bf16): 16 B of padding
  constexpr int VEC = HD / 8;  // 16-byte vectors per row
  __shared__ __align__(16) uint16_t ks[kMmaBK * LD];
  __shared__ __align__(16) uint16_t vs[kMmaBK * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, pair index
  const int b = blockIdx.z, h = blockIdx.y, kh = h / s.group;
  const int q0 = blockIdx.x * kMmaBQ;
  const long long q_stride = (long long)s.H * HD;   // one position
  const long long kv_stride = (long long)s.K * HD;
  const uint16_t* qb = q + (long long)b * s.Sq * q_stride + (long long)h * HD;
  const uint16_t* kb = k + (long long)b * s.Skv * kv_stride + (long long)kh * HD;
  const uint16_t* vb = v + (long long)b * s.Skv * kv_stride + (long long)kh * HD;
  uint16_t* ob = o + (long long)b * s.Sq * q_stride + (long long)h * HD;

  // This thread's two query rows; their q as A fragments, zero past Sq.
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    qf[kk][0] = qf[kk][2] = qf[kk][1] = qf[kk][3] = 0u;
    if (r0 < s.Sq) {
      const uint16_t* p = qb + r0 * q_stride + c;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
    if (r1 < s.Sq) {
      const uint16_t* p = qb + r1 * q_stride + c;
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(p);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's part

  int n_tiles = (s.Skv + kMmaBK - 1) / kMmaBK;
  if (s.causal) n_tiles = min(n_tiles, (q0 + kMmaBQ - 1) / kMmaBK + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kMmaBK;
    for (int i = threadIdx.x; i < kMmaBK * VEC; i += kMmaThreads) {
      const int r = i / VEC, c = (i % VEC) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + r < s.Skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kv_stride + c);
        vx = *reinterpret_cast<const uint4*>(vb + (k0 + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kx;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vx;
    }
    __syncthreads();

    // S = q K^T: C fragment n holds keys k0 + 8n + 2t (+1) of rows r0, r1.
    float sc[kMmaBK / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint16_t* kr = ks + (8 * n + g) * LD + 16 * kk + 2 * t;
        mma_bf16(sc[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const float x = visible(key, e < 2 ? r0 : r1, s) ? sc[n][e] * s.scale
                                                         : kNegInf;
        sc[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - (e < 2 ? mn0 : mn1));
        sc[n][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // acc += P V: the C fragments of keys 16kk..16kk+15 are P's A fragment.
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const uint16_t* vc = vs + (16 * kk + 2 * t) * LD + 8 * n + g;
        const uint32_t b0 = (uint32_t)vc[0] | ((uint32_t)vc[LD] << 16);
        const uint32_t b1 = (uint32_t)vc[8 * LD] | ((uint32_t)vc[9 * LD] << 16);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < s.Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < s.Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
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
    const float* __restrict__ v, float* __restrict__ o, Shape s) {
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
  const float* kb = k + (long long)b * s.Skv * kv_stride + (long long)kh * HD;
  const float* vb = v + (long long)b * s.Skv * kv_stride + (long long)kh * HD;
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
  }
}

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int B, const Shape& s, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.Sq + kFmaBQ - 1) / kFmaBQ, s.H, B);
  flash_fma_kernel<HD><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, const Shape& s, cudaStream_t stream) {
  const dim3 grid((s.Sq + kMmaBQ - 1) / kMmaBQ, s.H, B);
  flash_mma_kernel<HD><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), s);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Skv, K, hd); all contiguous, 16-byte
// aligned.  dtype 0 = float32, 1 = bfloat16; hd 64 or 128.
extern "C" int attn_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int K, int Sq, int Skv, int hd,
                                    int causal, int dtype, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || H < K || H % K != 0 || H > 65535 ||
      Sq < 0 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  const Shape s{Sq, Skv, H, K, H / K, causal ? 1 : 0,
                (float)(1.0 / sqrt((double)hd))};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeBF16 && hd == 64) err = launch_mma<64>(q, k, v, o, B, s, st);
  if (dtype == kDtypeBF16 && hd == 128) err = launch_mma<128>(q, k, v, o, B, s, st);
  if (dtype == kDtypeF32 && hd == 64) err = launch_fma<64>(q, k, v, o, B, s, st);
  if (dtype == kDtypeF32 && hd == 128) err = launch_fma<128>(q, k, v, o, B, s, st);
  return (int)err;
}
