// flash_attention_bwd (B5-bwd): the gradient of flash_attention (B5) with
// respect to q, k and v.
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention.py has no
// backward (no custom_vjp), and the reference's models differentiate
// chunked_attention (src/repro/models/attention.py) through XLA.  This is
// that gradient, rebuilt from B5's per-row log-sum-exp so the (Sq, Skv)
// probabilities never reach device memory.
//
// Bound on the card: tensor-core FLOPs.  A causal square call does
// 10*B*H*hd*S(S+1)/2 operations (S = Q K^T and dP = dO V^T recomputed,
// dV += P^T dO, dK += dS^T Q, dQ += dS K) on 2*(4*B*S*H*hd + 4*B*S*K*hd)
// bytes of bf16 plus the float32 statistics; at Yi-9B's attention (H=32,
// K=4, hd=128) and S=4096 that is 3.44e11 operations against 0.16 GB, 0.35
// ms at 989 TFLOP/s against 0.05 ms at 3.35 TB/s.
//
// Semantics: positions count from 0 on both sides, key j is visible to
// query i when j < Skv and (not causal or j <= i), scale = 1/sqrt(hd), as
// in B5.  With P = exp(scale * q.k - lse) and delta = rowsum(dO o O):
//   dV = P^T dO,  dS = P o (dO V^T - delta),  dK = scale dS^T Q,
//   dQ = scale dS K.
// Three launches, no atomics, a fixed order of every sum, so two calls
// give the same bits:
//  * delta: one warp per (batch, query, head) row, float32.
//  * dK / dV: one block per (KV tile of 64 keys, KV head, batch).  K and V
//    stay in shared memory; the block walks the G = H / K query heads of
//    its KV head and, for each, the query tiles from the causal diagonal
//    on, accumulating dK and dV in float32 registers.  GQA's sum over the
//    G heads happens inside the block.
//  * dQ: one block per (query tile of 64 rows, head, batch), walking the
//    KV tiles up to the diagonal, dQ in float32 registers.
//  * bf16: mma.sync m16n8k16 with float32 accumulators, four warps of 16
//    rows each (keys in dK / dV, queries in dQ); operands come from
//    shared memory through ldmatrix (rows padded by 16 bytes, so the eight
//    rows of a matrix fall in distinct banks), and P and dS go from the
//    accumulators straight into the A fragments of the next product.  No
//    pipelining: loads and products alternate behind __syncthreads.
//  * f32: FMA on the CUDA cores (TF32 would miss the float32 oracle), a
//    16 x 16 thread grid with 4 rows x hd/16 columns each; q is scaled as
//    it is loaded, as in B5's float32 kernel, so the product by the
//    scaled Q already carries dK's scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int B, Sq, Skv, H, K, group;  // group = H / K
  int causal;
  float scale;                  // 1 / sqrt(hd)
};

__device__ __forceinline__ bool visible(int key, int row, const Shape& s) {
  return key < s.Skv && row < s.Sq && (!s.causal || key <= row);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ----------------------------------------------------------------- delta

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp a row;
// rows are (b, i, h) in memory order.
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, long long rows, int hd, Shape s) {
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f32(o[r * hd + d]), to_f32(dout[r * hd + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const int h = (int)(r % s.H);
    const long long bi = r / s.H;          // b * Sq + i
    const long long b = bi / s.Sq, i = bi % s.Sq;
    delta[(b * s.H + h) * s.Sq + i] = acc;
  }
}

// ------------------------------------------------------------------ bf16

constexpr int kRows = 64;      // keys (dK / dV) or queries (dQ) per block
constexpr int kThreads = 128;  // four warps of 16 rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, f32) += A (16 x 16) B (16 x 8), bf16 fragments.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragment addresses in a row-major shared tile of row stride LD (bf16
// elements).  frag_a: the A operand of rows r0..r0+15 and k columns
// c0..c0+15 (ldsm_x4), and equally the B operands of two n-tiles from a
// tile stored [k][n] (ldsm_x4_t: k rows r0.., n columns c0..c0+15).
// frag_b: the B operands of two n-tiles from a tile stored [n][k]
// (ldsm_x4: n rows n0..n0+15, k columns k0..k0+15).
template <int LD>
__device__ __forceinline__ uint32_t frag_a(uint32_t base, int r0, int c0,
                                           int lane) {
  return base + ((r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8) * 2;
}
template <int LD>
__device__ __forceinline__ uint32_t frag_b(uint32_t base, int n0, int k0,
                                           int lane) {
  return base +
         ((n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0 + ((lane >> 3) & 1) * 8) * 2;
}

// rows row0..row0+n_rows-1 of a (rows, stride) bf16 matrix into a shared
// tile of row stride LD, 16 bytes a thread; rows at or past `limit` as 0.
template <int HD, int LD>
__device__ __forceinline__ void load_rows(uint16_t* dst,
                                          const uint16_t* __restrict__ src,
                                          int row0, int n_rows, int limit,
                                          long long stride) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < n_rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// The inner tile of the other side: 32 rows at hd 128 (registers), 64 at
// hd 64.
template <int HD>
__host__ __device__ constexpr int inner_rows() { return HD == 128 ? 32 : 64; }

template <int HD>
constexpr size_t mma_smem_bytes() {
  // two tiles of kRows and two of inner_rows, bf16, padded rows; then two
  // float vectors of inner_rows (dK / dV's lse and delta per query).
  return (size_t)2 * (2 * kRows + 2 * inner_rows<HD>()) * (HD + 8) +
         (size_t)2 * 4 * inner_rows<HD>();
}

// One block: 64 keys of one KV head and batch; warp w owns keys 16w..+15.
// Blocks run the key tiles with the most query tiles (the first, under
// causal) first.
template <int HD>
__global__ void __launch_bounds__(kThreads) dkdv_mma_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, Shape s) {
  constexpr int QT = inner_rows<HD>(), LD = HD + 8, NQ = QT / 8, ND = HD / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vs = ks + kRows * LD;
  uint16_t* qs = vs + kRows * LD;
  uint16_t* dos = qs + QT * LD;
  float* lse_s = reinterpret_cast<float*>(dos + QT * LD);  // * log2(e)
  float* delta_s = lse_s + QT;

  const int kh = blockIdx.x % s.K, b = (blockIdx.x / s.K) % s.B;
  const int k0 = (blockIdx.x / (s.K * s.B)) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;
  const long long kv_stride = (long long)s.K * HD, q_stride = (long long)s.H * HD;
  const long long kv_off = (long long)b * s.Skv * kv_stride + (long long)kh * HD;
  load_rows<HD, LD>(ks, k + kv_off, k0, kRows, s.Skv, kv_stride);
  load_rows<HD, LD>(vs, v + kv_off, k0, kRows, s.Skv, kv_stride);
  const uint32_t ks_a = smem_u32(ks), vs_a = smem_u32(vs);
  const uint32_t qs_a = smem_u32(qs), dos_a = smem_u32(dos);
  const float sl = s.scale * kLog2e;

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_qt = (s.Sq + QT - 1) / QT;
  const int first = s.causal ? min(k0 / QT, n_qt) : 0;
  for (int gi = 0; gi < s.group; ++gi) {
    const int h = kh * s.group + gi;
    const long long q_off = (long long)b * s.Sq * q_stride + (long long)h * HD;
    const long long st_off = ((long long)b * s.H + h) * s.Sq;
    for (int it = first; it < n_qt; ++it) {
      const int q0 = it * QT;
      __syncthreads();  // the last tile's reads are done (and K, V stored)
      load_rows<HD, LD>(qs, q + q_off, q0, QT, s.Sq, q_stride);
      load_rows<HD, LD>(dos, dout + q_off, q0, QT, s.Sq, q_stride);
      for (int i = threadIdx.x; i < QT; i += kThreads) {
        const bool in = q0 + i < s.Sq;
        lse_s[i] = in ? lse[st_off + q0 + i] * kLog2e : 0.f;
        delta_s[i] = in ? delta[st_off + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T: this warp's 16 keys x QT queries, over hd.
      float pt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, frag_a<LD>(ks_a, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int j = 0; j < NQ / 2; ++j) {
          uint32_t bq[4];
          ldsm_x4(bq, frag_b<LD>(qs_a, 16 * j, 16 * kk, lane));
          mma(pt[2 * j], a, bq[0], bq[1]);
          mma(pt[2 * j + 1], a, bq[2], bq[3]);
        }
      }
      // P^T: fragment j holds queries q0 + 8j + 2t (+1) of keys key0 (e <
      // 2) and key1.
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          pt[j][e] = visible(e < 2 ? key0 : key1, q0 + c, s)
                         ? ex2(fmaf(pt[j][e], sl, -lse_s[c]))
                         : 0.f;
        }
      // dV += P^T dO over the QT queries.
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(pt[2 * kk][0], pt[2 * kk][1]),
                               pack_bf16(pt[2 * kk][2], pt[2 * kk][3]),
                               pack_bf16(pt[2 * kk + 1][0], pt[2 * kk + 1][1]),
                               pack_bf16(pt[2 * kk + 1][2], pt[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < ND / 2; ++n) {
          uint32_t bo[4];
          ldsm_x4_t(bo, frag_a<LD>(dos_a, 16 * kk, 16 * n, lane));
          mma(dv_acc[2 * n], a, bo[0], bo[1]);
          mma(dv_acc[2 * n + 1], a, bo[2], bo[3]);
        }
      }
      // dP^T = V dO^T, then dS^T = P^T o (dP^T - delta).
      float ds[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, frag_a<LD>(vs_a, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int j = 0; j < NQ / 2; ++j) {
          uint32_t bo[4];
          ldsm_x4(bo, frag_b<LD>(dos_a, 16 * j, 16 * kk, lane));
          mma(ds[2 * j], a, bo[0], bo[1]);
          mma(ds[2 * j + 1], a, bo[2], bo[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = pt[j][e] * (ds[j][e] - delta_s[8 * j + 2 * t + (e & 1)]);
      // dK += dS^T Q (scaled at the end).
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
                               pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                               pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                               pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < ND / 2; ++n) {
          uint32_t bq[4];
          ldsm_x4_t(bq, frag_a<LD>(qs_a, 16 * kk, 16 * n, lane));
          mma(dk_acc[2 * n], a, bq[0], bq[1]);
          mma(dk_acc[2 * n + 1], a, bq[2], bq[3]);
        }
      }
    }
  }

  // Fragment n holds head dims 8n + 2t (+1) of keys key0 (e < 2), key1.
  uint16_t* dkb = dk + kv_off + 2 * t;
  uint16_t* dvb = dv + kv_off + 2 * t;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (key0 < s.Skv) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * kv_stride + 8 * n) =
          pack_bf16(dk_acc[n][0] * s.scale, dk_acc[n][1] * s.scale);
      *reinterpret_cast<uint32_t*>(dvb + key0 * kv_stride + 8 * n) =
          pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key1 < s.Skv) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * kv_stride + 8 * n) =
          pack_bf16(dk_acc[n][2] * s.scale, dk_acc[n][3] * s.scale);
      *reinterpret_cast<uint32_t*>(dvb + key1 * kv_stride + 8 * n) =
          pack_bf16(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// One block: 64 query rows of one head and batch; warp w owns rows
// 16w..+15.  The last query tile (the most KV tiles under causal) first.
template <int HD>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    uint16_t* __restrict__ dq, Shape s) {
  constexpr int KT = inner_rows<HD>(), LD = HD + 8, NK = KT / 8, ND = HD / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* dos = qs + kRows * LD;
  uint16_t* ks = dos + kRows * LD;
  uint16_t* vs = ks + KT * LD;

  const int h = blockIdx.x % s.H, b = (blockIdx.x / s.H) % s.B;
  const int n_qt = (s.Sq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / (s.H * s.B))) * kRows;
  const int kh = h / s.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const long long kv_stride = (long long)s.K * HD, q_stride = (long long)s.H * HD;
  const long long q_off = (long long)b * s.Sq * q_stride + (long long)h * HD;
  const long long kv_off = (long long)b * s.Skv * kv_stride + (long long)kh * HD;
  const long long st_off = ((long long)b * s.H + h) * s.Sq;
  load_rows<HD, LD>(qs, q + q_off, q0, kRows, s.Sq, q_stride);
  load_rows<HD, LD>(dos, dout + q_off, q0, kRows, s.Sq, q_stride);
  const float lse0 = r0 < s.Sq ? lse[st_off + r0] * kLog2e : 0.f;
  const float lse1 = r1 < s.Sq ? lse[st_off + r1] * kLog2e : 0.f;
  const float dl0 = r0 < s.Sq ? delta[st_off + r0] : 0.f;
  const float dl1 = r1 < s.Sq ? delta[st_off + r1] : 0.f;
  const uint32_t qs_a = smem_u32(qs), dos_a = smem_u32(dos);
  const uint32_t ks_a = smem_u32(ks), vs_a = smem_u32(vs);
  const float sl = s.scale * kLog2e;

  float dq_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  int n_kt = (s.Skv + KT - 1) / KT;
  if (s.causal) n_kt = min(n_kt, (q0 + kRows - 1) / KT + 1);
  for (int jt = 0; jt < n_kt; ++jt) {
    const int c0 = jt * KT;
    __syncthreads();
    load_rows<HD, LD>(ks, k + kv_off, c0, KT, s.Skv, kv_stride);
    load_rows<HD, LD>(vs, v + kv_off, c0, KT, s.Skv, kv_stride);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x KT keys, over hd.
    float p[NK][4], ds[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, frag_a<LD>(qs_a, 16 * warp, 16 * kk, lane));
      ldsm_x4(ao, frag_a<LD>(dos_a, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, frag_b<LD>(ks_a, 16 * j, 16 * kk, lane));
        ldsm_x4(bv, frag_b<LD>(vs_a, 16 * j, 16 * kk, lane));
        mma(p[2 * j], aq, bk[0], bk[1]);
        mma(p[2 * j + 1], aq, bk[2], bk[3]);
        mma(ds[2 * j], ao, bv[0], bv[1]);
        mma(ds[2 * j + 1], ao, bv[2], bv[3]);
      }
    }
    // Fragment j holds keys c0 + 8j + 2t (+1) of rows r0 (e < 2), r1.
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * j + 2 * t + (e & 1);
        const bool lo = e < 2;
        const float pv = visible(key, lo ? r0 : r1, s)
                             ? ex2(fmaf(p[j][e], sl, -(lo ? lse0 : lse1)))
                             : 0.f;
        ds[j][e] = pv * (ds[j][e] - (lo ? dl0 : dl1));
      }
    // dQ += dS K (scaled at the end).
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
                             pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                             pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                             pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND / 2; ++n) {
        uint32_t bk[4];
        ldsm_x4_t(bk, frag_a<LD>(ks_a, 16 * kk, 16 * n, lane));
        mma(dq_acc[2 * n], a, bk[0], bk[1]);
        mma(dq_acc[2 * n + 1], a, bk[2], bk[3]);
      }
    }
  }

  uint16_t* dqb = dq + q_off + 2 * t;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (r0 < s.Sq)
      *reinterpret_cast<uint32_t*>(dqb + r0 * q_stride + 8 * n) =
          pack_bf16(dq_acc[n][0] * s.scale, dq_acc[n][1] * s.scale);
    if (r1 < s.Sq)
      *reinterpret_cast<uint32_t*>(dqb + r1 * q_stride + 8 * n) =
          pack_bf16(dq_acc[n][2] * s.scale, dq_acc[n][3] * s.scale);
  }
}

// ------------------------------------------------------------------- f32

constexpr int kFmaRows = 64;
constexpr int kFmaThreads = 256;   // 16 x 16

template <int HD>
constexpr size_t fma_smem_bytes() {
  // four (64, HD + 1) tiles, two (64, 65) score tiles, two 64-vectors.
  return sizeof(float) * ((size_t)4 * kFmaRows * (HD + 1) +
                          (size_t)2 * kFmaRows * (kFmaRows + 1) + 2 * kFmaRows);
}

// rows row0.. of a (rows, stride) float32 matrix into a (64, HD + 1)
// shared tile, times `mul`; rows at or past `limit` as 0.
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const float* __restrict__ src,
                                              int row0, int limit,
                                              long long stride, float mul) {
  for (int i = threadIdx.x; i < kFmaRows * HD; i += kFmaThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] =
        row0 + r < limit ? src[(row0 + r) * stride + d] * mul : 0.f;
  }
}

// One block: 64 keys of one KV head and batch.  Thread (ty, tx) owns keys
// ty + 16i and, in the score tiles, queries tx + 16j; in dK / dV head dims
// tx + 16c.
template <int HD>
__global__ void __launch_bounds__(kFmaThreads) dkdv_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, Shape s) {
  constexpr int LQ = HD + 1, LP = kFmaRows + 1, C = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;                     // [64][LQ]
  float* vs = ks + kFmaRows * LQ;
  float* qs = vs + kFmaRows * LQ;       // q * scale
  float* dos = qs + kFmaRows * LQ;
  float* ps = dos + kFmaRows * LQ;      // P^T [key][query]
  float* dss = ps + kFmaRows * LP;      // dS^T
  float* lse_s = dss + kFmaRows * LP;
  float* delta_s = lse_s + kFmaRows;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kh = blockIdx.x % s.K, b = (blockIdx.x / s.K) % s.B;
  const int k0 = (blockIdx.x / (s.K * s.B)) * kFmaRows;
  const long long kv_stride = (long long)s.K * HD, q_stride = (long long)s.H * HD;
  const long long kv_off = (long long)b * s.Skv * kv_stride + (long long)kh * HD;
  load_rows_f32<HD>(ks, k + kv_off, k0, s.Skv, kv_stride, 1.f);
  load_rows_f32<HD>(vs, v + kv_off, k0, s.Skv, kv_stride, 1.f);

  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = (s.Sq + kFmaRows - 1) / kFmaRows;
  const int first = s.causal ? min(k0 / kFmaRows, n_qt) : 0;
  for (int gi = 0; gi < s.group; ++gi) {
    const int h = kh * s.group + gi;
    const long long q_off = (long long)b * s.Sq * q_stride + (long long)h * HD;
    const long long st_off = ((long long)b * s.H + h) * s.Sq;
    for (int it = first; it < n_qt; ++it) {
      const int q0 = it * kFmaRows;
      __syncthreads();
      load_rows_f32<HD>(qs, q + q_off, q0, s.Sq, q_stride, s.scale);
      load_rows_f32<HD>(dos, dout + q_off, q0, s.Sq, q_stride, 1.f);
      for (int i = threadIdx.x; i < kFmaRows; i += kFmaThreads) {
        const bool in = q0 + i < s.Sq;
        lse_s[i] = in ? lse[st_off + q0 + i] : 0.f;
        delta_s[i] = in ? delta[st_off + q0 + i] : 0.f;
      }
      __syncthreads();

      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(ty + 16 * i) * LQ + d];
          vv[i] = vs[(ty + 16 * i) * LQ + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 16 * j) * LQ + d];
          ov[j] = dos[(tx + 16 * j) * LQ + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + ty + 16 * i, c = tx + 16 * j;
          const float p =
              visible(key, q0 + c, s) ? expf(sc[i][j] - lse_s[c]) : 0.f;
          ps[(ty + 16 * i) * LP + c] = p;
          dss[(ty + 16 * i) * LP + c] = p * (dp[i][j] - delta_s[c]);
        }
      __syncthreads();

      for (int c = 0; c < kFmaRows; ++c) {
        float ov[C], qv[C];
#pragma unroll
        for (int x = 0; x < C; ++x) {
          ov[x] = dos[c * LQ + tx + 16 * x];
          qv[x] = qs[c * LQ + tx + 16 * x];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ps[(ty + 16 * i) * LP + c];
          const float dsv = dss[(ty + 16 * i) * LP + c];
#pragma unroll
          for (int x = 0; x < C; ++x) {
            dv_acc[i][x] = fmaf(p, ov[x], dv_acc[i][x]);
            dk_acc[i][x] = fmaf(dsv, qv[x], dk_acc[i][x]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= s.Skv) continue;
#pragma unroll
    for (int x = 0; x < C; ++x) {
      dk[kv_off + key * kv_stride + tx + 16 * x] = dk_acc[i][x];
      dv[kv_off + key * kv_stride + tx + 16 * x] = dv_acc[i][x];
    }
  }
}

// One block: 64 query rows of one head and batch.  Thread (ty, tx) owns
// rows ty + 16i and, in the score tile, keys tx + 16j; in dQ head dims
// tx + 16c.
template <int HD>
__global__ void __launch_bounds__(kFmaThreads) dq_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, Shape s) {
  constexpr int LQ = HD + 1, LP = kFmaRows + 1, C = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;                     // q * scale
  float* dos = qs + kFmaRows * LQ;
  float* ks = dos + kFmaRows * LQ;
  float* vs = ks + kFmaRows * LQ;
  float* dss = vs + kFmaRows * LQ;      // dS [query][key]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int h = blockIdx.x % s.H, b = (blockIdx.x / s.H) % s.B;
  const int n_qt = (s.Sq + kFmaRows - 1) / kFmaRows;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / (s.H * s.B))) * kFmaRows;
  const int kh = h / s.group;
  const long long kv_stride = (long long)s.K * HD, q_stride = (long long)s.H * HD;
  const long long q_off = (long long)b * s.Sq * q_stride + (long long)h * HD;
  const long long kv_off = (long long)b * s.Skv * kv_stride + (long long)kh * HD;
  const long long st_off = ((long long)b * s.H + h) * s.Sq;
  load_rows_f32<HD>(qs, q + q_off, q0, s.Sq, q_stride, s.scale);
  load_rows_f32<HD>(dos, dout + q_off, q0, s.Sq, q_stride, 1.f);
  float lse_r[4], delta_r[4], dq_acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < s.Sq ? lse[st_off + row] : 0.f;
    delta_r[i] = row < s.Sq ? delta[st_off + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) dq_acc[i][c] = 0.f;
  }

  int n_kt = (s.Skv + kFmaRows - 1) / kFmaRows;
  if (s.causal) n_kt = min(n_kt, (q0 + kFmaRows - 1) / kFmaRows + 1);
  for (int jt = 0; jt < n_kt; ++jt) {
    const int c0 = jt * kFmaRows;
    __syncthreads();
    load_rows_f32<HD>(ks, k + kv_off, c0, s.Skv, kv_stride, 1.f);
    load_rows_f32<HD>(vs, v + kv_off, c0, s.Skv, kv_stride, 1.f);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * LQ + d];
        ov[i] = dos[(ty + 16 * i) * LQ + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * LQ + d];
        vv[j] = vs[(tx + 16 * j) * LQ + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i, key = c0 + tx + 16 * j;
        const float p = visible(key, row, s) ? expf(sc[i][j] - lse_r[i]) : 0.f;
        dss[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    __syncthreads();

    for (int c = 0; c < kFmaRows; ++c) {
      float kv[C];
#pragma unroll
      for (int x = 0; x < C; ++x) kv[x] = ks[c * LQ + tx + 16 * x];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dsv = dss[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int x = 0; x < C; ++x) dq_acc[i][x] = fmaf(dsv, kv[x], dq_acc[i][x]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s.Sq) continue;
#pragma unroll
    for (int x = 0; x < C; ++x)
      dq[q_off + row * q_stride + tx + 16 * x] = dq_acc[i][x] * s.scale;
  }
}

// -------------------------------------------------------------- launches

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int hd, const Shape& s, cudaStream_t stream) {
  const long long rows = (long long)s.B * s.Sq * s.H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, hd,
      s);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       const Shape& s, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  const long long kv_blocks = (long long)((s.Skv + kRows - 1) / kRows) * s.K * s.B;
  const long long q_blocks = (long long)((s.Sq + kRows - 1) / kRows) * s.H * s.B;
  if (kv_blocks > 0x7fffffff || q_blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  using U = const uint16_t*;
  dkdv_mma_kernel<HD><<<(unsigned)kv_blocks, kThreads, smem, stream>>>(
      static_cast<U>(q), static_cast<U>(k), static_cast<U>(v),
      static_cast<U>(dout), lse, delta, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_mma_kernel<HD><<<(unsigned)q_blocks, kThreads, smem, stream>>>(
      static_cast<U>(q), static_cast<U>(k), static_cast<U>(v),
      static_cast<U>(dout), lse, delta, static_cast<uint16_t*>(dq), s);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       const Shape& s, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<HD>();
  const long long kv_blocks =
      (long long)((s.Skv + kFmaRows - 1) / kFmaRows) * s.K * s.B;
  const long long q_blocks =
      (long long)((s.Sq + kFmaRows - 1) / kFmaRows) * s.H * s.B;
  if (kv_blocks > 0x7fffffff || q_blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_fma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_fma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  using F = const float*;
  dkdv_fma_kernel<HD><<<(unsigned)kv_blocks, kFmaThreads, smem, stream>>>(
      static_cast<F>(q), static_cast<F>(k), static_cast<F>(v),
      static_cast<F>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_fma_kernel<HD><<<(unsigned)q_blocks, kFmaThreads, smem, stream>>>(
      static_cast<F>(q), static_cast<F>(k), static_cast<F>(v),
      static_cast<F>(dout), lse, delta, static_cast<float*>(dq), s);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, K, hd); lse and
// delta (scratch, written here): (B, H, Sq) float32; lse is B5's (the
// forward's) for these q, k, v.  All contiguous, 16-byte aligned; dtype
// 0 = float32, 1 = bfloat16; hd 64 or 128.  Three launches on `stream`
// (delta, dK / dV, dQ); returns 0 or the cudaError_t of the first that
// failed.
extern "C" int attn_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int K, int Sq, int Skv, int hd, int causal,
    int dtype, void* stream) {
  if (B < 1 || K < 1 || H < K || H % K != 0 || Sq < 0 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  const Shape s{B, Sq, Skv, H, K, H / K, causal ? 1 : 0,
                (float)(1.0 / sqrt((double)hd))};
  const cudaStream_t st = (cudaStream_t)stream;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeBF16 && (hd == 64 || hd == 128))
    err = launch_delta<__nv_bfloat16>(o, dout, dl, hd, s, st);
  if (dtype == kDtypeF32 && (hd == 64 || hd == 128))
    err = launch_delta<float>(o, dout, dl, hd, s, st);
  if (err != cudaSuccess) return (int)err;
  if (dtype == kDtypeBF16 && hd == 64)
    err = launch_mma<64>(q, k, v, dout, l, dl, dq, dk, dv, s, st);
  if (dtype == kDtypeBF16 && hd == 128)
    err = launch_mma<128>(q, k, v, dout, l, dl, dq, dk, dv, s, st);
  if (dtype == kDtypeF32 && hd == 64)
    err = launch_fma<64>(q, k, v, dout, l, dl, dq, dk, dv, s, st);
  if (dtype == kDtypeF32 && hd == 128)
    err = launch_fma<128>(q, k, v, dout, l, dl, dq, dk, dv, s, st);
  return (int)err;
}
