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
// bytes of bf16 plus the float32 statistics; at the trainer's call (B=4,
// S=4096, H=32, K=4, hd=128) that is 1.375e12 operations against 0.61 GB,
// 1.39 ms at 989 TFLOP/s against 0.18 ms at 3.35 TB/s.
//
// Semantics: positions count from 0 on both sides, key j is visible to
// query i when j < Skv, (not causal or j <= i) and (no window or i - j <
// window), scale = 1/sqrt(hd), as in B5.  With P = exp(scale * q.k - lse) and delta = rowsum(dO o O):
//   dV = P^T dO,  dS = P o (dO V^T - delta),  dK = scale dS^T Q,
//   dQ = scale dS K.
// No atomic sums and a fixed order of every sum, so two calls give the
// same bits.
//  * bf16: three launches.
//    1. delta: hd / 8 threads per (batch, query, head) row, float32; it
//       also writes lse * log2(e) beside delta, both padded to whole
//       64-row query tiles with zeros.
//    2. The main pass, a Hopper kernel (sm_90a), computes dK, dV and dQ
//       together: 5 products per (KV tile, query tile) pair, where a
//       two-kernel design recomputes S and dP for dQ (7).  A work item is
//       (KV tile of 128 keys, KV head, batch): K and V stay in shared
//       memory (one TMA load), and the item walks the G = H / K query
//       heads of its KV head and, under causal, the query tiles from the
//       diagonal on, last tile first and the G heads innermost, so GQA's
//       sum over the G heads stays inside the item.  A producer warp
//       streams 64-row Q and dO tiles (TMA, the 4-D maps of B5, which
//       zero-fill rows past Sq) and their lse / delta (bulk copies) into
//       a two-stage mbarrier ring.  Two consumer warpgroups (setmaxnreg
//       240) own 64 keys each: S^T = K Q^T and dP^T = V dO^T are wgmma
//       m64n64k16 from shared memory, committed apart so that P^T is built
//       while dP^T runs; P^T and dS^T are built in the accumulators, which
//       packed to bf16 already are the A fragments of dV += P^T dO (run
//       while dS^T is built) and dK += dS^T Q (wgmma with A in registers,
//       dO / Q as MN-major B operands).  dS^T goes to shared memory
//       (128-byte swizzle, one 128-byte row per key), and after a barrier
//       of the two warpgroups each computes dQ's partial dS K for half of
//       the head dims (A = dS MN-major, B = K MN-major, over the item's
//       128 keys) into one of two float32 staging tiles.
//       dQ's partials meet in a float32 workspace (B, H, query tiles, 64 x
//       hd, in the accumulators' fragment order) in ascending KV-tile
//       order: a writer warp copies each partial with one bulk store (KV
//       tile 0, so the workspace needs no memset) or one bulk float32 add,
//       after a per-(batch, head, query tile) ticket in global memory says
//       that the items of every lower KV tile have added theirs, and
//       releases the ticket once its own add has completed (acquire /
//       release at gpu scope).  A persistent grid of one block per SM
//       takes items from a counter in the order of Item (four passes over
//       the KV tiles, group by group inside a pass), in which a group's
//       KV tiles ascend, so every item waited on is held by a running
//       block; the counter only schedules, and every sum keeps its order.
//    3. A last pass casts the workspace, scaled, to dQ's (B, Sq, H, hd).
//    What bounds it on the card: the tensor cores, as far as the small
//    (m64n64) products and the per-step barrier of the two warpgroups let
//    them run (at the trainer's call ~45 % of 989 TFLOP/s); the
//    workspace's 4.4 GB of L2 adds cost ~0.15 ms more once the items that
//    share a tile run together.  The threads' shared-memory writes read by
//    wgmma or a bulk copy are fenced for shared memory only: a fence over
//    every state space waited on the bulk adds in flight and slowed the
//    products by half.
//  * f32: FMA on the CUDA cores (TF32 would miss the float32 oracle), a
//    16 x 16 thread grid with 4 rows x hd/16 columns each; q is scaled as
//    it is loaded, as in B5's float32 kernel, so the product by the
//    scaled Q already carries dK's scale.  Three launches: delta, dK / dV
//    (one block per 64 keys of a KV head and batch, walking its G query
//    heads), dQ (one block per 64 query rows).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int B, Sq, Skv, H, K, group;  // group = H / K
  int causal;
  int window;                   // 0: no sliding window
  float scale;                  // 1 / sqrt(hd)
  int n_qt;                     // bf16: query tiles of kBM rows
  int n_items;                  // bf16: (KV tile, KV head, batch) items
  int n_kv;                     // bf16: KV tiles of kBN keys
};

__device__ __forceinline__ bool visible(int key, int row, const Shape& s) {
  return key < s.Skv && row < s.Sq && (!s.causal || key <= row) &&
         (s.window == 0 || row - key < s.window);
}

// Under a window, the last query tile of `rows` rows that sees a key of
// the tile from key0 (`keys` keys): the one holding row key0 + keys - 2 +
// window, whose distance to the tile's last key is window - 1.
__device__ __forceinline__ int band_last_tile(int key0, int keys, int rows,
                                              int n_tiles, const Shape& s) {
  if (s.window == 0) return n_tiles - 1;
  return min(n_tiles - 1, (key0 + keys - 2 + s.window) / rows);
}

// Under a window, the first KV tile of `keys` keys that a query tile from
// row0 sees: the one holding key row0 - window + 1, the oldest key that
// row0 sees.
__device__ __forceinline__ int band_first_tile(int row0, int keys,
                                               const Shape& s) {
  const int key = row0 - s.window + 1;
  return s.window > 0 && key > 0 ? key / keys : 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ----------------------------------------------------------------- delta

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: hd / V threads a
// row (V elements = 16 bytes each); rows are (b, i, h) in memory order,
// i < sq_pad (>= Sq), and rows at or past Sq are 0.  Given lse2, it also
// takes lse * log2(e) (0 past Sq).  delta and lse2 are (B, H, sq_pad).
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ lse2, long long rows, int hd, int sq_pad, Shape s) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = hd / V;              // 8, 16 or 32 threads
  const long long r =
      ((long long)blockIdx.x * 256 + threadIdx.x) / per_row;
  const int part = threadIdx.x % per_row;
  const int h = (int)(r % s.H);
  const long long bi = r / s.H;          // b * sq_pad + i
  const long long b = bi / sq_pad, i = bi % sq_pad;
  float acc = 0.f;
  if (r < rows && i < s.Sq) {
    const long long src = ((b * s.Sq + i) * s.H + h) * hd + part * V;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + src);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + src);
    const T* op = reinterpret_cast<const T*>(&ov);
    const T* dp = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int x = 0; x < V; ++x) acc = fmaf(to_f32(op[x]), to_f32(dp[x]), acc);
  }
  for (int off = per_row / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (r < rows && part == 0) {
    const long long row = b * s.H + h;
    delta[row * sq_pad + i] = acc;
    if (lse2 != nullptr)
      lse2[row * sq_pad + i] = i < s.Sq ? lse[row * s.Sq + i] * kLog2e : 0.f;
  }
}

// ------------------------------------------------------------------ bf16

constexpr int kBM = 64;            // query rows per step
constexpr int kBN = 128;           // keys per item, 64 per consumer warpgroup
constexpr int kStages = 2;         // Q / dO tiles in the ring
constexpr int kThreads = 384;      // producer warpgroup + 2 consumer ones
constexpr int kConsumerWarps = 8;
constexpr int kQBox = kBoxCols * 2 * kBM;    // one 64-row box, 8 KB
constexpr int kKVBox = kBoxCols * 2 * kBN;   // one 128-row box, 16 KB
constexpr int kDSBytes = kBN * kBM * 2;      // dS^T: 128 keys x 64 queries
constexpr int kDQBufs = 2;         // dQ staging tiles
// Items are handed out in kPasses passes over the KV tiles, each pass
// group-major: see Item.
constexpr int kPasses = 4;

// Shared memory from a 1024-byte aligned base (the 128-byte swizzle's
// period): K, V (HD / 64 boxes each), the ring's Q and dO per stage, two
// dS^T buffers, the float32 dQ staging tiles, each stage's lse2 and delta
// (64 floats each), the mbarriers kv_full, full[kStages], empty[kStages],
// dq_full[kDQBufs], dq_empty[kDQBufs], and the item slot.
template <int HD>
struct Smem {
  static constexpr int kKV = HD * 2 * kBN;
  static constexpr int kQT = HD * 2 * kBM;
  static constexpr int kDQ = kBM * HD * 4;
  static constexpr int k = 0;
  static constexpr int v = kKV;
  static constexpr int ring = 2 * kKV;   // stage s: Q at + 2 kQT s, dO + kQT
  static constexpr int ds = ring + 2 * kStages * kQT;
  static constexpr int dq = ds + 2 * kDSBytes;
  static constexpr int stats = dq + kDQBufs * kDQ;  // lse2 + 512 s, delta + 256
  static constexpr int bars = stats + 512 * kStages;
  static constexpr int item = bars + 8 * (1 + 2 * kStages + 2 * kDQBufs);
  static constexpr size_t bytes = item + 16 + 1024;  // + alignment
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// The item's place.  Items go out in kPasses passes over the KV tiles
// (pass x: tiles x * per .. x * per + per - 1), and inside a pass group by
// group ((batch, KV head) outermost, KV tile ascending), so the items that
// add into a workspace tile mostly run together and find it in L2, while
// the longest (lowest) KV tiles still go first.  A group's KV tiles are
// handed out in ascending order, as the tickets need.  An item walks the
// query tiles from the diagonal (causal) to the last one that sees one of
// its keys (its band's end under a window, else the last).
struct Item {
  int j, b, kh, n_steps, last;
  __device__ Item(int item, const Shape& s) {
    const int per = (s.n_kv + kPasses - 1) / kPasses;
    const int x = item / (s.B * s.K * per);
    const int in_pass = min(per, s.n_kv - x * per);
    const int rest = item - x * s.B * s.K * per;
    const int bk = rest / in_pass;
    j = x * per + rest % in_pass;
    b = bk / s.K;
    kh = bk - b * s.K;
    const int first = s.causal ? min(j * (kBN / kBM), s.n_qt) : 0;
    last = band_last_tile(j * kBN, kBN, kBM, s.n_qt, s);
    n_steps = max(0, last + 1 - first) * s.group;
  }
  // Step st: query tile last - st / G (the last first), head st % G.
  __device__ int qt(int st, const Shape& s) const {
    return last - st / s.group;
  }
  __device__ int h(int st, const Shape& s) const {
    return kh * s.group + st % s.group;
  }
};

// Warpgroup 0: thread 0 takes items from the counter (tickets[0]) and
// issues every load; lane 0 of warp 1 writes dQ's partials.  Warpgroups 1
// and 2 compute, keys 0-63 and 64-127 of the item.  Their accumulator
// fragments: warp w, lane (g = lane / 4, t = lane % 4) holds rows 16w + g
// and 16w + g + 8, columns 8i + 2t and 8i + 2t + 1.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) bwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ stats, uint16_t* __restrict__ dk,
    uint16_t* __restrict__ dv, float* __restrict__ dq_ws,
    int* __restrict__ tickets, Shape s) {
  using L = Smem<HD>;
  constexpr int kDqCols = HD / 2;      // dQ's head dims per warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t kv_full = base + L::bars;
  const uint32_t full = kv_full + 8;                 // + 8 * stage
  const uint32_t empty = full + 8 * kStages;
  const uint32_t dq_full = empty + 8 * kStages;
  const uint32_t dq_empty = dq_full + 8 * kDQBufs;
  volatile int* item_slot = reinterpret_cast<volatile int*>(smem + L::item);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    for (int x = 0; x < kDQBufs; ++x) {
      mbar_init(dq_full + 8 * x, kConsumerWarps);
      mbar_init(dq_empty + 8 * x, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int it = 0;       // steps so far in this block: the rings' counter
  int n_done = 0;   // items so far: kv_full's phase
  if (threadIdx.x < 128) {
    // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (;;) {
      if (threadIdx.x == 0) *item_slot = atomicAdd(tickets, 1);
      __syncthreads();
      const int item = *item_slot;
      if (item >= s.n_items) break;
      const Item w(item, s);
      if (warp == 0 && lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
        for (int c = 0; c < HD / kBoxCols; ++c) {
          tma_load(base + L::k + c * kKVBox, &k_map, kv_full, c * kBoxCols,
                   w.kh, w.j * kBN, w.b);
          tma_load(base + L::v + c * kKVBox, &v_map, kv_full, c * kBoxCols,
                   w.kh, w.j * kBN, w.b);
        }
        const long long plane = (long long)s.B * s.H * s.n_qt * kBM;
        for (int st = 0; st < w.n_steps; ++st) {
          const int n = it + st, stage = n % kStages;
          if (n >= kStages) mbar_wait(empty + 8 * stage, (n / kStages - 1) & 1);
          const int qt = w.qt(st, s), h = w.h(st, s);
          const uint32_t bar = full + 8 * stage;
          const uint32_t qs = base + L::ring + 2 * L::kQT * stage;
          mbar_expect_tx(bar, 2 * L::kQT + 2 * kBM * 4);
#pragma unroll
          for (int c = 0; c < HD / kBoxCols; ++c) {
            tma_load(qs + c * kQBox, &q_map, bar, c * kBoxCols, h, qt * kBM,
                     w.b);
            tma_load(qs + L::kQT + c * kQBox, &do_map, bar, c * kBoxCols, h,
                     qt * kBM, w.b);
          }
          const float* row =
              stats + ((long long)(w.b * s.H + h) * s.n_qt + qt) * kBM;
          const uint32_t ss = base + L::stats + 512 * stage;
          bulk_load(ss, row, kBM * 4, bar);
          bulk_load(ss + 256, row + plane, kBM * 4, bar);
        }
      } else if (warp == 1 && lane == 0) {
        // dQ's partials into the workspace in ascending KV-tile order: KV
        // tile j adds once the query tile's band tiles j0 .. j - 1 have
        // (j0 = 0 without a window; tile j0 stores, so the workspace needs
        // no memset), and releases the ticket once its add has completed.
        for (int st = 0; st < w.n_steps; ++st) {
          const int n = it + st, buf = n % kDQBufs, qt = w.qt(st, s);
          const long long tile =
              (long long)(w.b * s.H + w.h(st, s)) * s.n_qt + qt;
          int* ticket = tickets + 1 + tile;
          const int j0 = band_first_tile(qt * kBM, kBN, s);
          if (w.j > j0) {
            while (ld_acquire(ticket) < w.j - j0) {
            }
            fence_proxy_async_global();
          }
          mbar_wait(dq_full + 8 * buf, (n / kDQBufs) & 1);
          float* dst = dq_ws + tile * (kBM * HD);
          const uint32_t src = base + L::dq + buf * L::kDQ;
          if (w.j == j0)
            bulk_store(dst, src, L::kDQ);
          else
            bulk_add_f32(dst, src, L::kDQ);
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(dq_empty + 8 * buf);
          bulk_wait();
          fence_proxy_async_global();
          red_release_add(ticket, 1);
        }
      }
      __syncwarp();
      it += w.n_steps;
      ++n_done;
      __syncthreads();
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const float sl = s.scale * kLog2e;
    // This warpgroup's 64 keys: rows 64 wg.. of each K / V box (A of S^T
    // and dP^T); its kDqCols head dims of K (B of dQ, MN-major).
    const uint32_t ka = base + L::k + wg * 64 * 128;
    const uint32_t va = base + L::v + wg * 64 * 128;
    const uint32_t kb = base + L::k + (wg * kDqCols / kBoxCols) * kKVBox +
                        (wg * kDqCols % kBoxCols) * 2;
    for (;;) {
      __syncthreads();
      const int item = *item_slot;
      if (item >= s.n_items) break;
      const Item w(item, s);
      const int key_lo = w.j * kBN + 64 * wg;
      const int kr0 = key_lo + 16 * warp + g, kr1 = kr0 + 8;
      float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      mbar_wait(kv_full, n_done & 1);

      for (int st = 0; st < w.n_steps; ++st) {
        const int n = it + st, stage = n % kStages;
        const int q0 = w.qt(st, s) * kBM;
        const uint32_t qs = base + L::ring + 2 * L::kQT * stage;
        const uint32_t dos = qs + L::kQT;
        const float* lse2 =
            reinterpret_cast<const float*>(smem + L::stats + 512 * stage);
        const float* dl = lse2 + kBM;

        // S^T = K Q^T, then dP^T = V dO^T, over HD / 16 steps of 16 head
        // dims (32 B of a 128-B row), committed as two groups: P^T is
        // built while dP^T's products run.
        float sT[32], dpT[32];
        mbar_wait(full + 8 * stage, (n / kStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t oa = (kk / 4) * kKVBox + (kk % 4) * 32;
          const uint32_t ob = (kk / 4) * kQBox + (kk % 4) * 32;
          wgmma_ss<0, 0>(sT, sw128_desc(ka + oa, 16, 1024),
                         sw128_desc(qs + ob, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t oa = (kk / 4) * kKVBox + (kk % 4) * 32;
          const uint32_t ob = (kk / 4) * kQBox + (kk % 4) * 32;
          wgmma_ss<0, 0>(dpT, sw128_desc(va + oa, 16, 1024),
                         sw128_desc(dos + ob, 16, 1024), kk > 0);
        }
        wgmma_commit();
        fence_acc(sT);
        fence_acc(dpT);
        wgmma_wait<1>();
        fence_acc(sT);

        // P^T = exp(scale s - lse); fragment i holds queries q0 + 8i + 2t
        // (+1) of keys kr0 (e < 2) and kr1.  Rows past Sq need no mask:
        // their Q, dO, lse and delta are 0.
        const bool masked =
            key_lo + 63 >= s.Skv || (s.causal && key_lo + 63 > q0) ||
            (s.window > 0 && q0 + 63 - key_lo >= s.window);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse2 + 8 * i + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(sT[4 * i + e], sl, (e & 1) ? -l2.y : -l2.x));
            if (masked) {
              const int key = e < 2 ? kr0 : kr1;
              const int q = q0 + 8 * i + 2 * t + (e & 1);
              if (key >= s.Skv || (s.causal && key > q) ||
                  (s.window > 0 && q - key >= s.window))
                p = 0.f;
            }
            sT[4 * i + e] = p;
          }
        }
        // In bf16: fragments 2kk and 2kk + 1 are the A fragment of queries
        // 16kk .. 16kk + 15 (keys g, g + 8; queries 2t.. and 2t + 8..).
        uint32_t pa[16], da[16];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[4 * kk + x] =
                pack_bf16(sT[8 * kk + 2 * x], sT[8 * kk + 2 * x + 1]);

        // dV += P^T dO over the 64 queries, run while dS^T is built: dO is
        // an MN-major B operand, 16 queries x 128 B = 2048 B a step; the
        // next 64 head dims are the next box (LBO).
        fence_acc(dv_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dv_acc, pa + 4 * kk,
                   sw128_desc(dos + kk * 2048, kQBox, 1024));
        wgmma_commit();
        fence_acc(dpT);
        wgmma_wait<1>();
        fence_acc(dpT);

        // dS^T = P^T o (dP^T - delta)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * i + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpT[4 * i + e] =
                sT[4 * i + e] * (dpT[4 * i + e] - ((e & 1) ? d2.y : d2.x));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            da[4 * kk + x] =
                pack_bf16(dpT[8 * kk + 2 * x], dpT[8 * kk + 2 * x + 1]);
        // dS^T into this step's buffer: row = the key's place in the item,
        // 64 queries = 128 B, 16-byte chunk i of row r at chunk i ^ (r % 8).
        const uint32_t dsb = base + L::ds + (n & 1) * kDSBytes;
        const uint32_t row0 = dsb + (64 * wg + 16 * warp + g) * 128;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t chunk = ((i ^ g) << 4) + 4 * t;
          st_shared(row0 + chunk, da[4 * (i / 2) + 2 * (i % 2)]);
          st_shared(row0 + 8 * 128 + chunk, da[4 * (i / 2) + 2 * (i % 2) + 1]);
        }

        // dK += dS^T Q, Q as dO above.
        fence_acc(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dk_acc, da + 4 * kk, sw128_desc(qs + kk * 2048, kQBox, 1024));
        wgmma_commit();

        // dQ's partial dS K: both warpgroups' dS^T in shared memory and
        // visible to wgmma; A = dS (64 queries x 128 keys) MN-major, B =
        // this warpgroup's kDqCols head dims of K, MN-major.
        fence_proxy_async_shared();
        consumers_sync();
        float dq[HD / 4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_ss<1, 1>(dq, sw128_desc(dsb + kk * 2048, kDSBytes, 1024),
                         sw128_desc(kb + kk * 2048, kKVBox, 1024), kk > 0);
        wgmma_commit();
        fence_acc(dv_acc);
        fence_acc(dk_acc);
        fence_acc(dq);
        wgmma_wait_all();
        fence_acc(dv_acc);
        fence_acc(dk_acc);
        fence_acc(dq);
        if (lane == 0) mbar_arrive(empty + 8 * stage);

        // The partial into the staging tile, in fragment order: float4 i
        // of thread tid of warpgroup wg at (wg * 64 * kDqCols / 4 + 128 i
        // + tid); the cast pass reads that order.
        const int buf = n % kDQBufs;
        if (n >= kDQBufs)
          mbar_wait(dq_empty + 8 * buf, (n / kDQBufs - 1) & 1);
        float4* stg = reinterpret_cast<float4*>(smem + L::dq + buf * L::kDQ) +
                      wg * (kBM * kDqCols / 4) + tid;
#pragma unroll
        for (int i = 0; i < HD / 16; ++i)
          stg[128 * i] = make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2],
                                     dq[4 * i + 3]);
        fence_proxy_async_shared();
        __syncwarp();
        if (lane == 0) mbar_arrive(dq_full + 8 * buf);
      }

      // Fragment i holds head dims 8i + 2t (+1) of keys kr0 (e < 2), kr1.
      const long long kv_stride = (long long)s.K * HD;
      const long long kv_off =
          ((long long)w.b * s.Skv * s.K + w.kh) * HD + 2 * t;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        if (kr0 < s.Skv) {
          *reinterpret_cast<uint32_t*>(dk + kv_off + kr0 * kv_stride + 8 * i) =
              pack_bf16(dk_acc[4 * i] * s.scale, dk_acc[4 * i + 1] * s.scale);
          *reinterpret_cast<uint32_t*>(dv + kv_off + kr0 * kv_stride + 8 * i) =
              pack_bf16(dv_acc[4 * i], dv_acc[4 * i + 1]);
        }
        if (kr1 < s.Skv) {
          *reinterpret_cast<uint32_t*>(dk + kv_off + kr1 * kv_stride + 8 * i) =
              pack_bf16(dk_acc[4 * i + 2] * s.scale,
                        dk_acc[4 * i + 3] * s.scale);
          *reinterpret_cast<uint32_t*>(dv + kv_off + kr1 * kv_stride + 8 * i) =
              pack_bf16(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
        }
      }
      it += w.n_steps;
      ++n_done;
      __syncthreads();
    }
  }
}

// dQ = scale * the workspace, from its fragment order to (B, Sq, H, hd)
// bf16: one block per (batch, head, query tile), the tile through shared
// memory, 16 bytes (8 head dims of a row) per thread and store.
template <int HD>
__global__ void __launch_bounds__(256) dq_cast_kernel(
    const float4* __restrict__ ws, uint16_t* __restrict__ dq, Shape s) {
  constexpr int kPerWg = kBM * HD / 2 / 4;   // float4s of one warpgroup
  __shared__ float4 buf[2 * kPerWg];
  const long long tile = blockIdx.x;
  for (int x = threadIdx.x; x < 2 * kPerWg; x += 256)
    buf[x] = ws[tile * (2 * kPerWg) + x];
  __syncthreads();
  const int qt = (int)(tile % s.n_qt);
  const long long bh = tile / s.n_qt;
  const int h = (int)(bh % s.H);
  const long long b = bh / s.H;
  for (int x = threadIdx.x; x < kBM * HD / 8; x += 256) {
    const int row = x / (HD / 8), col = 8 * (x % (HD / 8));
    const int q = qt * kBM + row;
    if (q >= s.Sq) continue;
    // Row 16w + g (+8: the float4's z, w) of warpgroup col / (HD / 2),
    // columns 8i + 2t (+1) in thread 32w + 4g + t's float4 i.
    const int wg = col / (HD / 2), i = (col % (HD / 2)) / 8;
    const int hi = (row % 16) / 8;
    const float4* src = buf + wg * kPerWg + 128 * i + 32 * (row / 16) +
                        4 * (row % 8);
    uint32_t out[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 f = src[t];
      out[t] = hi ? pack_bf16(f.z * s.scale, f.w * s.scale)
                  : pack_bf16(f.x * s.scale, f.y * s.scale);
    }
    *reinterpret_cast<uint4*>(dq + ((b * s.Sq + q) * s.H + h) * HD + col) =
        make_uint4(out[0], out[1], out[2], out[3]);
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
  const int last = band_last_tile(k0, kFmaRows, kFmaRows, n_qt, s);
  for (int gi = 0; gi < s.group; ++gi) {
    const int h = kh * s.group + gi;
    const long long q_off = (long long)b * s.Sq * q_stride + (long long)h * HD;
    const long long st_off = ((long long)b * s.H + h) * s.Sq;
    for (int it = first; it <= last; ++it) {
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
  for (int jt = band_first_tile(q0, kFmaRows, s); jt < n_kt; ++jt) {
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
cudaError_t launch_delta(const void* o, const void* dout, const float* lse,
                         float* delta, float* lse2, int hd, int sq_pad,
                         const Shape& s, cudaStream_t stream) {
  const long long rows = (long long)s.B * sq_pad * s.H;
  const long long blocks = (rows * (hd * sizeof(T) / 16) + 255) / 256;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      lse2, rows, hd, sq_pad, s);
  return cudaGetLastError();
}

// The main pass; returns a cudaError_t, or minus the CUresult of a failed
// tensor-map encode.
template <int HD>
int launch_main(const void* q, const void* k, const void* v,
                const void* dout, const float* stats, float* dq_ws,
                int* tickets, void* dk, void* dv, const Shape& s,
                cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm, dom;
  CUresult res = encode_map(encode, &qm, q, s.B, s.Sq, s.Sq, s.H, HD, kBM);
  if (res == CUDA_SUCCESS)
    res = encode_map(encode, &dom, dout, s.B, s.Sq, s.Sq, s.H, HD, kBM);
  if (res == CUDA_SUCCESS)
    res = encode_map(encode, &km, k, s.B, s.Skv, s.Skv, s.K, HD, kBN);
  if (res == CUDA_SUCCESS)
    res = encode_map(encode, &vm, v, s.B, s.Skv, s.Skv, s.K, HD, kBN);
  if (res != CUDA_SUCCESS) return -(int)res;
  constexpr size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  bwd_wgmma_kernel<HD><<<(unsigned)min(sms, s.n_items), kThreads, smem,
                         stream>>>(qm, km, vm, dom, stats,
                                   static_cast<uint16_t*>(dk),
                                   static_cast<uint16_t*>(dv), dq_ws, tickets,
                                   s);
  err = cudaGetLastError();
  return (int)err;
}

// The main pass, then dQ's cast; returns a cudaError_t, or minus the
// CUresult of a failed tensor-map encode.
template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* stats, float* dq_ws,
                 int* tickets, void* dq, void* dk, void* dv, const Shape& s,
                 cudaStream_t stream) {
  const int err = launch_main<HD>(q, k, v, dout, stats, dq_ws, tickets, dk,
                                  dv, s, stream);
  if (err != 0) return err;
  const long long tiles = (long long)s.B * s.H * s.n_qt;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dq_cast_kernel<HD><<<(unsigned)tiles, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dq_ws), static_cast<uint16_t*>(dq), s);
  return (int)cudaGetLastError();
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

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, K, hd); lse:
// (B, H, Sq) float32, B5's (the forward's) for these q, k, v; window > 0
// hides the keys `window` or more positions before a query.  All
// contiguous, 16-byte aligned; dtype 0 = float32, 1 = bfloat16; hd 64 or
// 128.  Scratch, written here: with P = ceil(Sq / 64) query tiles,
//  * bf16: `stats` 2 * B * H * 64P float32 (lse * log2(e), then delta),
//    `dq_ws` B * H * 64P * hd float32 (dQ's workspace), `tickets` 1 + B *
//    H * P int32, zero on entry (the item counter, then one ticket per
//    (batch, head, query tile));
//  * f32: `stats` B * H * Sq float32 (delta); dq_ws and tickets unused.
// Three launches on `stream`: delta, the main pass and the dQ cast
// (bf16); delta, dK / dV and dQ (f32).  Returns 0, the cudaError_t of the
// first launch that failed, or minus the CUresult of a failed tensor-map
// encode.
extern "C" int attn_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* stats, void* dq_ws,
    void* tickets, void* dq, void* dk, void* dv, int B, int H, int K, int Sq,
    int Skv, int hd, int causal, int window, int dtype, void* stream) {
  if (B < 1 || K < 1 || H < K || H % K != 0 || Sq < 0 || Skv < 1 ||
      window < 0 ||
      (hd != 64 && hd != 128) || (dtype != kDtypeBF16 && dtype != kDtypeF32))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  const int n_qt = (Sq + kBM - 1) / kBM;
  const long long n_items = (long long)((Skv + kBN - 1) / kBN) * B * K;
  if (n_items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Shape s{B, Sq, Skv, H, K, H / K, causal ? 1 : 0, window,
                (float)(1.0 / sqrt((double)hd)), n_qt, (int)n_items,
                (Skv + kBN - 1) / kBN};
  const cudaStream_t st = (cudaStream_t)stream;
  const float* l = static_cast<const float*>(lse);
  float* sf = static_cast<float*>(stats);
  if (dtype == kDtypeF32) {
    cudaError_t err = launch_delta<float>(o, dout, l, sf, nullptr, hd, Sq, s,
                                          st);
    if (err == cudaSuccess)
      err = hd == 64
                ? launch_fma<64>(q, k, v, dout, l, sf, dq, dk, dv, s, st)
                : launch_fma<128>(q, k, v, dout, l, sf, dq, dk, dv, s, st);
    return (int)err;
  }
  const int sq_pad = n_qt * kBM;
  const long long plane = (long long)B * H * sq_pad;
  const cudaError_t err = launch_delta<__nv_bfloat16>(o, dout, l, sf + plane,
                                                      sf, hd, sq_pad, s, st);
  if (err != cudaSuccess) return (int)err;
  float* ws = static_cast<float*>(dq_ws);
  int* tk = static_cast<int*>(tickets);
  return hd == 64
             ? launch_wgmma<64>(q, k, v, dout, sf, ws, tk, dq, dk, dv, s, st)
             : launch_wgmma<128>(q, k, v, dout, sf, ws, tk, dq, dk, dv, s,
                                 st);
}
