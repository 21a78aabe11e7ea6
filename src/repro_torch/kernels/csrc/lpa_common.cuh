// Shared device code of the four LPA kernels (label_argmax, fused_move,
// min_label, fused_split).
//
// Layout: the neighbor tiles are row-major (rows, d) — nbr int32, nw float32,
// nmask uint8 — and the per-vertex vectors (labels, comm, chg) are gathered
// through nbr inside the kernels.
//
// row_argmax (label_argmax, fused_move) has a narrow and a wide path,
// described at its section below.  row_min (min_label, fused_split) gives
// a row to a group of g lanes, g = the power of two >= d, capped at 32, so
// one warp covers 32 / g rows and the loads of a warp are contiguous; every
// thread of a block runs every shuffle, and rows past the end only carry
// valid_row = false.  Each of the two is the one function of its fused and
// unfused kernel, so fused and unfused sweeps compute bit-identical results.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lpa {

constexpr int kThreads = 128;            // threads per block
constexpr int kSentinel = 2147483647;    // INT32_MAX: "no label"
constexpr unsigned kFull = 0xffffffffu;

// Lanes per row: the power of two >= d, at most one warp.
inline int group_lanes(int d) {
  int g = 1;
  while (g < d && g < 32) g <<= 1;
  return g;
}

// Grid for `rows` rows at `g` lanes per row.
inline unsigned grid_blocks(long long rows, int g) {
  const long long per_block = kThreads / g;
  return (unsigned)((rows + per_block - 1) / per_block);
}

// uint32 Knuth multiplicative mix; identical to the label hash of the
// propagation loop: ((l*2654435761) ^ (s*0x9E3779B9)), xorshift 16,
// * 0x7FEB352D, xorshift 15, low 31 bits.
__device__ __forceinline__ int label_hash(int label, int seed) {
  unsigned x = (unsigned)label * 2654435761u;
  x ^= (unsigned)seed * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  return (int)(x & 0x7FFFFFFFu);
}

// Reductions over an aligned group of g lanes (g a power of two <= 32).
__device__ __forceinline__ float group_max(float v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int group_max(int v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int group_min(int v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// ------------------------------------------------------------------ argmax
//
// row_argmax is the one argmax of label_argmax and fused_move (both call
// the same functions below), so fused and unfused sweeps compute
// bit-identical results.  What it computes, per row: each real slot's
// score is the sum of the weights of the real slots that carry its label,
// folded in slot order from 0.0f; best_w is the largest score (clamped at
// 0); among labels reaching it with weight > 0 the largest label_hash
// wins, then the smallest label (kSentinel when none); cur_w is the score
// of the row's own label (0 when absent).  A real slot whose label is
// kSentinel scores nothing and is never a candidate.
//
// Two code paths, by tile width d:
//  * narrow (d <= kNarrowMax): one thread per row, the row in registers.
//    nbr / nw are 8- or 16-byte vector loads and the mask one word, issued
//    together; every label gather is issued before any is used; the
//    O(d^2) slot-order sums, max, hash and min run in registers, with no
//    shared memory and no shuffles.
//  * wide (d > kNarrowMax): one warp per row at a time.  A ballot + popc
//    prefix compacts the r real slots (in slot order), with their labels
//    and weights loaded in the same pass, into shared memory, so the work
//    is O(r) per row, never O(r * d).  For r <= kQuadMax each lane sums
//    its compacted slots over the r others in slot order (O(r^2) / 32 per
//    lane); above it the warp bitonic-sorts the (label, slot) keys in
//    registers (a stable order: slot breaks ties) and walks the sorted
//    keys, 32 at a time through shuffles, folding each label's run in
//    slot order (O(r log^2 r) / 32 per lane + r steps).
// Both paths add the same weights in the same order, so their floats are
// the bits of the plain slot-order sum on real weights too.

constexpr int kNarrowMax = 8;       // widest row on the one-thread path
constexpr int kNarrowThreads = 256;
constexpr int kQuadMax = 64;        // widest compacted row summed O(r^2)
constexpr int kWideSmemBytes = 49152;   // per block, no opt-in needed

struct Argmax {
  int best_lab;   // kSentinel when no label has weight > 0
  float best_w;   // clamped at 0
  float cur_w;    // summed weight of the row's own label
};

inline unsigned narrow_blocks(long long rows) {
  return (unsigned)((rows + kNarrowThreads - 1) / kNarrowThreads);
}

// One warp per row at a time; each warp holds 16 bytes per slot of its
// row's power-of-two capacity in shared memory (8 B keys, 4 B label, 4 B
// weight).  The grid is what fits on the card at once, and each warp walks
// the rows with a stride of all warps, so a warp whose row exits early
// (fused_move) or is short takes the next row instead of holding its
// block's shared memory idle.
struct WideLaunch {
  unsigned blocks;
  int threads;
  size_t smem;
  int cap;
};

// A wide row's slot capacity: the power of two >= d, at least a warp's 32
// (the kernels are instantiated per capacity / 32, the keys a lane sorts).
inline int wide_cap(int d) {
  int cap = 32;
  while (cap < d) cap <<= 1;
  return cap;
}

constexpr int kWideCapMax = 1024;   // ops.MAX_DEGREE

template <class Kernel>
inline WideLaunch wide_launch(Kernel kernel, long long rows, int d) {
  const int cap = wide_cap(d);
  const size_t per_warp = (size_t)cap * 16;
  int warps = (int)(kWideSmemBytes / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const int threads = 32 * warps;
  const size_t smem = (size_t)warps * per_warp;
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long need = (rows + warps - 1) / warps;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return {(unsigned)(need < fit ? need : fit), threads, smem, cap};
}

// --- narrow path: loads of one row of D slots into registers -----------

template <int D>
__device__ __forceinline__ void load_ids(const int* __restrict__ p,
                                         int (&v)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(p) + i);
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const int2 x = __ldcs(reinterpret_cast<const int2*>(p) + i);
      v[2 * i] = x.x; v[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = __ldcs(p + i);
  }
}

template <int D>
__device__ __forceinline__ void load_weights(const float* __restrict__ p,
                                             float (&w)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 x = __ldcs(reinterpret_cast<const float4*>(p) + i);
      w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const float2 x = __ldcs(reinterpret_cast<const float2*>(p) + i);
      w[2 * i] = x.x; w[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) w[i] = __ldcs(p + i);
  }
}

// The row's mask bytes as one 8-, 4- or 2-byte word where D allows.
template <int D>
__device__ __forceinline__ void load_mask(const unsigned char* __restrict__ p,
                                          bool (&m)[D]) {
  if constexpr (D == 8) {
    const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = (x.x >> (8 * i)) & 0xffu;
      m[4 + i] = (x.y >> (8 * i)) & 0xffu;
    }
  } else if constexpr (D == 4) {
    const unsigned x = __ldcs(reinterpret_cast<const unsigned*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = (x >> (8 * i)) & 0xffu;
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const unsigned short x =
          __ldcs(reinterpret_cast<const unsigned short*>(p) + i);
      m[2 * i] = x & 0xffu;
      m[2 * i + 1] = x >> 8;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) m[i] = __ldcs(p + i) != 0;
  }
}

// Every real slot's label gather issued before any is used; a masked slot
// gets kSentinel and gathers nothing.
template <int D>
__device__ __forceinline__ void gather_labels(const int* __restrict__ labels,
                                              const int (&v)[D],
                                              const bool (&m)[D],
                                              int (&lab)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) lab[j] = m[j] ? __ldg(labels + v[j]) : kSentinel;
}

// Any real slot whose neighbor changed.
template <int D>
__device__ __forceinline__ bool any_changed(const unsigned char* __restrict__ chg,
                                            const int (&v)[D],
                                            const bool (&m)[D]) {
  unsigned char c[D];
#pragma unroll
  for (int j = 0; j < D; ++j) c[j] = m[j] ? __ldg(chg + v[j]) : 0;
  bool any = false;
#pragma unroll
  for (int j = 0; j < D; ++j) any |= c[j] != 0;
  return any;
}

// The narrow row's argmax, all in registers.
template <int D>
__device__ __forceinline__ Argmax row_argmax(const int (&lab)[D],
                                             const float (&w)[D], int cur,
                                             int seed) {
  float s[D];
  float best = -1.f;
  float cw = -INFINITY;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) acc += (lab[j] == lab[k]) ? w[j] : 0.f;
    s[k] = acc;
    if (lab[k] != kSentinel) {
      best = fmaxf(best, acc);
      if (lab[k] == cur) cw = acc;
    }
  }
  int h[D];
  int bh = -1;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    h[k] = label_hash(lab[k], seed);
    if (lab[k] != kSentinel && best > 0.f && s[k] >= best) bh = max(bh, h[k]);
  }
  int bl = kSentinel;
#pragma unroll
  for (int k = 0; k < D; ++k)
    if (lab[k] != kSentinel && best > 0.f && s[k] >= best && h[k] == bh)
      bl = min(bl, lab[k]);
  return {bl, fmaxf(best, 0.f), cw == -INFINITY ? 0.f : cw};
}

// --- wide path: one warp per row ---------------------------------------

// A warp's shared memory for one row of capacity `cap` (wide_cap(d)):
// `key` holds cap 8-byte words, first as the compacted neighbor ids
// and slot indices (2 x cap ints), then as sort keys or scores.
struct WideRow {
  unsigned long long* key;
  int* lab;
  float* w;
  int r;   // real slots of the row (warp-uniform)

  __device__ __forceinline__ int* ids() { return reinterpret_cast<int*>(key); }
  __device__ __forceinline__ int* slots(int cap) { return ids() + cap; }
};

__device__ __forceinline__ WideRow wide_row(unsigned char* smem, int cap) {
  const int warp = threadIdx.x >> 5;
  unsigned char* base = smem + (size_t)warp * cap * 16;
  WideRow row;
  row.key = reinterpret_cast<unsigned long long*>(base);
  row.lab = reinterpret_cast<int*>(base + (size_t)cap * 8);
  row.w = reinterpret_cast<float*>(base + (size_t)cap * 12);
  row.r = 0;
  return row;
}

// Compact the row's real slots, in slot order, into ids() / slots().  With
// `labels` and `nw` (else null) each real slot's label gather and weight
// load are issued in the same pass, once its mask is in, and land in
// lab / w; with `chg` (else null) it returns whether any real neighbor
// changed.
__device__ __forceinline__ bool compact_row(
    const int* __restrict__ nbr, const unsigned char* __restrict__ nmask,
    const float* __restrict__ nw, const int* __restrict__ labels,
    const unsigned char* __restrict__ chg, long long row, int d, int cap,
    int lane, WideRow& wr) {
  const long long off = row * d;
  int* ids = wr.ids();
  int* slots = wr.slots(cap);
  int r = 0;
  bool any = false;
#pragma unroll 4
  for (int base = 0; base < d; base += 32) {
    const int j = base + lane;
    bool m = false;
    int v = 0;
    if (j < d) {
      m = __ldcs(nmask + off + j) != 0;
      v = __ldcs(nbr + off + j);
    }
    float w = 0.f;
    int lab = kSentinel;
    if (m) {
      if (nw != nullptr) w = __ldcs(nw + off + j);
      if (labels != nullptr) lab = __ldg(labels + v);
      if (chg != nullptr) any |= __ldg(chg + v) != 0;
    }
    const unsigned bal = __ballot_sync(kFull, m);
    if (m) {
      const int k = r + __popc(bal & ((1u << lane) - 1u));
      ids[k] = v;
      slots[k] = j;
      wr.w[k] = w;
      wr.lab[k] = lab;
    }
    r += __popc(bal);
  }
  wr.r = r;
  __syncwarp();
  return __any_sync(kFull, any);
}

// Gather the compacted slots' labels and weights (for a row whose need of
// them was known only after compact_row).
__device__ __forceinline__ void wide_gather(
    const float* __restrict__ nw, const int* __restrict__ labels,
    long long row, int d, int cap, int lane, WideRow& wr) {
  const int* ids = wr.ids();
  const int* slots = wr.slots(cap);
  const long long off = row * d;
  for (int k = lane; k < wr.r; k += 32) {
    wr.lab[k] = __ldg(labels + ids[k]);
    wr.w[k] = __ldcs(nw + off + slots[k]);
  }
  __syncwarp();
}

__device__ __forceinline__ int key_label(unsigned long long k) {
  return (int)((unsigned)(k >> 32) ^ 0x80000000u);
}

// max / hash / min over entries e < n with label lab(e) and score sc(e),
// where ok(e) says whether e is a candidate.  Every entry of one label
// carries the same score bits, so the own label's weight is any such
// entry's, and when all entries that reach the best weight carry one
// label, that label wins without the hash.
template <class Lab, class Score, class Ok>
__device__ __forceinline__ Argmax warp_finish(int n, int lane, int cur,
                                              int seed, Lab lab, Score sc,
                                              Ok ok) {
  float lmax = -1.f;
  float lcur = -INFINITY;
  for (int e = lane; e < n; e += 32) {
    if (!ok(e)) continue;
    const float s = sc(e);
    lmax = fmaxf(lmax, s);
    if (lab(e) == cur) lcur = s;
  }
  const float best = group_max(lmax, 32);
  const unsigned has_cur = __ballot_sync(kFull, lcur != -INFINITY);
  const float cw =
      has_cur ? __shfl_sync(kFull, lcur, __ffs(has_cur) - 1) : 0.f;
  // this lane's candidates: their one label, or `mixed`
  int first = kSentinel;
  bool mixed = false;
  if (best > 0.f) {
    for (int e = lane; e < n; e += 32) {
      if (!ok(e) || !(sc(e) >= best)) continue;
      const int l = lab(e);
      if (first == kSentinel) first = l;
      else if (l != first) mixed = true;
    }
  }
  const unsigned has = __ballot_sync(kFull, first != kSentinel);
  if (has == 0) return {kSentinel, fmaxf(best, 0.f), cw};
  const int one = __shfl_sync(kFull, first, __ffs(has) - 1);
  if (__all_sync(kFull, !mixed && (first == kSentinel || first == one)))
    return {one, fmaxf(best, 0.f), cw};
  int lh = -1;
  for (int e = lane; e < n; e += 32)
    if (ok(e) && sc(e) >= best) lh = max(lh, label_hash(lab(e), seed));
  const int bh = group_max(lh, 32);
  int lb = kSentinel;
  for (int e = lane; e < n; e += 32)
    if (ok(e) && sc(e) >= best && label_hash(lab(e), seed) == bh)
      lb = min(lb, lab(e));
  return {group_min(lb, 32), fmaxf(best, 0.f), cw};
}

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x >> 1);
}

__device__ __forceinline__ unsigned long long sort_key(int label, int slot) {
  return ((unsigned long long)((unsigned)label ^ 0x80000000u) << 32) |
         (unsigned)slot;
}

// Bitonic sort of 32 * K keys held in registers, K per lane: v[k] of lane
// L is element L * K + k of the network, so lane L ends with the sorted
// keys L*K .. L*K + K - 1.  Strides below K compare inside a lane, larger
// ones across lanes through shuffles; no shared memory.
template <int K>
__device__ __forceinline__ void warp_bitonic(unsigned long long (&v)[K],
                                             int lane) {
  constexpr int kLog = ilog2(32 * K);
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int size = 1 << ls;
      const int stride = 1 << lt;
      if (stride >= K) {   // partner: lane ^ (stride / K), same k
        const int lm = stride / K;
        const bool lower = (lane & lm) == 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool asc = ((lane * K + k) & size) == 0;
          const unsigned long long o = __shfl_xor_sync(kFull, v[k], lm);
          // the pair's lower element keeps the min when ascending
          v[k] = ((asc == lower) == (v[k] < o)) ? v[k] : o;
        }
      } else {             // partner: k ^ stride in the same lane
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k & stride) continue;
          const bool asc = ((lane * K + k) & size) == 0;
          const unsigned long long a = v[k], b = v[k + stride];
          const bool swap = asc == (a > b);
          v[k] = swap ? b : a;
          v[k + stride] = swap ? a : b;
        }
      }
    }
  }
}

// Sort the row's (label, slot) keys into wr.key[0 .. 32K): the slot makes
// every key unique, so the order is the stable one.
template <int K>
__device__ __forceinline__ void sort_row_keys(WideRow& wr, int lane) {
  unsigned long long v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {   // any start order: the network sorts all
    const int i = k * 32 + lane;
    v[k] = i < wr.r ? sort_key(wr.lab[i], i) : ~0ull;
  }
  warp_bitonic<K>(v, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) wr.key[lane * K + k] = v[k];
  __syncwarp();
}

// The smallest K <= CAPK with 32 * K >= r keys.
template <int K, int CAPK>
__device__ __forceinline__ void sort_row(WideRow& wr, int lane) {
  if constexpr (K < CAPK) {
    if (wr.r > 32 * K) {
      sort_row<2 * K, CAPK>(wr, lane);
      return;
    }
  }
  sort_row_keys<K>(wr, lane);
}

// The wide row's argmax over its r compacted slots (after wide_gather);
// CAPK = the row capacity / 32, the most keys a lane sorts.
template <int CAPK>
__device__ __forceinline__ Argmax row_argmax(WideRow& wr, int lane, int cur,
                                             int seed) {
  const int r = wr.r;
  const int* lab = wr.lab;
  const float* w = wr.w;
  if (r <= kQuadMax) {
    // each lane: its slots' sums over all r slots, in slot order
    float* score = reinterpret_cast<float*>(wr.key);
    for (int k = lane; k < r; k += 32) {
      const int lk = lab[k];
      float acc = 0.f;
      int j = 0;
      for (; j + 4 <= r; j += 4) {   // 16-byte loads; lab and w 16-aligned
        const int4 l4 = *reinterpret_cast<const int4*>(lab + j);
        const float4 w4 = *reinterpret_cast<const float4*>(w + j);
        acc += (l4.x == lk) ? w4.x : 0.f;
        acc += (l4.y == lk) ? w4.y : 0.f;
        acc += (l4.z == lk) ? w4.z : 0.f;
        acc += (l4.w == lk) ? w4.w : 0.f;
      }
      for (; j < r; ++j) acc += (lab[j] == lk) ? w[j] : 0.f;
      score[k] = acc;
    }
    __syncwarp();
    return warp_finish(
        r, lane, cur, seed, [&](int e) { return lab[e]; },
        [&](int e) { return score[e]; },
        [&](int e) { return lab[e] != kSentinel; });
  }
  sort_row<1, CAPK>(wr, lane);
  // each run's sum, folded in slot order: a warp-uniform walk over the
  // sorted keys, 32 at a time, each key's weight loaded by its lane; the
  // sums go over the labels, which the keys now hold
  const unsigned long long* key = wr.key;
  float* run = reinterpret_cast<float*>(wr.lab);
  int run_lab = key_label(key[0]);
  int start = 0;
  float acc = 0.f;
  for (int c = 0; c < r; c += 32) {
    const int p = c + lane;
    const unsigned long long kp = p < r ? key[p] : ~0ull;
    const int lp = key_label(kp);
    const float wp = p < r ? w[(unsigned)kp] : 0.f;
    const int n = min(32, r - c);
    for (int j = 0; j < n; ++j) {
      const int lj = __shfl_sync(kFull, lp, j);
      const float wj = __shfl_sync(kFull, wp, j);
      if (lj != run_lab) {
        if (lane == 0) run[start] = acc;
        acc = 0.f;
        run_lab = lj;
        start = c + j;
      }
      acc += wj;
    }
  }
  if (lane == 0) run[start] = acc;
  __syncwarp();
  return warp_finish(
      r, lane, cur, seed, [&](int e) { return key_label(key[e]); },
      [&](int e) { return run[e]; },
      [&](int e) {
        const int l = key_label(key[e]);
        return l != kSentinel && (e == 0 || key_label(key[e - 1]) != l);
      });
}

struct MinLabel {
  int min_lab;  // min label over real same-community neighbors (or kSentinel)
  int wake;     // any such neighbor changed (when chg given)
};

// Same-community neighbor minimum of one row.  `chg` may be null.
__device__ __forceinline__ MinLabel row_min(
    const int* __restrict__ nbr, const unsigned char* __restrict__ nmask,
    const int* __restrict__ labels, const int* __restrict__ comm,
    const unsigned char* __restrict__ chg, long long row, bool valid_row,
    int d, int g, int lane, int self_comm) {
  int lmin = kSentinel;
  int lwake = 0;
  if (valid_row) {
    for (int j = lane; j < d; j += g) {
      const long long idx = row * d + j;
      if (!nmask[idx]) continue;
      const int v = nbr[idx];
      if (comm[v] != self_comm) continue;
      lmin = min(lmin, labels[v]);
      if (chg != nullptr && chg[v]) lwake = 1;
    }
  }
  MinLabel out;
  out.min_lab = group_min(lmin, g);
  out.wake = group_max(lwake, g);
  return out;
}

}  // namespace lpa
