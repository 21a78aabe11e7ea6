// Shared device code of the four LPA kernels (label_argmax, fused_move,
// min_label, fused_split).
//
// Layout: the neighbor tiles are row-major (rows, d) — nbr int32, nw float32,
// nmask uint8 — and the per-vertex vectors (labels, comm, chg) are gathered
// through nbr inside the kernels.  A row is owned by a group of g lanes,
// g = the power of two >= d, capped at 32, so one warp covers 32 / g rows
// and the loads of a warp are contiguous.  Every thread of a block runs every
// shuffle: rows past the end only carry valid_row = false.
//
// row_argmax is the one argmax of label_argmax and fused_move, and row_min
// the one same-community minimum of min_label and fused_split, so fused and
// unfused sweeps compute bit-identical results.
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

struct Argmax {
  int best_lab;   // kSentinel when no label has weight > 0
  float best_w;   // clamped at 0
  float cur_w;    // summed weight of the row's own label
  int wake;       // any real slot whose neighbor changed (when chg given)
};

// Best label of one row.  s_lab / s_w / s_score hold d slots of shared
// memory for this row.  A masked slot is staged as (kSentinel, 0): it adds
// nothing to any real label's sum and is never a candidate.  Each slot's
// score is summed over the row's slots in slot order, so every slot of one
// label gets the same bits.  `chg` may be null (no wake).
__device__ __forceinline__ Argmax row_argmax(
    const int* __restrict__ nbr, const float* __restrict__ nw,
    const unsigned char* __restrict__ nmask, const int* __restrict__ labels,
    const unsigned char* __restrict__ chg, long long row, bool valid_row,
    int d, int g, int lane, int cur, int seed, int* s_lab, float* s_w,
    float* s_score) {
  int lwake = 0;
  for (int j = lane; j < d; j += g) {
    int lab = kSentinel;
    float w = 0.f;
    if (valid_row) {
      const long long idx = row * d + j;
      if (nmask[idx]) {
        const int v = nbr[idx];
        lab = labels[v];
        w = nw[idx];
        if (chg != nullptr && chg[v]) lwake = 1;
      }
    }
    s_lab[j] = lab;
    s_w[j] = w;
  }
  __syncwarp();

  float lmax = -1.f;
  float lcur = -INFINITY;
  for (int k = lane; k < d; k += g) {
    const int lk = s_lab[k];
    if (lk == kSentinel) continue;
    float s = 0.f;
    for (int j = 0; j < d; ++j) s += (s_lab[j] == lk) ? s_w[j] : 0.f;
    s_score[k] = s;
    lmax = fmaxf(lmax, s);
    if (lk == cur) lcur = s;
  }
  __syncwarp();
  const float best_w = group_max(lmax, g);
  const float cur_w = group_max(lcur, g);

  int lh = -1;
  for (int k = lane; k < d; k += g) {
    const int lk = s_lab[k];
    if (lk != kSentinel && best_w > 0.f && s_score[k] >= best_w)
      lh = max(lh, label_hash(lk, seed));
  }
  const int best_h = group_max(lh, g);

  int lbest = kSentinel;
  for (int k = lane; k < d; k += g) {
    const int lk = s_lab[k];
    if (lk != kSentinel && best_w > 0.f && s_score[k] >= best_w &&
        label_hash(lk, seed) == best_h)
      lbest = min(lbest, lk);
  }

  Argmax out;
  out.best_lab = group_min(lbest, g);
  out.best_w = fmaxf(best_w, 0.f);
  out.cur_w = cur_w == -INFINITY ? 0.f : cur_w;
  out.wake = group_max(lwake, g);
  return out;
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
