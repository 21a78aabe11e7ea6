// fused_move: lazy wake + label argmax + adopt rule in one pass per sub-sweep.
//
// Replaces the TPU kernel src/repro/kernels/fused_sweep.py:fused_move_pallas.
//
// Bound on the card: HBM bytes.  Per neighbor cell: nbr id 4 B, weight 4 B,
// mask 1 B, plus the gathered label (4 B) and changed flag (1 B), which come
// mostly from L2 on graphs with locality — the "10 B/cell fused against
// 11 B/cell separate" of benchmarks/bench_roofline.py, minus the gathered
// tiles the TPU path writes and re-reads.  Per row: 4 state bytes and the
// current label in, 5 B out.
//
// Design: the argmax is lpa::row_argmax, the very function label_argmax
// runs, so fused and unfused sweeps give bit-identical float sums and
// decisions.  The wake (any real neighbor changed last sub-sweep) is folded
// into the same staging loop that gathers the neighbor labels, so the tiles
// are read once.
#include "lpa_common.cuh"

namespace {

__global__ void __launch_bounds__(lpa::kThreads) fused_move_kernel(
    const int* __restrict__ nbr, const float* __restrict__ nw,
    const unsigned char* __restrict__ nmask, const int* __restrict__ labels,
    const unsigned char* __restrict__ chg,
    const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ cand_prev,
    const unsigned char* __restrict__ klass,
    const unsigned char* __restrict__ real, long long rows, int d, int g,
    int seed, int* __restrict__ new_labels, unsigned char* __restrict__ act_out) {
  extern __shared__ unsigned char smem[];
  const int per_block = lpa::kThreads / g;
  const int local = threadIdx.x / g;
  const int lane = threadIdx.x & (g - 1);
  const long long row = (long long)blockIdx.x * per_block + local;
  const bool valid_row = row < rows;

  int* s_lab = reinterpret_cast<int*>(smem) + local * d;
  float* s_w = reinterpret_cast<float*>(smem) + (per_block + local) * d;
  float* s_score = reinterpret_cast<float*>(smem) + (2 * per_block + local) * d;

  const int cur = valid_row ? labels[row] : lpa::kSentinel;
  const lpa::Argmax a = lpa::row_argmax(nbr, nw, nmask, labels, chg, row,
                                        valid_row, d, g, lane, cur, seed,
                                        s_lab, s_w, s_score);
  if (valid_row && lane == 0) {
    const bool act = (active[row] && !cand_prev[row]) || (a.wake && real[row]);
    const bool adopt = act && klass[row] && a.best_w > fmaxf(a.cur_w, 0.f);
    new_labels[row] = adopt ? a.best_lab : cur;
    act_out[row] = act ? 1 : 0;
  }
}

}  // namespace

extern "C" int lpa_fused_move(const int* nbr, const float* nw,
                              const unsigned char* nmask, const int* labels,
                              const unsigned char* chg,
                              const unsigned char* active,
                              const unsigned char* cand_prev,
                              const unsigned char* klass,
                              const unsigned char* real, long long rows, int d,
                              int seed, int* new_labels,
                              unsigned char* act_out, void* stream) {
  const int g = lpa::group_lanes(d);
  const size_t smem = (size_t)(lpa::kThreads / g) * d * 3 * sizeof(int);
  fused_move_kernel<<<lpa::grid_blocks(rows, g), lpa::kThreads, smem,
                      (cudaStream_t)stream>>>(nbr, nw, nmask, labels, chg,
                                              active, cand_prev, klass, real,
                                              rows, d, g, seed, new_labels,
                                              act_out);
  return (int)cudaGetLastError();
}
