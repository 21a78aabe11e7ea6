// label_argmax: the best neighboring label of every row (LPA move step).
//
// Replaces the TPU kernel src/repro/kernels/label_argmax.py:label_argmax_pallas
// (math in argmax_tile_math), which scores each slot through a D x D
// equality cube on the MXU.
//
// Bound on the card: HBM bytes.  Per neighbor cell it reads the nbr id (4 B),
// the weight (4 B) and the mask (1 B), and gathers the neighbor's label
// (4 B, mostly from L2 on graphs with locality) — about 9 B/cell of tile
// streams against 11 B/cell for the TPU path's gathered tiles plus its
// separate wake pass (benchmarks/bench_roofline.py).  Per row it writes
// 12 B.  The arithmetic is O(D^2) compares per row, far below the card's
// rate for the degree-bounded graphs the tile backend takes.
//
// Design: the label gather happens inside the kernel, so the (rows, D)
// label tile never goes through HBM.  A group of g = min(32, pow2(D)) lanes
// owns a row: loads are contiguous across the warp, the row's slots are
// staged in shared memory, and the max / hash / min tie-break chain is a
// shuffle reduction inside the group.  Masked slots skip their nbr and
// weight loads.
#include "lpa_common.cuh"

namespace {

__global__ void __launch_bounds__(lpa::kThreads) label_argmax_kernel(
    const int* __restrict__ nbr, const float* __restrict__ nw,
    const unsigned char* __restrict__ nmask, const int* __restrict__ labels,
    long long rows, int d, int g, int seed, int* __restrict__ best_lab,
    float* __restrict__ best_w, float* __restrict__ cur_w) {
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
  const lpa::Argmax a = lpa::row_argmax(nbr, nw, nmask, labels, nullptr, row,
                                        valid_row, d, g, lane, cur, seed,
                                        s_lab, s_w, s_score);
  if (valid_row && lane == 0) {
    best_lab[row] = a.best_lab;
    best_w[row] = a.best_w;
    cur_w[row] = a.cur_w;
  }
}

}  // namespace

extern "C" int lpa_label_argmax(const int* nbr, const float* nw,
                                const unsigned char* nmask, const int* labels,
                                long long rows, int d, int seed, int* best_lab,
                                float* best_w, float* cur_w, void* stream) {
  const int g = lpa::group_lanes(d);
  const size_t smem = (size_t)(lpa::kThreads / g) * d * 3 * sizeof(int);
  label_argmax_kernel<<<lpa::grid_blocks(rows, g), lpa::kThreads, smem,
                        (cudaStream_t)stream>>>(nbr, nw, nmask, labels, rows,
                                                d, g, seed, best_lab, best_w,
                                                cur_w);
  return (int)cudaGetLastError();
}
