// fused_split: lazy split-wake + min-label in one pass per split sweep.
//
// Replaces the TPU kernel src/repro/kernels/fused_sweep.py:fused_split_pallas
// (bodies _fused_split_prune_kernel and _fused_split_kernel).
//
// Bound on the card: HBM bytes.  Per neighbor cell: nbr id 4 B and mask 1 B
// from the tiles, plus the neighbor's community, label and (with prune)
// changed flag, 9 B gathered, mostly from L2 on graphs with locality — the
// 10 B/cell fused split of benchmarks/bench_roofline.py without the
// gathered tiles the TPU path writes first.  Per row: 8 B in, 4 B out.
//
// Design: the minimum is lpa::row_min, the same function min_label runs, so
// fused and unfused split sweeps agree bit for bit.  With prune the wake
// (any same-community neighbor changed last sweep) is taken in the same loop;
// without prune chg is never read.
#include "lpa_common.cuh"

namespace {

__global__ void __launch_bounds__(lpa::kThreads) fused_split_kernel(
    const int* __restrict__ nbr, const unsigned char* __restrict__ nmask,
    const int* __restrict__ labels, const int* __restrict__ comm,
    const unsigned char* __restrict__ chg, int prune, long long rows, int d,
    int g, int* __restrict__ out) {
  const int per_block = lpa::kThreads / g;
  const int lane = threadIdx.x & (g - 1);
  const long long row = (long long)blockIdx.x * per_block + threadIdx.x / g;
  const bool valid_row = row < rows;
  const int self_comm = valid_row ? comm[row] : 0;
  const lpa::MinLabel m =
      lpa::row_min(nbr, nmask, labels, comm, prune ? chg : nullptr, row,
                   valid_row, d, g, lane, self_comm);
  if (valid_row && lane == 0) {
    const int cur = labels[row];
    const int mres = min(cur, m.min_lab);
    out[row] = (!prune || m.wake) ? mres : cur;
  }
}

}  // namespace

extern "C" int lpa_fused_split(const int* nbr, const unsigned char* nmask,
                               const int* labels, const int* comm,
                               const unsigned char* chg, int prune,
                               long long rows, int d, int* out, void* stream) {
  const int g = lpa::group_lanes(d);
  fused_split_kernel<<<lpa::grid_blocks(rows, g), lpa::kThreads, 0,
                       (cudaStream_t)stream>>>(nbr, nmask, labels, comm, chg,
                                               prune, rows, d, g, out);
  return (int)cudaGetLastError();
}
