// min_label: the Split-Last min-label sweep (Algorithm 1 body) of every row.
//
// Replaces the TPU kernel src/repro/kernels/min_label.py:min_label_pallas.
//
// Bound on the card: HBM bytes.  Per neighbor cell: nbr id 4 B and mask 1 B
// from the tiles, plus the neighbor's community and label (8 B, gathered,
// mostly from L2 on graphs with locality).  Per row: own label and
// community in, 4 B out.  Integer compares only.
//
// Design: the community and label gathers happen inside the kernel, so the
// two (rows, D) tiles the TPU path builds in HBM before every call are never
// written.  A group of g = min(32, pow2(D)) lanes owns a row and reduces
// with shuffles; the minimum is lpa::row_min, shared with fused_split.
#include "lpa_common.cuh"

namespace {

__global__ void __launch_bounds__(lpa::kThreads) min_label_kernel(
    const int* __restrict__ nbr, const unsigned char* __restrict__ nmask,
    const int* __restrict__ labels, const int* __restrict__ comm,
    long long rows, int d, int g, int* __restrict__ out) {
  const int per_block = lpa::kThreads / g;
  const int lane = threadIdx.x & (g - 1);
  const long long row = (long long)blockIdx.x * per_block + threadIdx.x / g;
  const bool valid_row = row < rows;
  const int self_comm = valid_row ? comm[row] : 0;
  const lpa::MinLabel m = lpa::row_min(nbr, nmask, labels, comm, nullptr, row,
                                       valid_row, d, g, lane, self_comm);
  if (valid_row && lane == 0) out[row] = min(labels[row], m.min_lab);
}

}  // namespace

extern "C" int lpa_min_label(const int* nbr, const unsigned char* nmask,
                             const int* labels, const int* comm,
                             long long rows, int d, int* out, void* stream) {
  const int g = lpa::group_lanes(d);
  min_label_kernel<<<lpa::grid_blocks(rows, g), lpa::kThreads, 0,
                     (cudaStream_t)stream>>>(nbr, nmask, labels, comm, rows, d,
                                             g, out);
  return (int)cudaGetLastError();
}
