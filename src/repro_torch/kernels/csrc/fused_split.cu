// fused_split: lazy split-wake + min-label in one pass per split sweep.
//
// Replaces the TPU kernel src/repro/kernels/fused_sweep.py:fused_split_pallas
// (bodies _fused_split_prune_kernel and _fused_split_kernel).
//
// Bound on the card: HBM bytes, at every width.  min_label's bytes (mask
// tile, nbr of real cells, own label and community, 4 B out) and, with
// prune, the changed vector (1 B per vertex, gathered per real cell from
// L2): the 10 B/cell fused split of benchmarks/bench_roofline.py without
// the gathered tiles the TPU path writes first.  Integer compares only;
// latency, not arithmetic, is what a kernel has to hide (see
// min_label.cu).
//
// Design: the minimum is lpa::row_min (d <= 8, one thread per row) or
// lpa::row_min_wide (d > 8, a lane group per row), the same functions
// min_label runs, so fused and unfused split sweeps agree bit for bit.
// Each kernel is instantiated with and without prune.  With prune a
// slot's changed flag is gathered with its label, and the wake (a
// same-community neighbor changed last sweep) is folded with the
// minimum; without prune chg is a null pointer in the instance, which
// then compiles to min_label's code and never reads chg.
#include "lpa_common.cuh"

namespace {

template <int D, bool kPrune>
__global__ void __launch_bounds__(lpa::kNarrowThreads) fused_split_narrow_kernel(
    const int* __restrict__ nbr, const unsigned char* __restrict__ nmask,
    const int* __restrict__ labels, const int* __restrict__ comm,
    const unsigned char* __restrict__ chg, long long rows,
    int* __restrict__ out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int cur = __ldg(labels + row);
  const lpa::MinLabel m =
      lpa::row_min<D>(nbr, nmask, labels, comm, kPrune ? chg : nullptr, row);
  out[row] = (!kPrune || m.wake) ? min(cur, m.min_lab) : cur;
}

template <bool kPrune>
__global__ void __launch_bounds__(lpa::kThreads, lpa::kMinBlocks)
    fused_split_wide_kernel(
    const int* __restrict__ nbr, const unsigned char* __restrict__ nmask,
    const int* __restrict__ labels, const int* __restrict__ comm,
    const unsigned char* __restrict__ chg, long long rows, int d, int g,
    int* __restrict__ out) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / g;
  const bool valid_row = row < rows;
  const bool first = (threadIdx.x & (g - 1)) == 0;
  const int cur = (valid_row && first) ? __ldg(labels + row) : 0;
  const lpa::MinLabel m =
      lpa::row_min_wide(nbr, nmask, labels, comm, kPrune ? chg : nullptr,
                        row, valid_row, d, g);
  if (valid_row && first)
    out[row] = (!kPrune || m.wake) ? min(cur, m.min_lab) : cur;
}

template <bool kPrune>
void launch_split(const int* nbr, const unsigned char* nmask,
                  const int* labels, const int* comm,
                  const unsigned char* chg, long long rows, int d, int* out,
                  cudaStream_t s) {
#define LPA_NARROW(D)                                                    \
  case D:                                                                \
    fused_split_narrow_kernel<D, kPrune>                                 \
        <<<lpa::narrow_blocks(rows), lpa::kNarrowThreads, 0, s>>>(       \
            nbr, nmask, labels, comm, chg, rows, out);                   \
    break;
  switch (d) {
    LPA_NARROW(1) LPA_NARROW(2) LPA_NARROW(3) LPA_NARROW(4)
    LPA_NARROW(5) LPA_NARROW(6) LPA_NARROW(7) LPA_NARROW(8)
    default: {
      const int g = lpa::min_group(d);
      fused_split_wide_kernel<kPrune>
          <<<lpa::min_blocks(rows, g), lpa::kThreads, 0, s>>>(
              nbr, nmask, labels, comm, chg, rows, d, g, out);
    }
  }
#undef LPA_NARROW
}

static_assert(lpa::kNarrowMax == 8, "the switch above lists the widths");

}  // namespace

extern "C" int lpa_fused_split(const int* nbr, const unsigned char* nmask,
                               const int* labels, const int* comm,
                               const unsigned char* chg, int prune,
                               long long rows, int d, int* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (prune)
    launch_split<true>(nbr, nmask, labels, comm, chg, rows, d, out, s);
  else
    launch_split<false>(nbr, nmask, labels, comm, chg, rows, d, out, s);
  return (int)cudaGetLastError();
}
