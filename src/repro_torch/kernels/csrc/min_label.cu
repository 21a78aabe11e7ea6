// min_label: the Split-Last min-label sweep (Algorithm 1 body) of every row.
//
// Replaces the TPU kernel src/repro/kernels/min_label.py:min_label_pallas.
//
// Bound on the card: HBM bytes, at every width.  Per row it must read the
// mask (d B) and the nbr id of each real cell (4 B), its own label and
// community (8 B), and write 4 B; each real cell's community, and its
// label where the communities match, are gathered (from L2 while the
// vectors fit there).  Integer compares only.  What keeps a kernel from
// that bound is latency and gather requests: a lane that walks its slots
// through the chain mask -> nbr -> community -> compare -> label has one
// gather in flight and four round trips per slot, and a gather of a
// random neighbor id costs an L2 sector request of its own.
//
// Design (lpa::row_min / row_min_wide in lpa_common.cuh, shared with
// fused_split):
//  * d <= 8, the main path's width (d=4 on grid graphs): one thread per
//    row, instantiated per width.  The mask word, then the nbr vector
//    (8- or 16-byte loads; the wrapper checks the tiles' alignment) and
//    the own community, then every community and label gather of the
//    row's real slots at once, predicated on the mask only, so no label
//    gather waits for the compare (neighboring rows of a mesh gather
//    from shared sectors, so the extra label gathers cost little).  The
//    minimum runs in registers: no shuffles, no shared memory.  A padding
//    row (mask word zero) reads only its mask and own label.
//  * d > 8: a group of min_group(d) lanes per row, lane l on slots l,
//    l + g, ... (8 per step), so each instruction reads, and gathers
//    through, g consecutive slots of a row: coalesced where a row's ids
//    are sorted and close.  Per step all community gathers are in flight
//    at once, then all label gathers of the slots whose community
//    matched; the group's minima meet in shuffles.
// The community and label gathers happen inside the kernel, so the two
// (rows, D) tiles the TPU path builds in HBM before every call are never
// written.
#include "lpa_common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(lpa::kNarrowThreads) min_label_narrow_kernel(
    const int* __restrict__ nbr, const unsigned char* __restrict__ nmask,
    const int* __restrict__ labels, const int* __restrict__ comm,
    long long rows, int* __restrict__ out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int cur = __ldg(labels + row);
  const lpa::MinLabel m =
      lpa::row_min<D>(nbr, nmask, labels, comm, nullptr, row);
  out[row] = min(cur, m.min_lab);
}

__global__ void __launch_bounds__(lpa::kThreads, lpa::kMinBlocks)
    min_label_wide_kernel(
    const int* __restrict__ nbr, const unsigned char* __restrict__ nmask,
    const int* __restrict__ labels, const int* __restrict__ comm,
    long long rows, int d, int g, int* __restrict__ out) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / g;
  const bool valid_row = row < rows;
  const bool first = (threadIdx.x & (g - 1)) == 0;
  const int cur = (valid_row && first) ? __ldg(labels + row) : 0;
  const lpa::MinLabel m = lpa::row_min_wide(nbr, nmask, labels, comm,
                                            nullptr, row, valid_row, d, g);
  if (valid_row && first) out[row] = min(cur, m.min_lab);
}

void launch(const int* nbr, const unsigned char* nmask, const int* labels,
            const int* comm, long long rows, int d, int* out,
            cudaStream_t s) {
#define LPA_NARROW(D)                                                    \
  case D:                                                                \
    min_label_narrow_kernel<D>                                           \
        <<<lpa::narrow_blocks(rows), lpa::kNarrowThreads, 0, s>>>(       \
            nbr, nmask, labels, comm, rows, out);                        \
    break;
  switch (d) {
    LPA_NARROW(1) LPA_NARROW(2) LPA_NARROW(3) LPA_NARROW(4)
    LPA_NARROW(5) LPA_NARROW(6) LPA_NARROW(7) LPA_NARROW(8)
    default: {
      const int g = lpa::min_group(d);
      min_label_wide_kernel<<<lpa::min_blocks(rows, g), lpa::kThreads, 0,
                              s>>>(nbr, nmask, labels, comm, rows, d, g,
                                   out);
    }
  }
#undef LPA_NARROW
}

static_assert(lpa::kNarrowMax == 8, "the switch above lists the widths");

}  // namespace

extern "C" int lpa_min_label(const int* nbr, const unsigned char* nmask,
                             const int* labels, const int* comm,
                             long long rows, int d, int* out, void* stream) {
  launch(nbr, nmask, labels, comm, rows, d, out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
