// label_argmax: the best neighboring label of every row (LPA move step).
//
// Replaces the TPU kernel src/repro/kernels/label_argmax.py:label_argmax_pallas
// (math in argmax_tile_math), which scores each slot through a D x D
// equality cube on the MXU.
//
// Bound on the card: HBM bytes, at every width.  Per row it must read the
// mask (d B) and the nbr and weight of each real cell (8 B), gather each
// real neighbor's label (4 B, from L2 while the label vector fits there)
// and write 12 B.  The least arithmetic is a sort of the row's r real
// labels, r * ceil(log2 r) compares: at r <= 512 well under the bytes'
// time.  What keeps a kernel far from that bound at d=4 is a chain of
// dependent round trips (mask, then nbr and weight, then the label), one
// cell per thread, and shared-memory staging and shuffles per row; at wide
// rows, scoring every slot against all d slots (O(r * d) shared-memory
// compares, ~230K per row at d=512) makes it bound by instructions.
//
// Design (lpa::row_argmax in lpa_common.cuh, shared with fused_move):
//  * d <= 8, the main path's width (d=4 on grid graphs): one thread per
//    row.  The mask word and the 16-byte nbr and weight vectors are loaded
//    together and unconditionally, then every label gather (read-only
//    path) is in flight at once: two dependent round trips per row.  The
//    slot-order sums, max, hash and min run in registers.  The wrapper
//    checks the tiles' 16-byte alignment.
//  * d > 8: one warp per row, each warp walking rows with a grid-wide
//    stride.  One pass loads the mask and nbr, and, predicated on the
//    mask, each real slot's weight and label, then compacts the real slots
//    by ballot + popc into shared memory: O(r) loads, no byte of a masked
//    cell's weight.  For r <= 64 (kQuadMax) each lane sums its slots over
//    the r others in slot order (O(r^2) / 32 per lane, 16-byte shared
//    loads); above, the warp bitonic-sorts the (label, slot) keys in
//    registers and walks the sorted keys to fold each label's run in slot
//    order (O(r log^2 r) / 32 per lane plus r shuffles), never O(r * d).
//    The threshold 64 was picked on the card (PERF.md, section 6): 32, 64
//    and 128 tie at d=64 and d=512.
// Both paths add each label's weights in slot order from 0.0, so the
// output bits are those of the plain slot-order sum, real weights
// included.
#include "lpa_common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(lpa::kNarrowThreads) label_argmax_narrow_kernel(
    const int* __restrict__ nbr, const float* __restrict__ nw,
    const unsigned char* __restrict__ nmask, const int* __restrict__ labels,
    long long rows, int seed, int* __restrict__ best_lab,
    float* __restrict__ best_w, float* __restrict__ cur_w) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  int v[D], lab[D];
  float w[D];
  bool m[D];
  lpa::load_mask<D>(nmask + row * D, m);
  lpa::load_ids<D>(nbr + row * D, v);
  lpa::load_weights<D>(nw + row * D, w);
  const int cur = __ldg(labels + row);
  lpa::gather_labels<D>(labels, v, m, lab);
  const lpa::Argmax a = lpa::row_argmax<D>(lab, w, cur, seed);
  best_lab[row] = a.best_lab;
  best_w[row] = a.best_w;
  cur_w[row] = a.cur_w;
}

template <int CAPK>
__global__ void label_argmax_wide_kernel(
    const int* __restrict__ nbr, const float* __restrict__ nw,
    const unsigned char* __restrict__ nmask, const int* __restrict__ labels,
    long long rows, int d, int cap, int seed, int* __restrict__ best_lab,
    float* __restrict__ best_w, float* __restrict__ cur_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * (blockDim.x >> 5);
  lpa::WideRow wr = lpa::wide_row(smem, cap);
  for (long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                       (threadIdx.x >> 5);
       row < rows; row += stride) {   // warp-uniform: one row per warp
    __syncwarp();   // the previous row's shared-memory reads are done
    lpa::compact_row(nbr, nmask, nw, labels, nullptr, row, d, cap, lane, wr);
    const lpa::Argmax a =
        lpa::row_argmax<CAPK>(wr, lane, __ldg(labels + row), seed);
    if (lane == 0) {
      best_lab[row] = a.best_lab;
      best_w[row] = a.best_w;
      cur_w[row] = a.cur_w;
    }
  }
}

template <int CAPK>
void launch_wide(const int* nbr, const float* nw, const unsigned char* nmask,
                 const int* labels, long long rows, int d, int seed,
                 int* best_lab, float* best_w, float* cur_w,
                 cudaStream_t stream) {
  const lpa::WideLaunch l =
      lpa::wide_launch(label_argmax_wide_kernel<CAPK>, rows, d);
  label_argmax_wide_kernel<CAPK><<<l.blocks, l.threads, l.smem, stream>>>(
      nbr, nw, nmask, labels, rows, d, l.cap, seed, best_lab, best_w, cur_w);
}

template <int D>
void launch_narrow(const int* nbr, const float* nw, const unsigned char* nmask,
                   const int* labels, long long rows, int seed, int* best_lab,
                   float* best_w, float* cur_w, cudaStream_t stream) {
  label_argmax_narrow_kernel<D>
      <<<lpa::narrow_blocks(rows), lpa::kNarrowThreads, 0, stream>>>(
          nbr, nw, nmask, labels, rows, seed, best_lab, best_w, cur_w);
}

static_assert(lpa::kNarrowMax == 8 && lpa::kWideCapMax == 1024,
              "the switches below list the narrow widths and capacities");

}  // namespace

extern "C" int lpa_label_argmax(const int* nbr, const float* nw,
                                const unsigned char* nmask, const int* labels,
                                long long rows, int d, int seed, int* best_lab,
                                float* best_w, float* cur_w, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define LPA_NARROW(D)                                                      \
  case D:                                                                  \
    launch_narrow<D>(nbr, nw, nmask, labels, rows, seed, best_lab, best_w, \
                     cur_w, s);                                            \
    break;
#define LPA_WIDE(K)                                                         \
  case K:                                                                   \
    launch_wide<K>(nbr, nw, nmask, labels, rows, d, seed, best_lab, best_w, \
                   cur_w, s);                                               \
    break;
  switch (d) {
    LPA_NARROW(1) LPA_NARROW(2) LPA_NARROW(3) LPA_NARROW(4)
    LPA_NARROW(5) LPA_NARROW(6) LPA_NARROW(7) LPA_NARROW(8)
    default:
      switch (lpa::wide_cap(d) / 32) {
        LPA_WIDE(1) LPA_WIDE(2) LPA_WIDE(4) LPA_WIDE(8) LPA_WIDE(16)
        LPA_WIDE(32)
      }
  }
#undef LPA_WIDE
#undef LPA_NARROW
  return (int)cudaGetLastError();
}
