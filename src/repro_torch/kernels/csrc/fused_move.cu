// fused_move: lazy wake + label argmax + adopt rule in one pass per sub-sweep.
//
// Replaces the TPU kernel src/repro/kernels/fused_sweep.py:fused_move_pallas.
//
// Bound on the card: HBM bytes, at every width.  Per row it must read its
// four state bytes and current label and write 5 B.  Only a row that can
// adopt (act && klass) needs the argmax's bytes: mask, nbr and weight of
// its real cells plus the gathered labels.  Only a row whose act is not
// known from its state (not active && !cand_prev, and real) needs the
// wake: mask, nbr and the gathered changed flags of its real cells.  The
// arithmetic is label_argmax's.  Running the wake and the argmax on every
// row would make a sub-sweep cost the same late in a fit, with few rows
// active, as on the first.  At d=4 the rows of the parity class
// interleave with the others, so a 32-byte sector of nbr / weights holds
// one needed and one skipped row: the skipped rows save few bytes there.
//
// Design: the argmax is lpa::row_argmax, the very function label_argmax
// runs (one thread per row for d <= 8, one warp per row above; see
// label_argmax.cu), so fused and unfused sweeps give bit-identical float
// sums and decisions.  Early exits, per row:
//  * active && !cand_prev: act = 1 without the wake, no chg gathers;
//  * !(act && klass): no weight loads, no label gathers, no argmax;
//    new_labels = labels[row].
// A row known to need the argmax loads its tile and gathers at once; a
// row that needs the wake loads mask and nbr once, and its weights and
// labels only once woken.
#include "lpa_common.cuh"

namespace {

struct RowState {
  int cur;
  bool known;      // active && !cand_prev: act without the wake
  bool klass;
  bool need_wake;  // act depends on the wake
};

__device__ __forceinline__ RowState row_state(
    const int* __restrict__ labels, const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ cand_prev,
    const unsigned char* __restrict__ klass,
    const unsigned char* __restrict__ real, long long row) {
  RowState st;
  st.cur = __ldg(labels + row);
  st.known = __ldg(active + row) && !__ldg(cand_prev + row);
  st.klass = __ldg(klass + row) != 0;
  st.need_wake = !st.known && __ldg(real + row);
  return st;
}

template <int D>
__global__ void __launch_bounds__(lpa::kNarrowThreads) fused_move_narrow_kernel(
    const int* __restrict__ nbr, const float* __restrict__ nw,
    const unsigned char* __restrict__ nmask, const int* __restrict__ labels,
    const unsigned char* __restrict__ chg,
    const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ cand_prev,
    const unsigned char* __restrict__ klass,
    const unsigned char* __restrict__ real, long long rows, int seed,
    int* __restrict__ new_labels, unsigned char* __restrict__ act_out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const RowState st = row_state(labels, active, cand_prev, klass, real, row);
  bool act = st.known;
  int out = st.cur;
  if (st.need_wake || (st.known && st.klass)) {
    int v[D], lab[D];
    float w[D];
    bool m[D];
    lpa::load_mask<D>(nmask + row * D, m);
    lpa::load_ids<D>(nbr + row * D, v);
    if (st.known)   // then klass: the weights are needed, load them now
      lpa::load_weights<D>(nw + row * D, w);
    if (st.need_wake) {
      act = lpa::any_changed<D>(chg, v, m);
      if (act && st.klass) lpa::load_weights<D>(nw + row * D, w);
    }
    if (act && st.klass) {
      lpa::gather_labels<D>(labels, v, m, lab);
      const lpa::Argmax a = lpa::row_argmax<D>(lab, w, st.cur, seed);
      if (a.best_w > fmaxf(a.cur_w, 0.f)) out = a.best_lab;
    }
  }
  new_labels[row] = out;
  act_out[row] = act ? 1 : 0;
}

template <int CAPK>
__global__ void fused_move_wide_kernel(
    const int* __restrict__ nbr, const float* __restrict__ nw,
    const unsigned char* __restrict__ nmask, const int* __restrict__ labels,
    const unsigned char* __restrict__ chg,
    const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ cand_prev,
    const unsigned char* __restrict__ klass,
    const unsigned char* __restrict__ real, long long rows, int d, int cap,
    int seed, int* __restrict__ new_labels,
    unsigned char* __restrict__ act_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * (blockDim.x >> 5);
  lpa::WideRow wr = lpa::wide_row(smem, cap);
  for (long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                       (threadIdx.x >> 5);
       row < rows; row += stride) {   // warp-uniform: one row per warp
    // every lane reads the row's state, so each branch is warp-uniform
    const RowState st =
        row_state(labels, active, cand_prev, klass, real, row);
    bool act = st.known;
    int out = st.cur;
    if (st.need_wake || (st.known && st.klass)) {
      __syncwarp();   // the previous row's shared-memory reads are done
      if (st.need_wake) {   // the wake first; the argmax's loads if woken
        act = lpa::compact_row(nbr, nmask, nullptr, nullptr, chg, row, d,
                               cap, lane, wr);
        if (act && st.klass)
          lpa::wide_gather(nw, labels, row, d, cap, lane, wr);
      } else {              // known && klass: the argmax's loads at once
        lpa::compact_row(nbr, nmask, nw, labels, nullptr, row, d, cap, lane,
                         wr);
      }
      if (act && st.klass) {
        const lpa::Argmax a = lpa::row_argmax<CAPK>(wr, lane, st.cur, seed);
        if (a.best_w > fmaxf(a.cur_w, 0.f)) out = a.best_lab;
      }
    }
    if (lane == 0) {
      new_labels[row] = out;
      act_out[row] = act ? 1 : 0;
    }
  }
}

template <int CAPK>
void launch_wide(const int* nbr, const float* nw, const unsigned char* nmask,
                 const int* labels, const unsigned char* chg,
                 const unsigned char* active, const unsigned char* cand_prev,
                 const unsigned char* klass, const unsigned char* real,
                 long long rows, int d, int seed, int* new_labels,
                 unsigned char* act_out, cudaStream_t stream) {
  const lpa::WideLaunch l =
      lpa::wide_launch(fused_move_wide_kernel<CAPK>, rows, d);
  fused_move_wide_kernel<CAPK><<<l.blocks, l.threads, l.smem, stream>>>(
      nbr, nw, nmask, labels, chg, active, cand_prev, klass, real, rows, d,
      l.cap, seed, new_labels, act_out);
}

template <int D>
void launch_narrow(const int* nbr, const float* nw, const unsigned char* nmask,
                   const int* labels, const unsigned char* chg,
                   const unsigned char* active, const unsigned char* cand_prev,
                   const unsigned char* klass, const unsigned char* real,
                   long long rows, int seed, int* new_labels,
                   unsigned char* act_out, cudaStream_t stream) {
  fused_move_narrow_kernel<D>
      <<<lpa::narrow_blocks(rows), lpa::kNarrowThreads, 0, stream>>>(
          nbr, nw, nmask, labels, chg, active, cand_prev, klass, real, rows,
          seed, new_labels, act_out);
}

static_assert(lpa::kNarrowMax == 8 && lpa::kWideCapMax == 1024,
              "the switches below list the narrow widths and capacities");

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
  const cudaStream_t s = (cudaStream_t)stream;
#define LPA_NARROW(D)                                                     \
  case D:                                                                 \
    launch_narrow<D>(nbr, nw, nmask, labels, chg, active, cand_prev,      \
                     klass, real, rows, seed, new_labels, act_out, s);    \
    break;
#define LPA_WIDE(K)                                                    \
  case K:                                                              \
    launch_wide<K>(nbr, nw, nmask, labels, chg, active, cand_prev,     \
                   klass, real, rows, d, seed, new_labels, act_out, s); \
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
