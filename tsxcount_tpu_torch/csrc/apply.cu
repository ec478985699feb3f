// Kernels 4 and 5: the table backend's slot update and slot probe.
//
// Replace the TPU kernels apply_sorted_unique and gather_sorted
// (tsxcount_tpu/ops/pallas_apply.py).  A TPU cannot scatter or gather
// elements, so those kernels sweep the whole slot column tile by tile:
// each grid step finds its tile's run of sorted destinations, loads an
// aligned window of them, and routes values in and out of the tile through
// butterfly compaction and distribution networks, read-modify-writing the
// output window across sequential grid steps.  This card scatters and
// gathers natively, so none of that carries over.  The TPU kernels take one
// column a call; here one launch covers every column of a table round, so
// dst2 is read once.
//
// Contract (ops/apply.py).  dst2 int32[n]: element e is live iff dst2[e] is
// odd, and then addresses slot element dst2[e] >> 1 of each column of S
// uint32 words.  Live addresses outside [0, S) are ignored (memory safety;
// the callers never produce them).  C <= kMaxApplyCols columns a call.
//   gather_sorted:        outs[c][e] = live ? cols[c][dst2[e] >> 1] : 0;
//                         live addresses may repeat (every row of a run
//                         reads its slot).
//   apply_sorted_unique:  cols[c][dst2[e] >> 1] += vals[c][e] for live e,
//                         in place, modulo 2^32.  Live addresses are
//                         unique, so no two threads touch one word and no
//                         atomics are needed.  A column word is read and
//                         written only where its value is not 0 (adding 0
//                         is the identity modulo 2^32).
// The TPU kernels also return a window-overflow count; there is no window
// here, and the wrapper returns a device zero in its place.
//
// Bound: device-memory bandwidth.  dst2, vals and outs stream coalesced;
// the slot columns are touched only at live addresses.  Those ascend with
// e (the callers sort by slot), so the threads of a warp read or write
// nearby words where live elements are dense, but at the table path's
// densities (~12M live of 2^26 words) most warps still touch a separate
// 32-byte sector per live element, which is what keeps these kernels above
// the 4-byte bound.  Both kernels issue every slot load of a thread before
// its first store, so the scattered reads are in flight together, one
// element a thread: kernel 4 loads its values first; kernel 5 loads no slot
// word for a dead element.  At the main round a column's live words fall
// in 78 % of its 32-byte sectors and ~95 % of its 64-byte segments, so
// kernel 5's scattered reads come close to reading whole columns; one
// launch per round saves dst2's second read and a launch, not the
// columns' bytes.
#include "common.cuh"

namespace tsx {
namespace {

constexpr int kApplyThreads = 256;
// A whole slot's columns: slot_cols = lanes + 4 is 20 at k = 256 (16 key
// lanes, 3 count digits, the used flag).  A split round probes lanes + 1
// columns (kernel 5: 17 at k = 241-256) and applies lanes + 3 (kernel 4,
// the digit-2 column left out: 17-19 at k = 209-256), so every round is one
// launch of each kernel at any k.  v[NC] and old[NC] stay in registers at
// every width (nvcc 12.8, sm_90a, under __launch_bounds__(256)): kernel 5
// takes 32 registers a thread at NC = 1-20, kernel 4 48 at NC = 16-17, 60
// at 18, 58 at 19 and 62 at 20, with no stack frame or local memory in
// either (chip_smoke.py phase 2 checks this on every build).
constexpr int kMaxApplyCols = 20;

// The columns of one apply launch, passed by value (320 bytes of kernel
// parameters at 20 columns, inside the 4 KB limit).
struct ApplyCols {
  uint32_t* col[kMaxApplyCols];
  const uint32_t* val[kMaxApplyCols];
};

// The columns of one gather launch, passed by value.
struct GatherCols {
  const uint32_t* col[kMaxApplyCols];
  uint32_t* out[kMaxApplyCols];
};

// One element per thread, like kernel 4.  Two consecutive elements a
// thread, with 8-byte dst2 and output accesses and a scalar path for
// ragged ends, came within 0.5 % of it on the main round's two-column call
// on an H100 (0.2371 ms against 0.2381, medians of 21; 4 a thread was 4 %
// slower than 2), so the kernel keeps the plain form.
template <int NC>
__global__ void __launch_bounds__(kApplyThreads)
    gather_sorted_kernel(GatherCols c, int64_t s,
                         const int32_t* __restrict__ dst2, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  const uint32_t d = static_cast<uint32_t>(dst2[e]);
  const int64_t a = d >> 1;
  const bool live = (d & 1u) && a < s;
  uint32_t v[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) v[k] = live ? __ldg(c.col[k] + a) : 0u;
#pragma unroll
  for (int k = 0; k < NC; ++k) c.out[k][e] = v[k];
}

// One element per thread: a grid capped at 16 blocks per SM, walked with
// a stride, ran the main round 12 % slower on an H100.
template <int NC>
__global__ void __launch_bounds__(kApplyThreads)
    apply_sorted_unique_kernel(ApplyCols c, int64_t s,
                               const int32_t* __restrict__ dst2, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  const uint32_t d = static_cast<uint32_t>(dst2[e]);
  const int64_t a = d >> 1;
  if (!(d & 1u) || a >= s) return;
  uint32_t v[NC];
  uint32_t old[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) v[k] = c.val[k][e];
#pragma unroll
  for (int k = 0; k < NC; ++k) old[k] = v[k] != 0u ? c.col[k][a] : 0u;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (v[k] != 0u) c.col[k][a] = old[k] + v[k];  // wraps modulo 2^32
  }
}

}  // namespace
}  // namespace tsx

extern "C" int tsx_gather_sorted(const void* const* cols, void* const* outs,
                                 int n_cols, int64_t s, const void* dst2,
                                 int64_t n, void* stream) {
  using namespace tsx;
  if (n_cols < 1 || n_cols > kMaxApplyCols || s < 0 || n < 0) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    GatherCols c{};
    for (int k = 0; k < n_cols; ++k) {
      c.col[k] = static_cast<const uint32_t*>(cols[k]);
      c.out[k] = static_cast<uint32_t*>(outs[k]);
    }
    const unsigned blocks =
        static_cast<unsigned>(ceil_div(n, kApplyThreads));
    const int32_t* d = static_cast<const int32_t*>(dst2);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    with_cols<1, kMaxApplyCols>(n_cols, [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      gather_sorted_kernel<NC><<<blocks, kApplyThreads, 0, st>>>(c, s, d, n);
    });
  }
  return cudaGetLastError();
}

extern "C" int tsx_apply_sorted_unique(void* const* cols, void* const* vals,
                                       int n_cols, int64_t s,
                                       const void* dst2, int64_t n,
                                       void* stream) {
  using namespace tsx;
  if (n_cols < 1 || n_cols > kMaxApplyCols || s < 0 || n < 0) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    ApplyCols c{};
    for (int k = 0; k < n_cols; ++k) {
      c.col[k] = static_cast<uint32_t*>(cols[k]);
      c.val[k] = static_cast<const uint32_t*>(vals[k]);
    }
    const unsigned blocks =
        static_cast<unsigned>(ceil_div(n, kApplyThreads));
    const int32_t* d = static_cast<const int32_t*>(dst2);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    with_cols<1, kMaxApplyCols>(n_cols, [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      apply_sorted_unique_kernel<NC><<<blocks, kApplyThreads, 0, st>>>(c, s,
                                                                      d, n);
    });
  }
  return cudaGetLastError();
}
