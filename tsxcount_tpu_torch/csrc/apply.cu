// Kernels 4 and 5: the table backend's slot update and slot probe.
//
// Replace the TPU kernels apply_sorted_unique and gather_sorted
// (tsxcount_tpu/ops/pallas_apply.py).  A TPU cannot scatter or gather
// elements, so those kernels sweep the whole slot column tile by tile:
// each grid step finds its tile's run of sorted destinations, loads an
// aligned window of them, and routes values in and out of the tile through
// butterfly compaction and distribution networks, read-modify-writing the
// output window across sequential grid steps.  This card scatters and
// gathers natively, so none of that carries over: one thread per element
// (kernel 5 in a grid-stride loop).
//
// Contract (ops/apply.py).  dst2 int32[n]: element e is live iff dst2[e] is
// odd, and then addresses slot element dst2[e] >> 1 of a column of S
// uint32 words.  Live addresses outside [0, S) are ignored (memory safety;
// the callers never produce them).
//   gather_sorted:        out[e] = live ? col[dst2[e] >> 1] : 0; live
//                         addresses may repeat (every row of a run
//                         reads its slot).
//   apply_sorted_unique:  cols[c][dst2[e] >> 1] += vals[c][e] for live e
//                         and each of the C <= kMaxCols columns, in place,
//                         modulo 2^32.  Live addresses are unique, so no
//                         two threads touch one word and no atomics are
//                         needed.  One launch covers every column of a
//                         table round (the TPU kernel is called once per
//                         column): dst2 is read once, and a column word is
//                         read and written only where its value is not 0
//                         (adding 0 is the identity modulo 2^32).
// The TPU kernels also return a window-overflow count; there is no window
// here, and the wrapper returns a device zero in its place.
//
// Bound: device-memory bandwidth.  dst2, vals and out stream with coalesced
// 4-byte accesses; the slot columns are touched only at live addresses.
// Those ascend with e (the callers sort by slot), so the threads of a warp
// read or write nearby words where live elements are dense, but at the
// table path's densities (~12M live of 2^26 words) most warps still touch
// a separate 32-byte sector per live element, which is what keeps these
// kernels above the 4-byte bound.  Kernel 4 loads every value of an element
// before its first slot word, so the scattered reads of its columns are in
// flight together.
#include "common.cuh"

namespace tsx {
namespace {

constexpr int kApplyThreads = 256;
constexpr int64_t kApplyMaxBlocks = 132 * 16;  // 16 blocks on each SM

// The columns of one apply launch, passed by value.
struct ApplyCols {
  uint32_t* col[kMaxCols];
  const uint32_t* val[kMaxCols];
};

__global__ void __launch_bounds__(kApplyThreads)
    gather_sorted_kernel(const uint32_t* __restrict__ col, int64_t s,
                         const int32_t* __restrict__ dst2, int64_t n,
                         uint32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < n; e += stride) {
    const uint32_t d = static_cast<uint32_t>(dst2[e]);
    const int64_t a = d >> 1;
    out[e] = (d & 1u) && a < s ? col[a] : 0u;
  }
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

inline unsigned apply_blocks(int64_t n) {
  return static_cast<unsigned>(
      min64(ceil_div(n, kApplyThreads), kApplyMaxBlocks));
}

// Launches the instance for nc columns (1 <= nc <= kMaxCols).
template <int NC>
void launch_apply(int nc, const ApplyCols& c, int64_t s, const int32_t* dst2,
                  int64_t n, cudaStream_t stream) {
  if constexpr (NC < kMaxCols) {
    if (nc != NC) {
      launch_apply<NC + 1>(nc, c, s, dst2, n, stream);
      return;
    }
  }
  apply_sorted_unique_kernel<NC>
      <<<static_cast<unsigned>(ceil_div(n, kApplyThreads)), kApplyThreads, 0,
         stream>>>(c, s, dst2, n);
}

}  // namespace
}  // namespace tsx

extern "C" int tsx_gather_sorted(const void* col, int64_t s, const void* dst2,
                                 int64_t n, void* out, void* stream) {
  if (s < 0 || n < 0) return cudaErrorInvalidValue;
  if (n > 0) {
    tsx::gather_sorted_kernel<<<tsx::apply_blocks(n), tsx::kApplyThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(col), s,
        static_cast<const int32_t*>(dst2), n, static_cast<uint32_t*>(out));
  }
  return cudaGetLastError();
}

extern "C" int tsx_apply_sorted_unique(void* const* cols, void* const* vals,
                                       int n_cols, int64_t s,
                                       const void* dst2, int64_t n,
                                       void* stream) {
  if (n_cols < 1 || n_cols > tsx::kMaxCols || s < 0 || n < 0) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    tsx::ApplyCols c{};
    for (int k = 0; k < n_cols; ++k) {
      c.col[k] = static_cast<uint32_t*>(cols[k]);
      c.val[k] = static_cast<const uint32_t*>(vals[k]);
    }
    tsx::launch_apply<1>(n_cols, c, s, static_cast<const int32_t*>(dst2), n,
                         static_cast<cudaStream_t>(stream));
  }
  return cudaGetLastError();
}
