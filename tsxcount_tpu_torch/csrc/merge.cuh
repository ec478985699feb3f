// Device code shared by the stable merge of two sorted runs (kernel 2,
// merge.cu) and the merge-dedupe (kernel 3, merge_dedupe.cu): the key
// compares and the merge-path partition of the output into tiles.
//
// Keys are the first NK columns of each run: uint32 words, most significant
// first, compared as UNSIGNED values (a signed compare misorders keys whose
// top bit is set, e.g. a full-width key word at k % 16 == 0).  Ties take A
// first, and each run keeps its order, so a merge is stable.
//
// merge_partition_kernel: for every tile boundary t * tile of the output, a
// merge-path binary search over the diagonal gives the number of A rows
// before it (a_starts[t]); tile t then merges A[a_starts[t], a_starts[t+1])
// with the B rows of the same output range, independently of every other
// tile.
#pragma once

#include "common.cuh"

namespace tsx {
namespace {

constexpr int kMaxKeys = 8;

template <int NK>
__device__ __forceinline__ void load_key(const ColSet& s, int64_t i,
                                         uint32_t (&k)[NK]) {
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    k[c] = reinterpret_cast<const uint32_t*>(s.p[c])[i];
  }
}

template <int NK>
__device__ __forceinline__ bool key_le(const uint32_t (&a)[NK],
                                       const uint32_t (&b)[NK]) {
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (a[c] != b[c]) return a[c] < b[c];
  }
  return true;
}

// keys[.][x] <= keys[.][y] over the staged tile keys.
template <int NK, int T>
__device__ __forceinline__ bool staged_le(const uint32_t (&keys)[NK][T],
                                          int x, int y) {
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (keys[c][x] != keys[c][y]) return keys[c][x] < keys[c][y];
  }
  return true;
}

// a_starts[t] = A rows before output row t * tile, for t < n_diags.
template <int NK>
__global__ void merge_partition_kernel(ColSet a, ColSet b, int64_t m,
                                       int64_t n, int64_t n_diags,
                                       int64_t tile,
                                       int64_t* __restrict__ a_starts) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_diags) return;
  const int64_t diag = min64(t * tile, m + n);
  int64_t lo = max64(0, diag - n);
  int64_t hi = min64(diag, m);
  uint32_t ka[NK], kb[NK];
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    load_key<NK>(a, mid, ka);
    load_key<NK>(b, diag - 1 - mid, kb);
    if (key_le<NK>(ka, kb)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  a_starts[t] = lo;
}

}  // namespace
}  // namespace tsx
