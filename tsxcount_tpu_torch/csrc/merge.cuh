// Device code of the stable merge of two sorted runs (kernel 2); kernel 3
// (merge_dedupe.cu) shares the partition and the key compares.
//
// Keys are the first NK columns of each run: uint32 words, most significant
// first, compared as UNSIGNED values (a signed compare misorders keys whose
// top bit is set, e.g. a full-width key word at k % 16 == 0).  Ties take A
// first, and each run keeps its order, so the merge is stable.
//
//   1. merge_partition_kernel: for every tile boundary t*kMergeTile of the
//      output, a merge-path binary search over the diagonal gives the number
//      of A rows before it (a_starts[t]).
//   2. merge_tile_kernel: block t owns output rows [t*tile, (t+1)*tile).  It
//      stages its A and B key slices in shared memory, each thread finds its
//      own split of the tile by the same search and merges kMergeItems rows,
//      recording each row's source; then the block copies every column by
//      source with consecutive threads on consecutive outputs.
//   Blocks share nothing and run in any order.
#pragma once

#include "common.cuh"

namespace tsx {
namespace {

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 4;
constexpr int kMergeTile = kMergeThreads * kMergeItems;  // output rows/block
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

template <int NK>
__global__ void __launch_bounds__(kMergeThreads)
    merge_tile_kernel(ColSet a, ColSet b, ColSet out, int64_t m, int64_t n,
                      const int64_t* __restrict__ a_starts) {
  __shared__ uint32_t keys[NK][kMergeTile];  // A slice, then B slice
  __shared__ int64_t src[kMergeTile];        // >= 0: A row, < 0: ~B row
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kMergeTile;
  const int64_t a0 = a_starts[blockIdx.x];
  const int64_t a1 = a_starts[blockIdx.x + 1];
  const int64_t b0 = d0 - a0;
  const int len = static_cast<int>(min64(d0 + kMergeTile, m + n) - d0);
  const int la = static_cast<int>(a1 - a0);
  const int lb = len - la;
  for (int i = threadIdx.x; i < len; i += kMergeThreads) {
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      keys[c][i] = i < la
                       ? reinterpret_cast<const uint32_t*>(a.p[c])[a0 + i]
                       : reinterpret_cast<const uint32_t*>(b.p[c])[b0 + i - la];
    }
  }
  __syncthreads();
  const int d = min(static_cast<int>(threadIdx.x) * kMergeItems, len);
  int lo = max(0, d - lb);
  int hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (staged_le<NK>(keys, mid, la + d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo;
  int j = d - lo;
  const int end = min(d + kMergeItems, len);
  for (int q = d; q < end; ++q) {
    const bool take_a = j >= lb || (i < la && staged_le<NK>(keys, i, la + j));
    src[q] = take_a ? a0 + i++ : ~(b0 + j++);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < len; q += kMergeThreads) {
    const int64_t s = src[q];
    if (s >= 0) {
      copy_row(a, s, out, d0 + q);
    } else {
      copy_row(b, ~s, out, d0 + q);
    }
  }
}

// int64 scratch elements (the tile split points) for runs of m and n rows.
inline int64_t merge_scratch_elems(int64_t m, int64_t n) {
  return ceil_div(m + n, kMergeTile) + 1;
}

template <int NK>
void launch_merge_nk(const ColSet& a, const ColSet& b, const ColSet& out,
                     int64_t m, int64_t n, int64_t* a_starts,
                     cudaStream_t stream) {
  const int64_t tiles = ceil_div(m + n, kMergeTile);
  const int64_t n_diags = tiles + 1;
  merge_partition_kernel<NK>
      <<<static_cast<unsigned>(ceil_div(n_diags, 256)), 256, 0, stream>>>(
          a, b, m, n, n_diags, kMergeTile, a_starts);
  merge_tile_kernel<NK><<<static_cast<unsigned>(tiles), kMergeThreads, 0,
                          stream>>>(a, b, out, m, n, a_starts);
}

// Stable merge of A (m rows) and B (n rows) into out (m + n rows, > 0),
// keyed by the first n_keys columns.  False if n_keys is out of range.
inline bool launch_merge(int n_keys, const ColSet& a, const ColSet& b,
                         const ColSet& out, int64_t m, int64_t n,
                         int64_t* a_starts, cudaStream_t stream) {
  switch (n_keys) {
    case 1: launch_merge_nk<1>(a, b, out, m, n, a_starts, stream); return true;
    case 2: launch_merge_nk<2>(a, b, out, m, n, a_starts, stream); return true;
    case 3: launch_merge_nk<3>(a, b, out, m, n, a_starts, stream); return true;
    case 4: launch_merge_nk<4>(a, b, out, m, n, a_starts, stream); return true;
    case 5: launch_merge_nk<5>(a, b, out, m, n, a_starts, stream); return true;
    case 6: launch_merge_nk<6>(a, b, out, m, n, a_starts, stream); return true;
    case 7: launch_merge_nk<7>(a, b, out, m, n, a_starts, stream); return true;
    case 8: launch_merge_nk<8>(a, b, out, m, n, a_starts, stream); return true;
    default: return false;
  }
}

}  // namespace
}  // namespace tsx
