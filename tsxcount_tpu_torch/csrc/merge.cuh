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
//
// Key widths: the kernels are compiled for each width NK from 1 to
// kMaxFixedKeys (k <= 112, the k = 14 main path among them) and once more at
// NK = kMaxKeys for every wider key (k = 113-256), where they read the
// width nk at run time: arrays are sized for kMaxKeys and every loop over
// the key words stops at nk.  A fixed-width instantiation sees nk == NK at
// compile time (key_words), so its code is as if nk were not there.
#pragma once

#include "common.cuh"

namespace tsx {
namespace {

constexpr int kMaxFixedKeys = 8;  // widths compiled one by one
constexpr int kMaxKeys = 17;      // k = 256: 16 lanes + the invalid flag

// The key words an instantiation for NK compares: NK itself, or the width
// nk given at run time by the instantiation at kMaxKeys.
template <int NK>
__device__ __forceinline__ int key_words(int nk) {
  return NK <= kMaxFixedKeys ? NK : nk;
}

// Calls f(std::integral_constant<int, NK>{}) with NK = n_keys up to
// kMaxFixedKeys, else NK = kMaxKeys (1 <= n_keys <= kMaxKeys).
template <typename F>
void with_keys(int n_keys, F&& f) {
  if (n_keys <= kMaxFixedKeys) {
    with_cols<1, kMaxFixedKeys>(n_keys, f);
  } else {
    f(std::integral_constant<int, kMaxKeys>{});
  }
}

template <int NK>
__device__ __forceinline__ void load_key(const ColSet& s, int64_t i,
                                         uint32_t (&k)[NK], int nk) {
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (c < nk) k[c] = reinterpret_cast<const uint32_t*>(s.p[c])[i];
  }
}

template <int NK>
__device__ __forceinline__ bool key_le(const uint32_t (&a)[NK],
                                       const uint32_t (&b)[NK], int nk) {
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (c < nk && a[c] != b[c]) return a[c] < b[c];
  }
  return true;
}

// keys[.][x] <= keys[.][y] over the staged tile keys.
template <int NK, int T>
__device__ __forceinline__ bool staged_le(const uint32_t (&keys)[NK][T],
                                          int x, int y, int nk) {
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (c < nk && keys[c][x] != keys[c][y]) return keys[c][x] < keys[c][y];
  }
  return true;
}

// A rows of the tile whose output rows are [d0, d0 + len), given a0 =
// a_starts[t] and a_next = a_starts[t + 1]: a_next - a0 clamped to
// [0, len].  On sorted runs the clamp changes nothing.  Runs that break the
// order (a batch sorted only on its uniform prefix, until the counter reads
// its collision flag and recounts) can give split points that are not
// monotone; clamped, every tile still reads only rows of A and B (a0 and
// a_next each lie in [max(0, diag - n), min(diag, m)]), so the call
// returns unspecified rows instead of faulting the context.
__device__ __forceinline__ int tile_a_rows(int64_t a0, int64_t a_next,
                                           int len) {
  return static_cast<int>(max64(0, min64(a_next - a0, len)));
}

// a_starts[t] = A rows before output row t * tile, for t < n_diags.
template <int NK>
__global__ void merge_partition_kernel(ColSet a, ColSet b, int64_t m,
                                       int64_t n, int64_t n_diags,
                                       int64_t tile, int n_keys,
                                       int64_t* __restrict__ a_starts) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_diags) return;
  const int nk = key_words<NK>(n_keys);
  const int64_t diag = min64(t * tile, m + n);
  int64_t lo = max64(0, diag - n);
  int64_t hi = min64(diag, m);
  uint32_t ka[NK], kb[NK];
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    load_key<NK>(a, mid, ka, nk);
    load_key<NK>(b, diag - 1 - mid, kb, nk);
    if (key_le<NK>(ka, kb, nk)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  a_starts[t] = lo;
}

}  // namespace
}  // namespace tsx
