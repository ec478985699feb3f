// Pieces shared by the port's kernels: column sets, a block-wide scan and
// small index helpers.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace tsx {

constexpr int kMaxCols = 16;

// Up to kMaxCols device columns of 4- or 8-byte elements (key words are
// uint32 bit patterns, counts int64), passed to kernels by value.
struct ColSet {
  char* p[kMaxCols];
  int w[kMaxCols];
  int n;
};

inline ColSet make_colset(void* const* ptrs, const int* widths, int n) {
  ColSet s{};
  s.n = n;
  for (int c = 0; c < n; ++c) {
    s.p[c] = static_cast<char*>(ptrs[c]);
    s.w[c] = widths[c];
  }
  return s;
}

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

inline size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// dst row di = src row si, every column.  (Unrolling this loop over
// kMaxCols made the merge kernel 1.8x slower on an H100: keep it rolled.)
__device__ __forceinline__ void copy_row(const ColSet& src, int64_t si,
                                         const ColSet& dst, int64_t di) {
  for (int c = 0; c < src.n; ++c) {
    if (src.w[c] == 8) {
      reinterpret_cast<int64_t*>(dst.p[c])[di] =
          reinterpret_cast<const int64_t*>(src.p[c])[si];
    } else {
      reinterpret_cast<int32_t*>(dst.p[c])[di] =
          reinterpret_cast<const int32_t*>(src.p[c])[si];
    }
  }
}

// Inclusive prefix sum of one value per thread over a block of NT threads:
// a shuffle scan inside each warp, then the warp totals through shared
// memory.  `warp_sums` holds 2 * NT / 32 values; callers alternate `round`
// between calls, so one barrier per call suffices (a warp cannot reach the
// next call that writes the same half before every warp has passed this
// call's barrier and read it).  *total receives the block's sum.  Every
// thread of the block must call it.
template <int NT, typename T>
__device__ __forceinline__ T block_inclusive_scan(T v, T* warp_sums,
                                                  int round, T* total) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  T* sums = warp_sums + (round & 1) * kWarps;
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  T before = 0;
  T all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T s = sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + v;
}

}  // namespace tsx
