// Pieces shared by the port's kernels: column sets, aligned vectors, a
// block-wide scan and small index helpers.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace tsx {

// Columns of one call: the batch dedupe compacts up to 17 key operands and
// a position (k = 256), the store merge 17 key words and a count.
constexpr int kMaxCols = 18;

// Calls f(std::integral_constant<int, NC>{}) for NC == nc, 1 <= nc <=
// Max: a kernel templated on its column count, picked at run time.
template <int NC = 1, int Max = kMaxCols, typename F>
void with_cols(int nc, F&& f) {
  if constexpr (NC < Max) {
    if (nc != NC) {
      with_cols<NC + 1, Max>(nc, f);
      return;
    }
  }
  f(std::integral_constant<int, NC>{});
}

// N consecutive T, aligned to their size, so that one access moves them
// all (a 16-byte vector load or store for 4 words).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename V>
__host__ __device__ __forceinline__ bool aligned_for(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % sizeof(V) == 0;
}

// v = p[r, r + N) as one vector load where `vec` (p aligned for Vec<T, N>)
// and every row is below n; else row by row, 0 at and past n.
template <typename T, int N>
__device__ __forceinline__ void load_rows(const T* p, int64_t r, int64_t n,
                                          bool vec, T (&v)[N]) {
  if (vec && r + N <= n) {
    const Vec<T, N> q = *reinterpret_cast<const Vec<T, N>*>(p + r);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = q.v[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = r + i < n ? p[r + i] : T(0);
  }
}

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

// Inclusive prefix sum of one value per thread over a block of NT threads:
// a shuffle scan inside each warp, then the warp totals through shared
// memory (`warp_sums`, NT / 32 values; one barrier, so a second call on the
// same `warp_sums` needs a barrier before it).  *total receives the
// block's sum.  Every thread of the block must call it.
template <int NT, typename T>
__device__ __forceinline__ T block_inclusive_scan(T v, T* warp_sums,
                                                  T* total) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  T before = 0;
  T all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + v;
}

}  // namespace tsx
