// Device code of the stable stream compaction (kernel 1), shared with the
// fused merge-dedupe (kernel 3).  Three launches:
//   1. count_flags_kernel: flagged rows per tile of kTile rows;
//   2. scan_tiles_kernel:  exclusive scan of the tile counts (one block),
//                          which also yields the total;
//   3. scatter_kernel:     the tile in kItems rounds of kThreads consecutive
//                          rows (coalesced loads); a block scan of the flags
//                          ranks each round's flagged rows in row order
//                          (stable), and they are written to consecutive
//                          outputs (coalesced stores).
#pragma once

#include "common.cuh"

namespace tsx {
namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // rows per block
constexpr int kScanBlock = 1024;          // threads of the tile-scan block

__global__ void __launch_bounds__(kThreads)
    count_flags_kernel(const int32_t* __restrict__ flag, int64_t n,
                       int64_t* __restrict__ tile_counts) {
  __shared__ int warp_sums[2 * kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int c = 0;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < n && flag[i] != 0) ++c;
  }
  int total;
  block_inclusive_scan<kThreads>(c, warp_sums, 0, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// In-place exclusive scan of vals[0, n_tiles) by one block; thread t scans
// a contiguous chunk serially around one block scan of the chunk sums.
__global__ void __launch_bounds__(kScanBlock)
    scan_tiles_kernel(int64_t* __restrict__ vals, int64_t n_tiles,
                      int64_t* __restrict__ total_out) {
  __shared__ int64_t warp_sums[2 * kScanBlock / 32];
  const int64_t per = ceil_div(n_tiles, kScanBlock);
  const int64_t lo = min64(static_cast<int64_t>(threadIdx.x) * per, n_tiles);
  const int64_t hi = min64(lo + per, n_tiles);
  int64_t s = 0;
  for (int64_t i = lo; i < hi; ++i) s += vals[i];
  int64_t total;
  int64_t run = block_inclusive_scan<kScanBlock>(s, warp_sums, 0, &total) - s;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t v = vals[i];
    vals[i] = run;
    run += v;
  }
  if (threadIdx.x == 0 && total_out != nullptr) *total_out = total;
}

__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int32_t* __restrict__ flag, int64_t n,
                   const int64_t* __restrict__ tile_offsets, ColSet in,
                   ColSet out) {
  __shared__ int warp_sums[2 * kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t pos = tile_offsets[blockIdx.x];
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    const int f = i < n && flag[i] != 0;
    int round_total;
    const int rank = block_inclusive_scan<kThreads>(f, warp_sums, j,
                                                    &round_total) - f;
    if (f) copy_row(in, i, out, pos + rank);
    pos += round_total;
  }
}

// int64 scratch elements launch_compact needs for n rows.
inline int64_t compact_scratch_elems(int64_t n) {
  return ceil_div(n, kTile) + 1;
}

// Rows i with flag[i] != 0 of `in` go, in order, to rows [0, total) of
// `out`; total goes to *total_out (device) when it is not null.  n > 0.
inline void launch_compact(const int32_t* flag, const ColSet& in,
                           const ColSet& out, int64_t n, int64_t* scratch,
                           int64_t* total_out, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>(ceil_div(n, kTile));
  count_flags_kernel<<<tiles, kThreads, 0, stream>>>(flag, n, scratch);
  scan_tiles_kernel<<<1, kScanBlock, 0, stream>>>(scratch, tiles, total_out);
  scatter_kernel<<<tiles, kThreads, 0, stream>>>(flag, n, scratch, in, out);
}

}  // namespace
}  // namespace tsx
