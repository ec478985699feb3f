// Kernel 3: merge two sorted (key, count) runs and reduce every run of equal
// keys to one row holding the exact 64-bit sum of its counts.
//
// Replaces the TPU kernel merge_dedupe_sorted
// (tsxcount_tpu/ops/pallas_merge_dedupe.py).  That kernel runs the merge
// network, run flags, a carry-aware segmented sum and a butterfly compaction
// inside each tile, and carries the open run's key, its partial sum and the
// output frontier in SMEM from one SEQUENTIAL grid step to the next.  Blocks
// on this card run in any order and carry nothing, so the reduction is
// rebuilt from order-free passes:
//   1. merge both runs into scratch with kernel 2's device code (merge.cuh);
//   2. an inclusive 64-bit prefix sum S of the merged counts, with a flag on
//      every row that ends a run of equal keys (sum_counts_kernel, the tile
//      scan of compact.cuh, prefix_and_ends_kernel);
//   3. compact the run-end rows' keys and S with kernel 1's device code;
//   4. each run's total is the difference of consecutive compacted S values
//      (run_totals_kernel) — exact modulo 2^64 at any fan-in, so one key may
//      span any number of tiles.
//
// Bound: device-memory bandwidth.  The merged rows make a round trip through
// device memory (about 4 passes over M+N rows of n_keys + 2 words); keeping
// them on chip, e.g. with a decoupled look-back over (open key, partial sum,
// emitted count), is a later, measured change.
//
// Contract (ops/merge_dedupe.py): a and b hold n_keys (1..8) uint32 key words,
// most significant first, then one int64 count column; both runs ascending
// under the unsigned lexicographic order, with invalid rows forming one
// constant run at the end whose first key word is >= inv_min.  out gets the
// n_runs distinct keys ascending with their summed counts (rows beyond are
// unwritten); stats[0] = n_runs, stats[1] = n_runs less the trailing invalid
// run if there is one.

#include "compact.cuh"
#include "merge.cuh"

namespace tsx {
namespace {

__global__ void __launch_bounds__(kThreads)
    sum_counts_kernel(const int64_t* __restrict__ cnt, int64_t n,
                      int64_t* __restrict__ tile_sums) {
  __shared__ int64_t warp_sums[2 * kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t s = 0;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < n) s += cnt[i];
  }
  int64_t total;
  block_inclusive_scan<kThreads>(s, warp_sums, 0, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// cnt becomes its inclusive prefix sum (in place: each row is read and
// written by one thread), in kItems rounds of kThreads consecutive rows;
// ends[i] = 1 where row i ends a run of equal keys.  `keys` holds the
// n_keys merged key columns.
__global__ void __launch_bounds__(kThreads)
    prefix_and_ends_kernel(ColSet keys, int64_t* __restrict__ cnt, int64_t n,
                           const int64_t* __restrict__ tile_offsets,
                           int32_t* __restrict__ ends) {
  __shared__ int64_t warp_sums[2 * kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t run = tile_offsets[blockIdx.x];
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    const int64_t v = i < n ? cnt[i] : 0;
    int64_t round_total;
    const int64_t incl = block_inclusive_scan<kThreads>(v, warp_sums, j,
                                                        &round_total);
    if (i < n) {
      cnt[i] = run + incl;
      bool end = i + 1 == n;
#pragma unroll
      for (int c = 0; c < kMaxKeys; ++c) {
        if (c >= keys.n || end) break;
        const int32_t* col = reinterpret_cast<const int32_t*>(keys.p[c]);
        end = col[i] != col[i + 1];
      }
      ends[i] = end ? 1 : 0;
    }
    run += round_total;
  }
}

// out_cnt[j] = S[end_j] - S[end_{j-1}] for the n_runs = stats[0] compacted
// run ends; stats[1] = n_runs without the trailing invalid run.
__global__ void run_totals_kernel(const int64_t* __restrict__ ends_s,
                                  int64_t* __restrict__ out_cnt,
                                  const int32_t* __restrict__ out_msb,
                                  uint32_t inv_min, int64_t* stats) {
  const int64_t n_runs = stats[0];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j == 0) {
    const bool invalid_last =
        n_runs > 0 && static_cast<uint32_t>(out_msb[n_runs - 1]) >= inv_min;
    stats[1] = n_runs - (invalid_last ? 1 : 0);
  }
  if (j < n_runs) out_cnt[j] = ends_s[j] - (j > 0 ? ends_s[j - 1] : 0);
}

// Scratch regions, carved from one byte buffer (base == nullptr: sizes only).
struct Scratch {
  int64_t* a_starts;
  int32_t* keys[kMaxKeys];
  int64_t* cnt;
  int32_t* ends;
  int64_t* tile_vals;
  int64_t* ends_s;
  size_t bytes;
};

Scratch carve(char* base, int n_keys, int64_t m, int64_t n) {
  const int64_t total = m + n;
  Scratch s{};
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    char* p = base == nullptr ? nullptr : base + off;
    off = align256(off + bytes);
    return p;
  };
  s.a_starts = reinterpret_cast<int64_t*>(take(merge_scratch_elems(m, n) * 8));
  for (int c = 0; c < n_keys; ++c) {
    s.keys[c] = reinterpret_cast<int32_t*>(take(total * 4));
  }
  s.cnt = reinterpret_cast<int64_t*>(take(total * 8));
  s.ends = reinterpret_cast<int32_t*>(take(total * 4));
  s.tile_vals = reinterpret_cast<int64_t*>(take(compact_scratch_elems(total) * 8));
  s.ends_s = reinterpret_cast<int64_t*>(take(total * 8));
  s.bytes = off;
  return s;
}

}  // namespace
}  // namespace tsx

extern "C" int64_t tsx_merge_dedupe_scratch_bytes(int n_keys, int64_t m,
                                                  int64_t n) {
  return static_cast<int64_t>(tsx::carve(nullptr, n_keys, m, n).bytes);
}

extern "C" int tsx_merge_dedupe_sorted(void* const* a, void* const* b,
                                       void* const* out, int n_keys,
                                       int64_t m, int64_t n, uint32_t inv_min,
                                       void* stats, void* scratch,
                                       void* stream) {
  using namespace tsx;
  if (n_keys < 1 || n_keys > kMaxKeys || m < 0 || n < 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t* stat = static_cast<int64_t*>(stats);
  const int64_t total = m + n;
  if (total == 0) {
    cudaMemsetAsync(stat, 0, 2 * sizeof(int64_t), st);
    return cudaGetLastError();
  }
  const int n_cols = n_keys + 1;
  int widths[kMaxCols];
  for (int c = 0; c < n_keys; ++c) widths[c] = 4;
  widths[n_keys] = 8;
  const Scratch s = carve(static_cast<char*>(scratch), n_keys, m, n);
  void* merged[kMaxCols];
  for (int c = 0; c < n_keys; ++c) merged[c] = s.keys[c];
  merged[n_keys] = s.cnt;
  void* compacted[kMaxCols];
  for (int c = 0; c < n_keys; ++c) compacted[c] = out[c];
  compacted[n_keys] = s.ends_s;

  const ColSet merged_cols = make_colset(merged, widths, n_cols);
  launch_merge(n_keys, make_colset(a, widths, n_cols),
               make_colset(b, widths, n_cols), merged_cols, m, n, s.a_starts,
               st);
  const unsigned tiles = static_cast<unsigned>(ceil_div(total, kTile));
  sum_counts_kernel<<<tiles, kThreads, 0, st>>>(s.cnt, total, s.tile_vals);
  scan_tiles_kernel<<<1, kScanBlock, 0, st>>>(s.tile_vals, tiles, nullptr);
  prefix_and_ends_kernel<<<tiles, kThreads, 0, st>>>(
      make_colset(merged, widths, n_keys), s.cnt, total, s.tile_vals, s.ends);
  launch_compact(s.ends, merged_cols, make_colset(compacted, widths, n_cols),
                 total, s.tile_vals, stat, st);
  run_totals_kernel<<<static_cast<unsigned>(ceil_div(total, 256)), 256, 0,
                      st>>>(s.ends_s, static_cast<int64_t*>(out[n_keys]),
                            static_cast<const int32_t*>(out[0]), inv_min,
                            stat);
  return cudaGetLastError();
}
