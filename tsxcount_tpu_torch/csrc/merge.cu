// Kernel 2: stable merge of two sorted runs (merge path).
//
// Replaces the TPU kernel merge_sorted with merge_path_partition
// (tsxcount_tpu/ops/pallas_merge.py).  That kernel loads 1024-aligned DMA
// windows, takes B globally reversed (Mosaic has no reverse) and sorts each
// window pair with a bitonic network of log2(4*tile) stages, with MAX_KEY
// pads and a global-index column to make the order total.  None of that is
// needed here: the merge-path split points make every output tile
// independent, and a thread merges its few rows sequentially (merge.cuh).
//
// Bound: device-memory bandwidth.  Each input row is read about twice (key
// staging, then the column copy) and each output row written once; the
// binary searches touch O(log n) rows per tile and thread.
//
// Contract (ops/merge.py): a and b hold n_cols columns (int32 or int64, the
// same width for a column in both runs) of m and n rows; the first n_keys
// (1..8) are uint32 key words, most significant first, each run ascending
// under the unsigned lexicographic order.  out gets the m + n merged rows.

#include "merge.cuh"

extern "C" int64_t tsx_merge_scratch_elems(int64_t m, int64_t n) {
  return tsx::merge_scratch_elems(m, n);
}

extern "C" int tsx_merge_sorted(void* const* a, void* const* b,
                                void* const* out, const int* widths,
                                int n_cols, int n_keys, int64_t m, int64_t n,
                                void* scratch, void* stream) {
  if (n_cols < 1 || n_cols > tsx::kMaxCols || n_keys < 1 ||
      n_keys > tsx::kMaxKeys || n_keys > n_cols || m < 0 || n < 0) {
    return cudaErrorInvalidValue;
  }
  if (m + n > 0) {
    tsx::launch_merge(n_keys, tsx::make_colset(a, widths, n_cols),
                      tsx::make_colset(b, widths, n_cols),
                      tsx::make_colset(out, widths, n_cols), m, n,
                      static_cast<int64_t*>(scratch),
                      static_cast<cudaStream_t>(stream));
  }
  return cudaGetLastError();
}
