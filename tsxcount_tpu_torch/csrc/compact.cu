// Kernel 1: stable stream compaction of flagged rows.
//
// Replaces the TPU kernel compact_flagged (tsxcount_tpu/ops/pallas_compact.py),
// which compacts each tile with a butterfly routing network in VMEM and
// read-modify-writes 1024-aligned output windows across sequential grid
// steps.  Blocks on this card run in any order, so the design here is the
// classic count / scan / scatter (compact.cuh): no block depends on another
// block's writes, only on the scanned tile offsets.
//
// Bound: device-memory bandwidth.  The flags are read twice and every column
// once, and only flagged rows are written; there is no arithmetic to speak
// of.  Each block walks its tile in rounds of 256 consecutive rows, so loads
// are coalesced and a round's flagged rows land at consecutive outputs; the
// ranks come from a warp-shuffle block scan (one barrier per round).
//
// Contract (ops/compact.py): flag int32[n]; up to 16 columns of int32 or
// int64 [n]; outputs [n] whose rows [0, sum(flag != 0)) are the flagged rows
// in order; the rest is left unwritten.

#include "compact.cuh"

extern "C" int64_t tsx_compact_scratch_elems(int64_t n) {
  return tsx::compact_scratch_elems(n);
}

extern "C" int tsx_compact_flagged(const void* flag, void* const* in,
                                   void* const* out, const int* widths,
                                   int n_cols, int64_t n, void* scratch,
                                   void* stream) {
  if (n_cols < 1 || n_cols > tsx::kMaxCols || n < 0) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    tsx::launch_compact(static_cast<const int32_t*>(flag),
                        tsx::make_colset(in, widths, n_cols),
                        tsx::make_colset(out, widths, n_cols), n,
                        static_cast<int64_t*>(scratch), nullptr,
                        static_cast<cudaStream_t>(stream));
  }
  return cudaGetLastError();
}

extern "C" const char* tsx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
