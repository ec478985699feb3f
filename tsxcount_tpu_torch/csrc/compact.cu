// Kernel 1: stable stream compaction of flagged rows, in one pass.
//
// Replaces the TPU kernel compact_flagged (tsxcount_tpu/ops/pallas_compact.py),
// which compacts each tile with a butterfly routing network in VMEM and
// read-modify-writes 1024-aligned output windows across sequential grid
// steps.  Blocks on this card run in any order, so a tile learns where its
// output starts from the tiles before it through a decoupled look-back
// (lookback.cuh, shared with kernel 3): one launch after one memset (the
// tile counter and the statuses), and the flags are read once.
//
// A block takes the next tile of kTile rows from an atomic counter.  The
// tile is kRounds rounds of kThreads * kVec consecutive rows, and a thread
// holds kVec consecutive rows of every round, so each column is read with
// one vector load per round, neighbouring threads on neighbouring
// addresses.  A thread's flags become a bit mask and its flagged-row
// counts of the rounds four 16-bit fields of one 64-bit word, so ONE block
// scan of those words ranks every flagged row of the tile in row order
// (stable).  The tile publishes its count; then, column by column, each
// thread drops its flagged values into shared memory at their ranks and
// the block writes the tile's rows out as one contiguous range (coalesced
// stores), the first column once warp 0's look-back has given the tile's
// output offset.  Output positions depend on the flags alone, so repeated
// calls give identical outputs whatever order the tiles finish in.
//
// Bound: device-memory bandwidth.  Each flag and each column value is read
// once and each flagged value written once; the statuses are O(tiles)
// (32 KB at 2^24 rows).
//
// Contract (ops/compact.py): flag int32 or uint8 (torch.bool) [n], a row
// flagged where != 0; up to kMaxCols (18) columns of int32 or int64 [n]
// (a column aligned for its vector load takes it, another one scalar
// loads, e.g. an offset view); outputs [n] whose rows [0, sum(flag != 0)) are the flagged
// rows in order; the rest is left unwritten.

#include "lookback.cuh"

namespace tsx {
namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                     // consecutive rows a thread loads
constexpr int kRounds = 4;                  // 16-bit fields of a packed count
constexpr int kRoundRows = kThreads * kVec;
constexpr int kTile = kRoundRows * kRounds;  // 4096 rows
static_assert(kRoundRows < (1 << 16), "a round's count must fit 16 bits");

__device__ __forceinline__ int field(uint64_t packed, int j) {
  return static_cast<int>((packed >> (16 * j)) & 0xffffu);
}

// Every flagged value of column p among this thread's rows (round j: from
// row r0 + j * kRoundRows) goes to stage[off[j] + its rank in the round].
template <typename T>
__device__ __forceinline__ void stage_column(const T* p, int64_t r0,
                                             int64_t n, unsigned mask,
                                             const int (&off)[kRounds],
                                             T* stage) {
  const bool vec = aligned_for<Vec<T, kVec>>(p);
  T v[kRounds][kVec];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    load_rows(p, r0 + j * kRoundRows, n, vec, v[j]);
  }
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    int o = off[j];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (mask >> (j * kVec + i) & 1u) stage[o++] = v[j][i];
    }
  }
}

template <typename T>
__device__ __forceinline__ void write_range(const T* stage, int count,
                                            char* out, int64_t at) {
  T* o = reinterpret_cast<T*>(out) + at;
  for (int q = threadIdx.x; q < count; q += kThreads) o[q] = stage[q];
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const F* __restrict__ flag, int64_t n, ColSet in,
                   ColSet out, unsigned* tile_counter, uint64_t* status) {
  __shared__ uint64_t stage[kTile];  // one column's flagged rows (32 KB)
  __shared__ uint64_t warp_sums[kThreads / 32];
  __shared__ int64_t tile_sh, before_sh;
  const int tid = threadIdx.x;
  if (tid == 0) tile_sh = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const int64_t t = tile_sh;
  const int64_t r0 = t * kTile + tid * kVec;

  // bit j * kVec + i of mask: row r0 + j * kRoundRows + i is flagged
  const bool fvec = aligned_for<Vec<F, kVec>>(flag);
  unsigned mask = 0;
  uint64_t packed = 0;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    F f[kVec];
    load_rows(flag, r0 + j * kRoundRows, n, fvec, f);
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < kVec; ++i) m |= (f[i] != 0 ? 1u : 0u) << i;
    mask |= m << (j * kVec);
    packed |= static_cast<uint64_t>(__popc(m)) << (16 * j);
  }
  // no field borrows: each field of the inclusive scan is >= its own
  uint64_t agg;
  const uint64_t excl =
      block_inclusive_scan<kThreads>(packed, warp_sums, &agg) - packed;
  int off[kRounds];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    off[j] = total + field(excl, j);
    total += field(agg, j);
  }
  if (tid == 0) publish(status, t, t == 0 ? kInclusive : kAggregate, total);

  for (int c = 0; c < in.n; ++c) {
    if (c > 0) __syncthreads();  // the previous column has left `stage`
    const bool wide = in.w[c] == 8;
    if (wide) {
      stage_column(reinterpret_cast<const uint64_t*>(in.p[c]), r0, n, mask,
                   off, stage);
    } else {
      stage_column(reinterpret_cast<const uint32_t*>(in.p[c]), r0, n, mask,
                   off, reinterpret_cast<uint32_t*>(stage));
    }
    if (c == 0 && tid < 32) {
      const int64_t before = t == 0 ? 0 : look_back(status, t);
      if (tid == 0) {
        if (t > 0) publish(status, t, kInclusive, before + total);
        before_sh = before;
      }
    }
    __syncthreads();
    if (wide) {
      write_range(stage, total, out.p[c], before_sh);
    } else {
      write_range(reinterpret_cast<const uint32_t*>(stage), total, out.p[c],
                  before_sh);
    }
  }
}

// Scratch: the tile counter, then one status word per tile, all zeroed by
// one memset before every launch.
constexpr size_t kStatusOffset = 256;

int64_t compact_tiles(int64_t n) { return ceil_div(n, kTile); }

}  // namespace
}  // namespace tsx

extern "C" int64_t tsx_compact_scratch_bytes(int64_t n) {
  return static_cast<int64_t>(tsx::kStatusOffset) +
         tsx::compact_tiles(n) * static_cast<int64_t>(sizeof(uint64_t));
}

extern "C" int tsx_compact_flagged(const void* flag, int flag_bytes,
                                   void* const* in, void* const* out,
                                   const int* widths, int n_cols, int64_t n,
                                   void* scratch, void* stream) {
  using namespace tsx;
  if (n_cols < 1 || n_cols > kMaxCols || n < 0 ||
      (flag_bytes != 1 && flag_bytes != 4)) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    char* sc = static_cast<char*>(scratch);
    cudaMemsetAsync(sc, 0, tsx_compact_scratch_bytes(n), st);
    unsigned* counter = reinterpret_cast<unsigned*>(sc);
    uint64_t* status = reinterpret_cast<uint64_t*>(sc + kStatusOffset);
    const ColSet ci = make_colset(in, widths, n_cols);
    const ColSet co = make_colset(out, widths, n_cols);
    const unsigned tiles = static_cast<unsigned>(compact_tiles(n));
    if (flag_bytes == 1) {
      compact_kernel<<<tiles, kThreads, 0, st>>>(
          static_cast<const uint8_t*>(flag), n, ci, co, counter, status);
    } else {
      compact_kernel<<<tiles, kThreads, 0, st>>>(
          static_cast<const int32_t*>(flag), n, ci, co, counter, status);
    }
  }
  return cudaGetLastError();
}

extern "C" const char* tsx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
