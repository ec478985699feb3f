// The decoupled look-back shared by the single-pass kernels 1 (compact.cu)
// and 3 (merge_dedupe.cu): each tile publishes a count, first its own
// (aggregate), then the sum over every tile up to it (inclusive), and a
// later tile sums the statuses back to the nearest inclusive one.
//
// Where a look-back goes wrong, and what this one does about it:
//   * forward progress: callers take the tile index from an atomic counter,
//     zeroed on every call, not from blockIdx, so a block only waits on
//     tiles that running blocks hold, and each of those publishes its
//     aggregate before it waits itself;
//   * publication order: a tile's status is ONE 64-bit word, its flag
//     (aggregate or inclusive) in the top bits and the count below, stored
//     and loaded whole (volatile), so no reader sees a flag without its
//     value and no fence is needed.  (Kernel 3 once carried its 64-bit sums
//     in the look-back too: that took a separate flag, a release store and a
//     second load per window, 1.62 ms on an H100 at its main case against
//     1.39 ms with one word.)
#pragma once

#include "common.cuh"

namespace tsx {
namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

// A tile's status word: 0 until published, then the flag in the top two
// bits and the count (aggregate, or inclusive of every earlier tile) below.
constexpr uint64_t kAggregate = uint64_t(1) << 62;
constexpr uint64_t kInclusive = uint64_t(2) << 62;
constexpr uint64_t kCountMask = kAggregate - 1;

__device__ __forceinline__ void publish(uint64_t* status, int64_t t,
                                        uint64_t flag, int64_t count) {
  *reinterpret_cast<volatile uint64_t*>(status + t) =
      flag | static_cast<uint64_t>(count);
}

// The sum of the counts of tiles 0..t-1 (t > 0), by the 32 lanes of one
// warp: lane i reads tile base - i's status, waiting while it is 0; the
// counts up to the nearest inclusive one are summed, and the walk goes on
// 32 tiles further back if the window held none.  Lane 0's result counts.
// (Two, four or eight tiles a lane measured slower on an H100 in kernel 3:
// a wider window waits on more tiles that are still open.)
__device__ int64_t look_back(const uint64_t* status, int64_t t) {
  const int lane = threadIdx.x & 31;
  int64_t before = 0;
  for (int64_t base = t - 1;; base -= 32) {
    const int64_t j = base - lane;
    uint64_t w = kInclusive;  // before tile 0: nothing, as an inclusive
    if (j >= 0) {
      const volatile uint64_t* sj = status + j;
      while ((w = *sj) == 0) {
      }
    }
    const unsigned inclusive =
        __ballot_sync(kFullWarp, (w & ~kCountMask) == kInclusive);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    int64_t c = lane <= stop ? static_cast<int64_t>(w & kCountMask) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(kFullWarp, c, d);
    before += c;
    if (inclusive) return before;
  }
}

}  // namespace
}  // namespace tsx
