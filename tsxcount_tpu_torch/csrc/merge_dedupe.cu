// Kernel 3: merge two sorted (key, count) runs and reduce every run of equal
// keys to one row holding the exact 64-bit sum of its counts.
//
// Replaces the TPU kernel merge_dedupe_sorted
// (tsxcount_tpu/ops/pallas_merge_dedupe.py).  That kernel runs the merge
// network, run flags, a carry-aware segmented sum and a butterfly compaction
// inside each tile, and carries the open run's key, its partial sum and the
// output frontier in SMEM from one SEQUENTIAL grid step to the next.  Blocks
// on this card run in any order and carry nothing, so the carry becomes a
// scan across blocks, and the merged rows never reach device memory:
//   1. merge_partition_kernel (merge.cuh) splits the output into tiles of
//      T rows by the merge-path search;
//   2. merge_dedupe_kernel: a block takes the next tile from a global
//      counter, stages its A and B slices (keys and counts) in shared
//      memory, and each thread merges its rows straight into registers,
//      marking each row that starts a run (its key differs from the row
//      before; at the tile's first row, the row just before the diagonal,
//      the larger of A[a0-1] and B[b0-1]).  A block-wide scan of (heads,
//      sum since the last head) under the reduce-by-key operator
//          (n1, s1) + (n2, s2) = (n1 + n2, n2 > 0 ? s2 : s1 + s2)
//      gives every row its in-tile sum and the tile's aggregate, and a
//      decoupled look-back over the earlier tiles' head counts gives the
//      heads before the tile.  Each row that ends a run then knows its
//      run's index (heads so far - 1); the tile's run ends are staged in
//      shared memory and written out as one contiguous, coalesced range,
//      each with the sum of its rows in this tile.  The tile holding the
//      last row writes the stats;
//   3. fix_reduce_kernel and fix_apply_kernel: a run that began in an
//      earlier tile gets the sums of its rows there (the trailing sum of
//      the last tile with a head before it, plus the whole sums of the
//      tiles between), from a two-level reduce-by-key scan over the tiles'
//      (head, sum); exact modulo 2^64, so one key may span any number of
//      tiles.
//
// The look-back (lookback.cuh, shared with kernel 1) carries only the head
// counts, one 64-bit word per tile; the tile index comes from an atomic
// counter, zeroed on every call.  Shared memory: the tile is 2048 rows up
// to 3 key words, 1024 rows up to 8 (at most 40 KB at 8 key words, under
// the 48 KB of static shared memory, four blocks on each SM) and 512 rows
// beyond (39 KB at 17).  Key words 1 to 8 are each compiled as they are, 9
// to 17 by one instantiation that reads the width at run time (merge.cuh);
// it holds its rows' 17-word keys in registers, so it is bounded to 2
// blocks an SM (128 registers a thread) rather than 4.
//
// Bound: device-memory bandwidth.  Each input row is read once (keys and
// count, coalesced), each run written once (coalesced); the merge-path
// searches, the tile statuses and the fix-ups are O(tiles).  Scratch is
// O(tiles).
//
// Contract (ops/merge_dedupe.py): a and b hold n_keys (1..17) uint32 key words,
// most significant first, then one int64 count column; both runs ascending
// under the unsigned lexicographic order, with invalid rows forming one
// constant run at the end whose first key word is >= inv_min.  out gets the
// n_runs distinct keys ascending with their summed counts (rows beyond are
// unwritten); stats[0] = n_runs, stats[1] = n_runs less the trailing invalid
// run if there is one.  Runs out of order give unspecified rows and stats
// (n_runs <= m + n), but nothing is read or written outside a, b, out and
// the scratch (merge.cuh, tile_a_rows).

#include "lookback.cuh"
#include "merge.cuh"

namespace tsx {
namespace {

constexpr int kDedupeThreads = 256;

// Rows a thread merges at n_keys key words; the tile is kDedupeThreads
// times that.
__host__ __device__ constexpr int dedupe_items(int n_keys) {
  return n_keys <= 3 ? 8 : n_keys <= kMaxFixedKeys ? 4 : 2;
}

// Blocks an SM the register budget is set for: 4 (64 registers a thread) up
// to 8 key words, 2 beyond.
__host__ __device__ constexpr int dedupe_min_blocks(int n_keys) {
  return n_keys <= kMaxFixedKeys ? 4 : 2;
}

// A reduce-by-key value: n run heads, s the counts' sum since the last head.
struct Rbk {
  int64_t n;
  uint64_t s;
};

__device__ __forceinline__ Rbk rbk(const Rbk& x, const Rbk& y) {  // x, then y
  return {x.n + y.n, y.n > 0 ? y.s : x.s + y.s};
}

// Exclusive scan of one Rbk per thread over a block of NT threads; *total
// gets the block's aggregate.  One barrier; every thread must call it,
// once.
template <int NT>
__device__ __forceinline__ Rbk block_exclusive_rbk(Rbk v, Rbk* warp_sums,
                                                   Rbk* total) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Rbk y{__shfl_up_sync(kFullWarp, v.n, d),
                __shfl_up_sync(kFullWarp, v.s, d)};
    if (lane >= d) v = rbk(y, v);
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  Rbk before{0, 0};
  Rbk all{0, 0};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = rbk(before, warp_sums[w]);
    all = rbk(all, warp_sums[w]);
  }
  *total = all;
  Rbk left{__shfl_up_sync(kFullWarp, v.n, 1),
           __shfl_up_sync(kFullWarp, v.s, 1)};
  if (lane == 0) left = Rbk{0, 0};
  return rbk(before, left);
}

template <int NK>
__device__ __forceinline__ bool keys_differ(const uint32_t (&x)[NK],
                                            const uint32_t (&y)[NK], int nk) {
  bool d = false;
#pragma unroll
  for (int c = 0; c < NK; ++c) d |= c < nk && x[c] != y[c];
  return d;
}

// At most 64 registers a thread up to 8 key words, so that 4 blocks fit on
// an SM (76 without the bound: 3 blocks, and 9 % slower on an H100).
template <int NK>
__global__ void __launch_bounds__(kDedupeThreads, dedupe_min_blocks(NK))
    merge_dedupe_kernel(ColSet a, ColSet b, int64_t m, int64_t n, int n_keys,
                        const int64_t* __restrict__ a_starts, ColSet out,
                        uint32_t inv_min, int64_t* __restrict__ stats,
                        unsigned* tile_counter, uint64_t* status,
                        uint64_t* __restrict__ tile_sum,
                        int64_t* __restrict__ fix_at) {
  constexpr int I = dedupe_items(NK);
  constexpr int T = kDedupeThreads * I;
  // staged A slice then B slice; after the scan, the tile's output rows
  __shared__ uint32_t keys[NK][T];
  __shared__ uint64_t cnt[T];
  __shared__ uint32_t edge[2][NK];  // keys just before / after the tile
  __shared__ Rbk warp_sums[kDedupeThreads / 32];
  __shared__ int64_t heads_before_sh;
  __shared__ int64_t tile_sh;
  __shared__ int head0_sh, last_end_sh, last_invalid_sh;

  const int tid = threadIdx.x;
  if (tid == 0) tile_sh = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const int64_t t = tile_sh;
  const int64_t total = m + n;
  const int64_t d0 = t * T;
  const int len = static_cast<int>(min64(T, total - d0));
  const int64_t a0 = a_starts[t];
  const int la = tile_a_rows(a0, a_starts[t + 1], len);
  const int64_t a1 = a0 + la;
  const int64_t b0 = d0 - a0;
  const int64_t b1 = d0 + len - a1;
  const int lb = len - la;
  const bool has_prev = d0 > 0;
  const bool has_next = d0 + len < total;
  const int nk = key_words<NK>(n_keys);

  const uint32_t* ak[NK];
  const uint32_t* bk[NK];
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (c < nk) {
      ak[c] = reinterpret_cast<const uint32_t*>(a.p[c]);
      bk[c] = reinterpret_cast<const uint32_t*>(b.p[c]);
    }
  }
  const uint64_t* ac = reinterpret_cast<const uint64_t*>(a.p[nk]);
  const uint64_t* bc = reinterpret_cast<const uint64_t*>(b.p[nk]);
  {
    // every load of the thread's staged rows is in flight before the
    // first store to shared memory waits on one
    uint32_t sk[I][NK];
    uint64_t sc[I];
#pragma unroll
    for (int r = 0; r < I; ++r) {
      const int i = tid + r * kDedupeThreads;
      if (i < len) {
        const bool in_a = i < la;
        const int64_t row = in_a ? a0 + i : b0 + (i - la);
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          if (c < nk) sk[r][c] = (in_a ? ak[c] : bk[c])[row];
        }
        sc[r] = (in_a ? ac : bc)[row];
      }
    }
#pragma unroll
    for (int r = 0; r < I; ++r) {
      const int i = tid + r * kDedupeThreads;
      if (i < len) {
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          if (c < nk) keys[c][i] = sk[r][c];
        }
        cnt[i] = sc[r];
      }
    }
  }
  // the merged row before the tile is the larger of A[a0-1] and B[b0-1];
  // the one after it the smaller of A[a1] and B[b1] (ties: keys are equal)
  if (tid == 0 && has_prev) {
    uint32_t ka[NK], kb[NK];
    if (a0 > 0) load_key<NK>(a, a0 - 1, ka, nk);
    if (b0 > 0) load_key<NK>(b, b0 - 1, kb, nk);
    const bool take_b = a0 == 0 || (b0 > 0 && key_le<NK>(ka, kb, nk));
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      if (c < nk) edge[0][c] = take_b ? kb[c] : ka[c];
    }
  }
  if (tid == 32 && has_next) {
    uint32_t ka[NK], kb[NK];
    if (a1 < m) load_key<NK>(a, a1, ka, nk);
    if (b1 < n) load_key<NK>(b, b1, kb, nk);
    const bool take_a = b1 >= n || (a1 < m && key_le<NK>(ka, kb, nk));
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      if (c < nk) edge[1][c] = take_a ? ka[c] : kb[c];
    }
  }
  __syncthreads();

  // merge this thread's rows [d, d + nv) of the tile straight into
  // registers, with their run-head flags, holding the walk's two front
  // keys (staged A[i] and B[j]) in registers.  The merged row before the
  // rows is the later of A[i-1] and B[j-1] at the thread's split; the one
  // after them the earlier of the two front keys where the walk stops (on
  // equal keys either will do).
  const int d = min(tid * I, len);
  const int nv = min(I, len - d);
  int i, j;
  {
    int lo = max(0, d - lb);
    int hi = min(d, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (staged_le<NK>(keys, mid, la + d - 1 - mid, nk)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    i = lo;
    j = d - lo;
  }
  uint32_t prev[NK];
  bool prev_ok = true;
  if (d > 0) {
    const int s =
        i == 0 || (j > 0 && staged_le<NK>(keys, i - 1, la + j - 1, nk))
            ? la + j - 1
            : i - 1;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      if (c < nk) prev[c] = keys[c][s];
    }
  } else if (has_prev) {
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      if (c < nk) prev[c] = edge[0][c];
    }
  } else {
    prev_ok = false;  // the first merged row starts the first run
  }
  uint32_t ka[NK], kb[NK];
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (c < nk) {
      ka[c] = keys[c][i < la ? i : 0];
      kb[c] = keys[c][j < lb ? la + j : 0];
    }
  }
  uint32_t k[I][NK];
  uint64_t v[I];
  bool head[I];
  Rbk mine{0, 0};
#pragma unroll
  for (int r = 0; r < I; ++r) {
    if (r < nv) {
      const bool take_a = j >= lb || (i < la && key_le<NK>(ka, kb, nk));
      v[r] = cnt[take_a ? i : la + j];
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        if (c < nk) k[r][c] = take_a ? ka[c] : kb[c];
      }
      i += take_a;
      j += !take_a;
      // refill the front key of the side just taken
      const bool more = take_a ? i < la : j < lb;
      const int s = !more ? 0 : take_a ? i : la + j;
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        if (c < nk) {
          const uint32_t x = keys[c][s];
          ka[c] = take_a ? x : ka[c];
          kb[c] = take_a ? kb[c] : x;
        }
      }
      head[r] = r == 0 ? !prev_ok || keys_differ<NK>(k[0], prev, nk)
                       : keys_differ<NK>(k[r], k[r - 1], nk);
      mine = rbk(mine, Rbk{head[r] ? 1 : 0, v[r]});
    }
  }
  // whether this thread's last row ends its run
  bool last_end = false;
  if (nv > 0) {
    uint32_t next[NK];
    bool next_ok = true;
    if (d + nv < len) {
      const bool take_a = j >= lb || (i < la && key_le<NK>(ka, kb, nk));
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        if (c < nk) next[c] = take_a ? ka[c] : kb[c];
      }
    } else if (has_next) {
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        if (c < nk) next[c] = edge[1][c];
      }
    } else {
      next_ok = false;  // the last merged row ends the last run
    }
    last_end = !next_ok || keys_differ<NK>(k[nv - 1], next, nk);
    if (d == 0) head0_sh = head[0] ? 1 : 0;
    if (d + nv == len) {
      last_end_sh = last_end ? 1 : 0;
      last_invalid_sh = k[nv - 1][0] >= inv_min ? 1 : 0;
    }
  }

  Rbk agg;
  const Rbk before_me =
      block_exclusive_rbk<kDedupeThreads>(mine, warp_sums, &agg);

  if (tid == 0) publish(status, t, t == 0 ? kInclusive : kAggregate, agg.n);

  // every run end goes to its slot among the tile's run ends, with the sum
  // of its rows in this tile (the staged input rows are no longer read):
  // slot = heads so far in the tile, less one unless the tile's first run
  // began here.  This needs nothing from the look-back.
  Rbk run = before_me;
#pragma unroll
  for (int r = 0; r < I; ++r) {
    if (r < nv) {
      run = rbk(run, Rbk{head[r] ? 1 : 0, v[r]});
      const bool end = r + 1 < nv ? head[r + 1] : last_end;
      if (end) {
        const int slot = static_cast<int>(run.n) - head0_sh;
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          if (c < nk) keys[c][slot] = k[r][c];
        }
        cnt[slot] = run.s;
      }
    }
  }
  if (tid < 32) {
    const int64_t before = t == 0 ? 0 : look_back(status, t);
    if (tid == 0) {
      if (t > 0) publish(status, t, kInclusive, before + agg.n);
      heads_before_sh = before;
    }
  } else if (tid == 32) {
    tile_sum[t] = agg.s;  // for the fix-up of runs that span tiles
  }
  __syncthreads();

  // the tile's run ends, written from output row o_lo on
  const int64_t before = heads_before_sh;
  const int64_t o_lo = before - 1 + head0_sh;
  const int n_out = static_cast<int>(agg.n) - head0_sh + last_end_sh;
  if (tid == 32) {
    // the tile's first run began in an earlier tile and ends here
    fix_at[t] = !head0_sh && n_out > 0 ? o_lo : -1;
  }
  uint64_t* oc = reinterpret_cast<uint64_t*>(out.p[nk]);
  for (int q = tid; q < n_out; q += kDedupeThreads) {
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      if (c < nk) reinterpret_cast<uint32_t*>(out.p[c])[o_lo + q] = keys[c][q];
    }
    oc[o_lo + q] = cnt[q];
  }
  if (tid == 0 && !has_next) {
    const int64_t n_runs = before + agg.n;
    stats[0] = n_runs;
    stats[1] = n_runs - last_invalid_sh;
  }
}

constexpr int kFixThreads = 1024;  // tiles per block of the fix-up

// Tile j (< tiles) as a reduce-by-key value: whether it holds a head (its
// inclusive count exceeds the one before it) and tile_sum[j] (the sum
// after its last head, or its whole sum without one); past the last tile,
// the identity.
__device__ __forceinline__ Rbk tile_rbk(const uint64_t* status,
                                        const uint64_t* tile_sum, int64_t j,
                                        int64_t tiles) {
  if (j >= tiles) return Rbk{0, 0};
  const uint64_t before = j > 0 ? status[j - 1] & kCountMask : 0;
  return Rbk{(status[j] & kCountMask) > before ? 1 : 0, tile_sum[j]};
}

// The fix-up, first launch: block b's aggregate over its kFixThreads
// tiles, one tile a thread.
__global__ void __launch_bounds__(kFixThreads)
    fix_reduce_kernel(const uint64_t* __restrict__ status,
                      const uint64_t* __restrict__ tile_sum, int64_t tiles,
                      Rbk* __restrict__ block_agg) {
  __shared__ Rbk warp_sums[kFixThreads / 32];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kFixThreads +
                    threadIdx.x;
  Rbk total;
  block_exclusive_rbk<kFixThreads>(tile_rbk(status, tile_sum, j, tiles),
                                   warp_sums, &total);
  if (threadIdx.x == 0) block_agg[blockIdx.x] = total;
}

// The fix-up, second launch.  The rows that a tile's first run has in
// earlier tiles sum to the s of the exclusive reduce-by-key scan over the
// tiles: block b folds the aggregates of blocks 0..b-1, then scans its own
// tiles, and each tile whose first run began earlier and ends in it
// (fix_at >= 0) adds its carry to that run's output row.  (Walking back
// from each such tile instead takes as many steps as the run spans tiles:
// 8,700 for the invalid run at the end of a 2^26-row store that holds 2^24
// keys.)
__global__ void __launch_bounds__(kFixThreads)
    fix_apply_kernel(const int64_t* __restrict__ fix_at,
                     const uint64_t* __restrict__ status,
                     const uint64_t* __restrict__ tile_sum, int64_t tiles,
                     const Rbk* __restrict__ block_agg,
                     uint64_t* __restrict__ out_cnt) {
  __shared__ Rbk warp_sums[kFixThreads / 32];
  Rbk carry{0, 0};
  Rbk total;
  for (int64_t base = 0; base < blockIdx.x; base += kFixThreads) {
    const int64_t k = base + threadIdx.x;
    block_exclusive_rbk<kFixThreads>(k < blockIdx.x ? block_agg[k] : Rbk{0, 0},
                                     warp_sums, &total);
    carry = rbk(carry, total);
    __syncthreads();  // warp_sums is read again by the next call
  }
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kFixThreads +
                    threadIdx.x;
  const Rbk before = block_exclusive_rbk<kFixThreads>(
      tile_rbk(status, tile_sum, j, tiles), warp_sums, &total);
  if (j < tiles && fix_at[j] >= 0) {
    out_cnt[fix_at[j]] += rbk(carry, before).s;
  }
}

// Scratch regions, carved from one byte buffer (base == nullptr: sizes
// only).  The counter and the status words come first: one memset zeroes
// both.
struct Scratch {
  unsigned* tile_counter;
  uint64_t* status;
  uint64_t* tile_sum;
  int64_t* fix_at;
  Rbk* block_agg;
  int64_t* a_starts;
  size_t zeroed_bytes;
  size_t bytes;
};

Scratch carve(char* base, int64_t tiles) {
  Scratch s{};
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    char* p = base == nullptr ? nullptr : base + off;
    off = align256(off + bytes);
    return p;
  };
  s.tile_counter = reinterpret_cast<unsigned*>(take(sizeof(unsigned)));
  s.status = reinterpret_cast<uint64_t*>(take(tiles * sizeof(uint64_t)));
  s.zeroed_bytes = off;
  s.tile_sum = reinterpret_cast<uint64_t*>(take(tiles * sizeof(uint64_t)));
  s.fix_at = reinterpret_cast<int64_t*>(take(tiles * sizeof(int64_t)));
  s.block_agg = reinterpret_cast<Rbk*>(
      take(ceil_div(tiles, kFixThreads) * sizeof(Rbk)));
  s.a_starts = reinterpret_cast<int64_t*>(take((tiles + 1) * sizeof(int64_t)));
  s.bytes = off;
  return s;
}

int64_t dedupe_tiles(int n_keys, int64_t total) {
  return ceil_div(total, kDedupeThreads * dedupe_items(n_keys));
}

template <int NK>
void launch_merge_dedupe_nk(const ColSet& a, const ColSet& b,
                            const ColSet& out, int n_keys, int64_t m,
                            int64_t n, uint32_t inv_min, int64_t* stats,
                            char* scratch, cudaStream_t stream) {
  constexpr int T = kDedupeThreads * dedupe_items(NK);
  const int64_t tiles = dedupe_tiles(NK, m + n);
  const Scratch s = carve(scratch, tiles);
  cudaMemsetAsync(scratch, 0, s.zeroed_bytes, stream);
  merge_partition_kernel<NK>
      <<<static_cast<unsigned>(ceil_div(tiles + 1, 256)), 256, 0, stream>>>(
          a, b, m, n, tiles + 1, T, n_keys, s.a_starts);
  merge_dedupe_kernel<NK><<<static_cast<unsigned>(tiles), kDedupeThreads, 0,
                            stream>>>(a, b, m, n, n_keys, s.a_starts, out,
                                      inv_min, stats, s.tile_counter,
                                      s.status, s.tile_sum, s.fix_at);
  const unsigned fix_blocks =
      static_cast<unsigned>(ceil_div(tiles, kFixThreads));
  fix_reduce_kernel<<<fix_blocks, kFixThreads, 0, stream>>>(
      s.status, s.tile_sum, tiles, s.block_agg);
  fix_apply_kernel<<<fix_blocks, kFixThreads, 0, stream>>>(
      s.fix_at, s.status, s.tile_sum, tiles, s.block_agg,
      reinterpret_cast<uint64_t*>(out.p[n_keys]));
}

}  // namespace
}  // namespace tsx

extern "C" int64_t tsx_merge_dedupe_scratch_bytes(int n_keys, int64_t m,
                                                  int64_t n) {
  using namespace tsx;
  return static_cast<int64_t>(
      carve(nullptr, dedupe_tiles(n_keys, m + n)).bytes);
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
  if (m + n == 0) {
    cudaMemsetAsync(stat, 0, 2 * sizeof(int64_t), st);
    return cudaGetLastError();
  }
  int widths[kMaxCols];
  for (int c = 0; c < n_keys; ++c) widths[c] = 4;
  widths[n_keys] = 8;
  const ColSet ca = make_colset(a, widths, n_keys + 1);
  const ColSet cb = make_colset(b, widths, n_keys + 1);
  const ColSet co = make_colset(out, widths, n_keys + 1);
  char* sc = static_cast<char*>(scratch);
  with_keys(n_keys, [&](auto nk) {
    launch_merge_dedupe_nk<decltype(nk)::value>(ca, cb, co, n_keys, m, n,
                                                inv_min, stat, sc, st);
  });
  return cudaGetLastError();
}
