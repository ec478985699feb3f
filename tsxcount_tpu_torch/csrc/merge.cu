// Kernel 2: stable merge of two sorted runs (merge path).
//
// Replaces the TPU kernel merge_sorted with merge_path_partition
// (tsxcount_tpu/ops/pallas_merge.py).  That kernel loads 1024-aligned DMA
// windows, takes B globally reversed (Mosaic has no reverse) and sorts each
// window pair with a bitonic network of log2(4*tile) stages, with MAX_KEY
// pads and a global-index column to make the order total.  None of that is
// needed here: the merge-path split points make every output tile
// independent, and a thread merges its few rows sequentially.
//
//   1. merge_partition_kernel (merge.cuh, shared with kernel 3) gives the A
//      rows before every tile boundary;
//   2. merge_tile_kernel: block t owns output rows [t*T, (t+1)*T).  It
//      stages the A and B slices of its key columns and of its first
//      payload column in shared memory, every load in flight before the
//      first shared store; each thread finds its split of the tile by the
//      merge-path search there and walks its rows holding the two front
//      keys in registers, recording each output row's tile-local source
//      (uint16: the A slice first, then B at la + j).  The keys and that
//      payload column then leave from shared memory by source, consecutive
//      threads on consecutive output rows; any further payload column
//      passes through the same buffer, one at a time.
//
// Bound: device-memory bandwidth.  Each input byte is read once and each
// output byte written once, both coalesced.  The partition's binary
// searches read 2 * log2(m) scattered words per tile, 0.037 ms of the
// 0.253 at 2 x 2^24 rows on an H100: 2048-row tiles halve that, but at 8
// rows a thread the tile kernel takes 120 registers (80 with spills), and
// neither that nor 512 threads of 4 rows came out faster; a warp-wide
// 32-ary search, 8 times the scattered reads, took 2.5 times as long
// (PERF.md).
//
// Key words: 1 to 8 (k <= 112) each compiled as they are, 9 to 17 by one
// instantiation that reads the width at run time (merge.cuh).  The wide
// tiles are 512 rows (2 a thread), so that 17 staged key words stay under
// the 48 KB of static shared memory (39 KB).
//
// Contract (ops/merge.py): a and b hold n_cols (at most 18) columns (int32
// or int64, the same width for a column in both runs) of m and n rows; the
// first n_keys (1..17) are uint32 key words, most significant first, each
// run ascending under the unsigned lexicographic order.  out gets the m + n
// merged rows.  Runs out of that order give unspecified rows, but nothing
// is read or written outside a, b and out (merge.cuh, tile_a_rows).

#include "merge.cuh"

namespace tsx {
namespace {

constexpr int kMergeThreads = 256;

// Rows a thread merges at NK key words: 1024-row tiles up to 8 key words,
// 512 beyond.
__host__ __device__ constexpr int merge_items(int nk) {
  return nk <= kMaxFixedKeys ? 4 : 2;
}

__host__ __device__ constexpr int merge_tile(int nk) {
  return kMergeThreads * merge_items(nk);
}

// The tile's staged key columns and one payload column (at most 42 KB, at
// 8 key words; 39 KB at 17).
template <int NK>
struct MergeStage {
  static constexpr int T = merge_tile(NK);
  uint32_t keys[NK][T];
  union {
    uint32_t w32[T];
    uint64_t w64[T];
  } pay;
};

// out row d0 + q = buf[from[r]] for q = tid + r * kMergeThreads < len.
template <typename V, int I>
__device__ __forceinline__ void store_permuted(const V* buf, char* po,
                                               int64_t d0, int len,
                                               const int (&from)[I]) {
  V* o = reinterpret_cast<V*>(po) + d0;
#pragma unroll
  for (int r = 0; r < I; ++r) {
    const int q = threadIdx.x + r * kMergeThreads;
    if (q < len) o[q] = buf[from[r]];
  }
}

// One payload column through the shared buffer: its A slice then its B
// slice loaded (coalesced) to buf[0, len), then stored by source.  Every
// thread calls it.
template <typename V, int I>
__device__ __forceinline__ void move_column(
    const char* pa, const char* pb, char* po, V* buf, int64_t a0, int64_t b0,
    int64_t d0, int la, int len, const int (&from)[I]) {
  const V* av = reinterpret_cast<const V*>(pa);
  const V* bv = reinterpret_cast<const V*>(pb);
  V v[I];
#pragma unroll
  for (int r = 0; r < I; ++r) {
    const int i = threadIdx.x + r * kMergeThreads;
    if (i < len) v[r] = i < la ? av[a0 + i] : bv[b0 + (i - la)];
  }
#pragma unroll
  for (int r = 0; r < I; ++r) {
    const int i = threadIdx.x + r * kMergeThreads;
    if (i < len) buf[i] = v[r];
  }
  __syncthreads();
  store_permuted(buf, po, d0, len, from);
}

template <int NK>
__global__ void __launch_bounds__(kMergeThreads)
    merge_tile_kernel(ColSet a, ColSet b, ColSet out, int64_t m, int64_t n,
                      int n_keys, const int64_t* __restrict__ a_starts) {
  constexpr int I = merge_items(NK);
  constexpr int T = merge_tile(NK);
  __shared__ MergeStage<NK> st;
  __shared__ Vec<uint16_t, I> src[kMergeThreads];  // thread x: rows x*I..
  const int tid = threadIdx.x;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * T;
  const int64_t a0 = a_starts[blockIdx.x];
  const int64_t b0 = d0 - a0;
  const int len = static_cast<int>(min64(T, m + n - d0));
  const int la = tile_a_rows(a0, a_starts[blockIdx.x + 1], len);
  const int lb = len - la;
  const int nk = key_words<NK>(n_keys);

  // the key columns and the first payload column, every load of the
  // thread's rows in flight before the first store to shared memory
  const bool has_pay = a.n > nk;
  const bool wide = has_pay && a.w[nk] == 8;
  {
    uint32_t v[I][NK];
    uint64_t pv[I];
#pragma unroll
    for (int r = 0; r < I; ++r) {
      const int i = tid + r * kMergeThreads;
      if (i < len) {
        const bool in_a = i < la;
        const int64_t row = in_a ? a0 + i : b0 + (i - la);
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          if (c < nk) {
            v[r][c] = reinterpret_cast<const uint32_t*>(in_a ? a.p[c]
                                                             : b.p[c])[row];
          }
        }
        const char* pc = in_a ? a.p[nk] : b.p[nk];
        if (wide) {
          pv[r] = reinterpret_cast<const uint64_t*>(pc)[row];
        } else if (has_pay) {
          pv[r] = reinterpret_cast<const uint32_t*>(pc)[row];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < I; ++r) {
      const int i = tid + r * kMergeThreads;
      if (i < len) {
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          if (c < nk) st.keys[c][i] = v[r][c];
        }
        if (wide) {
          st.pay.w64[i] = pv[r];
        } else if (has_pay) {
          st.pay.w32[i] = static_cast<uint32_t>(pv[r]);
        }
      }
    }
  }
  __syncthreads();

  // this thread's rows [d, d + nv) of the tile: split by the merge-path
  // search, then a walk holding the front keys A[i] and B[j] in registers
  const int d = min(tid * I, len);
  const int nv = min(I, len - d);
  int lo = max(0, d - lb);
  int hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (staged_le<NK>(st.keys, mid, la + d - 1 - mid, nk)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo;
  int j = d - lo;
  uint32_t ka[NK], kb[NK];
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (c < nk) {
      ka[c] = st.keys[c][i < la ? i : 0];
      kb[c] = st.keys[c][j < lb ? la + j : 0];
    }
  }
  Vec<uint16_t, I> s{};
#pragma unroll
  for (int r = 0; r < I; ++r) {
    if (r < nv) {
      const bool take_a = j >= lb || (i < la && key_le<NK>(ka, kb, nk));
      s.v[r] = static_cast<uint16_t>(take_a ? i : la + j);
      i += take_a;
      j += !take_a;
      // refill the front key of the side just taken
      const bool more = take_a ? i < la : j < lb;
      const int x = !more ? 0 : take_a ? i : la + j;
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        if (c < nk) {
          const uint32_t y = st.keys[c][x];
          ka[c] = take_a ? y : ka[c];
          kb[c] = take_a ? kb[c] : y;
        }
      }
    }
  }
  src[tid] = s;
  __syncthreads();

  // output row q = tid + r * kMergeThreads comes from staged row from[r]
  const uint16_t* src_rows = reinterpret_cast<const uint16_t*>(src);
  int from[I];
#pragma unroll
  for (int r = 0; r < I; ++r) {
    const int q = tid + r * kMergeThreads;
    from[r] = q < len ? src_rows[q] : 0;
  }
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (c >= nk) break;
    uint32_t* o = reinterpret_cast<uint32_t*>(out.p[c]) + d0;
#pragma unroll
    for (int r = 0; r < I; ++r) {
      const int q = tid + r * kMergeThreads;
      if (q < len) o[q] = st.keys[c][from[r]];
    }
  }
  if (wide) {
    store_permuted(st.pay.w64, out.p[nk], d0, len, from);
  } else if (has_pay) {
    store_permuted(st.pay.w32, out.p[nk], d0, len, from);
  }
  // any further payload column through the same buffer
  for (int c = nk + 1; c < a.n; ++c) {
    __syncthreads();  // the buffer's last column has left
    if (a.w[c] == 8) {
      move_column(a.p[c], b.p[c], out.p[c], st.pay.w64, a0, b0, d0, la, len,
                  from);
    } else {
      move_column(a.p[c], b.p[c], out.p[c], st.pay.w32, a0, b0, d0, la, len,
                  from);
    }
  }
}

// int64 scratch elements (the tile split points) for runs of m and n rows
// of n_keys key words.
int64_t merge_scratch_elems(int n_keys, int64_t m, int64_t n) {
  return ceil_div(m + n, merge_tile(n_keys)) + 1;
}

template <int NK>
void launch_partition(const ColSet& a, const ColSet& b, int n_keys,
                      int64_t m, int64_t n, int64_t* a_starts,
                      cudaStream_t stream) {
  const int64_t n_diags = merge_scratch_elems(n_keys, m, n);
  merge_partition_kernel<NK>
      <<<static_cast<unsigned>(ceil_div(n_diags, 256)), 256, 0, stream>>>(
          a, b, m, n, n_diags, merge_tile(NK), n_keys, a_starts);
}

}  // namespace
}  // namespace tsx

extern "C" int64_t tsx_merge_scratch_elems(int n_keys, int64_t m,
                                           int64_t n) {
  return tsx::merge_scratch_elems(n_keys, m, n);
}

extern "C" int tsx_merge_sorted(void* const* a, void* const* b,
                                void* const* out, const int* widths,
                                int n_cols, int n_keys, int64_t m, int64_t n,
                                void* scratch, void* stream) {
  using namespace tsx;
  if (n_cols < 1 || n_cols > kMaxCols || n_keys < 1 || n_keys > kMaxKeys ||
      n_keys > n_cols || m < 0 || n < 0) {
    return cudaErrorInvalidValue;
  }
  if (m + n > 0) {
    const ColSet ca = make_colset(a, widths, n_cols);
    const ColSet cb = make_colset(b, widths, n_cols);
    const ColSet co = make_colset(out, widths, n_cols);
    int64_t* a_starts = static_cast<int64_t*>(scratch);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned tiles =
        static_cast<unsigned>(merge_scratch_elems(n_keys, m, n) - 1);
    with_keys(n_keys, [&](auto nk) {
      constexpr int NK = decltype(nk)::value;
      launch_partition<NK>(ca, cb, n_keys, m, n, a_starts, st);
      merge_tile_kernel<NK><<<tiles, kMergeThreads, 0, st>>>(
          ca, cb, co, m, n, n_keys, a_starts);
    });
  }
  return cudaGetLastError();
}

// The partition launch of tsx_merge_sorted alone (key columns only), for
// timing it apart from the tile kernel.
extern "C" int tsx_merge_partition(void* const* a, void* const* b, int n_keys,
                                   int64_t m, int64_t n, void* scratch,
                                   void* stream) {
  using namespace tsx;
  if (n_keys < 1 || n_keys > kMaxKeys || m < 0 || n < 0) {
    return cudaErrorInvalidValue;
  }
  if (m + n > 0) {
    int widths[kMaxKeys];
    for (int c = 0; c < n_keys; ++c) widths[c] = 4;
    const ColSet ca = make_colset(a, widths, n_keys);
    const ColSet cb = make_colset(b, widths, n_keys);
    with_keys(n_keys, [&](auto nk) {
      launch_partition<decltype(nk)::value>(
          ca, cb, n_keys, m, n, static_cast<int64_t*>(scratch),
          static_cast<cudaStream_t>(stream));
    });
  }
  return cudaGetLastError();
}
