// The table's residue phase: every reprobe round of an insert's narrow tail
// in one launch of one block.
//
// Replaces no TPU kernel.  The JAX package runs these rounds as XLA ops
// (tsxcount_tpu/core/table.py `QuotientTable.residue_phase`), and the port's
// plain twin (ops/table_residue.py `table_residue_plain`) runs them as
// eager PyTorch, one host-driven round at a time.  A tail round touches
// 4-32 K rows, no device work worth the name; what it costs there is ~110
// eager launches and 7 host syncs (the loop's check and the mask indexing
// of each slot column).  Here the whole loop runs inside one block: the
// host launches once and waits on nothing.
//
// Contract (ops/table_residue.py), the plain rounds' word for word.  Rows
// [0, width) of the carry start unresolved where `active`.  Round r, from
// r_start while r < max_reprobes and a row is unresolved, probes slot
// pos = (pos0 + r(r+1)/2) mod S, whose stored key lane 0 is cleared[0] | r:
//   * a row matches where the slot is used (used word != 0) and every key
//     lane is equal, and adds its digits d0 and d1 to the slot's;
//   * an empty slot goes to the LOWEST row among the round's contenders
//     for it, which adds its key lanes and digits and 1 to the used word;
//   * every other contender goes on to round r + 1.
// Adds wrap modulo 2^32.  n += winners; probe_hist[min(r, n_hist - 1)] +=
// the round's resolved rows; spilled += the active rows at or past `width`
// and the rows unresolved at the end; rounds += the rounds run.  n, spilled
// and probe_hist are read from their inputs and written to fresh outputs.
// `masks` is scratch of tsx_table_residue_scratch_words(width) int64
// words, O(width); its contents on entry do not matter.
//
// Design: one block of kThreads threads, three phases a round, each ended
// by a barrier.
//   1. Every unresolved row reads its slot's key lanes and used word.
//   2. A row that found its slot empty atomicMax-es the claim marker
//      kClaimBase - row into the used word.  Markers are >= 2, so none
//      reads as 0 or 1, and the highest is the lowest row.
//   3. A contender that reads its own marker back has won: it adds its key
//      lanes and digits and sets the used word to 1 (0 + 1).  A match adds
//      its digits.
// Every claimed slot ends its round at used = 1, so no marker outlives the
// round.  Match slots and claimed slots are disjoint (used in phase 1
// against empty), and keys are unique in a batch, so apart from phase 2's
// atomics no two threads touch one word in a round.  The rows come in
// chunks of kChunkRows: in chunk c, thread tid holds rows
// c * kChunkRows + j * kThreads + tid for j < 64, as the bits of one
// 64-bit word of each of three masks (unresolved, matched, claiming) in
// the scratch array, word c * kThreads + tid of each.  Only the thread
// that owns a word reads or writes it, so the masks need no barrier of
// their own; a thread skips a chunk whose unresolved word is 0, so a
// round costs its unresolved rows, plus one word a chunk.  Any width
// takes the one launch: no grid barrier, and one block also runs as it
// does here under the g++ emulation (tools/cuda_emu), which runs blocks
// in order.
//
// Bound: latency, not bandwidth.  A round moves a few hundred KB at the
// tails' widths; its time is a row's chain of dependent loads (its pos0,
// then its slot's words) times the rows a thread holds, plus three
// barriers.  One block leaves the rest of the card to the next launches
// of the stream; a tail of millions of rows (a batch inserted from round
// 0 by QuotientTable.insert, which no counter calls) runs at one SM's
// pace.

#include "common.cuh"

namespace tsx {
namespace {

constexpr int kThreads = 1024;
constexpr int kRowsPerWord = 64;  // bits of a mask word
constexpr int64_t kChunkRows = static_cast<int64_t>(kThreads) * kRowsPerWord;
constexpr int kMaxLanes = 16;     // key lanes at k = 256
constexpr int kClaimBase = 0x7fffffff;
// rows below this keep their markers >= 2: none reads as 0 or 1
constexpr int64_t kMaxWidth = kClaimBase - 1;

int64_t n_chunks(int64_t width) {
  return (width + kChunkRows - 1) / kChunkRows;
}

struct ResidueArgs {
  int32_t* slots;  // column-major: column c of slot i at c * s + i
  int64_t s;       // slots, a power of two
  int lanes;       // key lanes; then 3 count digits and the used word
  const int32_t* pos0;
  const int32_t* cleared[kMaxLanes];
  const int32_t* counts;
  const uint8_t* active;  // torch.bool
  int64_t n_rows;         // length of the carry's columns
  int64_t width;          // rows taken: [0, width)
  int64_t r_start;
  int64_t max_reprobes;
  const int64_t* n_in;
  const int64_t* spilled_in;
  const int64_t* hist_in;
  int64_t n_hist;
  int64_t* n_out;
  int64_t* spilled_out;
  int64_t* hist_out;
  int64_t* rounds;  // += the rounds run
  uint64_t* masks;  // [3][n_chunks * kThreads]: unresolved, match, claim
  int64_t n_words;  // n_chunks * kThreads
};

__device__ __forceinline__ int64_t probe_pos(const ResidueArgs& a, int64_t row,
                                             int64_t tri) {
  return (static_cast<int64_t>(a.pos0[row]) + tri) & (a.s - 1);
}

__device__ __forceinline__ void add_word(int32_t* p, uint32_t v) {
  *p = static_cast<int32_t>(static_cast<uint32_t>(*p) + v);  // wraps
}

// row of bit j of chunk c's word of thread tid
__device__ __forceinline__ int64_t row_of(int64_t c, int j, int tid) {
  return c * kChunkRows + static_cast<int64_t>(j) * kThreads + tid;
}

__global__ void __launch_bounds__(kThreads)
    table_residue_kernel(ResidueArgs a) {
  // row counts < kMaxWidth: 32-bit shared atomics, native on the card
  // (64-bit ones are a compare-and-swap loop that 1024 threads contend)
  __shared__ int s_left;
  __shared__ int s_resolved;
  __shared__ int s_won;
  __shared__ unsigned long long s_lost;
  const int tid = threadIdx.x;
  const int64_t s = a.s;
  const int64_t chunks = a.n_words / kThreads;
  int32_t* used_col = a.slots + (a.lanes + 3) * s;
  int32_t* d0_col = a.slots + a.lanes * s;
  uint64_t* unres_w = a.masks;
  uint64_t* match_w = a.masks + a.n_words;
  uint64_t* claim_w = a.masks + 2 * a.n_words;

  if (tid == 0) {
    s_left = 0;
    s_lost = 0;
  }
  for (int64_t i = tid; i < a.n_hist; i += kThreads) {
    a.hist_out[i] = a.hist_in[i];
  }
  int mine = 0;
  for (int64_t c = 0; c < chunks; ++c) {
    uint64_t u = 0;
    for (int j = 0; j < kRowsPerWord; ++j) {
      const int64_t row = row_of(c, j, tid);
      if (row < a.width && a.active[row]) u |= 1ull << j;
    }
    unres_w[c * kThreads + tid] = u;
    mine += __popcll(u);
  }
  unsigned long long lost = 0;
  for (int64_t row = a.width + tid; row < a.n_rows; row += kThreads) {
    lost += a.active[row] ? 1 : 0;
  }
  __syncthreads();
  if (mine) atomicAdd(&s_left, mine);
  if (lost) atomicAdd(&s_lost, lost);
  __syncthreads();
  int left = s_left;

  int64_t r = a.r_start;
  int64_t rounds = 0;
  int64_t won_total = 0;  // thread 0's
  while (r < a.max_reprobes && left > 0) {
    ++rounds;
    const int64_t tri = r * (r + 1) / 2;
    const int32_t r32 = static_cast<int32_t>(r);

    // phase 1: read; no slot word is written
    for (int64_t c = 0; c < chunks; ++c) {
      const int64_t w = c * kThreads + tid;
      const uint64_t u = unres_w[w];
      if (!u) continue;
      uint64_t match = 0, claim = 0;
      for (uint64_t m = u; m; m &= m - 1) {
        const int j = __ffsll(static_cast<long long>(m)) - 1;
        const int64_t row = row_of(c, j, tid);
        const int64_t p = probe_pos(a, row, tri);
        if (used_col[p] == 0) {
          claim |= 1ull << j;
          continue;
        }
        bool eq = a.slots[p] == (a.cleared[0][row] | r32);
        for (int l = 1; eq && l < a.lanes; ++l) {
          eq = a.slots[l * s + p] == a.cleared[l][row];
        }
        if (eq) match |= 1ull << j;
      }
      match_w[w] = match;
      claim_w[w] = claim;
    }
    __syncthreads();

    // phase 2: claims; the round's counts restart (every thread has read
    // the last round's s_left before the barrier above)
    for (int64_t c = 0; c < chunks; ++c) {
      const int64_t w = c * kThreads + tid;
      if (!unres_w[w]) continue;
      for (uint64_t m = claim_w[w]; m; m &= m - 1) {
        const int j = __ffsll(static_cast<long long>(m)) - 1;
        const int64_t row = row_of(c, j, tid);
        atomicMax(used_col + probe_pos(a, row, tri),
                  kClaimBase - static_cast<int>(row));
      }
    }
    if (tid == 0) {
      s_left = 0;
      s_resolved = 0;
      s_won = 0;
    }
    __syncthreads();

    // phase 3: winners and matches write
    int n_resolved = 0, n_won = 0, n_left = 0;
    for (int64_t c = 0; c < chunks; ++c) {
      const int64_t w = c * kThreads + tid;
      uint64_t u = unres_w[w];
      if (!u) continue;
      uint64_t won = 0;
      for (uint64_t m = claim_w[w]; m; m &= m - 1) {
        const int j = __ffsll(static_cast<long long>(m)) - 1;
        const int64_t row = row_of(c, j, tid);
        const int64_t p = probe_pos(a, row, tri);
        if (used_col[p] != kClaimBase - static_cast<int>(row)) continue;
        won |= 1ull << j;
        add_word(a.slots + p, static_cast<uint32_t>(a.cleared[0][row] | r32));
        for (int l = 1; l < a.lanes; ++l) {
          add_word(a.slots + l * s + p,
                   static_cast<uint32_t>(a.cleared[l][row]));
        }
        used_col[p] = 1;
      }
      const uint64_t resolved = match_w[w] | won;
      for (uint64_t m = resolved; m; m &= m - 1) {
        const int j = __ffsll(static_cast<long long>(m)) - 1;
        const int64_t row = row_of(c, j, tid);
        const int64_t p = probe_pos(a, row, tri);
        const int32_t cnt = a.counts[row];  // arithmetic shift, as the plain
        add_word(d0_col + p, static_cast<uint32_t>(cnt & 0xfffff));
        add_word(d0_col + s + p, static_cast<uint32_t>((cnt >> 20) & 0xfffff));
      }
      u &= ~resolved;
      unres_w[w] = u;
      n_resolved += __popcll(resolved);
      n_won += __popcll(won);
      n_left += __popcll(u);
    }
    if (n_resolved) atomicAdd(&s_resolved, n_resolved);
    if (n_won) atomicAdd(&s_won, n_won);
    if (n_left) atomicAdd(&s_left, n_left);
    __syncthreads();

    left = s_left;
    if (tid == 0) {
      a.hist_out[r < a.n_hist - 1 ? r : a.n_hist - 1] += s_resolved;
      won_total += s_won;
    }
    ++r;
  }
  if (tid == 0) {
    *a.n_out = *a.n_in + won_total;
    *a.spilled_out = *a.spilled_in + static_cast<int64_t>(s_lost) + left;
    *a.rounds += rounds;
  }
}

}  // namespace
}  // namespace tsx

// int64 words of the mask scratch a tail `width` rows wide takes
extern "C" int64_t tsx_table_residue_scratch_words(int64_t width) {
  using namespace tsx;
  return width < 0 ? 0 : 3 * n_chunks(width) * kThreads;
}

extern "C" int tsx_table_residue(
    void* slots, int64_t s, int lanes, const void* pos0,
    const void* const* cleared, const void* counts, const void* active,
    int64_t n_rows, int64_t width, int64_t r_start, int64_t max_reprobes,
    const void* n_in, const void* spilled_in, const void* hist_in,
    int64_t n_hist, void* n_out, void* spilled_out, void* hist_out,
    void* rounds, void* masks, int64_t mask_words, void* stream) {
  using namespace tsx;
  if (lanes < 1 || lanes > kMaxLanes || s < 1 || (s & (s - 1)) != 0 ||
      width < 0 || width > kMaxWidth || n_rows < width || r_start < 0 ||
      n_hist < 0 || (n_hist == 0 && r_start < max_reprobes) ||
      mask_words < tsx_table_residue_scratch_words(width)) {
    return cudaErrorInvalidValue;
  }
  ResidueArgs a{};
  a.slots = static_cast<int32_t*>(slots);
  a.s = s;
  a.lanes = lanes;
  a.pos0 = static_cast<const int32_t*>(pos0);
  for (int c = 0; c < lanes; ++c) {
    a.cleared[c] = static_cast<const int32_t*>(cleared[c]);
  }
  a.counts = static_cast<const int32_t*>(counts);
  a.active = static_cast<const uint8_t*>(active);
  a.n_rows = n_rows;
  a.width = width;
  a.r_start = r_start;
  a.max_reprobes = max_reprobes;
  a.n_in = static_cast<const int64_t*>(n_in);
  a.spilled_in = static_cast<const int64_t*>(spilled_in);
  a.hist_in = static_cast<const int64_t*>(hist_in);
  a.n_hist = n_hist;
  a.n_out = static_cast<int64_t*>(n_out);
  a.spilled_out = static_cast<int64_t*>(spilled_out);
  a.hist_out = static_cast<int64_t*>(hist_out);
  a.rounds = static_cast<int64_t*>(rounds);
  a.masks = static_cast<uint64_t*>(masks);
  a.n_words = n_chunks(width) * kThreads;
  table_residue_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return cudaGetLastError();
}
