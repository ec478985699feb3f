// fastxpack: the port's FASTQ/FASTA(.gz) parser and 2-bit batch packer
// (host C++, built with g++ by io/native.py; not part of the nvcc library).
//
// Its output is byte-identical to the JAX package's parser,
// tsxcount_tpu/_native/fastxpack.cpp, which the tests hold it to: the same
// batch buffers [words | interval starts | interval ends] (16 bases a
// uint32 word, LSB-first, A=00 C=01 G=10 T=11; unused interval slots
// 0xFFFFFFFF), the same batch boundaries (reads start on a word boundary,
// split with a k-1 overlap, an early flush when the interval budget
// fills), stats, byte-range ownership, error strings and splitmix64 draws.
//
// What differs is the work a base costs.  Records are walked in place in a
// large input buffer: line ends are found with memchr, and no line is
// copied (a multi-line FASTA record is joined into one string).  A read
// whose bytes are all ACGTacgt, at least k long, with the homopolymer
// collapse off, takes the one-pass path: its bytes are packed straight into
// words (8 bases per 64-bit load) and each segment of it is one interval.
// Any other read (an N or another invalid byte, a read shorter than k, or
// any read while the collapse is on) takes the general path: per-base codes,
// validity runs and a per-window interval scan, as the reference does.
// Which path a read takes depends on its own bytes and the handle's
// collapse flag alone; fxp_fast_reads counts the one-pass reads.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include <zlib.h>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "fastxpack packs 8 bases per 64-bit load and needs a little-endian host"
#endif

namespace {

constexpr int kBasesPerWord = 16;
// gzread request sizes: compressed input keeps the reference's 1 MiB
// requests (so a corrupt stream stops at the same byte); uncompressed input
// is read in large blocks straight into the buffer.
constexpr size_t kGzipChunk = 1 << 20;
constexpr size_t kPlainChunk = 8 << 20;
constexpr size_t kMaxRead = 1 << 30;  // gzread takes an unsigned length

// ASCII -> 2-bit code; 255 = invalid (N etc.)
struct CodeLut {
  uint8_t lut[256];
  CodeLut() {
    memset(lut, 255, sizeof(lut));
    lut['A'] = lut['a'] = 0;
    lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2;
    lut['T'] = lut['t'] = 3;
  }
};
const CodeLut g_lut;

// splitmix64 — small deterministic rng for n_policy=random
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed + 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
};

// True when every byte is one of ACGTacgt (clearing bit 5 maps exactly
// a, c, g, t onto A, C, G, T).  Byte masks and a byte accumulator, so that
// g++ -O3 vectorises the loop (16 bytes an instruction with SSE2).
bool all_acgt(const char *s, size_t n) {
  uint8_t bad = 0;
  for (size_t i = 0; i < n; ++i) {
    uint8_t u = (uint8_t)s[i] & 0xDF;
    uint8_t ok = (uint8_t)(-(u == 'A')) | (uint8_t)(-(u == 'C')) |
                 (uint8_t)(-(u == 'G')) | (uint8_t)(-(u == 'T'));
    bad |= (uint8_t)~ok;
  }
  return bad == 0;
}

// Eight ACGTacgt bytes (a little-endian 64-bit load) -> their 16-bit packed
// codes, base 0 in the low bits.  ((b >> 1) ^ (b >> 2)) & 3 is the code of
// each of the eight letters; the shifts then gather the 2-bit fields.
inline uint32_t pack8(uint64_t x) {
  uint64_t c = ((x >> 1) ^ (x >> 2)) & 0x0303030303030303ULL;
  c = (c | (c >> 6)) & 0x000F000F000F000FULL;
  c = (c | (c >> 12)) & 0x000000FF000000FFULL;
  c = (c | (c >> 24)) & 0xFFFFULL;
  return (uint32_t)c;
}

// Pack n ACGTacgt bytes into words from out[0]; the last word's unused
// high bits stay zero.
void pack_bases(const char *s, size_t n, uint32_t *out) {
  size_t i = 0;
  for (; i + kBasesPerWord <= n; i += kBasesPerWord) {
    uint64_t lo, hi;
    memcpy(&lo, s + i, 8);
    memcpy(&hi, s + i + 8, 8);
    *out++ = pack8(lo) | (pack8(hi) << 16);
  }
  if (i < n) {
    uint32_t v = 0;
    for (size_t j = n; j-- > i;) v = (v << 2) | g_lut.lut[(uint8_t)s[j]];
    *out = v;
  }
}

// One line of the input buffer: bytes [rel, rel + n) counted from the
// handle's mark, without its '\n' (and a '\r' before it); off = the file
// offset of its first byte.
struct Line {
  size_t rel = 0, n = 0;
  int64_t off = 0;
};

struct Handle {
  gzFile file = nullptr;
  int k = 0;
  int n_policy = 0;
  bool collapse = true;  // homopolymer run-length collapse (see encode_read)
  Rng rng{0};
  bool is_fasta = false;
  bool eof = false;
  std::string error;

  // byte-range parsing (plain files only): this handle owns records whose
  // header byte offset is in (range_skip, range_end]; range_end < 0 = to
  // EOF.  Ownership rule matches the reference-style chunked FASTQ
  // discipline: the reader seeked to offset s discards the line containing
  // s (a record starting exactly at s belongs to the previous chunk, whose
  // stop condition is offset > its end).
  int64_t range_end = -1;

  // input buffer: buf[0, len) holds file bytes [consumed_total - len,
  // consumed_total).  A refill keeps buf[mark, len) (the record being
  // parsed), moving it to the front, so no line of it is ever copied.
  std::unique_ptr<char[]> buf;
  size_t cap = 0, pos = 0, len = 0, mark = 0;
  bool direct = true;    // uncompressed input
  bool src_done = false;  // the file gave its last byte (or an error)
  int64_t consumed_total = 0;

  // the current read.  One-pass path (fast): its bytes, at seq (in buf,
  // or in fasta_seq), which stay put until the read is placed, since the
  // buffer moves only while a record is parsed.  General path: 2-bit codes
  // and run[i] = consecutive valid bases from i.
  bool fast = false;
  const char *seq = nullptr;
  std::string fasta_seq;
  std::vector<uint8_t> codes;
  std::vector<uint8_t> isn;  // 1 = invalid (N under drop policy)
  std::vector<int32_t> run;
  size_t read_len = 0;  // bases of the read (after a collapse)
  size_t start = 0;     // next unpacked offset within the read
  bool have_read = false;

  // stats (mirrors PackStats)
  int64_t reads = 0, reads_skipped = 0, bases = 0, n_bases = 0, windows = 0;
  int64_t packed_words = 0;  // uint32 words actually emitted across batches
  int64_t hp_bonus[4] = {0, 0, 0, 0};  // elided all-X windows per base code
  int64_t fast_reads = 0;  // reads that took the one-pass path

  int64_t file_off(size_t p) const {
    return consumed_total - (int64_t)(len - p);
  }

  // Move buf[mark, len) to the front and read more after it.
  void refill() {
    if (mark) {
      memmove(buf.get(), buf.get() + mark, len - mark);
      pos -= mark;
      len -= mark;
      mark = 0;
    }
    size_t need = direct ? kPlainChunk / 2 : kGzipChunk;  // free bytes
    if (cap - len < need) {  // a record longer than the buffer: grow it
      size_t grown = std::max({2 * cap, len + need, 2 * need});
      std::unique_ptr<char[]> b(new char[grown]);
      if (len) memcpy(b.get(), buf.get(), len);
      buf = std::move(b);
      cap = grown;
    }
    size_t ask = direct ? std::min(cap - len, kMaxRead) : kGzipChunk;
    int n = gzread(file, buf.get() + len, (unsigned)ask);
    if (n < 0) {
      int errnum = 0;
      error = gzerror(file, &errnum);
      src_done = true;
      return;
    }
    if (n == 0) {
      src_done = true;
      return;
    }
    len += (size_t)n;
    consumed_total += n;
  }

  // The next line; false when no byte is left.  A last line with no '\n'
  // keeps a trailing '\r', as the reference's getline does.
  bool take_line(Line *out) {
    size_t scan = pos;
    for (;;) {
      const char *b = buf.get();
      const char *nl =
          len > scan ? (const char *)memchr(b + scan, '\n', len - scan)
                     : nullptr;
      if (nl) {
        size_t e = (size_t)(nl - b);
        size_t n = e - pos;
        if (n && b[e - 1] == '\r') --n;
        *out = {pos - mark, n, file_off(pos)};
        pos = e + 1;
        return true;
      }
      if (src_done) {
        if (pos == len) return false;
        *out = {pos - mark, len - pos, file_off(pos)};
        pos = len;
        return true;
      }
      scan = len - mark;  // where the search stopped, after the move
      refill();
    }
  }

  char first(const Line &l) const { return l.n ? buf[mark + l.rel] : '\0'; }

  // Position the parser at the first record owned by (skip, range_end].
  // Called once after seeking to `skip`: discards the line containing the
  // seek point, then scans to a record boundary (FASTA: a '>' line; FASTQ:
  // a line L starting '@' with L+2 starting '+', which disambiguates
  // '@'-leading quality lines because sequence lines never start with '+').
  // The record's first line is left unread, for next_record.
  void resync() {
    Line l;
    mark = pos;
    if (!take_line(&l)) {  // partial line at the seek point
      eof = true;
      return;
    }
    if (is_fasta) {
      for (;;) {
        mark = pos;
        if (!take_line(&l)) {
          eof = true;
          return;
        }
        if (first(l) == '>') {
          if (range_end >= 0 && l.off > range_end) eof = true;
          pos = mark + l.rel;
          return;
        }
      }
    }
    // FASTQ: a 3-line lookahead window, mark at its first line
    Line win[3];
    int nw = 0;
    mark = pos;
    for (;;) {
      for (; nw < 3; ++nw) {
        if (!take_line(&win[nw])) {
          eof = true;
          return;
        }
      }
      if (first(win[0]) == '@' && first(win[2]) == '+') {
        if (range_end >= 0 && win[0].off > range_end) eof = true;
        pos = mark + win[0].rel;
        return;
      }
      size_t d = win[1].rel;
      mark += d;
      win[0] = win[1];
      win[1] = win[2];
      win[0].rel -= d;
      win[1].rel -= d;
      nw = 2;
    }
  }

  // Count a parsed read and choose its path.
  void take_read(const char *s, size_t n) {
    reads++;
    bases += (int64_t)n;
    if (!collapse && n >= (size_t)k && all_acgt(s, n)) {
      fast = true;
      seq = s;
      read_len = n;
      start = 0;
      have_read = true;
      fast_reads++;
      return;
    }
    fast = false;
    encode_read(s, n);
  }

  // The general path: codes, validity and the collapse of one read.
  void encode_read(const char *s, size_t n) {
    codes.resize(n);
    isn.resize(n);
    int64_t local_n = 0;
    for (size_t i = 0; i < n; ++i) {
      uint8_t c = g_lut.lut[(uint8_t)s[i]];
      if (c == 255) {
        local_n++;
        isn[i] = (n_policy == 1) ? 0 : 1;
        codes[i] = (n_policy == 1) ? (uint8_t)(rng.next() & 3) : 0;
      } else {
        isn[i] = 0;
        codes[i] = c;
      }
    }
    n_bases += local_n;
    if (n < (size_t)k) {  // skip on ORIGINAL length (python-packer parity)
      reads_skipped++;
      have_read = false;
      return;
    }
    // Homopolymer collapse: splice maximal valid single-base runs longer
    // than keep = 2k-2 down to keep bases, crediting the elided all-X
    // windows to hp_bonus (exactly L - keep per run).  Window contents and
    // validity of every surviving position are preserved (the proof is in
    // the JAX package's io/packer.py collapse_homopolymers).
    if (collapse && k >= 2) {
      size_t keep = (size_t)(2 * k - 2);
      size_t w = 0, i = 0;
      while (i < n) {
        size_t j = i + 1;
        if (!isn[i])
          while (j < n && !isn[j] && codes[j] == codes[i]) ++j;
        size_t L = j - i, keepL = L;
        if (!isn[i] && L > keep) {
          keepL = keep;
          hp_bonus[codes[i]] += (int64_t)(L - keep);
        }
        if (w != i)
          for (size_t t = 0; t < keepL; ++t) {
            codes[w + t] = codes[i + t];
            isn[w + t] = isn[i + t];
          }
        w += keepL;
        i = j;
      }
      codes.resize(w);
      isn.resize(w);
      n = w;
    }
    run.resize(n + 1);
    run[n] = 0;
    for (size_t i = n; i-- > 0;) run[i] = isn[i] ? 0 : run[i + 1] + 1;
    read_len = n;
    start = 0;
    have_read = true;
  }

  // Parse the next record; false on EOF, range end, or error.
  bool next_record() {
    Line h;
    mark = pos;
    if (is_fasta) {
      if (!take_line(&h)) return false;
      if (first(h) != '>') {
        error = "malformed FASTA header";
        return false;
      }
      if (range_end >= 0 && h.off > range_end) return false;  // next chunk's
      fasta_seq.clear();
      for (;;) {
        Line l;
        mark = pos;
        if (!take_line(&l)) break;
        if (first(l) == '>') {  // the next record's header: read it again
          pos = mark + l.rel;
          break;
        }
        fasta_seq.append(buf.get() + mark + l.rel, l.n);
      }
      take_read(fasta_seq.data(), fasta_seq.size());
      return true;
    }
    // FASTQ: 4-line records; the quality line is only stepped over
    if (!take_line(&h)) return false;
    if (h.n == 0) return false;
    if (first(h) != '@') {
      error = "malformed FASTQ record (missing @)";
      return false;
    }
    if (range_end >= 0 && h.off > range_end) return false;  // next chunk's
    Line s, p, q;
    if (!take_line(&s)) {
      error = "truncated FASTQ record";
      return false;
    }
    if (!take_line(&p) || first(p) != '+' || !take_line(&q)) {
      error = "truncated FASTQ record";
      return false;
    }
    take_read(buf.get() + mark + s.rel, s.n);
    return true;
  }
};

// One-pass placement of read bytes [start, start + seg_len) at word w0: all
// of its windows are valid, so they are one interval.  Returns seg_len, or
// 0 when no interval slot is left (the caller flushes and retries).
size_t place_fast(Handle *h, uint32_t *words, uint32_t *iv_s, uint32_t *iv_e,
                  int64_t max_ivs, int64_t *n_ivs, int64_t w0,
                  size_t seg_len) {
  if (*n_ivs >= max_ivs) return 0;
  int64_t n_win = (int64_t)seg_len - h->k + 1;
  int64_t base = w0 * kBasesPerWord;
  iv_s[*n_ivs] = (uint32_t)base;
  iv_e[(*n_ivs)++] = (uint32_t)(base + n_win);
  h->windows += n_win;
  pack_bases(h->seq + h->start, seg_len, words + w0);
  return seg_len;
}

// General placement: pack codes[start, start+seg_len) at word w0 and emit
// valid-window runs as intervals.  Returns the number of bases actually
// placed: seg_len normally, less if the interval budget truncated the
// segment mid-read (the unplaced windows stay with the read's
// continuation), 0 if nothing fits (caller flushes the batch and retries).
size_t place_segment(Handle *h, uint32_t *words, uint32_t *iv_s,
                     uint32_t *iv_e, int64_t max_ivs, int64_t *n_ivs,
                     int64_t w0, size_t seg_len) {
  const uint8_t *codes = h->codes.data() + h->start;
  const int32_t *run = h->run.data() + h->start;
  const int k = h->k;
  int64_t n_win = (int64_t)seg_len - k + 1;
  int64_t base = w0 * kBasesPerWord;

  // maximal runs of valid window starts, truncated at the interval budget
  int64_t placed_win = n_win;
  int64_t run_start = -1;
  int64_t emitted_windows = 0;
  bool truncated = false;
  for (int64_t p = 0; p < n_win; ++p) {
    bool ok = run[p] >= k;
    if (ok && run_start < 0) {
      if (*n_ivs >= max_ivs) {
        truncated = true;
        placed_win = p;
        break;
      }
      run_start = p;
      iv_s[*n_ivs] = (uint32_t)(base + p);
    } else if (!ok && run_start >= 0) {
      iv_e[(*n_ivs)++] = (uint32_t)(base + p);
      emitted_windows += p - run_start;
      run_start = -1;
    }
  }
  if (run_start >= 0) {
    iv_e[(*n_ivs)++] = (uint32_t)(base + placed_win);
    emitted_windows += placed_win - run_start;
  }
  size_t placed =
      truncated ? (placed_win > 0 ? (size_t)(placed_win + k - 1) : 0)
                : seg_len;
  if (placed == 0) return 0;
  h->windows += emitted_windows;

  // pack exactly `placed` bases (tail bits of the last word stay zero)
  int64_t w = w0;
  size_t i = 0;
  for (; i + kBasesPerWord <= placed; i += kBasesPerWord, ++w) {
    uint32_t v = 0;
    for (int j = kBasesPerWord - 1; j >= 0; --j)
      v = (v << 2) | codes[i + (size_t)j];
    words[w] = v;
  }
  if (i < placed) {
    uint32_t v = 0;
    for (size_t j = placed; j-- > i;) v = (v << 2) | codes[j];
    words[w] = v;
  }
  return placed;
}

}  // namespace

extern "C" {

// Open a byte range [byte_start, byte_end) of the file; the handle yields
// exactly the records owned by that range (see Handle::range_end), so N
// readers on a partition of [0, filesize) together parse every record
// exactly once.  byte_end < 0 = to EOF.  Ranges with byte_start > 0 or
// byte_end >= 0 require an UNCOMPRESSED file (gzip streams cannot seek);
// such opens on gzip data return nullptr.
void *fxp_open_range(const char *path, int k, int n_policy, uint64_t seed,
                     int64_t byte_start, int64_t byte_end, int collapse) {
  Handle *h = new Handle();
  h->k = k;
  h->n_policy = n_policy;
  h->collapse = collapse != 0;
  h->rng = Rng(seed);
  h->range_end = byte_end;
  h->file = gzopen(path, "rb");
  if (!h->file) {
    delete h;
    return nullptr;
  }
  gzbuffer(h->file, 1 << 20);
  int first = gzgetc(h->file);
  if (first < 0) {
    h->eof = true;
    return h;
  }
  gzungetc(first, h->file);
  h->is_fasta = (first == '>');
  h->direct = gzdirect(h->file) != 0;
  bool ranged = byte_start > 0 || byte_end >= 0;
  if (ranged && !h->direct) {  // compressed: cannot seek
    gzclose(h->file);
    delete h;
    return nullptr;
  }
  if (byte_start > 0) {
    if (gzseek(h->file, (z_off_t)byte_start, SEEK_SET) < 0) {
      gzclose(h->file);
      delete h;
      return nullptr;
    }
    h->consumed_total = byte_start;
    h->resync();
  }
  return h;
}

// Fills one batch buffer laid out as [words | iv starts | iv ends]:
// total_words uint32 of packed bases (zeroed here) followed by
// 2*max_intervals uint32 of validity intervals (set to 0xFFFFFFFF here).
// Returns 1 if more data may follow, 0 on EOF (batch may still hold data),
// -1 on parse error.
int fxp_next_batch(void *hv, uint32_t *buf, int64_t total_words,
                   int64_t capacity_words, int64_t max_intervals,
                   int64_t *n_valid, int64_t *n_bases_out) {
  Handle *h = (Handle *)hv;
  uint32_t *words = buf;
  uint32_t *iv_s = buf + total_words;
  uint32_t *iv_e = iv_s + max_intervals;
  memset(words, 0, (size_t)total_words * sizeof(uint32_t));
  memset(iv_s, 0xFF, (size_t)(2 * max_intervals) * sizeof(uint32_t));
  int64_t cur_word = 0;
  int64_t n_ivs = 0;
  int64_t batch_bases = 0;
  int64_t windows_before = h->windows;
  const int k = h->k;

  for (;;) {
    if (!h->have_read) {
      if (h->eof) break;
      if (!h->next_record()) {
        if (!h->error.empty()) return -1;
        h->eof = true;
        break;
      }
      continue;  // may have been skipped (len < k)
    }
    size_t remaining = h->read_len - h->start;
    if (remaining < (size_t)k) {
      h->have_read = false;
      continue;
    }
    int64_t avail_bases = (capacity_words - cur_word) * kBasesPerWord;
    if (avail_bases < k) break;  // batch full (words)
    size_t seg_len =
        remaining < (size_t)avail_bases ? remaining : (size_t)avail_bases;
    size_t placed =
        h->fast ? place_fast(h, words, iv_s, iv_e, max_intervals, &n_ivs,
                             cur_word, seg_len)
                : place_segment(h, words, iv_s, iv_e, max_intervals, &n_ivs,
                                cur_word, seg_len);
    if (placed == 0) break;  // batch full (interval budget): early flush
    batch_bases += (int64_t)placed;
    cur_word += (int64_t)((placed + kBasesPerWord - 1) / kBasesPerWord);
    if (h->start + placed >= h->read_len) {
      h->have_read = false;
    } else {
      h->start += placed - (size_t)(k - 1);
    }
  }
  *n_valid = h->windows - windows_before;
  *n_bases_out = batch_bases;
  h->packed_words += cur_word;
  return h->eof && !h->have_read ? 0 : 1;
}

// Total uint32 words emitted so far (batch-fill accounting).
int64_t fxp_packed_words(void *hv) {
  Handle *h = (Handle *)hv;
  return h->packed_words;
}

// Reads that took the one-pass path so far.
int64_t fxp_fast_reads(void *hv) {
  Handle *h = (Handle *)hv;
  return h->fast_reads;
}

void fxp_stats(void *hv, int64_t *reads, int64_t *skipped, int64_t *bases,
               int64_t *n_bases, int64_t *windows) {
  Handle *h = (Handle *)hv;
  *reads = h->reads;
  *skipped = h->reads_skipped;
  *bases = h->bases;
  *n_bases = h->n_bases;
  *windows = h->windows;
}

// Per-base-code counts of homopolymer windows elided by the collapse
// (exact; the caller merges them into the store once at finish).
void fxp_hp_bonus(void *hv, int64_t *out4) {
  Handle *h = (Handle *)hv;
  for (int c = 0; c < 4; ++c) out4[c] = h->hp_bonus[c];
}

const char *fxp_error(void *hv) {
  Handle *h = (Handle *)hv;
  return h->error.c_str();
}

void fxp_close(void *hv) {
  Handle *h = (Handle *)hv;
  if (h->file) gzclose(h->file);
  delete h;
}

}  // extern "C"
