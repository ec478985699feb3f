"""KmerCounter — the end-to-end streaming counter.

Streams FASTQ/FASTA records, packs them on the host (io/), and folds each
fixed-shape batch through the device: window extraction and an exact batch
histogram (sort + kernel 1), then, by backend (the reference's --mode
strings map onto the two):
  * "sort": every `merge_every` batches one store merge (kernel 2's merge
    tree, then kernel 3 into the sorted store, core/store.py; into the
    LSM store's L0 where its rule engages, core/lsm.py).  From 8
    lanes (k >= 113), or with hash_first, each batch's keys first go
    through a bijection, the lane mix (ops/mix.py, one kernel) or with
    hash_first="gf2" the seeded GF(2) matrix (ops/gf2.py, a float32
    matmul on bit planes): the store holds the images and the dedupe
    sorts only their >= 64-bit prefix.  With mix_prefix the keys are
    extended by two mixing-hash columns instead (ops/mix.py mix_cols),
    the store holds the extended keys and the dedupe sorts (flag,
    mix_hi, mix_lo).  Either way a detected prefix collision makes
    count_file recount with the full sort;
  * "table": an insert into the quotient table (core/table.py) in reprobe
    rounds of shrinking width (kernels 5, 4 and 1 per round), the widths
    chosen on the host from the batch's distinct count and each round's
    leftover count, exactly as the JAX package chooses them.
Parsing, packing and the host-to-device copy run on a producer thread
(io/pipeline.py); this thread launches the device work, which PyTorch
queues without waiting.  The sort backend synchronises once per file or
query, the table backend also once per batch and per round (the counts
that size the rounds).

Canonical mode folds each window to min(kmer, revcomp) after extraction
(ops/canonical.py); homopolymer collapse splices long all-X runs at ingest
and adds the elided counts back wherever counts leave the store
(HpBonusMixin).  Both, the LSM rule and the store layouts are the JAX
package's, so checkpoints (core/checkpoint.py) load in either package.

The device is explicit: "cuda" (the default) raises where no GPU is
present, and nothing falls back to the CPU unless asked for.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import time
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

from tsxcount_tpu_torch._build import resolve_device
from tsxcount_tpu_torch.config import BatchSpec, KmerSpec, counts_to_int
from tsxcount_tpu_torch.core.lsm import LSMStore
from tsxcount_tpu_torch.core.store import CountStore
from tsxcount_tpu_torch.core.table import QuotientTable
from tsxcount_tpu_torch.io.fastx import read_fastx
from tsxcount_tpu_torch.io.packer import PackedBatch, ReadPacker, add_stats
from tsxcount_tpu_torch.ops.canonical import canonicalize, canonicalize_cols
from tsxcount_tpu_torch.ops.count import UniqueCounts, count_unique
from tsxcount_tpu_torch.ops.gf2 import DEFAULT_SEED, GF2Hash
from tsxcount_tpu_torch.ops.mix import (
    LaneMixBijection,
    extend_cols,
    extend_keys_host,
    make_ext_spec,
    strip_mix,
)
from tsxcount_tpu_torch.ops.window import extract_kmer_cols, intervals_to_valid
from tsxcount_tpu_torch.utils.goldenfile import read_golden
from tsxcount_tpu_torch.utils.profiling import span
from tsxcount_tpu_torch.utils.sequence import kmers_to_strings, strings_to_kmers

# the JAX package's reference mode strings -> backends
MODE_TO_BACKEND = {
    "SERIAL": "sort",
    "PTHREAD": "sort",
    "OMP": "sort",
    "OMP_COUNT": "sort",
    "CAS": "table",
    "TSX": "table",
    "EXPERIMENTAL": "table",
}
_MIX_AUTO_MIN_LANES = 8  # hash_first=None: the lane mix from 8 lanes up
_TABLE_RESIDUE_ELEMS = 1 << 18  # w * slot_cols at or below: one plain tail

_QUERY_BATCH = 1 << 16
_HINT_SAMPLE = 64  # reads sampled for the auto read-length hint


def _peek_read_lens(path) -> list[int]:
    """Lengths of the first few records (for interval-budget auto-sizing)."""
    return [len(rec.seq)
            for rec in itertools.islice(read_fastx(path), _HINT_SAMPLE)]


@dataclasses.dataclass
class CheckResult:
    """Outcome of golden-file verification."""

    n_checked: int = 0
    n_matched: int = 0
    mismatches: list = dataclasses.field(default_factory=list)  # (kmer, want, got)
    missing: list = dataclasses.field(default_factory=list)     # kmer absent
    extra_distinct: int = 0  # stored kmers never queried (coverage audit)

    @property
    def ok(self) -> bool:
        return (
            not self.mismatches and not self.missing and self.extra_distinct == 0
        )


class CheckAbort(RuntimeError):
    """Raised on the first mismatch in checkabort mode."""


class TableFull(RuntimeError):
    """Distinct k-mers exceeded the store's capacity 2^l, or (table) some
    found no slot within max_reprobes."""


class PrefixCollision(RuntimeError):
    """Two DISTINCT keys collided in the 64-bit uniform prefix that the
    dedupe sorts (probability ~P^2/2^65 a batch), so one ingested batch's
    histogram may be wrong.

    Detection is exact (ops/count.py sort_uniform_prefix).  count_file()
    handles it by recounting the file with the full sort; it reaches the
    caller only from add_reads() + finish(), where the input cannot be
    replayed: rerun with hash_first=False and mix_prefix off, or feed the
    input via count_file."""


def table_insert(table: QuotientTable, state, uc: UniqueCounts):
    """Insert a batch histogram into the table with the JAX package's
    host schedule, which decides which arbitration each row meets and so
    the table's layout: round 0 at the narrowest of P/4, P/2 (at least
    256) that holds the batch's distinct keys, else P; each later round
    at the next power of two >= the rows left (at least 256); the plain
    tail once w * slot_cols <= 2^18 or from round 6 on.  One host read
    of the distinct count and one of each round's rows left."""
    table.inserts += 1
    p = uc.keys.shape[0]
    with span("sync"):
        n = int(uc.n_unique)
    width = p
    for w in (p // 4, p // 2):
        if 256 <= w and n <= w:
            width = w
            break
    st, carry, _, n_left = table.split_round(
        state, 0, *table.round0_args(
            uc.keys[:width], uc.counts[:width], uc.valid[:width]))
    r = 1
    while True:
        with span("sync"):
            f = int(n_left)
        if f == 0:
            return table.renorm(st)
        w = min(width, max(256, 1 << (f - 1).bit_length()))
        if w * table.slot_cols <= _TABLE_RESIDUE_ELEMS or r >= 6:
            return table.residue_phase(st, carry, r, w)
        p0, cl, c, a = carry
        st, carry, _, n_left = table.split_round(
            st, r, p0[:w], tuple(x[:w] for x in cl), c[:w], a[:w])
        r += 1


class IngestProgressMixin:
    """One stderr progress line every `progress_every` batches (off at 0)."""

    progress_every: int = 0
    _progress_t0 = None
    _progress_last = 0

    def _maybe_progress(self, stats_fn=None) -> None:
        if not self.progress_every:
            return
        if self._progress_t0 is None:
            self._progress_t0 = time.perf_counter()
        if self.batches_processed - self._progress_last < self.progress_every:
            return
        self._progress_last = self.batches_processed
        st = stats_fn() if stats_fn is not None else self.packer.stats
        dt = max(1e-9, time.perf_counter() - self._progress_t0)
        print(
            f"progress: batches={self.batches_processed} reads={st.reads} "
            f"windows={st.windows} ({st.windows / dt / 1e6:.1f}M win/s) "
            f"packed_mb={st.packed_words * 4 / 2**20:.0f}",
            file=sys.stderr, flush=True,
        )


class HpBonusMixin:
    """Read-time homopolymer-collapse bonus.

    With collapse on, the ingest splices all-c runs down to 2k-2 bases and
    owes `stats.hp_bonus[c]` occurrences of the all-c k-mer (io/packer.py
    collapse_homopolymers).  The spliced run keeps k-1 all-c windows, so
    the key is in the store; the owed count is added on the host wherever
    counts leave the store (get_counts, items, check).  No device work."""

    def _hp_stats(self):
        """The ingest stats that owe the bonus (the sharded counter sums
        every rank's)."""
        return self.packer.stats

    def _hp_owed_emit(self) -> dict[str, int]:
        """Owed bonus by the STORED k-mer string (the canonical one in
        canonical mode): the export's view."""
        k = self.spec.k
        out: dict[str, int] = {}
        for c, b in enumerate(self._hp_stats().hp_bonus):
            if b:
                s = "ACGT"[min(c, 3 - c) if self.canonical else c] * k
                out[s] = out.get(s, 0) + int(b)
        return out

    def _hp_owed_query(self) -> dict[str, int]:
        """Owed bonus by every query spelling: in canonical mode the
        all-T query sees the all-A bonus and all-G the all-C one."""
        emit = self._hp_owed_emit()
        if not emit or not self.canonical:
            return emit
        k = self.spec.k
        out = dict(emit)
        for c in range(4):
            rep = "ACGT"[min(c, 3 - c)] * k
            if rep in emit:
                out["ACGT"[c] * k] = emit[rep]
        return out


class KmerCounter(HpBonusMixin, IngestProgressMixin):
    def __init__(
        self,
        k: int,
        l: int = 26,
        s: int = 4,
        backend: str = "sort",
        batch_words: int = 1 << 16,
        n_policy: str = "drop",
        hash_seed: int = DEFAULT_SEED,
        identity_hash: bool = False,
        max_reprobes: int = 64,
        seed: int = 0,
        merge_every: int = 4,
        canonical: bool = False,
        lsm: bool | None = None,
        lsm_growth: int = 8,
        threads: int = 0,
        prefetch_depth: int = 3,
        read_len_hint: int = 0,
        collapse_homopolymers: bool = False,
        progress_every: int = 0,
        hash_first: bool | str | None = None,
        mix_prefix: bool | None = None,
        device: str | torch.device = "cuda",
    ):
        backend = MODE_TO_BACKEND.get(backend, backend)
        if backend not in ("sort", "table"):
            raise ValueError(f"backend must be 'sort', 'table' or a "
                             f"reference mode {sorted(MODE_TO_BACKEND)}")
        if lsm_growth < 2:
            raise ValueError("lsm_growth must be >= 2")
        self.spec = KmerSpec(k)
        # hash_first: False, "mix" (True aliases it) or "gf2": the store
        # holds the bijection's images and the dedupe sorts their uniform
        # prefix; None engages the lane mix on the sort backend from 8
        # lanes up unless mix_prefix is asked for, as the JAX package
        # does, so that both hold the same store states
        if hash_first is None:
            hash_first = ("mix" if backend == "sort" and not mix_prefix
                          and self.spec.lanes >= _MIX_AUTO_MIN_LANES
                          else False)
        if hash_first is True:
            hash_first = "mix"
        if hash_first not in (False, "mix", "gf2"):
            raise ValueError("hash_first must be False, True/'mix', or "
                             "'gf2'")
        if hash_first == "gf2" and identity_hash:
            hash_first = False  # the identity image is not uniform
        self.hash_first = hash_first if backend == "sort" else False
        # mix_prefix: the store holds extended keys (raw lanes + mix_lo,
        # mix_hi) and the dedupe sorts (flag, mix_hi, mix_lo).  None is
        # off: the JAX package's auto rule (from 99 lanes) never engages
        if mix_prefix and self.hash_first:
            raise ValueError("mix_prefix and hash_first are exclusive "
                             "(both replace the dedupe sort comparator)")
        self.mix_prefix = bool(mix_prefix and backend == "sort")
        self.store_spec = (make_ext_spec(self.spec) if self.mix_prefix
                           else self.spec)
        # the GF(2) hash: the table's, the "gf2" store image's, and the
        # matrices a checkpoint writes on either backend
        self.hash_fn = GF2Hash(self.spec, seed=hash_seed,
                               identity=identity_hash)
        self.key_map = {"mix": LaneMixBijection(self.spec),
                        "gf2": self.hash_fn}.get(self.hash_first)
        # set after a detected prefix collision: count_file recounts with
        # the full sort
        self._mix_full_sort = False
        self.device = resolve_device(device)
        # read_len_hint sizes the interval-coded validity budget (see
        # BatchSpec.max_intervals); 0 = auto-detect from the first reads
        self._auto_hint = read_len_hint == 0
        self.batch = BatchSpec(self.spec, batch_words, read_len_hint or 384)
        self.l = l
        self.s = s  # accepted for CLI parity; counts are unbounded here
        self.backend = backend
        self.n_policy = n_policy
        self.seed = seed
        self.threads = max(1, threads)
        self.prefetch_depth = max(1, prefetch_depth)
        self.canonical = canonical
        self.collapse_hp = collapse_homopolymers
        self.lsm = False
        self.lsm_growth = lsm_growth
        if backend == "sort":
            self.merge_every = max(1, merge_every)
            capacity = 1 << l
            flush = self.merge_every * self.batch.positions
            # the JAX package's rule: the LSM pays once the flat store's
            # O(capacity) pass per flush costs more than the cascade's
            # amortised work, capacity * (growth-1) > growth^2 * flush;
            # None applies it, True/False force it, and a table no larger
            # than L0 (flush * growth) stays flat
            use_lsm = (capacity * (lsm_growth - 1) > lsm_growth ** 2 * flush
                       if lsm is None else lsm)
            if use_lsm and capacity > flush * lsm_growth:
                self.store = LSMStore(self.store_spec, capacity, flush,
                                      growth=lsm_growth, device=self.device)
                self.lsm = True
            else:
                self.store = CountStore(self.store_spec, capacity,
                                        self.device)
        else:
            self.merge_every = 1
            self.table = QuotientTable(self.spec, l, self.hash_fn,
                                       max_reprobes=max_reprobes,
                                       device=self.device)
        self.progress_every = max(0, progress_every)
        self.reset()

    def reset(self) -> None:
        """Clear all counts and ingest stats."""
        if self.backend == "sort":
            self.state = self.store.init_state()
            if self.lsm:
                self.store.reset_schedule()
        else:
            self.state = self.table.init_state()
            self.table.inserts = self.table.rounds = 0
        self._pending: list[UniqueCounts] = []
        # the batches' prefix-collision flags, ORed on the device
        self._collided: torch.Tensor | None = None
        self.packer = self._new_packer()
        # reads that took the native parser's one-pass path (a host count,
        # not a PackStats field: checkpoints do not carry it)
        self.parse_fast_reads = 0
        self.batches_processed = 0
        self.elapsed = 0.0
        self._progress_t0 = None
        self._progress_last = 0

    def _new_packer(self) -> ReadPacker:
        return ReadPacker(self.batch, n_policy=self.n_policy, seed=self.seed,
                          collapse=self.collapse_hp)

    def load_store_state(self, ref) -> None:
        """Replace the counts with a store state from the JAX package
        (`tsxcount_tpu` KmerCounter.state's fields as numpy arrays; with
        the LSM store, its collapsed top level), so that a count started
        there continues here.  Ingest stats are kept."""
        self._pending = []
        self.state = self.store.state_from_reference(ref)

    def load_table_state(self, ref) -> None:
        """Replace the counts with a table state from the JAX package
        (`tsxcount_tpu` KmerCounter.state's fields slots, n, spilled and
        probe_hist as numpy arrays; the same k, l, hash and max_reprobes),
        so that a count started there continues here."""
        self.state = self.table.state_from_reference(ref)

    def _adapt_read_len(self, read_lens) -> None:
        """One-shot sizing of the interval budget from the shortest of the
        first read lengths (read_len_hint=0); count state and ingest stats
        carry over."""
        if not self._auto_hint:
            return
        self._auto_hint = False
        lens = [int(x) for x in read_lens]
        if not lens:
            return
        hint = max(self.spec.k, min(lens))
        new_batch = dataclasses.replace(self.batch, read_len_hint=hint)
        if new_batch.max_intervals == self.batch.max_intervals:
            return
        self.batch = new_batch
        stats = self.packer.stats
        self.packer = self._new_packer()
        self.packer.stats = stats

    # --- ingestion ---

    def _put(self, pb: PackedBatch) -> torch.Tensor:
        # words and validity intervals ride ONE buffer: one copy per batch,
        # made on the producer thread
        with span("put"):
            return torch.from_numpy(pb.buf.view(np.int32)).to(self.device)

    def _dedupe(self, buf: torch.Tensor) -> UniqueCounts:
        with span("step"):
            batch = self.batch
            keys = extract_kmer_cols(buf[: batch.total_words], batch)
            if self.canonical:  # before the hash, as in the JAX package
                keys = canonicalize_cols(keys, self.spec)
            if self.hash_first == "mix":
                keys = self.key_map.apply_cols(keys)
            elif self.hash_first == "gf2":  # the product takes stacked rows
                keys = self.key_map.apply(torch.stack(keys, dim=-1))
            elif self.mix_prefix:
                keys = extend_cols(keys)
            valid = intervals_to_valid(buf[batch.total_words :], batch)
            uniform = bool((self.hash_first or self.mix_prefix)
                           and not self._mix_full_sort)
            uc = count_unique(keys, valid, self.store_spec,
                              uniform_prefix=uniform)
            if uc.collided is not None:  # on the device, read once a file
                self._collided = (uc.collided if self._collided is None
                                  else self._collided | uc.collided)
            return uc

    def _flush_pending(self) -> None:
        """Fold the pending batch histograms into the store."""
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        with span("fold"):
            self.state = self.store.merge_stacked(
                self.state,
                torch.stack([u.keys for u in pend]),
                torch.stack([u.counts for u in pend]),
                torch.stack([u.valid for u in pend]),
            )

    def _table_step(self, buf: torch.Tensor) -> None:
        uc = self._dedupe(buf)
        with span("fold"):
            self.state = table_insert(self.table, self.state, uc)

    def _consume_bufs(self, bufs: Iterable[torch.Tensor],
                      stats_fn=None) -> None:
        t0 = time.perf_counter()
        for buf in bufs:
            if self.backend == "table":
                self._table_step(buf)
            else:
                self._pending.append(self._dedupe(buf))
                if len(self._pending) >= self.merge_every:
                    self._flush_pending()
            self.batches_processed += 1
            self._maybe_progress(stats_fn)
        self.elapsed += time.perf_counter() - t0

    def _consume(self, batches: Iterator[PackedBatch]) -> None:
        self._consume_bufs(self._put(pb) for pb in batches)

    def add_reads(self, reads: Iterable[str | bytes]) -> None:
        reads = iter(reads)
        if self._auto_hint:
            sample = list(itertools.islice(reads, _HINT_SAMPLE))
            self._adapt_read_len(len(s) for s in sample)
            reads = itertools.chain(sample, reads)
        for seq in reads:
            self._consume(self.packer.feed(seq))

    def flush(self) -> None:
        """Count the packer's partial batch and fold every pending batch
        histogram into the store (before a checkpoint; finish adds the
        capacity check).  Counting goes on after it: the packer starts a
        new batch."""
        self._consume(self.packer.finish())
        self._flush_pending()

    def finish(self) -> None:
        """flush, then check capacity."""
        self.flush()
        self._check_capacity()

    def _collapse_if_lsm(self) -> None:
        if self.backend == "sort" and self.lsm:
            self.state = self.store.collapse(self.state)

    def _check_capacity(self) -> None:
        # the one host synchronisation per file
        if self.backend == "table":
            with span("sync"):
                spilled = int(self.state.spilled)
            if spilled:
                raise TableFull(
                    f"{spilled} kmers unresolved after "
                    f"{self.table.max_reprobes} reprobes; increase l or "
                    f"max_reprobes"
                )
            return
        # every level's overflow flag and the collision flag: one read
        states = self.state if self.lsm else [self.state]
        flags = [s.overflowed for s in states]
        n_over = len(flags)
        if self._collided is not None:
            flags.append(self._collided)
        self._collided = None
        with span("sync"):
            flags = torch.stack(flags).cpu().tolist()
        if any(flags[:n_over]):
            raise TableFull(
                f"distinct kmers exceeded capacity 2^{self.l}; rerun with "
                f"a larger l"
            )
        if any(flags[n_over:]):
            raise PrefixCollision(PrefixCollision.__doc__)

    def count_file(self, path: str | Path,
                   use_native: bool | None = None) -> None:
        """Count a FASTQ/FASTA(.gz) file.

        use_native: True = the C++ parser (raises if it cannot be built),
        False = the Python packer, None = the C++ parser if it builds.

        A detected dedupe-prefix collision (hash_first or mix_prefix) is
        handled here by recounting the file with the full sort, when this
        counter held no earlier data; otherwise it raises PrefixCollision.
        """
        fresh = (self.batches_processed == 0
                 and self.packer.stats.reads == 0)
        try:
            self._count_file(path, use_native)
        except PrefixCollision:
            if not fresh:
                raise
            print("tsxcount: dedupe-prefix collision detected; recounting "
                  "with the full-comparator sort (exact, ~2x this file's "
                  "cost)", file=sys.stderr)
            self._mix_full_sort = True
            self.reset()
            self._count_file(path, use_native)

    def _count_file(self, path: str | Path, use_native: bool | None) -> None:
        from tsxcount_tpu_torch.io.native import (
            NativeFileReader,
            native_available,
        )
        from tsxcount_tpu_torch.io.pipeline import prefetch

        if self._auto_hint:
            self._adapt_read_len(_peek_read_lens(path))
        if use_native is None:
            use_native = native_available()
        if use_native:
            reader = NativeFileReader(path, self.batch,
                                      n_policy=self.n_policy,
                                      seed=self.seed, threads=self.threads,
                                      collapse=self.collapse_hp)
            self._consume_bufs(
                prefetch(iter(reader), self._put, depth=self.prefetch_depth),
                stats_fn=reader.live_stats,
            )
            self.packer.stats = add_stats(self.packer.stats, reader.stats)
            self.parse_fast_reads += reader.fast_reads
        else:
            packer = self.packer

            def batches():
                for rec in read_fastx(path):
                    yield from packer.feed(rec.seq)
                yield from packer.finish()

            self._consume_bufs(
                prefetch(batches(), self._put, depth=self.prefetch_depth)
            )
        self._flush_pending()
        self._check_capacity()

    # --- queries & export ---

    @property
    def distinct(self) -> int:
        self._flush_pending()
        self._collapse_if_lsm()
        with span("sync"):
            return int((self.state[-1] if self.lsm else self.state).n)

    @property
    def total_kmers(self) -> int:
        st = self.packer.stats
        return st.windows + sum(st.hp_bonus)

    def get_counts(self, kmers: list[str]) -> list[int]:
        """Exact counts for a list of kmer strings (0 if absent)."""
        if not kmers:
            return []
        self._flush_pending()
        keys = strings_to_kmers(kmers, self.spec)
        if self.canonical:
            keys = canonicalize(torch.from_numpy(keys.view(np.int32)),
                                self.spec).numpy().view(np.uint32)
        if self.key_map is not None:  # the store holds the images
            keys = self.key_map.apply_host(keys)
        if self.mix_prefix:  # the store holds (raw, mix) extended keys
            keys = extend_keys_host(keys)
        keys = keys.view(np.int32)
        out: list[int] = []
        for off in range(0, len(kmers), _QUERY_BATCH):
            q = torch.from_numpy(keys[off : off + _QUERY_BATCH]).to(
                self.device)
            if self.backend == "sort":
                counts, _ = self.store.lookup(self.state, q)
                out.extend(counts.cpu().tolist())
                continue
            digits, found = self.table.lookup(self.state, q)
            for (d0, d1, d2), ok in zip(digits.cpu().tolist(),
                                        found.cpu().tolist()):
                out.append(counts_to_int(d0, d1, d2) if ok else 0)
        owed = self._hp_owed_query()
        if owed:
            out = [c + owed.get(s, 0) for s, c in zip(kmers, out)]
        return out

    def items(self) -> Iterator[tuple[str, int]]:
        """Stream (kmer string, count) for every stored k-mer: ascending
        (sort backend) or in slot order (table backend), with any owed
        homopolymer bonus added."""
        self._flush_pending()
        self._collapse_if_lsm()
        if self.backend == "sort":
            keys, counts, _ = self.store.to_host(self.state, self.key_map)
            if self.mix_prefix:  # drop the mix columns
                keys = strip_mix(keys)
        else:
            keys, counts, _ = self.table.to_host(self.state)
        owed = self._hp_owed_emit()
        for kmer_str, cnt in zip(kmers_to_strings(keys, self.spec),
                                 counts.tolist()):
            yield kmer_str, cnt + owed.pop(kmer_str, 0)
        # owed keys the store never saw (bonus set without its runs, e.g.
        # a resumed partial state) are still owed
        for kmer_str, cnt in sorted(owed.items()):
            if cnt:
                yield kmer_str, cnt

    def to_dict(self) -> dict[str, int]:
        return dict(self.items())

    def check(self, golden_path: str | Path, abort: bool = False,
              max_report: int = 20) -> CheckResult:
        """Verify counts against a `kmer\\tcount` golden file."""
        golden = read_golden(golden_path)
        res = CheckResult()
        kmers = list(golden.keys())
        for kmer_str, got in zip(kmers, self.get_counts(kmers)):
            want = golden[kmer_str]
            res.n_checked += 1
            if got == want:
                res.n_matched += 1
                continue
            target = res.missing if got == 0 else res.mismatches
            if len(target) < max_report:
                target.append((kmer_str, want, got))
            if abort:
                raise CheckAbort(
                    f"count mismatch for {kmer_str}: expected {want}, "
                    f"got {got}"
                )
        # coverage audit: with exact counts, every stored kmer was queried
        # iff the distinct totals match
        res.extra_distinct = max(0, self.distinct - len(golden))
        return res

    def stats(self) -> dict:
        table = self.backend == "table"
        st = dataclasses.asdict(self.packer.stats)
        st = {"reads": st["reads"], "parse_fast_reads": self.parse_fast_reads,
              **st}
        st.update(
            backend=self.backend,
            k=self.spec.k,
            l=self.l,
            lanes=self.spec.lanes,
            lsm=self.lsm,
            device=str(self.device),
            distinct_kmers=self.distinct,
            total_kmers=self.total_kmers,
            batches=self.batches_processed,
            device_seconds=round(self.elapsed, 4),
            table_inserts=self.table.inserts if table else 0,
            table_rounds=self.table.rounds if table else 0,
        )
        if table:
            st["fill_factor"] = self.table.fill_factor(self.state)
            st["spilled"] = int(self.state.spilled)
            # reprobe-depth histogram, trailing zeros trimmed
            hist = self.state.probe_hist.cpu().tolist()
            while hist and hist[-1] == 0:
                hist.pop()
            st["probe_histogram"] = hist
        return st

    def print_stats(self) -> None:
        for key, val in self.stats().items():
            print(f"{key}: {val}")
