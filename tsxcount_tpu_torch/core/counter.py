"""KmerCounter — the end-to-end streaming counter — and BaseCounter, the
user surface it shares with parallel/sharded.py's ShardedKmerCounter.

Which module decides what:
  * this module's KmerCounter: the backend (once, in its constructor,
    when it builds the store), the LSM rule and the key maps (hash_first,
    mix_prefix, key_map), and its step: extract -> (canonical) -> map ->
    dedupe (ops/count.py count_unique_ops: sort + kernel 1);
  * the store (core/store.py CountStore, core/lsm.py LSMStore,
    core/table.py QuotientTable, one interface): how a step's output is
    folded in (every `merge_every` batches: kernel 2's merge tree and
    kernel 3 into the sorted store or the LSM's L0; on the table, reprobe
    rounds of kernels 5, 4 and 1 at the JAX package's host widths), what
    reads see, what "full" means and how counts decode;
  * BaseCounter: ingest helpers, the recount after a prefix collision,
    `finish`'s one read of the flags, the reads, check, stats and the
    homopolymer bonus, for both counters.

From 8 lanes (k >= 113), or with hash_first, each batch's keys first go
through a bijection, the lane mix (ops/mix.py, one kernel) or with
hash_first="gf2" the seeded GF(2) matrix (ops/gf2.py, a float32 matmul on
bit planes): the store holds the images and the dedupe sorts only their
>= 64-bit prefix.  With mix_prefix the keys are extended by two
mixing-hash columns instead (ops/mix.py mix_cols), the store holds the
extended keys and the dedupe sorts (flag, mix_hi, mix_lo).  Either way a
detected prefix collision makes count_file recount with the full sort.

Parsing, packing and the host-to-device copy run on a producer thread
(io/pipeline.py); this thread launches the device work, which PyTorch
queues without waiting.  The sort backend synchronises once per file or
query, the table backend also once per batch and per round (the counts
that size the rounds).

Canonical mode folds each window to min(kmer, revcomp) after extraction
(ops/canonical.py); homopolymer collapse splices long all-X runs at ingest
and adds the elided counts back wherever counts leave the store
(BaseCounter).  Both, the LSM rule and the store layouts are the JAX
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
from tsxcount_tpu_torch.config import BatchSpec, KmerSpec
from tsxcount_tpu_torch.core.lsm import LSMStore
from tsxcount_tpu_torch.core.store import CountStore
from tsxcount_tpu_torch.core.table import QuotientTable
from tsxcount_tpu_torch.io.fastx import peek_read_lens, read_fastx
from tsxcount_tpu_torch.io.packer import PackedBatch, ReadPacker, add_stats
from tsxcount_tpu_torch.ops.canonical import canonicalize, canonicalize_cols
from tsxcount_tpu_torch.ops.count import UniqueOps, count_unique_ops
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


class BaseCounter:
    """The user surface of both counters (this module's KmerCounter and
    parallel/sharded.py's ShardedKmerCounter): ingest helpers, the
    prefix-collision recount, `finish`'s one read of the flags, reads,
    the check, stats and the homopolymer bonus.  A counter holds its
    store in `store` (core/store.py's interface) and its state in
    `state`, and defines what differs: `_prepare` (the folds a read needs
    first), `_query_keys`, `_export_parts`, `_own_stats`, `flush`,
    `_count_file`, and the collective `_sum` where it has ranks.

    Homopolymer collapse: with it on, the ingest splices all-c runs down
    to 2k-2 bases and owes `stats.hp_bonus[c]` occurrences of the all-c
    k-mer (io/packer.py collapse_homopolymers).  The spliced run keeps k-1
    all-c windows, so the key is in the store; the owed count is added on
    the host wherever counts leave the store (get_counts, items, check).
    """

    QUERY_BATCH = 1 << 16
    HINT_SAMPLE = 64  # reads sampled for the auto read-length hint
    progress_every: int = 0

    def reset(self) -> None:
        """Clear all counts and ingest stats."""
        self.state = self.store.init_state()
        self._to_fold: list = []  # step outputs the next fold takes
        # [hard spill, prefix collisions] of the steps since the last
        # finish, on the device (summed over the ranks there)
        self._health = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.packer = self._new_packer()
        # reads that took the native parser's one-pass path (a host count,
        # not a PackStats field: checkpoints do not carry it)
        self.parse_fast_reads = 0
        self.batches_processed = 0
        self.elapsed = 0.0
        self._progress_t0 = None
        self._progress_last = 0

    # --- ingestion ---

    def _new_packer(self) -> ReadPacker:
        return ReadPacker(self.batch, n_policy=self.n_policy, seed=self.seed,
                          collapse=self.collapse_hp)

    def _adapt_read_len(self, read_lens) -> None:
        """One-shot sizing of the interval budget from the shortest of the
        first read lengths (read_len_hint=0); count state and ingest stats
        carry over.  The sharded exchange's shapes depend on the positions
        only, so ranks that size it differently still exchange alike."""
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

    def _hinted(self, reads: Iterable[str | bytes]) -> Iterator:
        """`reads`, the read-length hint sized from its first reads."""
        reads = iter(reads)
        if self._auto_hint:
            sample = list(itertools.islice(reads, self.HINT_SAMPLE))
            self._adapt_read_len(len(s) for s in sample)
            reads = itertools.chain(sample, reads)
        return reads

    def _put(self, pb: PackedBatch) -> torch.Tensor:
        # words and validity intervals ride ONE buffer: one copy a batch,
        # made on the producer thread
        with span("put"):
            return torch.from_numpy(pb.buf.view(np.int32)).to(self.device)

    def _maybe_progress(self, stats_fn=None) -> None:
        """One stderr progress line every `progress_every` batches (off
        at 0)."""
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

    def _sum(self, values) -> list[int]:
        """A list of ints (or an int64 tensor on the counter's device) as
        host ints: one host read."""
        t = torch.as_tensor(values, dtype=torch.int64, device=self.device)
        with span("sync"):
            return t.tolist()

    def count_file(self, path: str | Path,
                   use_native: bool | None = None) -> None:
        """Count a FASTQ/FASTA(.gz) file.

        use_native: True = the C++ parser (raises if it cannot be built),
        False = the Python packer, None = the C++ parser if it builds.

        A detected dedupe-prefix collision (hash_first, mix_prefix or a
        hashed shard store; every rank sees it) is handled here by
        recounting the file with the full sort, when this counter held no
        earlier data; otherwise it raises PrefixCollision.
        """
        fresh = (self.batches_processed == 0
                 and self._hp_stats().reads == 0)
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

    def finish(self) -> None:
        """flush, then check the flags."""
        self.flush()
        self._check_flags()

    def _check_flags(self) -> None:
        """The store's full flag and the steps' spill and collision flags
        in one read (summed over the ranks: every rank raises the same
        error)."""
        full = self.store.full_flag(self.state).to(torch.int64).reshape(1)
        over, spill, taint = self._sum(torch.cat([full, self._health]))
        self._health.zero_()
        if over:
            raise TableFull(f"{self.store.FULL}; rerun with a larger l")
        if spill:
            raise TableFull(
                f"{spill} routed kmers overflowed both the per-destination "
                f"capacity and the spill carry; increase capacity_factor")
        if taint:
            raise PrefixCollision(PrefixCollision.__doc__)

    # --- queries & export ---

    @property
    def distinct(self) -> int:
        self._prepare()
        return self._sum(self.store.read_state(self.state).n.reshape(1))[0]

    @property
    def total_kmers(self) -> int:
        st = self._hp_stats()
        return st.windows + sum(st.hp_bonus)

    def get_counts(self, kmers: list[str]) -> list[int]:
        """Exact counts for a list of kmer strings (0 if absent)."""
        if not kmers:
            return []
        keys = self._query_keys(kmers)
        out: list[int] = []
        for off in range(0, len(kmers), self.QUERY_BATCH):
            q = keys[off : off + self.QUERY_BATCH].to(self.device)
            out.extend(self._sum(self.store.counts_of(self.state, q)))
        owed = self._hp_owed_query()
        if owed:
            out = [c + owed.get(s, 0) for s, c in zip(kmers, out)]
        return out

    def items(self) -> Iterator[tuple[str, int]]:
        """Stream (kmer string, count) for every stored k-mer, in the
        store's order (ascending by stored key, or the table's slot order;
        shard after shard), with any owed homopolymer bonus added."""
        self._prepare()
        owed = self._hp_owed_emit()
        for keys, counts in self._export_parts():
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
        st = dataclasses.asdict(self._hp_stats())
        st = {"reads": st["reads"], "parse_fast_reads": self.parse_fast_reads,
              **st}
        st.update(backend=self.backend, k=self.spec.k, l=self.l,
                  lanes=self.spec.lanes, lsm=self.lsm,
                  device=str(self.device))
        st.update(self._own_stats())
        st.update(table_inserts=self.store.inserts,
                  table_residue_launches=self.store.residue_launches,
                  table_rounds=self.store.rounds,
                  table_split_rounds=self.store.split_rounds)
        return st

    def print_stats(self) -> None:
        for key, val in self.stats().items():
            print(f"{key}: {val}")

    # --- checkpoints (core/checkpoint.py) ---

    def _shard_reference(self) -> dict[str, np.ndarray]:
        """The read state as the JAX package's state fields (numpy), after
        every pending read, batch and run is folded in."""
        self.flush()
        self._prepare()
        return self.store.state_to_reference(self.state)

    def _load_shard_reference(self, ref) -> None:
        """Replace the counts with a JAX package state (numpy fields; an
        LSM's collapsed top level), so that a count started there
        continues here.  Ingest stats are kept."""
        self._to_fold = []
        self.state = self.store.state_from_reference(ref)

    # --- the homopolymer bonus ---

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


class KmerCounter(BaseCounter):
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
            self.store = self.table = QuotientTable(
                self.spec, l, self.hash_fn, max_reprobes=max_reprobes,
                device=self.device)
        self.progress_every = max(0, progress_every)
        self.reset()

    def load_store_state(self, ref) -> None:
        """Replace the counts with a state from the JAX package
        (`tsxcount_tpu` KmerCounter.state's fields as numpy arrays: a
        store's, with the LSM store its collapsed top level, or a table's
        slots, n, spilled and probe_hist at the same k, l, hash and
        max_reprobes), so that a count started there continues here.
        Ingest stats are kept."""
        self._load_shard_reference(ref)

    load_table_state = load_store_state

    # --- ingestion ---

    def _dedupe(self, buf: torch.Tensor) -> UniqueOps:
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
            uo = count_unique_ops(keys, valid, self.store_spec,
                                  uniform_prefix=uniform)
            if uo.collided is not None:  # on the device, read at finish
                self._health[1] += uo.collided.to(torch.int64)
            return uo

    def _flush_pending(self) -> None:
        """Fold the pending batch histograms into the store."""
        if not self._to_fold:
            return
        pend, self._to_fold = self._to_fold, []
        with span("fold"):
            self.state = self.store.merge_batches(self.state, pend)

    def _consume_bufs(self, bufs: Iterable[torch.Tensor],
                      stats_fn=None) -> None:
        t0 = time.perf_counter()
        for buf in bufs:
            self._to_fold.append(self._dedupe(buf))
            if len(self._to_fold) >= self.merge_every:
                self._flush_pending()
            self.batches_processed += 1
            self._maybe_progress(stats_fn)
        self.elapsed += time.perf_counter() - t0

    def _consume(self, batches: Iterator[PackedBatch]) -> None:
        self._consume_bufs(self._put(pb) for pb in batches)

    def add_reads(self, reads: Iterable[str | bytes]) -> None:
        for seq in self._hinted(reads):
            self._consume(self.packer.feed(seq))

    def flush(self) -> None:
        """Count the packer's partial batch and fold every pending batch
        histogram into the store (before a checkpoint; finish adds the
        capacity check).  Counting goes on after it: the packer starts a
        new batch."""
        self._consume(self.packer.finish())
        self._flush_pending()

    def _count_file(self, path: str | Path, use_native: bool | None) -> None:
        from tsxcount_tpu_torch.io.native import (
            NativeFileReader,
            native_available,
        )
        from tsxcount_tpu_torch.io.pipeline import prefetch

        if self._auto_hint:
            self._adapt_read_len(peek_read_lens(path, self.HINT_SAMPLE))
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
        self._check_flags()

    # --- reads (BaseCounter's) ---

    def _prepare(self) -> None:
        self._flush_pending()
        self.state = self.store.collapse(self.state)

    def _query_keys(self, kmers: list[str]) -> torch.Tensor:
        """The stored form of the query k-mers (int32 [N, lanes], on the
        host: copied a chunk at a time).  Reads sum the LSM's levels, as
        the JAX counter's do: no collapse."""
        self._flush_pending()
        keys = strings_to_kmers(kmers, self.spec)
        if self.canonical:
            keys = canonicalize(torch.from_numpy(keys.view(np.int32)),
                                self.spec).numpy().view(np.uint32)
        if self.key_map is not None:  # the store holds the images
            keys = self.key_map.apply_host(keys)
        if self.mix_prefix:  # the store holds (raw, mix) extended keys
            keys = extend_keys_host(keys)
        return torch.from_numpy(keys.view(np.int32))

    def _export_parts(self) -> Iterator[tuple]:
        keys, counts, _ = self.store.to_host(self.state, self.key_map)
        if self.mix_prefix:  # drop the mix columns
            keys = strip_mix(keys)
        yield keys, counts

    def _own_stats(self) -> dict:
        return dict(distinct_kmers=self.distinct,
                    total_kmers=self.total_kmers,
                    batches=self.batches_processed,
                    device_seconds=round(self.elapsed, 4))

    def stats(self) -> dict:
        st = super().stats()
        st.update(self.store.state_stats(self.state))
        return st
