"""KmerCounter — the end-to-end streaming counter, sort backend.

Streams FASTQ/FASTA records, packs them on the host (io/), and folds each
fixed-shape batch through the device: window extraction, an exact batch
histogram (sort + kernel 1), and every `merge_every` batches one store
merge (kernel 2's merge tree, then kernel 3 into the store).  Parsing,
packing and the host-to-device copy run on a producer thread
(io/pipeline.py); this thread launches the device work, which PyTorch
queues without waiting, and synchronises once per file or query.

The device is explicit: "cuda" (the default) raises where no GPU is
present, and nothing falls back to the CPU unless asked for.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

from tsxcount_tpu_torch.config import BatchSpec, KmerSpec
from tsxcount_tpu_torch.core.store import CountStore
from tsxcount_tpu_torch.io.fastx import read_fastx
from tsxcount_tpu_torch.io.packer import PackedBatch, ReadPacker, add_stats
from tsxcount_tpu_torch.ops.count import UniqueCounts, count_unique
from tsxcount_tpu_torch.ops.window import extract_kmer_cols, intervals_to_valid
from tsxcount_tpu_torch.utils.goldenfile import read_golden
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
MAX_LANES = 7  # from 8 lanes (k >= 113) the JAX package engages a lane mix

_QUERY_BATCH = 1 << 16
_HINT_SAMPLE = 64  # reads sampled for the auto read-length hint


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tsxcount_tpu_torch yet ({item} of "
        f"ROADMAP.md); use tsxcount_tpu for it"
    )


def _peek_read_lens(path) -> list[int]:
    """Lengths of the first few records (for interval-budget auto-sizing)."""
    return [len(rec.seq)
            for rec in itertools.islice(read_fastx(path), _HINT_SAMPLE)]


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to count on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


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
    """Distinct k-mers exceeded the store's capacity 2^l."""


class KmerCounter:
    def __init__(
        self,
        k: int,
        l: int = 26,
        s: int = 4,
        backend: str = "sort",
        batch_words: int = 1 << 16,
        n_policy: str = "drop",
        seed: int = 0,
        merge_every: int = 4,
        canonical: bool = False,
        lsm: bool | None = None,
        threads: int = 0,
        prefetch_depth: int = 3,
        read_len_hint: int = 0,
        collapse_homopolymers: bool = False,
        hash_first: bool | str | None = None,
        mix_prefix: bool | None = None,
        device: str | torch.device = "cuda",
    ):
        backend = MODE_TO_BACKEND.get(backend, backend)
        if backend == "table":
            raise _not_ported("backend='table' (modes CAS, TSX, "
                              "EXPERIMENTAL)", "Queue 1 item 11")
        if backend != "sort":
            raise ValueError(f"backend must be 'sort' or a reference mode "
                             f"{sorted(MODE_TO_BACKEND)}")
        if canonical:
            raise _not_ported("canonical=True", "Queue 1 item 9")
        if lsm:
            raise _not_ported("lsm=True", "Queue 1 item 8")
        if hash_first:
            raise _not_ported("hash_first", "Queue 1 item 7")
        if mix_prefix:
            raise _not_ported("mix_prefix", "the 'Do not port' list")
        if collapse_homopolymers:
            raise _not_ported("collapse_homopolymers=True", "Queue 1 item 13")
        self.spec = KmerSpec(k)
        if self.spec.lanes > MAX_LANES:
            raise _not_ported(f"k={k} ({self.spec.lanes} lanes, lane mix)",
                              "Queue 1 item 7")
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
        self.merge_every = max(1, merge_every)
        # lsm=None uses the flat store: counts are exact either way, and the
        # JAX package's auto rule for the LSM store is a TPU measurement
        self.lsm = False
        self.store = CountStore(self.spec, 1 << l, self.device)
        self.reset()

    def reset(self) -> None:
        """Clear all counts and ingest stats."""
        self.state = self.store.init_state()
        self._pending: list[UniqueCounts] = []
        self.packer = ReadPacker(self.batch, n_policy=self.n_policy,
                                 seed=self.seed)
        self.batches_processed = 0
        self.elapsed = 0.0

    def load_store_state(self, ref) -> None:
        """Replace the counts with a store state from the JAX package
        (`tsxcount_tpu` KmerCounter.state's fields as numpy arrays), so that
        a count started there continues here.  Ingest stats are kept."""
        self._pending = []
        self.state = self.store.state_from_reference(ref)

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
        self.packer = ReadPacker(self.batch, n_policy=self.n_policy,
                                 seed=self.seed)
        self.packer.stats = stats

    # --- ingestion ---

    def _put(self, pb: PackedBatch) -> torch.Tensor:
        # words and validity intervals ride ONE buffer: one copy per batch,
        # made on the producer thread
        return torch.from_numpy(pb.buf.view(np.int32)).to(self.device)

    def _dedupe(self, buf: torch.Tensor) -> UniqueCounts:
        batch = self.batch
        cols = extract_kmer_cols(buf[: batch.total_words], batch)
        valid = intervals_to_valid(buf[batch.total_words :], batch)
        return count_unique(cols, valid, self.spec)

    def _flush_pending(self) -> None:
        """Fold the pending batch histograms into the store."""
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        self.state = self.store.merge_stacked(
            self.state,
            torch.stack([u.keys for u in pend]),
            torch.stack([u.counts for u in pend]),
            torch.stack([u.valid for u in pend]),
        )

    def _consume_bufs(self, bufs: Iterable[torch.Tensor]) -> None:
        t0 = time.perf_counter()
        for buf in bufs:
            self._pending.append(self._dedupe(buf))
            if len(self._pending) >= self.merge_every:
                self._flush_pending()
            self.batches_processed += 1
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

    def finish(self) -> None:
        """Flush the final partial batch and check capacity."""
        self._consume(self.packer.finish())
        self._flush_pending()
        self._check_capacity()

    def _check_capacity(self) -> None:
        # the one host synchronisation per file
        if bool(self.state.overflowed):
            raise TableFull(
                f"distinct kmers exceeded capacity 2^{self.l}; rerun with "
                f"a larger l"
            )

    def count_file(self, path: str | Path,
                   use_native: bool | None = None) -> None:
        """Count a FASTQ/FASTA(.gz) file.

        use_native: True = the C++ parser (raises if it cannot be built),
        False = the Python packer, None = the C++ parser if it builds.
        """
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
                                      seed=self.seed, threads=self.threads)
            self._consume_bufs(
                prefetch(iter(reader), self._put, depth=self.prefetch_depth)
            )
            self.packer.stats = add_stats(self.packer.stats, reader.stats)
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
        return int(self.state.n)

    @property
    def total_kmers(self) -> int:
        return self.packer.stats.windows

    def get_counts(self, kmers: list[str]) -> list[int]:
        """Exact counts for a list of kmer strings (0 if absent)."""
        if not kmers:
            return []
        self._flush_pending()
        keys = strings_to_kmers(kmers, self.spec).view(np.int32)
        out: list[int] = []
        for off in range(0, len(kmers), _QUERY_BATCH):
            q = torch.from_numpy(keys[off : off + _QUERY_BATCH]).to(
                self.device)
            counts, _ = self.store.lookup(self.state, q)
            out.extend(counts.cpu().tolist())
        return out

    def items(self) -> Iterator[tuple[str, int]]:
        """Stream (kmer string, count) for every stored k-mer, ascending."""
        self._flush_pending()
        keys, counts, _ = self.store.to_host(self.state)
        for kmer_str, cnt in zip(kmers_to_strings(keys, self.spec),
                                 counts.tolist()):
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
        st = dataclasses.asdict(self.packer.stats)
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
            host_seconds=round(self.elapsed, 4),
        )
        return st

    def print_stats(self) -> None:
        for key, val in self.stats().items():
            print(f"{key}: {val}")
