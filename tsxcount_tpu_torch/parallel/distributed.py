"""Counting a file over several ranks: each rank reads its share.

The port of `tsxcount_tpu/parallel/distributed.py`, with one rank a shard
(parallel/mesh.py):

  * an uncompressed file splits by byte offset: rank r opens only its
    1/N byte range and the native parser resyncs to a record boundary
    (io/native.py `split_ranges`), so the parse is O(file / N) a rank;
  * gzip input (not seekable) and the pure-Python packer stripe by
    record index: each rank parses everything but packs only the records
    where (index // stride) % N == rank;
  * every step is collective, but the ranks' shares pack into different
    numbers of batches, so ingest runs in ROUNDS: each rank takes up to
    `round_groups` batches from its prefetch pipeline, one
    all_reduce(MAX) agrees on the round's length, and a rank short of
    batches steps empty ones.  Rounds end when every rank reports none
    left, so every rank enters the same collectives, however unequal
    the shares, one rank's being empty included.

One rank reads the whole file with the counter's parse threads (gzip
included, which the native parser reads as one stream), and its rounds
need no agreement.
"""

from __future__ import annotations

import itertools
import os
import time
from pathlib import Path
from typing import Iterator

from tsxcount_tpu_torch.io.fastx import SeqRecord, peek_read_lens, read_fastx


def striped_records(path: str | Path, rank: int, n_ranks: int,
                    stride: int = 64) -> Iterator[SeqRecord]:
    """This rank's stripe of records: index // stride mod n_ranks.
    Contiguous stripes of `stride` records keep each rank's batches dense
    while spreading read-length variance over the ranks."""
    for i, rec in enumerate(read_fastx(path)):
        if (i // stride) % n_ranks == rank:
            yield rec


def host_input_mode(path: str | Path, n_ranks: int,
                    use_native: bool | None = None) -> str:
    """'range' (the native parser on this rank's byte range, or on the
    whole file for one rank) or 'stripe' (record striping: gzip over
    several ranks, or no native parser)."""
    from tsxcount_tpu_torch.io.native import is_gzip, native_available

    if use_native is None:
        use_native = native_available()
    if not use_native:
        return "stripe"
    return "range" if n_ranks == 1 or not is_gzip(path) else "stripe"


def run_round(counter, items: list, put=None) -> int:
    """Step `items` (device batch buffers, or batches that `put` copies
    to the device one at a time) on this rank after agreeing the round's
    length with every rank; a rank short of batches steps empty ones.
    Returns the length (0: every rank had none)."""
    target = counter._max(len(items))
    for i in range(target):
        if i >= len(items):
            counter._step_buf(counter._empty_buf())
        else:
            counter._step_buf(put(items[i]) if put else items[i])
    return target


def count_file_distributed(counter, path: str | Path, stride: int = 64,
                           round_groups: int = 4,
                           use_native: bool | None = None) -> str:
    """Feed a ShardedKmerCounter this rank's share of `path`, streaming,
    then `finish` (a collective, as every step).  Parse, pack and the copy
    to the device run on a producer thread at most `prefetch_depth`
    batches ahead.  Returns the input mode ('range' or 'stripe')."""
    from tsxcount_tpu_torch.io.packer import add_stats
    from tsxcount_tpu_torch.io.pipeline import prefetch

    rank, n_ranks = counter.rank, counter.n_shards
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    mode = host_input_mode(path, n_ranks, use_native)
    # the same file head on every rank: the same interval budget
    if counter._auto_hint:
        counter._adapt_read_len(peek_read_lens(path, counter.HINT_SAMPLE))
    reader = None
    batches = iter(())
    if mode == "range":
        from tsxcount_tpu_torch.io.native import (
            NativeFileReader,
            split_ranges,
        )

        # a file of fewer bytes than ranks leaves the last ranks none
        ranges = [(0, -1)] if n_ranks == 1 else split_ranges(path, n_ranks)
        if rank < len(ranges):
            reader = NativeFileReader(
                path, counter.batch, n_policy=counter.n_policy,
                seed=counter.seed, threads=counter.threads,
                collapse=counter.collapse_hp, byte_start=ranges[rank][0],
                byte_end=ranges[rank][1])
            batches = iter(reader)
            counter._live_stats_fn = reader.live_stats
    else:
        def batches_of_stripe():
            for rec in striped_records(path, rank, n_ranks, stride):
                yield from counter.packer.feed(rec.seq)
            yield from counter.packer.finish()

        batches = batches_of_stripe()
    ready = prefetch(batches, counter._put, depth=counter.prefetch_depth)
    rounds = 0
    t0 = time.perf_counter()
    try:
        while run_round(counter, list(itertools.islice(ready,
                                                       round_groups))):
            rounds += 1
    finally:
        counter._live_stats_fn = None
    counter.elapsed += time.perf_counter() - t0
    counter._stream_rounds = rounds
    if reader is not None:
        counter.packer.stats = add_stats(counter.packer.stats, reader.stats)
        counter.parse_fast_reads += reader.fast_reads
    counter.finish()
    return mode
