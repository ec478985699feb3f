"""The store interface (core/store.py) under both counters: the flat
CountStore, the LSMStore and the QuotientTable, each held by KmerCounter
and by ShardedKmerCounter(n_shards=1), count one small FASTQ; the calls
a counter makes of its store (the read state, the full flag, int64
lookups of the stored query keys and the export) are held against the
JAX package's count of the same file."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu_torch import (  # noqa: E402
    CountStore,
    KmerCounter,
    LSMStore,
    QuotientTable,
    ShardedKmerCounter,
)
from tsxcount_tpu_torch.utils.sequence import kmers_to_strings  # noqa: E402

from tests.test_packer import rand_reads  # noqa: E402

K = 14
KW = dict(l=18, batch_words=64, merge_every=2)
STORES = {"flat": (CountStore, dict(backend="sort", lsm=False)),
          "lsm": (LSMStore, dict(backend="sort", lsm=True, lsm_growth=2)),
          "table": (QuotientTable, dict(backend="table"))}


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """Reads, their file, and the JAX package's counts of it."""
    reads = rand_reads(np.random.default_rng(29), 40, 30, 260,
                       alphabet="ACGTNACGT")
    path = tmp_path_factory.mktemp("iface") / "r.fastq"
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    ref = JKmerCounter(k=K, **KW)
    ref.count_file(path, use_native=False)
    return path, ref.to_dict()


def _counter(cls, store_kw):
    if cls is ShardedKmerCounter:
        return ShardedKmerCounter(k=K, n_shards=1, device="cpu",
                                  **KW, **store_kw)
    return KmerCounter(k=K, device="cpu", **KW, **store_kw)


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("cls", [KmerCounter, ShardedKmerCounter],
                         ids=["plain", "sharded"])
def test_each_store_answers_the_interface(fastq, cls, store):
    path, want = fastq
    store_cls, store_kw = STORES[store]
    c = _counter(cls, store_kw)
    assert type(c.store) is store_cls and c.lsm is (store == "lsm")
    c.count_file(path, use_native=False)
    assert c.batches_processed > c.merge_every
    c._prepare()  # what every read does first
    read = c.store.read_state(c.state)
    assert read is (c.state[-1] if store == "lsm" else c.state)
    assert int(read.n) == len(want)
    assert not bool(c.store.full_flag(c.state))

    queries = list(want)[:50] + ["A" * K, "ACGT" * 3 + "AC"]
    counts = c.store.counts_of(c.state, c._query_keys(queries))
    assert counts.dtype == torch.int64
    assert counts.tolist() == [want.get(q, 0) for q in queries]

    keys, counts = c.store.export(c.state)
    assert keys.shape == (len(want), c.spec.lanes)
    if getattr(c, "hashed_store", False):  # the sharded table's images
        keys = c.route_map.inv_apply(keys)
    got = dict(zip(kmers_to_strings(keys.numpy().view(np.uint32), c.spec),
                   counts.tolist()))
    assert got == want
    # the stats keys the backend adds: the plain counter's table alone
    # reports its fill
    st = c.stats()
    assert (st["table_inserts"] > 0) is (store == "table")
    assert ("fill_factor" in st) is (store == "table" and cls is KmerCounter)
