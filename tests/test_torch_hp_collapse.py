"""Homopolymer collapse in the port (collapse_homopolymers=True): exact
counts against the uncollapsed port, the JAX package and a brute-force
count; the native parser's batches and bonus against the Python packer's;
and the read-time bonus, large counts and canonical spellings included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.config import BatchSpec as JBatchSpec  # noqa: E402
from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu.io.packer import ReadPacker as JReadPacker  # noqa: E402
from tsxcount_tpu_torch import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.config import BatchSpec, KmerSpec  # noqa: E402
from tsxcount_tpu_torch.io.native import NativeFileReader  # noqa: E402
from tsxcount_tpu_torch.io.packer import (  # noqa: E402
    ReadPacker,
    collapse_homopolymers,
)

from tests.test_hp_collapse import _brute_counts, _hp_reads  # noqa: E402

CPU = "cpu"


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def test_collapse_transform_brute_force():
    rng = np.random.default_rng(1)
    k = 7
    keep = 2 * k - 2
    for _ in range(60):
        codes = rng.integers(0, 4, size=rng.integers(k, 120)).astype(np.uint8)
        for _ in range(rng.integers(0, 4)):  # runs
            i = rng.integers(0, len(codes))
            j = min(len(codes), i + rng.integers(1, 50))
            codes[i:j] = codes[i]
        invalid = rng.random(len(codes)) < 0.05
        want, got = {}, {}
        for p in range(len(codes) - k + 1):
            if not invalid[p : p + k].any():
                t = tuple(codes[p : p + k])
                want[t] = want.get(t, 0) + 1
        c2, i2, bonus = collapse_homopolymers(codes, invalid, keep)
        for p in range(len(c2) - k + 1):
            if not i2[p : p + k].any():
                t = tuple(c2[p : p + k])
                got[t] = got.get(t, 0) + 1
        for c in range(4):
            if bonus[c]:
                key = (c,) * k
                got[key] = got.get(key, 0) + int(bonus[c])
        assert got == want


@pytest.mark.parametrize("backend,canonical", [
    ("sort", False), ("sort", True), ("table", False),
])
def test_counts_exact_with_collapse(backend, canonical):
    rng = np.random.default_rng(3)
    k = 9
    reads = _hp_reads(rng, k=k)
    kw = dict(k=k, l=14, backend=backend, batch_words=256,
              canonical=canonical)
    counter = KmerCounter(collapse_homopolymers=True, device=CPU, **kw)
    plain = KmerCounter(collapse_homopolymers=False, device=CPU, **kw)
    ref = JKmerCounter(collapse_homopolymers=True, **kw)
    for c in (counter, plain, ref):
        c.add_reads(reads)
        c.finish()
    assert sum(counter.packer.stats.hp_bonus) > 0  # collapse really fired
    assert counter.packer.stats.hp_bonus == ref.packer.stats.hp_bonus
    assert counter.total_kmers == plain.total_kmers == ref.total_kmers
    assert counter.to_dict() == plain.to_dict() == ref.to_dict()


def test_collapse_against_brute_force_counts():
    rng = np.random.default_rng(5)
    k = 9
    reads = _hp_reads(rng, k=k)
    counter = KmerCounter(k=k, l=14, batch_words=256,
                          collapse_homopolymers=True, device=CPU)
    counter.add_reads(reads)
    counter.finish()
    want = _brute_counts(reads, k)
    assert counter.to_dict() == want
    assert counter.total_kmers == sum(want.values())
    assert counter.get_counts(list(want)) == list(want.values())


def test_native_packer_parity_with_collapse(tmp_path):
    """The native parser with collapse on gives the Python packer's
    batches and bonus, in the port and in the JAX package."""
    rng = np.random.default_rng(7)
    k = 11
    reads = _hp_reads(rng, n_reads=40, k=k)
    path = tmp_path / "hp.fastq"
    _write_fastq(path, reads)
    batch = BatchSpec(KmerSpec(k), 64, 64)
    bufs = {}
    for name, packer in (
            ("port", ReadPacker(batch, collapse=True)),
            ("jax", JReadPacker(JBatchSpec(JKmerSpec(k), 64, 64),
                                collapse=True))):
        out = []
        for seq in reads:
            out.extend(pb.buf.copy() for pb in packer.feed(seq))
        out.extend(pb.buf.copy() for pb in packer.finish())
        bufs[name] = (out, packer.stats)
    nat = NativeFileReader(path, batch, collapse=True)
    nat_bufs = [pb.buf.copy() for pb in nat]
    for out, stats in bufs.values():
        assert len(out) == len(nat_bufs)
        for a, b in zip(out, nat_bufs):
            np.testing.assert_array_equal(a, b)
        assert tuple(stats.hp_bonus) == tuple(nat.stats.hp_bonus)
        assert stats.windows == nat.stats.windows
    assert sum(nat.stats.hp_bonus) > 0


def test_count_file_with_collapse_matches_jax(tmp_path, capsys):
    """count_file through the native parser with collapse on equals the
    JAX package's count; progress_every=1 prints a line a batch from the
    parser's live stats."""
    rng = np.random.default_rng(13)
    k = 11
    reads = _hp_reads(rng, n_reads=60, k=k)
    path = tmp_path / "hp.fastq"
    _write_fastq(path, reads)
    kw = dict(k=k, l=14, batch_words=64, collapse_homopolymers=True)
    port = KmerCounter(device=CPU, progress_every=1, **kw)
    port.count_file(path, use_native=True)
    ref = JKmerCounter(**kw)
    ref.count_file(path, use_native=False)
    assert sum(port.packer.stats.hp_bonus) > 0
    assert port.to_dict() == ref.to_dict() == _brute_counts(reads, k)
    assert port.total_kmers == ref.total_kmers
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("progress: batches=")]
    assert len(lines) == port.batches_processed > 1
    assert f"reads={len(reads)} " in lines[-1]


def test_live_stats_while_the_reader_finishes(tmp_path):
    """Progress lines read the parser's stats from the consumer's thread
    while the thread that drains the reader closes its handles: with a
    short switch interval, live_stats never touches a closed handle and
    ends on the final stats."""
    import sys
    import threading

    rng = np.random.default_rng(19)
    reads = _hp_reads(rng, n_reads=60, k=11)
    path = tmp_path / "hp.fastq"
    _write_fastq(path, reads)
    batch = BatchSpec(KmerSpec(11), 32, 32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            reader = NativeFileReader(path, batch, threads=2, collapse=True)
            t = threading.Thread(target=lambda: list(reader))
            t.start()
            while t.is_alive():
                reader.live_stats()
            t.join(timeout=30)
            assert not t.is_alive()
            assert reader.live_stats() == reader.stats
            assert reader.stats.reads == len(reads)
    finally:
        sys.setswitchinterval(interval)


def test_read_time_bonus_large_counts():
    """Owed bonus above 2^30 is added exactly at read time, also for keys
    the store never saw (a partial state resumed)."""
    counter = KmerCounter(k=5, l=10, batch_words=64, device=CPU)
    counter.add_reads(["AAAAAGG"])  # the store sees AAAAA once
    counter.finish()
    counter.packer.stats.hp_bonus = (3, (1 << 30) + 7, 0, 2)
    d = counter.to_dict()
    assert d["AAAAA"] == 3 + 1
    assert d["CCCCC"] == (1 << 30) + 7
    assert d["TTTTT"] == 2
    assert counter.get_counts(["AAAAA", "CCCCC", "GGGGG", "TTTTT"]) == [
        4, (1 << 30) + 7, 0, 2,
    ]
    assert counter.total_kmers == 3 + 3 + (1 << 30) + 7 + 2


def test_read_time_bonus_canonical_query_spellings():
    """In canonical mode both homopolymer spellings of a complement pair
    see the folded bonus."""
    counter = KmerCounter(k=5, l=10, batch_words=64, canonical=True,
                          device=CPU)
    counter.add_reads(["AAAAA" + "CGTAG"])
    counter.finish()
    counter.packer.stats.hp_bonus = (2, 0, 0, 5)  # A-runs + T-runs
    base = counter.get_counts(["AAAAA"])[0]
    assert counter.get_counts(["TTTTT"])[0] == base
    assert counter.to_dict()["AAAAA"] == base
    assert base >= 7  # 2 + 5 folded into the canonical A key
