"""The slice as a whole: the port's KmerCounter (device="cpu", so every
kernel runs its plain version) against the JAX package's KmerCounter on the
same seeded reads and files.  Counts are integers: the dumps, totals and
query answers must be identical."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu.utils.goldenfile import write_golden  # noqa: E402
from tsxcount_tpu_torch import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.core.counter import CheckAbort, TableFull  # noqa: E402

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402


def _pair(reads, k, **kw):
    ref = JKmerCounter(k=k, **kw)
    ref.add_reads(reads)
    ref.finish()
    port = KmerCounter(k=k, device="cpu", **kw)
    port.add_reads(reads)
    port.finish()
    return ref, port


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


@pytest.mark.parametrize("k", [9, 14, 16, 33])
def test_dump_totals_and_queries_match_jax(k):
    rng = np.random.default_rng(k)
    reads = rand_reads(rng, 40, max(1, k - 4), 3 * k + 80, alphabet="ACGTN")
    ref, port = _pair(reads, k, l=12, batch_words=64, merge_every=3)
    want = ref.to_dict()
    assert port.to_dict() == want == dict(naive_kmers(reads, k))
    assert list(port.items()) == sorted(want.items(),
                                        key=lambda kv: kv[0][::-1])
    assert port.distinct == ref.distinct
    assert port.total_kmers == ref.total_kmers
    queries = list(want)[:30] + ["A" * k, "C" * k, "G" * (k - 1) + "T"]
    assert port.get_counts(queries) == ref.get_counts(queries)
    st = port.stats()
    assert st["lsm"] is False and st["device"] == "cpu"
    assert st["distinct_kmers"] == ref.distinct


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_stats_keys_contain_jax_keys(backend):
    """After one small count, the port's stats() has every key of the JAX
    package's (device_seconds included), with equal totals."""
    rng = np.random.default_rng(5)
    reads = rand_reads(rng, 20, 20, 90)
    ref, port = _pair(reads, 14, l=12, batch_words=64, backend=backend)
    pst, rst = port.stats(), ref.stats()
    assert set(rst) <= set(pst), set(rst) - set(pst)
    assert isinstance(pst["device_seconds"], float)
    for key in ("distinct_kmers", "total_kmers", "batches", "backend"):
        assert pst[key] == rst[key]


def test_check_against_jax_golden(tmp_path):
    rng = np.random.default_rng(3)
    reads = rand_reads(rng, 30, 20, 90)
    ref, port = _pair(reads, 14, l=12, batch_words=32)
    golden = tmp_path / "g.count"
    write_golden(golden, ref.to_dict())
    res = port.check(golden)
    assert res.ok and res.n_matched == res.n_checked == ref.distinct
    want = ref.to_dict()
    kmer = next(iter(want))
    want[kmer] += 1
    write_golden(golden, want)
    res = port.check(golden)
    assert not res.ok and res.mismatches == [(kmer, want[kmer],
                                              want[kmer] - 1)]
    with pytest.raises(CheckAbort):
        port.check(golden, abort=True)


def test_table_full_raises():
    rng = np.random.default_rng(2)
    reads = rand_reads(rng, 30, 30, 60)
    port = KmerCounter(k=10, l=4, batch_words=32, device="cpu")
    port.add_reads(reads)
    with pytest.raises(TableFull):
        port.finish()


def test_known_frequencies():
    """Known relative frequencies N, N/2, N/2, N/4 come out exact."""
    n = 2048
    kmers = ["ACGTACGTACGTAC", "TTTTACGTACGTAC", "ACGTACGTTTTTTT",
             "GGGGACGTACGTAC"]
    freqs = [n, n // 2, n // 2, n // 4]
    reads = [km for km, f in zip(kmers, freqs) for _ in range(f)]
    order = np.random.default_rng(0).permutation(len(reads))
    port = KmerCounter(k=14, l=12, batch_words=16, device="cpu")
    port.add_reads([reads[i] for i in order])
    port.finish()
    assert port.to_dict() == dict(zip(kmers, freqs))


@pytest.mark.parametrize("use_native", [True, False])
def test_count_file_matches_jax(tmp_path, use_native):
    rng = np.random.default_rng(17)
    reads = rand_reads(rng, 60, 10, 300, alphabet="ACGTNACGT")
    path = tmp_path / "r.fastq"
    _write_fastq(path, reads)
    ref = JKmerCounter(k=14, l=14, batch_words=256)
    ref.count_file(path, use_native=False)
    port = KmerCounter(k=14, l=14, batch_words=256, device="cpu")
    port.count_file(path, use_native=use_native)
    assert port.to_dict() == ref.to_dict()
    assert port.total_kmers == ref.total_kmers
    assert port.stats()["n_bases"] == ref.stats()["n_bases"] > 0


def test_resume_jax_store_in_port(tmp_path):
    """A store counted by the JAX package continues in the port and ends
    equal to a whole-file count by the JAX package."""
    rng = np.random.default_rng(23)
    reads = rand_reads(rng, 50, 20, 200)
    full, second = tmp_path / "full.fastq", tmp_path / "second.fastq"
    _write_fastq(full, reads)
    _write_fastq(second, reads[20:])
    kw = dict(k=14, l=13, batch_words=128, read_len_hint=64)
    whole = JKmerCounter(**kw)
    whole.count_file(full, use_native=False)
    first = JKmerCounter(**kw)
    first.add_reads(reads[:20])
    first.finish()
    port = KmerCounter(device="cpu", **kw)
    port.load_store_state(
        {f: np.asarray(v) for f, v in first.state._asdict().items()})
    port.count_file(second, use_native=True)
    assert port.to_dict() == whole.to_dict()
