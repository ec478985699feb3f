"""The table backend as a whole: the port's KmerCounter(backend="table",
device="cpu"), every kernel as its plain version, against the JAX
package's KmerCounter(backend="table") on the same seeded reads and files.
The table states must be equal word for word (slots, n, spilled,
probe_hist), and dumps, totals, queries and stats identical: all integers,
exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu.utils.goldenfile import write_golden  # noqa: E402
from tsxcount_tpu_torch import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.core.counter import CheckAbort, TableFull  # noqa: E402

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402
from tests.test_torch_counter import _write_fastq  # noqa: E402

TABLE_STATS = ("distinct_kmers", "total_kmers", "batches", "fill_factor",
               "spilled", "probe_histogram", "reads", "windows")


def assert_same_table(ref, port):
    got = port.table.state_to_reference(port.state)
    for f in ("slots", "n", "spilled", "probe_hist"):
        want = np.asarray(getattr(ref.state, f))
        assert got[f].dtype == want.dtype and np.array_equal(got[f], want), f


def _fastq(tmp_path, k, seed, n_reads=60):
    rng = np.random.default_rng(seed)
    reads = rand_reads(rng, n_reads, max(1, k - 4), 3 * k + 250,
                       alphabet="ACGTNACGT")
    path = tmp_path / f"r{k}.fastq"
    _write_fastq(path, reads)
    return path, reads


@pytest.mark.parametrize("k,l,bw,use_native", [
    (14, 12, 256, True), (14, 12, 256, False), (31, 12, 128, True),
])
def test_count_file_state_matches_jax(tmp_path, k, l, bw, use_native):
    path, reads = _fastq(tmp_path, k, k)
    ref = JKmerCounter(k=k, l=l, backend="table", batch_words=bw)
    ref.count_file(path, use_native=False)
    port = KmerCounter(k=k, l=l, backend="table", batch_words=bw,
                       device="cpu")
    port.count_file(path, use_native=use_native)
    assert port.batches_processed > 1
    assert_same_table(ref, port)
    want = ref.to_dict()
    assert port.to_dict() == want == dict(naive_kmers(reads, k))
    assert list(port.items()) == list(ref.items())  # slot order
    assert (port.distinct, port.total_kmers) == (ref.distinct,
                                                 ref.total_kmers)
    queries = list(want)[:40] + ["A" * k, "C" * k, "G" * (k - 1) + "T"]
    assert port.get_counts(queries) == ref.get_counts(queries)
    pst, rst = port.stats(), ref.stats()
    assert {f: pst[f] for f in TABLE_STATS} == {f: rst[f] for f in
                                                 TABLE_STATS}
    assert pst["backend"] == "table" and pst["device"] == "cpu"


@pytest.mark.parametrize("mode", ["CAS", "TSX", "EXPERIMENTAL"])
def test_mode_aliases_count_like_jax(mode):
    rng = np.random.default_rng(len(mode))
    reads = rand_reads(rng, 30, 16, 120)
    ref = JKmerCounter(k=16, l=11, backend=mode, batch_words=64)
    ref.add_reads(reads)
    ref.finish()
    port = KmerCounter(k=16, l=11, backend=mode, batch_words=64,
                       device="cpu")
    port.add_reads(reads)
    port.finish()
    assert port.backend == "table"
    assert_same_table(ref, port)
    assert port.to_dict() == ref.to_dict()


def test_check_and_check_abort(tmp_path):
    rng = np.random.default_rng(3)
    reads = rand_reads(rng, 30, 20, 90)
    port = KmerCounter(k=14, l=12, backend="table", batch_words=32,
                       device="cpu")
    port.add_reads(reads)
    port.finish()
    golden = tmp_path / "g.count"
    want = dict(naive_kmers(reads, 14))
    write_golden(golden, want)
    res = port.check(golden)
    assert res.ok and res.n_matched == res.n_checked == port.distinct
    kmer = next(iter(want))
    want[kmer] += 1
    write_golden(golden, want)
    res = port.check(golden)
    assert not res.ok and res.mismatches == [(kmer, want[kmer],
                                              want[kmer] - 1)]
    with pytest.raises(CheckAbort):
        port.check(golden, abort=True)


def test_table_full_on_tiny_l():
    rng = np.random.default_rng(2)
    reads = rand_reads(rng, 30, 30, 60)
    ref = JKmerCounter(k=10, l=4, backend="table", batch_words=32)
    ref.add_reads(reads)
    port = KmerCounter(k=10, l=4, backend="table", batch_words=32,
                       device="cpu")
    port.add_reads(reads)
    with pytest.raises(TableFull):
        port.finish()
    with pytest.raises(Exception, match="unresolved"):
        ref.finish()
    assert_same_table(ref, port)
    assert port.stats()["spilled"] == int(ref.state.spilled) > 0


def test_resume_jax_table_in_port(tmp_path):
    """A table counted by the JAX package continues in the port and ends
    with the counts of a whole-file count by the JAX package (the layout
    differs: the batches split elsewhere)."""
    rng = np.random.default_rng(23)
    reads = rand_reads(rng, 50, 20, 200)
    full, second = tmp_path / "full.fastq", tmp_path / "second.fastq"
    _write_fastq(full, reads)
    _write_fastq(second, reads[20:])
    kw = dict(k=14, l=14, backend="table", batch_words=128,
              read_len_hint=64)
    whole = JKmerCounter(**kw)
    whole.count_file(full, use_native=False)
    first = JKmerCounter(**kw)
    first.add_reads(reads[:20])
    first.finish()
    port = KmerCounter(device="cpu", **kw)
    port.load_table_state(
        {f: np.asarray(v) for f, v in first.state._asdict().items()})
    port.count_file(second, use_native=True)
    assert port.to_dict() == whole.to_dict()
    assert port.distinct == whole.distinct


def test_reset_and_wide_k():
    """k=127 (8 lanes, 12 slot columns) counts exactly; reset() clears."""
    rng = np.random.default_rng(127)
    reads = rand_reads(rng, 12, 130, 200)
    port = KmerCounter(k=127, l=10, backend="table", batch_words=64,
                       device="cpu")
    port.add_reads(reads)
    port.finish()
    assert port.table.slot_cols == 12
    assert port.to_dict() == dict(naive_kmers(reads, 127))
    port.reset()
    assert port.distinct == 0 and port.to_dict() == {}
