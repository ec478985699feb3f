"""The one-shard hand-off of the sharded counter (parallel/sharded.py
`_route_direct`): at one shard with no spill carry, a batch's histogram
goes from the dedupe to the store merge as kernel 1's operand columns.

Every store it builds is held word for word against the padded route
(the same counter with `_direct_route` cleared: rows, padding, the slice
gather, the identity exchange and `merge_stacked`), at the benchmark's
k = 14 and k = 127 configurations at small shapes: the flat store after
`count_file`, the LSM's levels mid-stream, and the table's state; and
the plain KmerCounter's store against the row fold it replaced.  Also:
the hand-off's step count in `stats()` and a prefix collision that
recounts through the hand-off (a carry's padded route and several ranks:
tests/test_torch_sharded.py, tests/test_torch_distributed.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import reference, run, traffic  # noqa: E402
from tsxcount_tpu_torch.config import KmerSpec  # noqa: E402
from tsxcount_tpu_torch.core.store import CountStore  # noqa: E402
from tsxcount_tpu_torch.core.counter import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.ops.count import (  # noqa: E402
    count_unique,
    count_unique_ops,
    histogram_run,
    unique_rows,
)
from tsxcount_tpu_torch.parallel import sharded as sharded_mod  # noqa: E402
from tsxcount_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedKmerCounter,
)
from tsxcount_tpu_torch.utils.sequence import (  # noqa: E402
    strings_to_kmers,
)

# the CPU holds a smaller store and batches (the configurations' files:
# 2^26 rows, 2^20 words)
SMALL = dict(l=16, batch_words=256)
CONFIGS = {"sort-k14": 14, "sort-k127": 127}


def _counter(config: str, padded: bool = False, **kw) -> ShardedKmerCounter:
    """The configuration's counter at SMALL (and kw); padded: cleared
    from the hand-off, so that it takes the padded route at one shard."""
    cfg = run.load_config(config)
    c = ShardedKmerCounter(device="cpu",
                           **dict(cfg["counter"], **dict(SMALL, **kw)))
    if padded:
        assert c._direct_route
        c._direct_route = False
    return c


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """`synth-long` as the benchmark writes it, at 30 reads: 8 batches
    at SMALL, so several flushes of the store."""
    mix = dict(run.load_traffic("synth-long"), reads=30)
    path = str(tmp_path_factory.mktemp("handoff") / "reads.fastq")
    traffic.write_fastq(mix, 2 ** 33 + 19, path)
    return path


def _reads(path: str) -> list[str]:
    with open(path) as f:
        return f.read().splitlines()[1::4]


def _same_store(a, b) -> None:
    for field in ("keys", "counts", "n", "overflowed"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("config", list(CONFIGS))
def test_hand_off_store_equals_the_padded_route(fastq, config):
    direct, padded = _counter(config), _counter(config, padded=True)
    for c in (direct, padded):
        c.count_file(fastq)
    assert direct.batches_processed > direct.merge_every
    _same_store(direct.state, padded.state)
    st = direct.stats()
    assert st["route_direct_batches"] == st["batches"] > 0
    assert padded.stats()["route_direct_batches"] == 0
    want = reference.reference_count(fastq, CONFIGS[config])
    check = reference.compare(want, run.export(direct, CONFIGS[config]))
    assert set(check.values()) == {0}, check


@pytest.mark.parametrize("config", list(CONFIGS))
def test_hand_off_lsm_levels_equal_the_padded_route(fastq, config):
    """The LSM's L0 takes the hand-off's runs (LSMStore.merge_runs): every
    level, mid-stream and before any collapse, equals the padded route's,
    after L0 absorbed into L1 at least once."""
    kw = dict(lsm=True, lsm_growth=2, merge_every=1, l=18)
    direct, padded = (_counter(config, p, **kw) for p in (False, True))
    reads = _reads(fastq)
    for c in (direct, padded):
        c.add_reads(reads)
    assert direct.lsm and direct.store.absorbs > 0
    for a, b in zip(direct.state, padded.state, strict=True):
        _same_store(a, b)
    # stats() collapses the levels: read it after the comparison
    assert direct.stats()["route_direct_batches"] == direct.batches_processed


def test_hand_off_table_state_equals_the_padded_route(fastq):
    """The table re-dedupes the hand-off's run from its operand columns:
    the table's state after count_file is the padded route's word for
    word."""
    direct = _counter("table-k14")
    padded = _counter("table-k14", padded=True)
    for c in (direct, padded):
        c.count_file(fastq)
    a = direct.table.state_to_reference(direct.state)
    b = padded.table.state_to_reference(padded.state)
    assert a.keys() == b.keys()
    for field in a:
        np.testing.assert_array_equal(a[field], b[field], err_msg=field)
    st = direct.stats()
    assert st["route_direct_batches"] == st["batches"] > 0


@pytest.mark.parametrize("k", list(CONFIGS.values()))
def test_plain_counter_store_equals_the_row_fold(fastq, k):
    """KmerCounter's sort step hands kernel 1's operand runs to
    `merge_runs` (CountStore.merge_batches): its store equals, word for
    word, a counter that unpacks the same batches to [P, lanes] rows and
    folds them with `merge_stacked`, the path before the hand-off (at
    k = 127 the lane mix's images)."""
    kw = dict(k=k, l=16, batch_words=256, lsm=False, device="cpu")
    runs, rows = KmerCounter(**kw), KmerCounter(**kw)

    def row_fold(state, uos):
        ucs = [unique_rows(uo, rows.store.spec) for uo in uos]
        return rows.store.merge_stacked(
            state, *(torch.stack([getattr(u, f) for u in ucs])
                     for f in ("keys", "counts", "valid")))

    rows.store.merge_batches = row_fold
    for c in (runs, rows):
        c.count_file(fastq)
    assert runs.batches_processed > runs.merge_every
    assert (runs.hash_first == "mix") is (k == 127)
    _same_store(runs.state, rows.state)
    want = reference.reference_count(fastq, k)
    check = reference.compare(want, run.export(runs, k))
    assert set(check.values()) == {0}, check


def test_reset_clears_the_hand_off_count(fastq):
    c = _counter("sort-k14")
    c.count_file(fastq)
    assert c.stats()["route_direct_batches"] > 0
    c.reset()
    assert c.stats()["route_direct_batches"] == 0


def test_forced_collision_recounts_through_the_hand_off(fastq, monkeypatch,
                                                        capsys):
    """A collision flag forced on every prefix-sorted batch of the k = 127
    configuration: the flag reaches the health vector from the hand-off,
    count_file recounts with the full sort, through the hand-off again,
    and the counts are exact."""
    real = sharded_mod.count_unique_ops
    calls = []

    def colliding(kmers, valid, spec, uniform_prefix=False):
        calls.append(uniform_prefix)
        uo = real(kmers, valid, spec, uniform_prefix=uniform_prefix)
        if uniform_prefix:
            uo = uo._replace(collided=torch.ones((), dtype=torch.bool))
        return uo

    monkeypatch.setattr(sharded_mod, "count_unique_ops", colliding)
    c = _counter("sort-k127")
    c.count_file(fastq)
    assert c._mix_full_sort and True in calls and calls[-1] is False
    assert "recounting with the full-comparator sort" in (
        capsys.readouterr().err)
    st = c.stats()
    assert st["route_direct_batches"] == st["batches"] > 0
    want = reference.reference_count(fastq, 127)
    check = reference.compare(want, run.export(c, 127))
    assert set(check.values()) == {0}, check


@pytest.mark.parametrize("k", [14, 64, 127])
def test_histogram_run_is_the_packed_rows_run(k):
    """ops/count.py histogram_run of count_unique_ops' columns equals
    CountStore.pack_runs of count_unique's stacked rows, word for word
    (at k = 64 the top lane is full and the flag a column of its own)."""
    rng = np.random.default_rng(k)
    spec = KmerSpec(k)
    seqs = ["".join(rng.choice(list("ACGT"), k)) for _ in range(40)]
    kmers = torch.from_numpy(
        strings_to_kmers(seqs * 3, spec).view(np.int32))[
            torch.from_numpy(rng.permutation(120))]
    valid = torch.from_numpy(rng.random(120) < 0.8)
    uo = count_unique_ops(kmers, valid, spec)
    uc = count_unique(kmers, valid, spec)
    rows = torch.arange(120) < uo.n_unique
    got = histogram_run(uo.ops, uo.counts, rows, spec)
    (want,) = CountStore(spec, 256, "cpu").pack_runs(
        uc.keys[None], uc.counts[None], uc.valid[None])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
