"""The benchmark's k = 256 table configuration
(`portbench/configs/table-k256.json`) on the CPU: the sharded counter built
from the file's own keywords counts `synth-long`-shaped reads exactly as the
benchmark's plain reference does, with nothing spilled; its geometry builds
at the file's full 2^26 slots of 20 columns; the table's split rounds are a
span nested in the fold, counted in `stats()`, and never open on the sort
backend; the byte counts of kernels 4 and 5 behind their roofline shares;
and where the LSM auto rule engages at the benchmark's batch settings."""

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from portbench import reference, roofline, run, table_roofline, traffic  # noqa: E402
from tsxcount_tpu_torch import _build  # noqa: E402
from tsxcount_tpu_torch.core.store import CountStore  # noqa: E402
from tsxcount_tpu_torch.core.table import QuotientTable  # noqa: E402
from tsxcount_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedKmerCounter,
)
from tsxcount_tpu_torch.utils.profiling import (  # noqa: E402
    reset_spans,
    span_totals,
)

# the CPU holds a smaller table and batches: l and batch_words are the only
# keywords changed from the configuration's file (2^26 slots, 2^20 words)
SMALL = dict(l=16, batch_words=256)


def _counter(config: str, **kw) -> ShardedKmerCounter:
    cfg = run.load_config(config)
    return ShardedKmerCounter(device="cpu", **dict(cfg["counter"], **kw))


def _fastq(tmp_path, seed: int, reads: int) -> str:
    """`synth-long` as the benchmark writes it, at fewer reads."""
    mix = dict(run.load_traffic("synth-long"), reads=reads)
    path = str(tmp_path / "reads.fastq")
    traffic.write_fastq(mix, seed, path)
    return path


@pytest.mark.parametrize("seed,reads", [(3, 24), (2 ** 33 + 11, 40)])
def test_the_configuration_counts_like_the_reference(tmp_path, seed, reads):
    counter = _counter("table-k256", **SMALL)
    assert (counter.spec.k, counter.spec.lanes) == (256, 16)
    assert counter.backend == "table" and counter.table.slot_cols == 20
    path = _fastq(tmp_path, seed, reads)
    counter.count_file(path)
    want = reference.reference_count(path, 256)
    assert counter.distinct == want[0].shape[0]
    got = run.export(counter, 256)
    check = reference.compare(want, got)  # every number the cell checks
    assert len(check) >= 5 and set(check.values()) == {0}, check
    assert counter.table.state_stats(counter.state)["spilled"] == 0
    st = counter.stats()
    # every batch is a split round 0, then rounds until the tail's width
    assert st["table_inserts"] == st["batches"] > 1
    assert 1 <= st["table_inserts"] <= st["table_split_rounds"]
    assert st["table_split_rounds"] <= st["table_rounds"]
    assert st["table_residue_launches"] == 0  # the CPU takes plain rounds


def test_the_configuration_builds_at_its_full_geometry(monkeypatch):
    """2^26 slots of 20 columns: past the JAX package's cap on 2^L x
    columns (int32 flat element addresses), inside the port's (doubled
    slot addresses); constructed only, with the slot array stubbed out."""
    monkeypatch.setattr(QuotientTable, "init_state", lambda self: None)
    counter = _counter("table-k256")
    table = counter.table
    assert (table.slots, table.slot_cols) == (1 << 26, 20)
    assert table.slots * table.slot_cols * 4 == 5_368_709_120  # 5.37 GB
    assert counter.batch.positions == 1 << 24


@pytest.mark.parametrize("config,split", [("table-k256", True),
                                          ("table-k14", True),
                                          ("sort-k127", False),
                                          ("sort-k14", False)])
def test_the_split_span_opens_inside_the_fold_on_the_table_only(tmp_path,
                                                                 config,
                                                                 split):
    counter = _counter(config, **SMALL)
    path = _fastq(tmp_path, 7, 8)
    counter.count_file(path)  # the read-length hint settles
    counter.reset()
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        counter.count_file(path)
        counter.distinct
    tot = span_totals()
    st = counter.stats()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in ("tsx.fold", "tsx.table_split")]
    folds = [(s, e) for n, s, e in events if n == "tsx.fold"]
    splits = [(s, e) for n, s, e in events if n == "tsx.table_split"]
    assert folds
    if not split:
        assert "table_split" not in tot and not splits
        assert st["table_split_rounds"] == 0
        return
    assert tot["table_split"][0] == len(splits) == st["table_split_rounds"]
    assert st["table_inserts"] <= len(splits) <= st["table_rounds"]
    for s, e in splits:  # every split round inside a fold
        assert any(s0 <= s and e <= e0 for s0, e0 in folds)
    # the fold's self time leaves out the split rounds and the host reads
    n_fold, total_fold, self_fold = tot["fold"]
    nested = tot["table_split"][1] + tot["sync"][1]
    assert self_fold <= total_fold - tot["table_split"][1] + 1e-6
    assert self_fold >= total_fold - nested - 1e-6


@pytest.fixture
def fresh_tables(monkeypatch):
    """Launch counts and shapes of this test alone."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(_build, "_SHAPES", {})


def test_table_kernel_bytes_at_the_wide_rounds_measured_shapes():
    """Kernels 5 and 4 at the wide table's round (2^24 destinations,
    11,473,005 of them live: PERF.md's kernel table, 17 and 19 columns):
    the shares' floors, and the counts beside the kernel-alone times,
    which add the live slot words that only the card knows."""
    e, live = 1 << 24, 11_473_005
    gather = table_roofline.round_bytes(e, 17)
    assert gather == 1_207_959_552  # dst2 read, 17 probe columns written
    # + each live slot word of 17 columns read: 1.99 GB
    assert round((gather + 17 * live * 4) / 1e7) == 199
    apply = table_roofline.round_bytes(e, 19)
    assert apply == 1_342_177_280  # dst2 and 19 value columns read
    # the kernel-alone count reads the live rows' values alone, and 4 B
    # read and 4 B written a nonzero update (18 of 19 columns a live row
    # in that round): 2.59 GB
    alone = apply - 19 * (e - live) * 4 + 18 * live * 8
    assert round(alone / 1e7) == 259
    # the k = 14 table's main round: 2 probe columns, 4 value columns
    assert table_roofline.round_bytes(e, 2) == 3 * 4 * e
    assert table_roofline.round_bytes(e, 4) == 5 * 4 * e


@pytest.mark.parametrize("metric,kernel,device_op", [
    ("kernels.table_gather.roofline_pct", "gather_sorted",
     "void tsx::(anonymous namespace)::gather_sorted_kernel<17>(...)"),
    ("kernels.table_apply.roofline_pct", "apply_sorted_unique",
     "void tsx::(anonymous namespace)::apply_sorted_unique_kernel<19>(...)"),
])
def test_the_table_roofline_readers(fresh_tables, metric, kernel,
                                    device_op):
    """A reader sums its kernel's launches by shape over its device time,
    at the card's peak, and finds nothing without launches."""
    reader = run.load_metric(metric)
    rec = {"jobs": 2, "busy_s": 1.0, "window_s": 2.0,
           "device_ops": {device_op: 0.004,
                          "void merge_tile_kernel<1>(ColSet, ...)": 0.5}}
    assert reader.read(rec) is None  # no launch recorded
    with profile(activities=[ProfilerActivity.CPU]):
        _build.count_launch(kernel, elements=1 << 20, cols=17)
        _build.count_launch(kernel, elements=1 << 20, cols=17)
        _build.count_launch(kernel, elements=4096, cols=19)
        _build.count_launch("compact_flagged", rows=1 << 20, cols=18)
    moved = (2 * table_roofline.round_bytes(1 << 20, 17)
             + table_roofline.round_bytes(4096, 19))
    want = 100.0 * moved / roofline.HBM_BYTES_PER_S / 0.004
    assert reader.read(rec) == pytest.approx(want)
    assert reader.read(dict(rec, device_ops={})) is None


@pytest.mark.parametrize("l_bits,lsm", [(26, False), (28, False),
                                        (29, False), (30, True)])
def test_the_lsm_auto_rule_engages_from_l_30_at_the_cells_batches(
        monkeypatch, l_bits, lsm):
    """sort-k14's keywords (one shard, 2^20-word batches, merge_every 4)
    with `lsm` unset: a flush is 4 x 2^24 = 2^26 rows, and the rule
    engages the LSM where 2^l x 7 > 64 x 2^26 and 2^l > 8 x 2^26, so
    from l = 30.  Constructed only, with the stores' allocations stubbed
    out."""
    from tsxcount_tpu_torch.core.lsm import LSMStore

    monkeypatch.setattr(CountStore, "init_state", lambda self: None)
    monkeypatch.setattr(LSMStore, "init_state", lambda self: None)
    counter = _counter("sort-k14", l=l_bits)
    assert run.load_config("sort-k14")["counter"]["lsm"] is None
    assert counter.lsm is lsm
    assert isinstance(counter.store, LSMStore if lsm else CountStore)
