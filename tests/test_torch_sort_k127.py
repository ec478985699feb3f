"""The benchmark's k = 127 configuration (`portbench/configs/sort-k127.json`)
on the CPU: the sharded counter built from the file's own keywords counts
`synth-long`-shaped reads exactly as the benchmark's plain reference does;
the lane mix is a span nested in the step at 8 lanes and never opens at
k = 14; the per-launch shape table records only under a profiler; the
roofline byte counts of `portbench/roofline.py` at the kernels' measured
shapes; and the export's decode of wide keys."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from portbench import reference, roofline, run, traffic  # noqa: E402
from tsxcount_tpu_torch import KmerSpec, _build  # noqa: E402
from tsxcount_tpu_torch.config import BASES_PER_WORD  # noqa: E402
from tsxcount_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedKmerCounter,
)
from tsxcount_tpu_torch.utils.profiling import (  # noqa: E402
    reset_spans,
    span_totals,
)
from tsxcount_tpu_torch.utils.sequence import (  # noqa: E402
    kmers_to_strings,
)

# the CPU holds a smaller store and batches: l and batch_words are the only
# keywords changed from the configuration's file (2^26 rows, 2^20 words)
SMALL = dict(l=16, batch_words=256)


def _counter(config: str) -> ShardedKmerCounter:
    cfg = run.load_config(config)
    return ShardedKmerCounter(device="cpu", **dict(cfg["counter"], **SMALL))


def _fastq(tmp_path, seed: int, reads: int) -> str:
    """`synth-long` as the benchmark writes it, at fewer reads."""
    mix = dict(run.load_traffic("synth-long"), reads=reads)
    path = str(tmp_path / "reads.fastq")
    traffic.write_fastq(mix, seed, path)
    return path


@pytest.mark.parametrize("seed,reads", [(1, 24), (2 ** 33 + 7, 40)])
def test_the_configuration_counts_like_the_reference(tmp_path, seed, reads):
    counter = _counter("sort-k127")
    assert (counter.spec.k, counter.spec.lanes) == (127, 8)
    assert counter.hashed_store and counter.routing_hash == "mix"
    path = _fastq(tmp_path, seed, reads)
    counter.count_file(path)
    assert not counter._mix_full_sort  # no prefix collision, no recount
    want = reference.reference_count(path, 127)
    assert counter.distinct == want[0].shape[0]
    got = run.export(counter, 127)
    check = reference.compare(want, got)  # every number the cell checks
    assert len(check) >= 5 and set(check.values()) == {0}, check
    # several batches a job and more than one flush of the store
    assert counter.batches_processed > counter.merge_every


@pytest.mark.parametrize("config,mixed", [("sort-k127", True),
                                          ("sort-k14", False)])
def test_the_mix_span_opens_inside_the_step_at_8_lanes_only(tmp_path,
                                                            config, mixed):
    counter = _counter(config)
    path = _fastq(tmp_path, 5, 8)
    counter.count_file(path)  # the read-length hint settles
    counter.reset()
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        counter.count_file(path)
        counter.distinct
    tot = span_totals()
    assert ("mix" in tot) == mixed
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("tsx.step", "tsx.mix")]
    steps = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if e.name() == "tsx.step"]
    mixes = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if e.name() == "tsx.mix"]
    assert steps and len(mixes) == (len(steps) if mixed else 0)
    for s, e in mixes:  # one forward mix inside each batch's step
        assert any(s0 <= s and e <= e0 for s0, e0 in steps)
    if mixed:
        n_step, total_step, self_step = tot["step"]
        assert tot["mix"][0] == n_step
        assert self_step == pytest.approx(total_step - tot["mix"][1],
                                          abs=1e-6)
        # the export's inverse mix runs with no profiler: nothing recorded
        reset_spans()
        assert len(list(counter.items())) == counter.distinct
        assert span_totals() == {}


@pytest.fixture
def fresh_tables(monkeypatch):
    """Launch counts and shapes of this test alone."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(_build, "_SHAPES", {})


@pytest.mark.parametrize("name,shape", [
    ("lane_mix", dict(positions=1 << 24, lanes=8, input_bytes=1 << 29)),
    ("merge_dedupe_sorted", dict(m=1 << 26, n=1 << 25, n_keys=8)),
    ("merge_sorted", dict(m=7, n=9, n_keys=9, payload_cols=1)),
    ("compact_flagged", dict(rows=100, cols=10)),
    ("apply_sorted_unique", dict(elements=64, cols=4)),
    ("gather_sorted", dict(elements=64, cols=2)),
])
def test_launch_shapes_are_kept_only_under_a_profiler(fresh_tables, name,
                                                      shape):
    _build.count_launch(name, **shape)
    assert _build.launch_shapes() == []
    with profile(activities=[ProfilerActivity.CPU]):
        _build.count_launch(name, **shape)
        _build.count_launch(name, **shape)
        _build.count_launch(name, **dict(shape, cols=1))
    _build.count_launch(name, **shape)
    assert _build.launch_counts()[name] == 5  # the counts as before
    got = sorted(_build.launch_shapes(), key=lambda t: -t[2])
    assert got == [(name, shape, 2), (name, dict(shape, cols=1), 1)]
    _build.reset_launch_shapes()
    assert _build.launch_shapes() == []
    assert _build.launch_counts()[name] == 5


def test_a_callable_shape_value_is_called_only_under_a_profiler(
        fresh_tables):
    calls = []

    def size():
        calls.append(1)
        return 7

    _build.count_launch("lane_mix", positions=3, lanes=1, input_bytes=size)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        _build.count_launch("lane_mix", positions=3, lanes=1,
                            input_bytes=size)
    assert calls == [1]
    assert _build.launch_shapes() == [
        ("lane_mix", dict(positions=3, lanes=1, input_bytes=7), 1)]


@pytest.mark.parametrize("k", [14, 127])
def test_the_routing_steps_lanes_share_their_bytes(k):
    """The window columns the routing step mixes are views of one stream,
    16 positions apart, but the top lane, a masked copy: their distinct
    bytes are the stream's and the copy's, not lanes x positions x 4."""
    from tsxcount_tpu_torch.config import BatchSpec
    from tsxcount_tpu_torch.ops.window import extract_kmer_cols

    spec = KmerSpec(k)
    batch = BatchSpec(spec, 64)
    words = torch.arange(batch.total_words, dtype=torch.int32)
    cols = extract_kmer_cols(words, batch)
    p = batch.positions
    # lanes below the top one: stream[16 j : 16 j + p]
    stream = (p + 16 * (spec.lanes - 2)) * 4 if spec.lanes > 1 else 0
    assert _build.distinct_bytes(cols) == stream + 4 * p
    separate = [c.clone() for c in cols]
    assert _build.distinct_bytes(separate) == spec.lanes * 4 * p


def test_roofline_bytes_at_the_kernels_measured_shapes():
    # the lane mix alone on 8 separate columns of 2^24 positions: 1,074 MB
    # read and written
    assert roofline.lane_mix_bytes(1 << 24, 8, 8 << 26) == 1_073_741_824
    # in the routing step the 8 lanes read 2 columns' worth: 671 MB
    step = roofline.lane_mix_bytes(1 << 24, 8, ((1 << 25) + 96) * 4)
    assert round(step / 1e6) == 671
    # kernel 3's store merge, a 2^26-row store run + a 2^25-row batch run
    # at one key word: its 2,063 MB less the 71,275,347-row output
    inputs = roofline.merge_dedupe_bytes(1 << 26, 1 << 25, 1)
    assert inputs == 1_207_959_552
    assert round((inputs + 71_275_347 * 12) / 1e6) == 2_063
    # the k = 127 store: 40 B a row of 8 key words and an int64 count
    assert roofline.merge_dedupe_bytes(1 << 26, 0, 8) == 40 << 26


def _decode_lane_by_lane(keys: np.ndarray, spec: KmerSpec) -> list[str]:
    """The decode as it was: every base's 2 bits shifted out of its word
    into an (N, lanes, 16) array."""
    keys = np.asarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    if n == 0:
        return []
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, None, :]
    codes = ((keys[:, :, None] >> shifts) & 3).reshape(n, -1)[:, : spec.k]
    chars = np.frombuffer(b"ACGT", dtype=np.uint8)[codes.astype(np.uint8)]
    blob = chars.tobytes().decode("ascii")
    return [blob[i * spec.k : (i + 1) * spec.k] for i in range(n)]


@pytest.mark.parametrize("k,n", [(1, 5), (14, 70_001), (16, 3), (17, 0),
                                 (127, 140_000), (128, 9), (256, 65_537)])
def test_the_decode_is_the_lane_by_lane_decode(k, n):
    """Byte for byte, over more than one block of rows, on full 32-bit
    words (and the top lane as a key holds it), from a column view."""
    spec = KmerSpec(k)
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 2**32, (n, spec.lanes), dtype=np.uint32)
    assert kmers_to_strings(keys, spec) == _decode_lane_by_lane(keys, spec)
    keys[:, -1] &= np.uint32(spec.top_lane_mask)
    view = np.asfortranarray(keys)[::-1]
    assert kmers_to_strings(view, spec) == _decode_lane_by_lane(view, spec)
