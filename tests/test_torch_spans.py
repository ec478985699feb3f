"""The port's spans (`utils/profiling.py` `span`): nothing recorded while
no profiler runs, a plain RecordFunction (no user annotation) while one
does, self time net of nested spans, spans of threads the trace does not
record, the table's clock against kineto's, every span of the ingest path
in a CPU count, the table's round counters, and the producer joined when
the consumer stops early."""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tsxcount_tpu_torch import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.io.pipeline import prefetch  # noqa: E402
from tsxcount_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedKmerCounter,
)
from tsxcount_tpu_torch.utils import profiling  # noqa: E402
from tsxcount_tpu_torch.utils.profiling import (  # noqa: E402
    reset_spans,
    span,
    span_totals,
)

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402

INGEST_SPANS = {"feed_wait", "parse", "put", "step", "fold", "sync"}


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _tsx_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("tsx.")]


def test_without_a_profiler_a_span_records_nothing():
    reset_spans()
    with span("a"):
        with span("b"):
            pass
    assert span_totals() == {}
    assert span("a") is span("b")  # one shared null context


def test_a_span_is_a_host_op_and_no_user_annotation():
    reset_spans()
    with _profiler() as prof:
        with span("fold"):
            torch.ones(4).sum()
    (ev,) = _tsx_events(prof)
    assert ev.name() == "tsx.fold"
    assert not ev.is_user_annotation()
    assert ev.device_type() == torch.autograd.DeviceType.CPU
    assert span_totals()["fold"][0] == 1


def test_nested_spans_give_self_time():
    reset_spans()
    with _profiler():
        with span("outer"):
            time.sleep(0.02)
            for _ in range(2):
                with span("inner"):
                    time.sleep(0.01)
    tot = span_totals()
    n_out, total_out, self_out = tot["outer"]
    n_in, total_in, self_in = tot["inner"]
    assert (n_out, n_in) == (1, 2)
    assert self_in == total_in >= 0.02
    assert self_out == pytest.approx(total_out - total_in, abs=1e-9)
    assert 0.02 <= self_out < total_out


def test_a_span_on_another_thread_reaches_the_table_not_the_trace():
    reset_spans()

    def work():
        with span("parse"):
            torch.ones(4)

    with _profiler() as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert span_totals()["parse"][0] == 1
    assert _tsx_events(prof) == []


def test_the_table_shares_the_traces_clock():
    """The span's trace event lies inside a bracket of `time.time_ns()`
    stamps taken just before and after the span, and its duration equals
    the table's within the bracket's slack (the table's interval lies
    inside the event's): one clock, however loaded the host."""
    reset_spans()
    with _profiler() as prof:
        before = time.time_ns()
        with span("put"):
            time.sleep(0.005)
        after = time.time_ns()
    (ev,) = _tsx_events(prof)
    total_ns = round(span_totals()["put"][1] * 1e9)
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert before <= start < end <= after
    assert 0 <= ev.duration_ns() - total_ns <= (after - before) - total_ns


def test_a_span_exits_cleanly_on_an_exception():
    reset_spans()
    with _profiler() as prof:
        with pytest.raises(ValueError):
            with span("outer"):
                with span("sync"):
                    raise ValueError("boom")
        with span("step"):
            pass
    tot = span_totals()
    assert {n: c for n, (c, _, _) in tot.items()} == {
        "outer": 1, "sync": 1, "step": 1}
    assert profiling._local.stack == []
    assert sorted(e.name() for e in _tsx_events(prof)) == [
        "tsx.outer", "tsx.step", "tsx.sync"]


def test_spans_of_many_threads_lose_no_update():
    reset_spans()
    n_threads, n_spans = 16, 300

    def work():
        for _ in range(n_spans):
            with span("outer"):
                with span("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    tot = span_totals()
    assert tot["outer"][0] == tot["inner"][0] == n_threads * n_spans
    own = tot["outer"][1] - tot["inner"][1]
    assert tot["outer"][2] == pytest.approx(own, abs=1e-6)


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    rng = np.random.default_rng(16)
    reads = rand_reads(rng, 60, 20, 120)
    path = tmp_path_factory.mktemp("spans") / "in.fastq"
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return path, reads


def _make(cls, backend):
    kw = dict(k=14, l=12, backend=backend, batch_words=64, device="cpu")
    if cls is ShardedKmerCounter:
        kw["n_shards"] = 1
    return cls(**kw)


@pytest.mark.parametrize("backend", ["sort", "table"])
@pytest.mark.parametrize("cls", [ShardedKmerCounter, KmerCounter],
                         ids=["sharded", "plain"])
def test_a_profiled_count_records_every_ingest_span(fastq, cls, backend):
    path, reads = fastq
    c = _make(cls, backend)
    c.count_file(path, use_native=True)  # the read-length hint settles
    c.reset()
    reset_spans()
    with _profiler() as prof:
        c.count_file(path, use_native=True)
        distinct = c.distinct
    tot = span_totals()
    assert INGEST_SPANS <= set(tot), INGEST_SPANS - set(tot)
    assert distinct == len(naive_kmers(reads, 14))
    # the producer's parse and copy ran on a thread the trace left out
    names = {e.name() for e in _tsx_events(prof)}
    assert {"tsx.feed_wait", "tsx.step", "tsx.fold", "tsx.sync"} <= names
    assert "tsx.parse" not in names and "tsx.put" not in names
    st = c.stats()
    if backend == "table":
        assert st["table_inserts"] == tot["fold"][0] > 0
        assert st["table_rounds"] >= st["table_inserts"]
    else:
        assert st["table_inserts"] == st["table_rounds"] == 0


def test_table_counters_restart_at_reset(fastq):
    path, _ = fastq
    c = _make(ShardedKmerCounter, "table")
    c.count_file(path)
    once = c.stats()
    assert once["table_rounds"] > 0
    c.count_file(path)  # twice the batches, no reset
    assert c.stats()["table_inserts"] == 2 * once["table_inserts"]
    c.reset()
    st = c.stats()
    assert st["table_inserts"] == st["table_rounds"] == 0


def test_prefetch_closed_early_joins_its_producer():
    before = set(threading.enumerate())
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield i
            i += 1

    it = prefetch(endless(), lambda x: x * 2, depth=1)
    assert [next(it), next(it)] == [0, 2]
    it.close()
    assert set(threading.enumerate()) - before == set()
    n = len(pulled)
    time.sleep(0.05)
    assert len(pulled) == n  # the producer stopped


def test_prefetch_raises_the_producers_error_after_its_pulls():
    def failing():
        yield 1
        raise OSError("disk")

    reset_spans()
    with _profiler():
        it = prefetch(failing(), lambda x: x, depth=2)
        assert next(it) == 1
        with pytest.raises(OSError, match="disk"):
            next(it)
    assert span_totals()["feed_wait"][0] == 2


def test_the_cli_profile_prints_the_spans(fastq, tmp_path, capsys):
    from tsxcount_tpu_torch.cli import main

    path, _ = fastq
    assert main(["count", "--input", str(path), "--k", "14", "--l", "12",
                 "--batch-words", "64", "--platform", "cpu", "--profile",
                 str(tmp_path / "prof")]) == 0
    err = capsys.readouterr().err
    assert "device busy 0.0000 s" in err
    for name in INGEST_SPANS:
        assert f"profile: span {name} count " in err, name
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


class _Ev:
    def __init__(self, dev, s, e, annotation=False):
        self._v = (dev, s, e, annotation)

    def device_type(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def is_user_annotation(self):
        return self._v[3]


def test_device_busy_reads_the_kineto_events():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    evs = [_Ev(cuda, 0, 1000), _Ev(cuda, 500, 2000), _Ev(cuda, 3000, 4000),
           _Ev(cpu, 0, 10_000), _Ev(cuda, 0, 10_000, annotation=True)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return evs

    assert profiling.device_busy_us(Prof) == pytest.approx(3.0)
