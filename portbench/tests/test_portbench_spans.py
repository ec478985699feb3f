"""The readers of the port's spans: None on an empty record or an empty
table, the right value from a hand-filled table, and every one of them
non-null after a traced run on the CPU."""

import pytest

from portbench import run
from portbench.tests.test_portbench_harness import tiny
from tsxcount_tpu_torch.utils import profiling

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
# {name: seconds}: count, total, self of each span
TABLE = {"feed_wait": (40, 0.6, 0.6), "parse": (40, 0.5, 0.5),
         "put": (40, 0.04, 0.04), "step": (40, 0.1, 0.08),
         "fold": (10, 0.3, 0.2), "sync": (30, 0.12, 0.12)}
REC = {"jobs": 4, "window_s": 2.0, "busy_s": 0.4, "device_ops": {},
       "idle_gaps": {"tsx.feed_wait": 0.5, "aten::sort": 0.1}}
WANT = {"feed.wait_ms_per_job": 150.0, "parse.span_s_per_job": 0.125,
        "h2d.put_ms_per_job": 10.0, "step.ms_per_job": 20.0,
        "fold.ms_per_job": 50.0, "sync.ms_per_job": 30.0,
        "device.feed_idle_pct": 25.0}
SPAN_READERS = sorted(set(WANT) - {"device.feed_idle_pct"})


@pytest.fixture()
def table(monkeypatch):
    filled = dict(TABLE)
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(filled))
    return filled


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_reads_the_hand_filled_table(name, table):
    assert run.load_metric(name).read(REC) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_finds_nothing_in_an_empty_record(name, table):
    empty = {"jobs": 0, "window_s": 0.0, "busy_s": 0.0, "device_ops": {}}
    assert run.load_metric(name).read(empty) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_reader_finds_nothing_in_an_empty_table(name, table):
    table.clear()
    assert run.load_metric(name).read(REC) is None


def test_the_idle_share_needs_its_gap():
    reader = run.load_metric("device.feed_idle_pct")
    assert reader.read(dict(REC, idle_gaps={"aten::sort": 0.1})) is None


def test_a_program_without_the_table_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "span_totals")
    for name in SPAN_READERS:
        assert run.load_metric(name).read(REC) is None, name


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_finds_nothing_without_work_on_a_card(name, table):
    assert run.load_metric(name).read(dict(REC, busy_s=0.0)) is None


def test_a_traced_cpu_runs_table_holds_its_window_alone():
    """On the CPU the result line leaves the span metrics out (no card);
    the records with a card's busy time put back read every span reader
    (the idle share needs the card's gaps)."""
    cfg, mix = tiny("table-k14.synth-long")
    profiling.reset_spans()
    out = run.run_cell(cfg, mix, 2 ** 31 + 11, 0.05, trace=True,
                       device="cpu")
    res = run.report(BENCH, out, True,
                     {"platform": "cpu", "kind": "cpu", "count": 1})
    assert res["correct"], res["check"]
    assert not set(WANT) & set(res["metrics"])
    assert not any(n.startswith("tsx.")
                   for n, _ in res["breakdown"]["device_ops"])
    rec = dict(out["records"], busy_s=1e-3)
    got = {n: run.load_metric(n).read(rec) for n in SPAN_READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    # the untraced warm-up job and the parse pass after the window left
    # nothing: one fold a table insert, the same inserts every job
    assert profiling.span_totals()["fold"][0] == out["stats"][
        "table_inserts"] * res["attempted"]
