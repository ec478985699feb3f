"""The harness on the CPU at a tiny size: a sound run is correct, and with
the timed path broken underneath `correct` comes out false.  The look for
a card (`main`) is skipped: `run_cell` drives the rest of a run."""

import pytest

from portbench import control, reference, run
from tsxcount_tpu_torch.parallel import sharded

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in BENCH["workloads"]]


def tiny(cell_name: str) -> tuple[dict, dict]:
    """The cell's configuration and mix at a size the CPU holds: a smaller
    table and batches, fewer reads; widths and rules as they stand."""
    cell = run.find_cell(BENCH, cell_name)
    cfg = run.load_config(cell["config"])
    cfg["counter"].update(l=17, batch_words=512)
    mix = run.load_traffic(cell["traffic"])
    mix.update({"reads": 12} if "reads" in mix else {"genome_len": 2500})
    return cfg, mix


def result(cell_name: str, seed: int = 2 ** 31 + 5) -> dict:
    cfg, mix = tiny(cell_name)
    out = run.run_cell(cfg, mix, seed, 0.05, trace=False, device="cpu")
    return run.report(BENCH, out, False,
                      {"platform": "cpu", "kind": "cpu", "count": 1})


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = result(cell)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"kmers_per_s", "job_s_p90",
                                   "peak_mem_gib", "setup_s"}
    assert all(c["limit"] == 0 for c in res["check"].values())


def _unchanged_step(monkeypatch):
    monkeypatch.setattr(sharded.ShardedKmerCounter, "_step_buf",
                        lambda self, buf: None)


def _half_batch(monkeypatch):
    real = sharded.intervals_to_valid

    def half(ivals, batch):
        valid = real(ivals, batch).clone()
        valid[1::2] = False  # every other window position
        return valid

    monkeypatch.setattr(sharded, "intervals_to_valid", half)


def _altered_answer(monkeypatch):
    real = sharded.ShardedKmerCounter._shard_export

    def altered(self):
        keys, counts = real(self)
        counts = counts.clone()
        counts[0] += 1
        return keys, counts

    monkeypatch.setattr(sharded.ShardedKmerCounter, "_shard_export", altered)


FAULTS = {"state_unchanged": _unchanged_step, "half_batch": _half_batch,
          "answer_altered": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    """One shard exchanges with itself: the fault of a left-out exchange
    between chips does not exist in these cells."""
    FAULTS[fault](monkeypatch)
    res = result(cell)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    cfg, mix = tiny(cell)
    nums = control.control_numbers(cfg, mix, 2 ** 31 + 9)
    assert nums["windows_off"] > 0 and nums["wrong_count"] + nums[
        "missing"] > 0


def test_a_failed_job_is_counted_and_not_correct(monkeypatch):
    real = sharded.ShardedKmerCounter.count_file
    calls = []

    def every_other(self, path, use_native=None):
        calls.append(path)
        if len(calls) % 2 == 0:  # the warm-up, call 1, passes
            raise sharded.TableFull("planted")
        return real(self, path, use_native)

    monkeypatch.setattr(sharded.ShardedKmerCounter, "count_file",
                        every_other)
    cfg, mix = tiny(CELLS[0])
    out = run.run_cell(cfg, mix, 3, 0.3, trace=False, device="cpu")
    res = run.report(BENCH, out, False,
                     {"platform": "cpu", "kind": "cpu", "count": 1})
    assert res["failed"] >= 1 and res["attempted"] > res["failed"]
    assert res["check"]["jobs_failed"]["value"] == res["failed"]
    assert not res["correct"]


def test_the_traced_run_reports_every_per_layer_metric_it_can_read():
    cfg, mix = tiny(CELLS[0])
    out = run.run_cell(cfg, mix, 4, 0.05, trace=True, device="cpu")
    res = run.report(BENCH, out, True,
                     {"platform": "cpu", "kind": "cpu", "count": 1})
    assert res["correct"]
    # no device on the CPU: only the host's parse span has a reading
    assert set(res["metrics"]) == {"parse.s_per_job"}
    assert res["device"]["busy_s"] == 0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("rule", [{"n_policy": "random"},
                                  {"collapse_homopolymers": True}],
                         ids=["n_policy", "collapse"])
def test_the_reference_refuses_rules_it_does_not_follow(rule):
    cfg, mix = tiny(CELLS[0])
    cfg["counter"].update(rule)
    with pytest.raises(ValueError):
        run.run_cell(cfg, mix, 3, 0.05, trace=False, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_canonical_run_is_correct_and_its_control_is_not(cell):
    """The reference takes `canonical` from the configuration, so a cell
    that counts canonical k-mers needs only new data files."""
    cfg, mix = tiny(cell)
    cfg["counter"]["canonical"] = True
    out = run.run_cell(cfg, mix, 2 ** 31 + 6, 0.05, trace=False,
                       device="cpu")
    res = run.report(BENCH, out, False,
                     {"platform": "cpu", "kind": "cpu", "count": 1})
    assert res["correct"], res["check"]
    nums = control.control_numbers(cfg, mix, 2 ** 31 + 9)
    assert nums["windows_off"] > 0


def test_the_export_decodes_to_the_counters_counts():
    cfg, mix = tiny(CELLS[0])
    counter = run.make_counter(cfg, "cpu")
    counter.add_reads(["ACGTACGTACGTACGTAC", "TTTTTTTTTTTTTTTT"])
    counter.finish()
    rows, counts = run.export(counter, 14)
    want = reference.encode_kmers(
        b"ACGTACGTACGTAC" b"CGTACGTACGTACG" b"GTACGTACGTACGT"
        b"TACGTACGTACGTA" b"TTTTTTTTTTTTTT", 14)
    got = dict(zip(rows.tolist(), counts.tolist()))
    assert got == dict(zip(want.tolist(), [2, 1, 1, 1, 3]))
