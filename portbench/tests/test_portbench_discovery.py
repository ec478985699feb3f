"""BENCHMARK.json against the benchmark's contract, discovery of every
configuration, mix and per-layer metric by name, and the import check."""

import inspect
import json
import re
import subprocess
import sys

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_has_the_contracts_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (run.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda c: c["name"])
def test_each_cell_finds_its_configuration_and_mix(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert run.load_traffic(cell["traffic"])["name"] == cell["traffic"]
    assert run.find_cell(BENCH, cell["name"]) is cell


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_is_its_file_and_the_counters_keywords(conf):
    from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

    cfg = run.load_config(conf["name"])
    assert conf["file"] == f"portbench/configs/{conf['name']}.json"
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    params = inspect.signature(ShardedKmerCounter).parameters
    assert set(cfg["counter"]) <= set(params) - {"device"}
    assert cfg["counter"]["n_shards"] == 1


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader_that_can_find_nothing(metric):
    reader = run.load_metric(metric["name"])
    empty = {"jobs": 0, "window_s": 0.0, "busy_s": 0.0, "device_ops": {},
             "idle_gaps": {}}
    assert reader.read(empty) is None


def test_the_readers_split_device_time_by_layer():
    rec = {"jobs": 2, "window_s": 1.0, "busy_s": 0.25, "parse_s": 0.5,
           "device_ops": {"Memcpy HtoD (Pageable -> Device)": 0.004,
                          "Memset (Device)": 0.001,
                          "void merge_tile_kernel<1>(ColSet, ...)": 0.010,
                          "compact_kernel": 0.002,
                          "void at::native::elementwise_kernel<...>": 0.1}}
    read = {m["name"]: run.load_metric(m["name"]).read(rec)
            for m in BENCH["per_layer"]}
    assert read["h2d.ms_per_job"] == pytest.approx(2.0)
    assert read["kernels.ms_per_job"] == pytest.approx(6.0)
    assert read["glue.ms_per_job"] == pytest.approx(50.0)
    assert read["device.idle_pct"] == pytest.approx(75.0)
    assert read["parse.s_per_job"] == pytest.approx(0.5)


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "tsxcount_tpu",
              "tsxcount_tpu.core.counter", "tsxcount_tpu_torch",
              "tsxcount_tpu_torch.core", "jaxtyping", "numpy"]
    assert run.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "tsxcount_tpu",
        "tsxcount_tpu.core.counter"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run on the CPU, in a process of its own, then the check
    that `main` makes once the window has closed."""
    code = """
import json, sys
from portbench import run
cfg = run.load_config("table-k14")
cfg["counter"].update(l=17, batch_words=512)
mix = dict(run.load_traffic("synth-long"), reads=6)
out = run.run_cell(cfg, mix, 1, 0.05, trace=True, device="cpu")
print(json.dumps(run.forbidden_modules()))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_without_a_card_the_run_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
