"""The readers of the kernels' roofline shares and of the lane mix's span:
the right value from a hand-filled launch table and trace, None where the
window ran no such kernel, where no card ran, or where the program has no
launch table (a tree older than the table)."""

import pytest

from portbench import roofline, run
from tsxcount_tpu_torch import _build
from tsxcount_tpu_torch.utils import profiling

MIX = "void tsx::(anonymous namespace)::lane_mix_kernel<8, false>(tsx::ColSet)"
K3 = ("void tsx::(anonymous namespace)::merge_partition_kernel<8>(...)",
      "void tsx::(anonymous namespace)::merge_dedupe_kernel<8>(...)",
      "tsx::(anonymous namespace)::fix_reduce_kernel(...)",
      "tsx::(anonymous namespace)::fix_apply_kernel(...)")
SHAPES = [("lane_mix", {"positions": 1 << 24, "lanes": 8,
                         "input_bytes": 1 << 27}, 2),
          ("merge_dedupe_sorted", {"m": 1 << 26, "n": 1 << 25,
                                   "n_keys": 8}, 1),
          ("merge_sorted", {"m": 5, "n": 5, "n_keys": 8,
                            "payload_cols": 1}, 1)]
REC = {"jobs": 2, "window_s": 1.0, "busy_s": 0.5,
       "device_ops": {MIX: 0.002, K3[0]: 0.0001, K3[1]: 0.0058,
                      K3[2]: 0.00005, K3[3]: 0.00005,
                      "void merge_tile_kernel<8>(...)": 0.003,
                      "Memset (Device)": 0.001}}
PEAK = roofline.HBM_BYTES_PER_S


@pytest.fixture()
def table(monkeypatch):
    monkeypatch.setattr(_build, "launch_shapes", lambda: list(SHAPES))
    monkeypatch.setattr(profiling, "span_totals",
                        lambda: {"mix": (4, 0.003, 0.003)})


def test_the_shares_read_the_hand_filled_table(table):
    mix = run.load_metric("kernels.lane_mix.roofline_pct").read(REC)
    moved = 2 * ((1 << 27) + (1 << 29))  # 2 launches, 128 MiB in, 512 out
    assert mix == pytest.approx(100 * moved / PEAK / 0.002)
    k3 = run.load_metric("kernels.merge_dedupe.roofline_pct").read(REC)
    assert k3 == pytest.approx(100 * 3 * (1 << 25) * 40 / PEAK / 0.006)
    assert run.load_metric("mix.ms_per_job").read(REC) == pytest.approx(1.5)


@pytest.mark.parametrize("name", ["kernels.lane_mix.roofline_pct",
                                  "kernels.merge_dedupe.roofline_pct",
                                  "mix.ms_per_job"])
@pytest.mark.parametrize("rec", [
    {"jobs": 0, "window_s": 0.0, "busy_s": 0.0, "device_ops": {}},
    {"jobs": 2, "window_s": 1.0, "busy_s": 0.5,
     "device_ops": {"void merge_tile_kernel<1>(...)": 0.01}},
], ids=["empty", "no_such_kernel"])
def test_a_reader_finds_nothing_where_nothing_ran(monkeypatch, name, rec):
    monkeypatch.setattr(_build, "launch_shapes", lambda: [])
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    assert run.load_metric(name).read(rec) is None


@pytest.mark.parametrize("name", ["kernels.lane_mix.roofline_pct",
                                  "kernels.merge_dedupe.roofline_pct"])
def test_a_program_without_the_launch_table_gives_nothing(monkeypatch, name):
    monkeypatch.delattr(_build, "launch_shapes")
    assert roofline.launch_shapes() is None
    assert run.load_metric(name).read(REC) is None


def test_a_traced_cpu_run_of_the_new_cell_reads_its_span():
    """No card: the roofline shares and the span read None, and the run is
    correct."""
    from portbench.tests.test_portbench_harness import tiny

    cfg, mix = tiny("sort-k127.synth-long")
    out = run.run_cell(cfg, mix, 2 ** 32 + 3, 0.05, trace=True, device="cpu")
    assert out["check"] and set(out["check"].values()) == {0}
    rec = out["records"]
    for name in ("kernels.lane_mix.roofline_pct",
                 "kernels.merge_dedupe.roofline_pct", "mix.ms_per_job"):
        assert run.load_metric(name).read(rec) is None
