"""The benchmark's command on the card: one short run of the first cell,
plain and traced, each correct with its metrics.  Skips without a GPU."""

import json
import subprocess
import sys

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = BENCH["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 101 + trace), "--seconds", "2", "--trace",
         str(trace)], cwd=run.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    entries = BENCH["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in entries}
    assert set(res["metrics"]) == want
