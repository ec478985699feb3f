"""The port's CUDA kernel sources, compiled with g++ against a thread
emulation of the CUDA runtime (tools/cuda_emu), held against their plain
PyTorch versions on seeded inputs.  Outputs are integers: exact equality.
This checks the kernels' logic on a machine without a GPU; nvcc and the
card stay the judges of what compiles and how fast it runs."""

import pathlib
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_emulated_kernels_match_plain_versions():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "cuda_emu" / "emulate.py")],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("compact_flagged", "merge_sorted", "merge_dedupe_sorted",
                 "merge out of order", "apply_sorted_unique",
                 "gather_sorted", "lane_mix", "table_residue"):
        assert f"{name}: ok" in proc.stdout
