#!/usr/bin/env python3
"""Where the device time goes in the PyTorch/CUDA port, on one GPU.

    python3 tools/port_profile.py [--out DIR]

Traces with torch.profiler (CPU + CUDA activities):
  1. each port kernel once at chip_smoke.py's main-path shapes;
  2. one warm end-to-end count of the seed-42 bench FASTQ at k=14 with the
     CLI's defaults (the first, cold count is untraced), by the sort
     backend and by the table backend (l=26).
Prints, per part, the device time by kernel name (key_averages, sorted by
device time), the part's wall time and the device's busy share over it;
writes the tables and a Chrome trace of the end-to-end part to DIR
(default tsxcount_tpu_torch/build/profile).  Needs a CUDA device; imports
no JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
from tsxcount_tpu_torch import KmerCounter, _build  # noqa: E402
from tsxcount_tpu_torch.ops.compact import compact_flagged  # noqa: E402
from tsxcount_tpu_torch.ops.merge import merge_sorted  # noqa: E402
from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted  # noqa: E402


def device_busy_us(prof) -> float:
    """Union of the CUDA kernel/memcpy intervals in the trace (us)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def traced(name: str, fn, out: Path, trace: bool = False) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy_us(prof) / 1e6
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=25)
    head = (f"== {name}: wall {wall:.6f} s, device busy {busy:.6f} s "
            f"({100 * busy / wall:.1f}%)")
    print(head)
    print(table)
    (out / f"{name}.txt").write_text(head + "\n" + table)
    if trace:
        prof.export_chrome_trace(str(out / f"{name}.trace.json"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    _build.kernels()

    n = 1 << 24
    flag = torch.from_numpy((rng.random(n) < 0.5).astype(np.int32)).to(dev)
    op = torch.randint(0, 1 << 29, (n,), dtype=torch.int32, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    a = torch.sort(torch.randint(0, 1 << 29, (n,), device=dev)).values
    b = torch.sort(torch.randint(0, 1 << 29, (n,), device=dev)).values
    a, b = a.to(torch.int32), b.to(torch.int32)
    store = torch.sort(torch.randint(0, 1 << 28, (1 << 26,), device=dev)
                       ).values.to(torch.int32)
    batch = torch.sort(torch.randint(0, 1 << 28, (1 << 25,), device=dev)
                       ).values.to(torch.int32)
    s_cnt = torch.randint(1, 1000, (1 << 26,), device=dev)
    b_cnt = torch.randint(1, 100, (1 << 25,), device=dev)
    for fn in (lambda: compact_flagged(flag, (op, pos)),
               lambda: merge_sorted((a, pos), (b, pos)),
               lambda: merge_dedupe_sorted((store, s_cnt), (batch, b_cnt), 1,
                                           1 << 28)):
        fn()  # warm-up
    traced("compact_flagged_2^24", lambda: compact_flagged(flag, (op, pos)),
           out)
    traced("merge_sorted_2x2^24", lambda: merge_sorted((a, pos), (b, pos)),
           out)
    traced("merge_dedupe_sorted_2^26+2^25",
           lambda: merge_dedupe_sorted((store, s_cnt), (batch, b_cnt), 1,
                                       1 << 28), out)
    del flag, op, pos, a, b, store, batch, s_cnt, b_cnt

    path = _build.BUILD_DIR / f"bench.{bench.N_READS}.fastq"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    bench.ensure_synth_fastq(path, bench.N_READS, seed=42)
    counter = KmerCounter(k=14, l=26, batch_words=1 << 20, merge_every=4,
                          device="cuda")
    counter.count_file(path, use_native=True)  # cold, untraced
    counter.reset()
    traced("e2e_warm_k14", lambda: counter.count_file(path, use_native=True),
           out, trace=True)
    del counter
    table = KmerCounter(k=14, l=26, backend="table", batch_words=1 << 20,
                        device="cuda")
    table.count_file(path, use_native=True)  # cold, untraced
    table.reset()
    traced("e2e_warm_k14_table",
           lambda: table.count_file(path, use_native=True), out, trace=True)
    print("device:", torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
