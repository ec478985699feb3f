#!/usr/bin/env python3
"""Where a block of kernel 2's tile kernel spends its life, from clock64
stamps, on one GPU.

    python3 tools/merge_stamps.py [--out DIR]

Copies tsxcount_tpu_torch to DIR (default tsxcount_tpu_torch/build/stamps,
gitignored) and adds stamps to the COPY's csrc/merge.cu, never to the
package's own source: thread 0 of each block reads clock64() at the
kernel's start, after barrier 1 (keys and first payload column staged),
after barrier 2 (sources merged) and after an added barrier 3 (keys and
first payload column stored), with its SM id.  It builds the copy's
kernels, merges two 2^24-row runs of one key word and an int32 payload
(the merge tree's shape, data made on the card from a fixed seed) and
prints one JSON line: the stamped call's time, the mean cycles of each
phase, quantiles of the staging phase, the tiles per SM and the SM clock
as nvidia-smi reads it.  The extra barrier and stores make the stamped
kernel slower than the real one; the phases' shares are what it is for.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
ROWS = 1 << 24
MAX_TILES = 1 << 16

KERNEL = ("template <int NK>\n__global__ void __launch_bounds__(kMergeThreads)"
          "\n    merge_tile_kernel")
BARRIER_1 = "  __syncthreads();\n\n  // this thread's rows"
BARRIER_2 = "  src[tid] = s;\n  __syncthreads();\n"
FURTHER = "  // any further payload column through the same buffer\n"
# (anchor in csrc/merge.cu, what replaces it)
EDITS = (
    (KERNEL, f"__device__ long long g_stamps[{MAX_TILES}][5];\n" + KERNEL),
    ("  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n  const long long c0 = clock64();\n"),
    (BARRIER_1, BARRIER_1.replace(
        "\n\n", "\n  const long long c1 = clock64();\n\n")),
    (BARRIER_2, BARRIER_2 + "  const long long c2 = clock64();\n"),
    (FURTHER, f"""  __syncthreads();
  if (tid == 0 && blockIdx.x < {MAX_TILES}) {{
    unsigned sm;
    asm("mov.u32 %0, %%smid;" : "=r"(sm));
    long long* g = g_stamps[blockIdx.x];
    g[0] = c0; g[1] = c1; g[2] = c2; g[3] = clock64(); g[4] = sm;
  }}
""" + FURTHER),
)
READ_STAMPS = """
extern "C" int tsx_merge_stamps(void* out) {
  return cudaMemcpyFromSymbol(out, tsx::g_stamps, sizeof(tsx::g_stamps));
}
"""


def stamped_source(src: str) -> str:
    """merge.cu with the stamps; raises if an anchor is not there once."""
    for anchor, new in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor[:50]!r}")
        src = src.replace(anchor, new)
    return src + READ_STAMPS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = args.out or REPO / "tsxcount_tpu_torch" / "build" / "stamps"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(REPO / "tsxcount_tpu_torch", out / "tsxcount_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    cu = out / "tsxcount_tpu_torch" / "csrc" / "merge.cu"
    cu.write_text(stamped_source(cu.read_text()))
    sys.path.insert(0, str(out))
    from tsxcount_tpu_torch import _build
    from tsxcount_tpu_torch.ops.merge import merge_sorted

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    runs = [(torch.sort(torch.randint(0, 1 << 29, (ROWS,), device=dev,
                                      generator=g)).values.to(torch.int32),
             torch.arange(ROWS, dtype=torch.int32, device=dev))
            for _ in range(2)]
    lib = _build.kernels()
    lib.tsx_merge_stamps.argtypes = [ctypes.c_void_p]
    lib.tsx_merge_stamps.restype = ctypes.c_int
    for _ in range(3):
        merge_sorted(*runs)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    merge_sorted(*runs)
    t1.record()
    torch.cuda.synchronize()
    buf = np.zeros((MAX_TILES, 5), np.int64)
    if lib.tsx_merge_stamps(buf.ctypes.data) != 0:
        raise RuntimeError("reading the stamps failed")
    tiles = lib.tsx_merge_scratch_elems(1, ROWS, ROWS) - 1
    st = buf[:tiles]
    phase = np.diff(st[:, :4], axis=1)
    sms = np.unique(st[:, 4]).size
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({
        "stamped_ms": t0.elapsed_time(t1), "tiles": int(tiles),
        "cycles_stage": float(phase[:, 0].mean()),
        "cycles_merge": float(phase[:, 1].mean()),
        "cycles_store": float(phase[:, 2].mean()),
        "cycles_stage_p50": float(np.median(phase[:, 0])),
        "cycles_stage_p90": float(np.percentile(phase[:, 0], 90)),
        "sms": int(sms), "tiles_per_sm": tiles / sms, "clocks_sm": clocks,
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
