#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tsxcount_tpu_torch) once on one Hopper GPU.

    python3 chip_smoke.py

Phases, each printing one line (every failure raises, so the exit code is
non-zero and no result line is printed):
  1. environment: a CUDA device of capability (9, 0), its name and power
     limit as nvidia-smi reports them;
  2. build: the nvcc kernel library and the native FASTQ parser, timed;
  3. each CUDA kernel against its plain PyTorch version on the card, on
     seeded numpy inputs at the main path's shapes plus hard cases —
     exact equality (all outputs are integers) — with both times;
  4. end to end: the seed-42 bench FASTQ (bench.py, 20,000 reads) counted
     at k=14 with the CLI's defaults; totals, the full sorted export
     against an independent numpy count, point queries, the kernels'
     launch counts on that run, and a second batch geometry that must give
     the identical export;
then the kernels' JSON line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Builds and data go to
tsxcount_tpu_torch/build/ (gitignored).  No JAX is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402  (module scope imports numpy only)
from tsxcount_tpu_torch import KmerCounter, _build  # noqa: E402
from tsxcount_tpu_torch.core.store import CountStore  # noqa: E402
from tsxcount_tpu_torch.io import native  # noqa: E402
from tsxcount_tpu_torch.ops.compact import (  # noqa: E402
    compact_flagged,
    compact_flagged_plain,
)
from tsxcount_tpu_torch.ops.merge import (  # noqa: E402
    merge_sorted,
    merge_sorted_plain,
)
from tsxcount_tpu_torch.ops.merge_dedupe import (  # noqa: E402
    merge_dedupe_sorted,
    merge_dedupe_sorted_plain,
)
from tsxcount_tpu_torch.config import KmerSpec  # noqa: E402

K = 14
TOTAL_KMERS = 18_750_197     # seed-42 bench FASTQ, k=14 windows
DISTINCT_KMERS = 14_479_762  # and distinct k-mers
INV14 = 1 << 28              # k=14 invalid constant (flag above 28 key bits)
KERNELS = {
    "compact_flagged": ("tsxcount_tpu_torch/csrc/compact.cu",
                        "tsxcount_tpu/ops/pallas_compact.py:165"),
    "merge_sorted": ("tsxcount_tpu_torch/csrc/merge.cu",
                     "tsxcount_tpu/ops/pallas_merge.py:140"),
    "merge_dedupe_sorted": ("tsxcount_tpu_torch/csrc/merge_dedupe.cu",
                            "tsxcount_tpu/ops/pallas_merge_dedupe.py:83"),
}
DEV = torch.device("cuda")
rng = np.random.default_rng(1234)


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def gpu(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(got, want, rows=None) -> int:
    """Largest |got - want| over columns (rows limits to a prefix)."""
    err = 0
    for g, w in zip(got, want):
        if rows is not None:
            g, w = g[:rows], w[:rows]
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def sorted_keys(n: int, n_keys: int, hi: int,
                flag_col: bool = False) -> np.ndarray:
    """[n, n_keys] uint32 rows below hi, lexicographically ascending;
    flag_col: the first column is a 0 flag (k % 16 == 0 operands)."""
    keys = rng.integers(0, hi, size=(n, n_keys), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    if flag_col:
        keys[:, 0] = 0
    if n_keys == 1:
        return np.sort(keys, axis=0)
    return keys[np.lexsort(keys.T[::-1])]


# --- phase 1 ----------------------------------------------------------------

def environment() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase("env", device=repr(name), capability=cap,
          torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count(), nvidia_smi=repr(smi))
    if cap != (9, 0):
        raise RuntimeError(f"capability {cap}: the kernels target sm_90a")
    return name, smi


# --- phase 2 ----------------------------------------------------------------

def build() -> None:
    t0 = time.perf_counter()
    _build.kernels()
    t1 = time.perf_counter()
    native.load_native()
    t2 = time.perf_counter()
    phase("build", kernels_s=round(t1 - t0, 3), parser_s=round(t2 - t1, 3),
          library=_build.library_path().name)


# --- phase 3 ----------------------------------------------------------------

def check_compact(results: dict) -> None:
    n = 1 << 24
    worst = 0
    for case, density in (("random", 0.5), ("all0", 0.0), ("all1", 1.0)):
        flag = gpu((rng.random(n) < density).astype(np.int32))
        cols = (gpu(rng.integers(0, 1 << 29, n, dtype=np.uint32)),
                torch.arange(n, dtype=torch.int32, device=DEV),
                gpu(rng.integers(-2**62, 2**62, n)))
        got = compact_flagged(flag, cols)
        want = compact_flagged_plain(flag, cols)
        rows = int((flag != 0).sum())
        err = max_err(got, want, rows)
        phase("kernel", name="compact_flagged", case=case, rows=n,
              flagged=rows, max_abs_err=err)
        worst = max(worst, err)
        if case == "random":  # the main path's columns: operand + position
            ms = cuda_ms(lambda: compact_flagged(flag, cols[:2]))
            plain_ms = cuda_ms(lambda: compact_flagged_plain(flag, cols[:2]))
    results["compact_flagged"] = dict(max_abs_err=worst, ms=ms,
                                      plain_ms=plain_ms)


def check_merge(results: dict) -> None:
    n = 1 << 24
    worst = 0
    cases = {
        "random": (1, 1 << 29),
        "one_key": (1, 1),
        "n_keys2_full32": (2, 1 << 32),
    }
    for case, (n_keys, hi) in cases.items():
        size = n if n_keys == 1 else 1 << 21
        a = sorted_keys(size, n_keys, hi)
        b = sorted_keys(size, n_keys, hi)
        a_cols = tuple(gpu(a[:, j]) for j in range(n_keys)) + (
            torch.arange(size, dtype=torch.int32, device=DEV),)
        b_cols = tuple(gpu(b[:, j]) for j in range(n_keys)) + (
            torch.arange(size, 2 * size, dtype=torch.int32, device=DEV),)
        got = merge_sorted(a_cols, b_cols, n_keys=n_keys)
        want = merge_sorted_plain(a_cols, b_cols, n_keys=n_keys)
        err = max_err(got, want)
        phase("kernel", name="merge_sorted", case=case, rows=2 * size,
              n_keys=n_keys, max_abs_err=err)
        worst = max(worst, err)
        if case == "random":
            ms = cuda_ms(lambda: merge_sorted(a_cols, b_cols))
            plain_ms = cuda_ms(lambda: merge_sorted_plain(a_cols, b_cols))
    results["merge_sorted"] = dict(max_abs_err=worst, ms=ms,
                                   plain_ms=plain_ms)


def dedupe_run(n: int, n_keys: int, hi: int, n_invalid: int, inv_min: int,
               counts: tuple[int, int], unique: bool = False) -> tuple:
    """A sorted (keys, int64 count) run of n rows whose last rows (at
    least n_invalid) are the invalid constant with count 0; unique: no
    repeated valid key, as in a store."""
    keys = sorted_keys(n - n_invalid, n_keys, hi, flag_col=inv_min == 1)
    if unique:
        keys = np.unique(keys[:, 0])[:, None] if n_keys == 1 else np.unique(
            keys, axis=0)
    n_valid = len(keys)
    inv = np.zeros((n - n_valid, n_keys), np.uint32)
    inv[:, 0] = inv_min
    keys = np.concatenate([keys, inv])
    cnt = rng.integers(counts[0], counts[1], n, dtype=np.int64)
    cnt[n_valid:] = 0
    return tuple(gpu(keys[:, j]) for j in range(n_keys)) + (gpu(cnt),)


def check_merge_dedupe(results: dict) -> None:
    worst = 0
    cases = {
        # store run (unique keys) + batch run, k=14 operands
        "main": (dedupe_run(1 << 26, 1, 1 << 28, 1 << 24, INV14, (1, 1000),
                            unique=True),
                 dedupe_run(1 << 25, 1, 1 << 28, 1 << 20, INV14, (1, 100)),
                 1, INV14),
        # one key across many blocks; run sums cross 2^32
        "one_key_sum_over_2^32": (
            dedupe_run(1 << 22, 1, 1, 0, INV14, (1 << 31, 1 << 32)),
            dedupe_run(1 << 21, 1, 1, 1000, INV14, (1 << 31, 1 << 32)),
            1, INV14),
        "all_invalid_b": (
            dedupe_run(1 << 22, 1, 1 << 28, 1000, INV14, (1, 50)),
            dedupe_run(1 << 21, 1, 1 << 28, 1 << 21, INV14, (1, 50)),
            1, INV14),
        # k=32: flag column + two full 32-bit words (a signed compare fails)
        "n_keys3_full32": (
            dedupe_run(1 << 22, 3, 1 << 32, 5000, 1, (1, 1 << 40)),
            dedupe_run(1 << 21, 3, 1 << 32, 0, 1, (1, 1 << 40)),
            3, 1),
    }
    for case, (a, b, n_keys, inv_min) in cases.items():
        got, g_runs, g_valid = merge_dedupe_sorted(a, b, n_keys, inv_min)
        want, w_runs, w_valid = merge_dedupe_sorted_plain(a, b, n_keys,
                                                          inv_min)
        if (int(g_runs), int(g_valid)) != (int(w_runs), int(w_valid)):
            raise AssertionError(
                f"merge_dedupe {case}: runs/valid {int(g_runs)}/"
                f"{int(g_valid)} != {int(w_runs)}/{int(w_valid)}")
        err = max_err(got, want, int(w_runs))
        phase("kernel", name="merge_dedupe_sorted", case=case,
              rows=a[0].numel() + b[0].numel(), n_keys=n_keys,
              runs=int(w_runs), valid=int(w_valid), max_abs_err=err)
        worst = max(worst, err)
        if case == "main":
            ms = cuda_ms(lambda: merge_dedupe_sorted(a, b, 1, INV14))
            plain_ms = cuda_ms(
                lambda: merge_dedupe_sorted_plain(a, b, 1, INV14))
    worst = max(worst, check_store_junk_tail())
    results["merge_dedupe_sorted"] = dict(max_abs_err=worst, ms=ms,
                                          plain_ms=plain_ms)


def check_store_junk_tail() -> int:
    """A reference store state whose unused rows hold junk keys, merged on
    the card (kernels 2 and 3) and on the CPU (plain versions)."""
    spec = KmerSpec(31)
    cap, n0, p, r = 1 << 20, 300_000, 1 << 18, 3
    keys = rng.integers(0, 2**32, size=(cap, 2), dtype=np.uint32)
    keys[:, 1] &= np.uint32(spec.top_lane_mask)
    head = np.unique(keys[:n0], axis=0)
    head = head[np.lexsort(head.T)]
    n0 = len(head)
    keys[:n0] = head
    digits = np.zeros((cap, 3), np.int32)
    digits[:, 0] = rng.integers(1, 1 << 20, cap)
    digits[:, 1] = rng.integers(0, 1 << 12, cap)
    ref = dict(keys=keys, digits=digits, used=np.arange(cap) < n0,
               n=np.int32(n0), overflowed=np.bool_(False))
    uk = np.zeros((r, p, 2), np.uint32)
    uc = np.zeros((r, p), np.int32)
    uv = np.zeros((r, p), bool)
    for i in range(r):
        b = np.concatenate([head[rng.integers(0, n0, p // 2)],
                            rng.integers(0, 2**32, (p // 2, 2),
                                         dtype=np.uint32)])
        b[:, 1] &= np.uint32(spec.top_lane_mask)
        b = np.unique(b, axis=0)
        b = b[np.lexsort(b.T)]
        uk[i, : len(b)] = b
        uk[i, len(b) :] = rng.integers(0, 2**31, (p - len(b), 2))
        uc[i] = rng.integers(1, 1 << 30, p)
        uv[i, : len(b)] = True
    out = []
    for dev in (DEV, torch.device("cpu")):
        store = CountStore(spec, cap, dev)
        st = store.merge_stacked(
            store.state_from_reference(ref),
            torch.from_numpy(uk.view(np.int32)).to(dev),
            torch.from_numpy(uc).to(dev), torch.from_numpy(uv).to(dev),
        )
        out.append(store.state_to_reference(st))
    err = 0
    for f in ("keys", "digits", "used", "n", "overflowed"):
        a = np.asarray(out[0][f]).astype(np.int64)
        b = np.asarray(out[1][f]).astype(np.int64)
        err = max(err, int(np.abs(a - b).max()) if a.size else 0)
    phase("kernel", name="store_merge_stacked", case="junk_store_tail",
          n_keys=2, distinct=int(out[0]["n"]), max_abs_err=err)
    return err


# --- phase 4 ----------------------------------------------------------------

def host_count(path: Path, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Independent numpy count: sorted distinct 2-bit keys (base i at bits
    2i, A=0 C=1 G=2 T=3) and their counts; windows with non-ACGT skipped."""
    lut = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
        lut[ord(chr(ch).lower())] = i
    weights = (np.int64(4) ** np.arange(k, dtype=np.int64))
    chunks = []
    with open(path, "rb") as f:
        for ln, line in enumerate(f):
            if ln % 4 != 1:
                continue
            codes = lut[np.frombuffer(line.rstrip(b"\r\n"), np.uint8)]
            if len(codes) < k:
                continue
            win = np.lib.stride_tricks.sliding_window_view(codes, k)
            ok = (win != 255).all(axis=1)
            chunks.append(win[ok].astype(np.int64) @ weights)
    return np.unique(np.concatenate(chunks), return_counts=True)


def export(counter: KmerCounter) -> tuple[np.ndarray, np.ndarray]:
    keys, counts, _ = counter.store.to_host(counter.state)
    return keys[:, 0].astype(np.int64), counts


def timed_count(counter: KmerCounter, path: Path) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counter.count_file(path, use_native=True)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def end_to_end() -> dict:
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    path = build_dir / f"bench.{bench.N_READS}.fastq"
    t0 = time.perf_counter()
    bench.ensure_synth_fastq(path, bench.N_READS, seed=42)
    want_keys, want_counts = host_count(path, K)
    phase("e2e_setup", fastq=path.name, reads=bench.N_READS,
          host_count_s=round(time.perf_counter() - t0, 3),
          host_distinct=len(want_keys), host_total=int(want_counts.sum()))

    counter = KmerCounter(k=K, l=26, batch_words=1 << 20, merge_every=4,
                          device="cuda")
    _build.reset_launch_counts()
    cold = timed_count(counter, path)
    launches = _build.launch_counts()
    total, distinct = counter.total_kmers, counter.distinct
    got_keys, got_counts = export(counter)
    phase("e2e", run="cold", seconds=round(cold, 4),
          kmers_per_s=round(total / cold), total_kmers=total,
          distinct=distinct, launches=launches)
    if (total, distinct) != (TOTAL_KMERS, DISTINCT_KMERS):
        raise AssertionError(f"totals {total}/{distinct} != "
                             f"{TOTAL_KMERS}/{DISTINCT_KMERS}")
    if not (np.array_equal(got_keys, want_keys)
            and np.array_equal(got_counts, want_counts)):
        raise AssertionError("export differs from the numpy host count")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} not launched on the path")

    # point queries: half present, half random (mostly absent)
    present = want_keys[rng.integers(0, len(want_keys), 2048)]
    rand = rng.integers(0, 4**K, 2048, dtype=np.int64)
    q = np.concatenate([present, rand])
    idx = np.clip(np.searchsorted(want_keys, q), 0, len(want_keys) - 1)
    want_q = np.where(want_keys[idx] == q, want_counts[idx], 0)
    strings = ["".join("ACGT"[(int(v) >> (2 * i)) & 3] for i in range(K))
               for v in q]
    got_q = np.asarray(counter.get_counts(strings))
    if not np.array_equal(got_q, want_q):
        raise AssertionError("get_counts differs from the host count")
    phase("e2e_queries", queries=len(q), present=int((want_q > 0).sum()))

    counter.reset()
    warm = timed_count(counter, path)
    if not all(np.array_equal(x, y) for x, y in
               zip(export(counter), (got_keys, got_counts))):
        raise AssertionError("warm export differs from the cold one")
    phase("e2e", run="warm", seconds=round(warm, 4),
          kmers_per_s=round(counter.total_kmers / warm))

    small = KmerCounter(k=K, l=26, batch_words=1 << 18, merge_every=2,
                        device="cuda")
    small.reset()
    t_small = timed_count(small, path)
    if not all(np.array_equal(x, y) for x, y in
               zip(export(small), (got_keys, got_counts))):
        raise AssertionError("batch_words=2^18, merge_every=2 export differs")
    phase("e2e", run="batch_words=2^18,merge_every=2",
          seconds=round(t_small, 4), batches=small.batches_processed,
          kmers_per_s=round(small.total_kmers / t_small))
    return launches


def main() -> int:
    name, smi = environment()
    build()
    results: dict = {}
    check_compact(results)
    check_merge(results)
    check_merge_dedupe(results)
    for kname, r in results.items():
        phase("kernel_time", name=kname, ms=round(r["ms"], 4),
              plain_ms=round(r["plain_ms"], 4))
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{kname} differs from its plain version")
    launches = end_to_end()
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": KERNELS[kname][0],
         "replaces": KERNELS[kname][1], "launches": launches[kname],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for kname, r in results.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
