#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tsxcount_tpu_torch) once on one Hopper GPU.

    python3 chip_smoke.py

Phases, each printing lines (every failure raises, so the exit code is
non-zero and no result line is printed):
  1. environment: a CUDA device of capability (9, 0), its name and power
     limit as nvidia-smi reports them;
  2. build: the nvcc kernel library and the native FASTQ parser, timed;
     kernels 4 and 5 at every column count up to the cap (20) without a
     stack frame or local memory (cuobjdump's resource usage; the
     registers a thread of 16-20 columns printed);
  3. each CUDA kernel against its plain PyTorch version on the card, on
     seeded inputs at the main paths' shapes plus hard cases — exact
     equality (all outputs are integers) — with the kernel's, the plain
     version's and a yardstick PyTorch call's times, and the kernel's
     bytes bound at the card's 3.35 TB/s; kernel 1 with int32 and bool
     flags (bool, as the callers pass them, in the kernels line; int32 in
     its kernel_time line), its main case called 10 more times, and
     kernel 3's main and one-key cases too, bit-identical every time
     (their tiles finish in a different order on every call), with kernel
     3's scratch bytes; kernel 2 at one key word (the main shape) and at
     2, 3 and 8 full 32-bit words, timed at 1, 2 and 8 (2 and 8 in its
     kernel_time line); kernels 2 and 3 at phase 8a's shapes too (two
     routed runs of route_cap rows; the 2^24-row shard store and their
     merged run), timed in their kernel_time lines;
     kernel 4 timed as the table calls it, one launch over a round's four
     value columns, and kernel 5 as one launch over the two k=14 probe
     columns and as one column, both with the 32-byte sectors they touch
     (the sector floor beside the bound); both also at the wide table's
     widths on the same round (kernel 5 on 17 and 20 columns, kernel 4
     on 19 and 20: regions of one flat array of S_COL words each), exact,
     timed beside index_select / index_add_ on the same columns;
  4. end to end, sort backend: the seed-42 bench FASTQ (bench.py, 20,000
     reads) counted at k=14 with the CLI's defaults; totals, the full
     sorted export against an independent numpy count, point queries, the
     kernels' launch counts on that run (kernel 2 exactly once: one flush
     of two runs), and a second batch geometry that
     must give the identical export;
  5. end to end, table backend: the same file at k=14, l=26 (totals,
     spill, fill factor, export and queries against the numpy count,
     launch counts, one kernel-4 and one kernel-5 launch per split
     round, the round widths, cold and warm times); at k=31, l=25 against
     a numpy count at k=31; and a small file counted on the card and on
     the CPU, whose table states must be identical word for word;
  6. wide keys: the lane-mix kernel against its plain version at 8 and 16
     lanes (2^24 positions, forward, inverse and the round trip, exact,
     timed beside its bound), kernel 2 at 8, 9 and 17 key words on two
     2^24-row runs (the wide counts' merge tree), kernel 3 at 3, 5, 8, 9
     and 17 key words at the k=14 store-merge shape and at 8 and 17 at the
     wide counts' (2^25 + 2^25 rows), kernel 1 with 18 columns on 2^24
     rows (each exact, timed beside its bound);
     then the bench FASTQ counted on the sort backend at k = 31, 63, 127
     (the lane mix engaged by the auto rule) and 256 (the mix, 17
     operands), each export against an independent numpy count of
     multi-lane keys, with the launches of each count, and k=127 again
     with hash_first=False (the same export; cold and warm walls of both,
     and the device's busy time over one more warm count of each, from a
     torch.profiler trace: the auto rule's A/B);
  7. the user surface: the bench FASTQ at k=14, l=26, batch_words 2^16
     (the counter's defaults) with the LSM store at growth 8 (levels 2^25,
     2^26, by the auto rule) and 2 (2^23 .. 2^26, cascades during the
     count) and with the flat store, each export against the numpy count
     (cold, warm and busy times, the levels, the absorbs, the launches);
     kernel 3 at the LSM absorb's shape (the collapsed 2^26-row top level
     + the 2^25-row L0, from that count) exact and timed beside its bound;
     canonical counts (sort k=31 l=25, table k=14 l=26) against numpy
     canonical counts, walls beside the plain counts'; a count split in two
     halves with save_counter / load_counter between them (sort with the
     LSM, table), equal to the whole count; the command line in process at
     its defaults (--stats-json --save-state: the totals; its default
     --shards 1 is the sharded counter, so 8c is checked here: the
     sharded stats keys, a file of n_shards 1 that loads back to the
     numpy count), one
     `python -m tsxcount_tpu_torch count --dump --check` process on a
     small file (exit 0), --checkabort (200) and a too-small --l (42); and
     the memory model's estimate held above the allocator's peak for the
     LSM, canonical and command-line counts;
  8. the sharded counter (parallel/sharded.py): 8a, the reference's main
     path, ShardedKmerCounter at one shard (alone: no process group) at
     bench.py's sharded defaults (k=14, l=24, merge_every 2,
     capacity_factor 1.5, bench.py's auto batch words): totals, export
     and queries against the numpy count, cold and warm walls and the
     card's busy time beside KmerCounter at the same geometry, launches,
     the memory estimate (n_shards 1) against the peak, then one more
     count on a one-rank NCCL group made first (its collectives through
     NCCL; export against the numpy count); kernels 2 and 3 were held at
     8a's shapes in phase 3; 8b, the table at
     k=14, l=26 (the lane mix, kernels 5, 4, 1) and the sort backend at
     k=127 (the mix, the prefix sort) at one shard, each export against
     its numpy count, busy times beside the plain counter's; 8d, two rank
     processes on the one card (cuda:0,
     gloo stages the exchange through the host), sort and table at k=14,
     each rank its byte range of the file, exports against the numpy
     count;
  9. the last options (the bench FASTQ, each export against its numpy
     count): 9a `hash_first="gf2"` (sort, k=14 l=26 and k=63 l=25,
     2^20-word batches), 9b `mix_prefix=True` at k = 31, 127 and 224
     (l=25; k=224 runs kernels 1-3 at 17 key words), each with cold and
     warm walls and the card's busy time beside the default path at the
     same k, the GF(2) product's time a batch (event-timed, and aten::mm
     from a trace) and the mix columns' time; kernels 2 and 3 at 9b's
     k=127 and k=224 widths and rows (kernel 3 on each count's own
     store), exact and timed beside their bounds; 9c
     `ShardedKmerCounter(n_shards=1, routing_hash="gf2")` on the table
     (k=14 l=26) and `identity_hash=True` on the sort backend; 9d two
     ranks on cuda:0 over gloo with the GF(2) routing, sort and table;
     9e save -> load -> continue for 9a (k=14), 9b (k=127) and 9c, each
     equal to the whole count, and the command line with `--shards 0
     --mix-prefix`, `--shards 0 --hash-first gf2` and `--routing-hash gf2
     --mode table` (exit 0, the k=14 totals); the memory estimate against
     the peak of three of its counts;
 10. the wide table: the bench FASTQ on the table at k = 256, l = 25
     (20 slot columns; kernel 5 reads 17 a round, kernel 4 adds 19),
     against phase 6's numpy count at k = 256 with no spill, one launch
     of kernels 4 and 5 per split round; cold and warm walls, the card's
     busy time, the rounds, the fill and the memory estimate against the
     peak; the same at one shard (ShardedKmerCounter); the small file's
     table states on the card and the CPU at k = 209 and 256;
then the kernels' JSON line (the contract's keys; extra times, floors and
bounds only in the kernel_time lines), the nvidia-smi line, and as the
last line
{"ok": true, "device": {...}}.  Builds and data go to
tsxcount_tpu_torch/build/ (gitignored).  No JAX is imported.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import io
import json
import re
import shutil
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
from tsxcount_tpu_torch.ops.apply import (  # noqa: E402
    MAX_APPLY_COLS,
    apply_sorted_unique,
    apply_sorted_unique_plain,
    gather_sorted,
    gather_sorted_plain,
)
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
from tsxcount_tpu_torch.ops.lanes import lexsort_perm  # noqa: E402
from tsxcount_tpu_torch.ops.table_residue import (  # noqa: E402
    table_residue,
    table_residue_plain,
)
from tsxcount_tpu_torch.ops.mix import (  # noqa: E402
    LaneMixBijection,
    lane_mix,
    lane_mix_plain,
    mix_cols,
    strip_mix,
)
from tsxcount_tpu_torch import cli  # noqa: E402
from tsxcount_tpu_torch.core.checkpoint import (  # noqa: E402
    load_counter,
    save_counter,
)
from tsxcount_tpu_torch.utils.hbm import estimate_for  # noqa: E402
from tsxcount_tpu_torch.config import (  # noqa: E402
    BatchSpec,
    route_capacity,
)
from tsxcount_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedKmerCounter,
)
from tsxcount_tpu_torch.utils.profiling import device_busy_us  # noqa: E402

K = 14
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device-memory rate (data sheet)
SLEEP_CYCLES = 100_000_000   # ~50 ms of device sleep ahead of timed calls
SORT_KERNELS = ("compact_flagged", "merge_sorted", "merge_dedupe_sorted")
TABLE_KERNELS = ("gather_sorted", "apply_sorted_unique", "compact_flagged")
TOTAL_KMERS = 18_750_197     # seed-42 bench FASTQ, k=14 windows
DISTINCT_KMERS = 14_479_762  # and distinct k-mers
INV14 = 1 << 28              # k=14 invalid constant (flag above 28 key bits)
DEDUPE_REPEATS = 10          # kernel 3 race check: calls per repeated case
COMPACT_REPEATS = 10         # kernel 1 race check: calls of the main case
DEDUPE_REPEATED = ("main", "one_key_sum_over_2^32")
KERNELS = {
    "compact_flagged": ("tsxcount_tpu_torch/csrc/compact.cu",
                        "tsxcount_tpu/ops/pallas_compact.py:165"),
    "merge_sorted": ("tsxcount_tpu_torch/csrc/merge.cu",
                     "tsxcount_tpu/ops/pallas_merge.py:140"),
    "merge_dedupe_sorted": ("tsxcount_tpu_torch/csrc/merge_dedupe.cu",
                            "tsxcount_tpu/ops/pallas_merge_dedupe.py:83"),
    "apply_sorted_unique": ("tsxcount_tpu_torch/csrc/apply.cu",
                            "tsxcount_tpu/ops/pallas_apply.py:98"),
    "gather_sorted": ("tsxcount_tpu_torch/csrc/apply.cu",
                      "tsxcount_tpu/ops/pallas_apply.py:249"),
    # no Pallas kernel: LaneMixBijection._apply_cols, which XLA fuses
    "lane_mix": ("tsxcount_tpu_torch/csrc/lane_mix.cu",
                 "tsxcount_tpu/ops/mix.py:255"),
    # no Pallas kernel: the XLA ops of QuotientTable.residue_phase
    "table_residue": ("tsxcount_tpu_torch/csrc/table_residue.cu",
                      "tsxcount_tpu/core/table.py:418"),
}
# table_residue's tails at table-k14's shape: (rows, r_start); the first
# is the kernels line's, the cells' widest at their usual round
RESIDUE_TAILS = ((16384, 3), (4096, 2), (8192, 4), (65536, 4))
WIDE_RUNS = ((31, None), (63, None), (127, None), (256, None),
             (127, False))  # (k, hash_first) of phase 6's sort counts
WIDE_L = 25                 # 2^25 store rows: every k's distinct fits
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
    """Median device time of fn() over reps calls, each between its own
    pair of CUDA events, after one warm-up (the median keeps one slow call
    out of the figure).  The calls queue up behind a device sleep, so the
    wrappers' Python time never leaves the card idle inside an event pair
    (device time, not the host's launch time)."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for t0, t1 in events:
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return float(np.median([t0.elapsed_time(t1) for t0, t1 in events]))


def bytes_ms(n_bytes: int) -> float:
    """Least time to move n_bytes at the card's memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


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
    check_apply_registers()


def check_apply_registers() -> None:
    """Kernels 4 and 5 keep their NC column words in registers at every
    width up to the cap: no instantiation of either may use a stack frame
    or local memory (a spill), read from the built library's resource
    usage (cuobjdump); the widths from 16 up are printed."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run(
        [str(tool), "--dump-resource-usage", str(_build.library_path())],
        capture_output=True, text=True, check=True).stdout
    usage, func = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            func = re.search(r"(gather_sorted|apply_sorted_unique)_kernel"
                             r"ILi(\d+)E", m.group(1))
            continue
        if func and "REG:" in line:
            res = dict((k, int(v)) for k, v in
                       re.findall(r"(\w+):(\d+)", line))
            usage[(func.group(1), int(func.group(2)))] = res
            func = None
    want = {(n, nc) for n in ("gather_sorted", "apply_sorted_unique")
            for nc in range(1, MAX_APPLY_COLS + 1)}
    if set(usage) != want:
        raise AssertionError(f"apply kernels in the library: "
                             f"{sorted(set(usage) ^ want)} missing or extra")
    for (name, nc), res in sorted(usage.items()):
        if nc >= 16:
            phase("registers", kernel=name, columns=nc, registers=res["REG"],
                  stack=res["STACK"], local=res["LOCAL"])
        if res["STACK"] or res["LOCAL"]:
            raise AssertionError(f"{name}<{nc}> spills: {res}")


# --- phase 3 ----------------------------------------------------------------

def check_compact(results: dict) -> None:
    """Kernel 1 with int32 flags (the earlier rows' case) and bool flags
    (as both callers now pass them), then offset (unaligned) views; the
    main case timed with bool flags (the contract's keys), with int32 flags
    beside it (an extra), and called COMPACT_REPEATS more times."""
    n = 1 << 24
    worst = 0
    for case, density in (("random", 0.5), ("all0", 0.0), ("all1", 1.0)):
        mask = gpu(rng.random(n) < density)
        cols = (gpu(rng.integers(0, 1 << 29, n, dtype=np.uint32)),
                torch.arange(n, dtype=torch.int32, device=DEV),
                gpu(rng.integers(-2**62, 2**62, n)))
        rows = int(mask.sum())
        for flag in (mask.to(torch.int32), mask):
            err = max_err(compact_flagged(flag, cols),
                          compact_flagged_plain(flag, cols), rows)
            phase("kernel", name="compact_flagged", case=case, rows=n,
                  flags=str(flag.dtype), flagged=rows, max_abs_err=err)
            worst = max(worst, err)
        if case == "random":  # the main path's columns: operand + position
            main, flag32 = cols[:2], mask.to(torch.int32)
            check_compact_repeats(mask, main, rows)
            stacked = torch.stack(main)
            # flags (1 B bool, 4 B int32) and both columns read, the
            # flagged rows written
            timing = dict(
                ms=cuda_ms(lambda: compact_flagged(mask, main)),
                plain_ms=cuda_ms(lambda: compact_flagged_plain(mask, main)),
                library_ms=cuda_ms(lambda: stacked[:, mask]),
                bound_ms=bytes_ms(n + 2 * n * 4 + rows * 2 * 4),
                extra=dict(
                    ms_int32_flags=cuda_ms(
                        lambda: compact_flagged(flag32, main)),
                    bound_ms_int32_flags=bytes_ms(
                        n * 4 + 2 * n * 4 + rows * 2 * 4)))
    # bool flags and columns one row into their storage: the scalar paths
    base = (gpu(rng.random(n + 1) < 0.5),
            gpu(rng.integers(0, 2**32, n + 1, dtype=np.uint32)),
            gpu(rng.integers(-2**62, 2**62, n + 1)))
    flag, cols = base[0][1:], tuple(c[1:] for c in base[1:])
    rows = int(flag.sum())
    err = max_err(compact_flagged(flag, cols),
                  compact_flagged_plain(flag, cols), rows)
    phase("kernel", name="compact_flagged", case="offset_views", rows=n,
          flags=str(flag.dtype), flagged=rows, max_abs_err=err)
    worst = max(worst, err)
    results["compact_flagged"] = dict(max_abs_err=worst, **timing)


def check_compact_repeats(flag, cols, rows: int) -> None:
    """Kernel 1's tiles finish in another order on every call (atomic tile
    counter, look-back): COMPACT_REPEATS more calls must give outputs
    bit-identical to the first call's."""
    first = compact_flagged(flag, cols)
    for i in range(COMPACT_REPEATS):
        got = compact_flagged(flag, cols)
        if not all(torch.equal(g[:rows], f[:rows])
                   for g, f in zip(got, first)):
            raise AssertionError(f"compact_flagged: call {i + 2} differs "
                                 f"from the first")
    phase("kernel_repeats", name="compact_flagged", case="random",
          flags=str(flag.dtype), calls=COMPACT_REPEATS, bit_identical=True)


def route_run(rows: int, n_invalid: int, first: int) -> tuple:
    """A k=14 routed run as the sharded merge tree gets it: `rows` one-word
    keys ascending, the last n_invalid the invalid constant, and an int32
    payload first, first + 1, ... (so that stability shows)."""
    keys = np.concatenate([sorted_keys(rows - n_invalid, 1, INV14)[:, 0],
                           np.full(n_invalid, INV14, np.uint32)])
    return (gpu(keys), torch.arange(first, first + rows, dtype=torch.int32,
                                    device=DEV))


def check_merge(results: dict, route_cap: int) -> None:
    """Kernel 2 against its plain version: the main shape (one key word,
    int32 payload, 2 x 2^24 rows), one key over every row (stability),
    2, 3 and 8 full 32-bit key words at 2 x 2^21 rows, and phase 8a's
    shape (two routed runs of route_cap rows, a third of each the invalid
    tail); timed at the main shape (the contract's keys), at 2 and 8 key
    words and at 8a's shape (extras), each beside its bound: (4 * n_keys
    + 4) B read and written per row."""
    worst = 0
    extra = {}
    cases = {
        "random": (1, 1 << 29),
        "one_key": (1, 1),
        "n_keys2_full32": (2, 1 << 32),
        "n_keys3_full32": (3, 1 << 32),
        "n_keys8_full32": (8, 1 << 32),
    }
    for case, (n_keys, hi) in cases.items():
        size = 1 << 24 if n_keys == 1 else 1 << 21
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
        bound = bytes_ms(2 * (2 * size) * (4 * n_keys + 4))
        if case == "random":
            ms = cuda_ms(lambda: merge_sorted(a_cols, b_cols))
            plain_ms = cuda_ms(lambda: merge_sorted_plain(a_cols, b_cols))
            keys = torch.cat([a_cols[0], b_cols[0]])
            library_ms = cuda_ms(lambda: torch.sort(keys, stable=True))
            main_bound = bound
        elif case in ("n_keys2_full32", "n_keys8_full32"):
            extra[f"ms_n_keys{n_keys}"] = cuda_ms(
                lambda: merge_sorted(a_cols, b_cols, n_keys=n_keys))
            extra[f"bound_ms_n_keys{n_keys}"] = bound
    a = route_run(route_cap, route_cap // 3, 0)
    b = route_run(route_cap, route_cap // 3, route_cap)
    err = max_err(merge_sorted(a, b), merge_sorted_plain(a, b))
    phase("kernel", name="merge_sorted", case="sharded_8a",
          rows=2 * route_cap, n_keys=1, max_abs_err=err)
    worst = max(worst, err)
    tag = f"rows2x{route_cap}"
    extra[f"ms_{tag}"] = cuda_ms(lambda: merge_sorted(a, b))
    extra[f"plain_ms_{tag}"] = cuda_ms(lambda: merge_sorted_plain(a, b))
    extra[f"bound_ms_{tag}"] = bytes_ms(2 * (2 * route_cap) * 8)
    results["merge_sorted"] = dict(max_abs_err=worst, ms=ms,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=main_bound, extra=extra)


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


def check_merge_dedupe(results: dict, route_cap: int) -> None:
    """Kernel 3 against its plain version: the k=14 store merge (the main
    shape, timed for the contract's keys), sums across 2^32, an all-invalid
    side, full 32-bit words, and phase 8a's fold (its 2^24-row shard store
    and the merged run of 2 x route_cap rows, timed in the extras)."""
    worst = 0
    extra = {}
    sharded = f"rows2^24+2x{route_cap}"
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
        # phase 8a: the shard store + the two routed runs merged
        "sharded_8a": (
            dedupe_run(1 << 24, 1, 1 << 28, 1 << 21, INV14, (1, 1000),
                       unique=True),
            dedupe_run(2 * route_cap, 1, 1 << 28, 2 * route_cap // 3, INV14,
                       (1, 100)),
            1, INV14),
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
        m, n = a[0].numel(), b[0].numel()
        phase("kernel", name="merge_dedupe_sorted", case=case,
              rows=m + n, n_keys=n_keys, runs=int(w_runs),
              valid=int(w_valid), max_abs_err=err,
              scratch_bytes=_build.kernels().tsx_merge_dedupe_scratch_bytes(
                  n_keys, m, n))
        worst = max(worst, err)
        if case in DEDUPE_REPEATED:
            check_repeats(case, a, b, n_keys, inv_min, got,
                          (int(w_runs), int(w_valid)))
        if case == "main":
            ms = cuda_ms(lambda: merge_dedupe_sorted(a, b, 1, INV14))
            plain_ms = cuda_ms(
                lambda: merge_dedupe_sorted_plain(a, b, 1, INV14))
            # (int32 key, int64 count) rows of both runs read, one row per
            # run written
            bound = bytes_ms((a[0].numel() + b[0].numel()) * 12
                             + int(w_runs) * 12)
        elif case == "sharded_8a":
            extra[f"ms_{sharded}"] = cuda_ms(
                lambda: merge_dedupe_sorted(a, b, 1, INV14))
            extra[f"plain_ms_{sharded}"] = cuda_ms(
                lambda: merge_dedupe_sorted_plain(a, b, 1, INV14))
            extra[f"bound_ms_{sharded}"] = bytes_ms((m + n + int(w_runs))
                                                    * 12)
    worst = max(worst, check_store_junk_tail())
    # no single PyTorch call merges, dedupes and sums: library_ms is null
    results["merge_dedupe_sorted"] = dict(max_abs_err=worst, ms=ms,
                                          plain_ms=plain_ms,
                                          library_ms=None, bound_ms=bound,
                                          extra=extra)


def check_repeats(case: str, a, b, n_keys: int, inv_min: int, first,
                  stats: tuple[int, int]) -> None:
    """Kernel 3's tiles finish in another order on every call (the tile
    index comes from an atomic counter; the look-back waits on whichever
    tiles are still open): DEDUPE_REPEATS more calls must give outputs and
    stats bit-identical to the first call's."""
    n_runs = stats[0]
    for i in range(DEDUPE_REPEATS):
        got, g_runs, g_valid = merge_dedupe_sorted(a, b, n_keys, inv_min)
        same = ((int(g_runs), int(g_valid)) == stats and all(
            torch.equal(g[:n_runs], f[:n_runs]) for g, f in zip(got, first)))
        if not same:
            raise AssertionError(f"merge_dedupe {case}: call {i + 2} differs "
                                 f"from the first")
    phase("kernel_repeats", name="merge_dedupe_sorted", case=case,
          calls=DEDUPE_REPEATS, bit_identical=True)


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


S_COL = 1 << 26      # one column region of the k=14, l=26 table
# kernel 5's and kernel 4's column sets of the wide table's round (k = 241-
# 256: 16 lanes + the used flag; + digits 0 and 1), and a whole slot's 20
WIDE_GATHER_COLS = (17, 20)
WIDE_APPLY_COLS = (19, 20)
W_ROUND = 1 << 24    # round-0 width of a 2^20-word batch (P = 16 * 2^20)
N_ACTIVE = 12 << 20  # rows of that round with a k-mer (distinct per batch)


def round_dst(n_active: int, width: int, s: int, n_slots: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dstg, dsta) of a table round: n_active rows probe uniform slots of
    [0, s) (or of n_slots of them), sorted; the rest are inactive (1 << 30).
    dstg reads every active row's slot; dsta updates each run's last row,
    as a round into an empty table resolves every run at its end."""
    slots = rng.integers(0, s, n_active) if n_slots is None else (
        rng.integers(0, s, n_slots)[rng.integers(0, n_slots,
                                                           n_active)])
    pos = torch.sort(gpu(slots.astype(np.int64))).values
    end = torch.ones_like(pos, dtype=torch.bool)
    end[:-1] = pos[1:] != pos[:-1]
    dead = torch.full((width - n_active,), 1 << 30, dtype=torch.int64,
                      device=DEV)
    dstg = torch.cat([2 * pos + 1, dead])
    dsta = torch.cat([torch.where(end, 2 * pos + 1, 2 * pos), dead])
    return dstg.to(torch.int32), dsta.to(torch.int32)


def live_addr(dst2: torch.Tensor) -> torch.Tensor:
    return (dst2[(dst2 & 1) == 1] >> 1).to(torch.int64)


def apply_cases() -> dict:
    """name -> (dstg, dsta): the main round and the hard cases."""
    s = S_COL
    ar = torch.arange(s, dtype=torch.int32, device=DEV)
    edges = torch.cat([
        torch.tensor([1], dtype=torch.int32, device=DEV),
        2 * torch.arange(1, s, 997, dtype=torch.int32, device=DEV),
        torch.tensor([2 * s - 1], dtype=torch.int32, device=DEV),
        torch.full((1 << 20,), 1 << 30, dtype=torch.int32, device=DEV)])
    dead = torch.sort(2 * gpu(rng.integers(0, s, W_ROUND).astype(np.int32)))
    return {
        "main": round_dst(N_ACTIVE, W_ROUND, s),
        "all_dead": (dead.values, dead.values),
        "dense": (2 * ar + 1, 2 * ar + 1),
        "first_and_last_word": (edges, edges),
        "dead_tail_only": round_dst(0, 1 << 20, s),
        "long_runs": round_dst(N_ACTIVE, W_ROUND, s, n_slots=4096),
    }


def check_apply_kernels(results: dict) -> None:
    col = gpu(rng.integers(0, 2**32, S_COL, dtype=np.uint32))
    # kernel 5's column set: two adjacent regions of one flat array
    flat2 = gpu(rng.integers(0, 2**32, 2 * S_COL, dtype=np.uint32))
    pair = [flat2[:S_COL], flat2[S_COL:]]
    worst_g = worst_a = 0
    for case, (dstg, dsta) in apply_cases().items():
        g = gather_sorted(col, dstg)
        w = gather_sorted_plain(col, dstg)
        err_g = max(max_err(g, w),
                    max_err(gather_sorted(pair, dstg)[0],
                            gather_sorted_plain(pair, dstg)[0]))
        val = gpu(rng.integers(0, 2**32, dsta.numel(), dtype=np.uint32))
        got = apply_sorted_unique(col.clone(), dsta, val)
        want = apply_sorted_unique_plain(col.clone(), dsta, val)
        err_a = max_err(got, want)
        phase("kernel", name="gather/apply", case=case, elements=dstg.numel(),
              live_gather=int((dstg & 1).sum()),
              live_apply=int((dsta & 1).sum()),
              max_abs_err_gather=err_g, max_abs_err_apply=err_a)
        worst_g, worst_a = max(worst_g, err_g), max(worst_a, err_a)
    # adds that wrap past 2^32: slot words and values both >= 2^31
    dstg, dsta = round_dst(N_ACTIVE, W_ROUND, S_COL)
    big = gpu(rng.integers(2**31, 2**32, S_COL, dtype=np.uint32))
    val = gpu(rng.integers(2**31, 2**32, W_ROUND, dtype=np.uint32))
    err = max_err(apply_sorted_unique(big.clone(), dsta, val),
                  apply_sorted_unique_plain(big.clone(), dsta, val))
    phase("kernel", name="apply_sorted_unique", case="wrap_past_2^32",
          elements=W_ROUND, max_abs_err=err)
    worst_a = max(worst_a, err)

    # a table round at the main shape, all columns in one launch
    worst_a = max(worst_a, check_apply_round(results, dsta))

    # gather times at the main round's shape: one call over the two probe
    # columns of k=14 (key word, used flag), and a one-column call
    live_g = live_addr(dstg)
    words_g = torch.unique_consecutive(live_g).numel()
    sectors_g = torch.unique_consecutive(live_g >> 3).numel()
    segments_g = torch.unique_consecutive(live_g >> 4).numel()
    idx_g = torch.where((dstg & 1) == 1, dstg >> 1, 0).to(torch.int64)
    slots2d = flat2.view(2, S_COL)
    w = dstg.numel()
    extra = dict(
        sector_floor_ms=bytes_ms(w * 4 + 2 * w * 4 + 2 * sectors_g * 32),
        ms_one_column=cuda_ms(lambda: gather_sorted(col, dstg)),
        library_ms_one_column=cuda_ms(
            lambda: torch.index_select(col, 0, idx_g)),
        bound_ms_one_column=bytes_ms(w * 8 + words_g * 4))
    for n_cols in WIDE_GATHER_COLS:  # the wide table's probe, one slot
        wide = gather_times(dstg, n_cols, words_g, sectors_g, idx_g)
        worst_g = max(worst_g, wide.pop("max_abs_err"))
        extra |= {f"{key}_cols{n_cols}": v for key, v in wide.items()}
    results["gather_sorted"] = dict(
        max_abs_err=worst_g,
        ms=cuda_ms(lambda: gather_sorted(pair, dstg)),
        plain_ms=cuda_ms(lambda: gather_sorted_plain(pair, dstg)),
        library_ms=cuda_ms(lambda: torch.index_select(slots2d, 1, idx_g)),
        # dst2 read, two outs written, each distinct live slot word of
        # each column read once (4 B; 32 B per distinct sector for the
        # floor that the data's scatter puts above it)
        bound_ms=bytes_ms(w * 4 + 2 * w * 4 + 2 * words_g * 4),
        extra=extra)
    results["apply_sorted_unique"]["max_abs_err"] = worst_a
    phase("kernel_shape", name="gather_sorted", column_words=S_COL,
          elements=w, columns=2, live_gather=live_g.numel(),
          words_gather=words_g, sectors_32B=sectors_g,
          segments_64B=segments_g)


def round_values(dsta: torch.Tensor, lanes: int = 1,
                 digit2: bool = False) -> list:
    """Kernel 4's value columns of a table's round 0 into an empty table,
    without the digit-2 column (as core/table.py passes them) unless
    digit2: every live row wins its slot, so key lanes and used flag are
    non-zero there; digit 0 is the count (1..999), digits 1 and 2 zero
    (counts below 2^20).  The k=14 table has one key lane, k = 256 16."""
    w = dsta.numel()
    keys = [gpu(rng.integers(1, 1 << 28, w, dtype=np.uint32))] + [
        gpu(rng.integers(1, 2**32, w, dtype=np.uint32))
        for _ in range(lanes - 1)]
    zero = torch.zeros(w, dtype=torch.int32, device=DEV)
    return keys + [gpu(rng.integers(1, 1000, w).astype(np.int32)), zero,
                   *([zero] * digit2),
                   torch.ones(w, dtype=torch.int32, device=DEV)]


def apply_times(dsta: torch.Tensor, vals: list, plain: bool) -> dict:
    """Kernel 4 over the value columns `vals` of one round, on column
    regions of one flat slot array: exact against the plain version, then
    timed beside one index_add_ on the flat array at precomputed c * S +
    address (the yardstick), with its bytes bound and sector floor (and
    the plain version's time where `plain`)."""
    n_cols = len(vals)
    flat0 = gpu(rng.integers(0, 2**32, n_cols * S_COL, dtype=np.uint32))
    regions = lambda f: [f[c * S_COL : (c + 1) * S_COL] for c in range(n_cols)]
    got, want = flat0.clone(), flat0.clone()
    apply_sorted_unique(regions(got), dsta, vals)
    apply_sorted_unique_plain(regions(want), dsta, vals)
    err = max_err((got,), (want,))
    del got, want
    phase("kernel", name="apply_sorted_unique",
          case=f"round_{n_cols}_columns", elements=dsta.numel(),
          columns=n_cols, max_abs_err=err)
    live = (dsta & 1) == 1
    addr = live_addr(dsta)
    idx = torch.cat([c * S_COL + addr for c in range(n_cols)])
    lib_vals = torch.cat([v[live] for v in vals])
    scratch = flat0
    cols = regions(scratch)
    # dst2 read once; per column its live values read; 4 B read and 4 B
    # written per non-zero update
    nonzero = [int((v[live] != 0).sum()) for v in vals]
    sectors = [torch.unique_consecutive(addr[v[live] != 0] >> 3).numel()
               for v in vals]
    streamed = dsta.numel() * 4 + n_cols * addr.numel() * 4
    out = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: apply_sorted_unique(cols, dsta, vals)),
        library_ms=cuda_ms(lambda: scratch.index_add_(0, idx, lib_vals)),
        bound_ms=bytes_ms(streamed + sum(nonzero) * 8),
        sector_floor_ms=bytes_ms(streamed + 2 * 32 * sum(sectors)))
    if plain:
        out["plain_ms"] = cuda_ms(
            lambda: apply_sorted_unique_plain(cols, dsta, vals))
    phase("kernel_shape", name="apply_sorted_unique", column_words=S_COL,
          elements=dsta.numel(), columns=n_cols, live=addr.numel(),
          nonzero_updates=nonzero, sectors_32B=sectors,
          sector_bytes_moved=2 * 32 * sum(sectors))
    return out


def check_apply_round(results: dict, dsta: torch.Tensor) -> int:
    """Kernel 4 as the table calls it: one launch over the four value
    columns of the k=14 table's main-shape round (the contract's time),
    and over the wide table's 19 (k = 241-256: 16 lanes, digits 0 and 1,
    used) and a whole slot's 20 (the cap), each in its kernel_time
    extras (ms_cols19, ...)."""
    r = apply_times(dsta, round_values(dsta), plain=True)
    extra = dict(sector_floor_ms=r.pop("sector_floor_ms"))
    err = r["max_abs_err"]
    for n_cols in WIDE_APPLY_COLS:
        w = apply_times(dsta, round_values(dsta, lanes=16,
                                           digit2=n_cols == 20),
                        plain=False)
        err = max(err, w.pop("max_abs_err"))
        extra |= {f"{key}_cols{n_cols}": v for key, v in w.items()}
    results["apply_sorted_unique"] = r | dict(extra=extra)
    return err


def gather_times(dstg: torch.Tensor, n_cols: int, words_g: int,
                 sectors_g: int, idx_g) -> dict:
    """Kernel 5 over n_cols regions of one flat slot array at the main
    round's dstg: exact against the plain version, timed beside one
    index_select over the same columns, with its bytes bound and sector
    floor."""
    flat = gpu(rng.integers(0, 2**32, n_cols * S_COL, dtype=np.uint32))
    cols = [flat[c * S_COL : (c + 1) * S_COL] for c in range(n_cols)]
    err = max_err(gather_sorted(cols, dstg)[0],
                  gather_sorted_plain(cols, dstg)[0])
    phase("kernel", name="gather_sorted", case=f"main_{n_cols}_columns",
          elements=dstg.numel(), columns=n_cols, max_abs_err=err)
    w = dstg.numel()
    slots2d = flat.view(n_cols, S_COL)
    streamed = w * 4 + n_cols * w * 4
    return dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: gather_sorted(cols, dstg)),
        library_ms=cuda_ms(lambda: torch.index_select(slots2d, 1, idx_g)),
        bound_ms=bytes_ms(streamed + n_cols * words_g * 4),
        sector_floor_ms=bytes_ms(streamed + n_cols * sectors_g * 32))


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
    """(int64 keys ascending, counts) of the counter's full export (k <=
    32)."""
    keys, counts = export_lanes(counter)
    return flat_export(keys, counts)


def export_lanes(counter: KmerCounter) -> tuple[np.ndarray, np.ndarray]:
    """(uint32 keys [n, lanes], counts) of the counter's full export, in
    the store's (or the table's slot) order; reading `distinct` first
    collapses an LSM store."""
    counter.distinct
    if counter.backend == "sort":  # store images mapped back on the card
        keys, counts, _ = counter.store.to_host(counter.state,
                                                counter.key_map)
        if counter.mix_prefix:
            keys = strip_mix(keys)
    else:
        keys, counts, _ = counter.table.to_host(counter.state)
    return keys, counts


def check_queries(counter: KmerCounter, want_keys, want_counts) -> None:
    """Point queries, half present and half random (mostly absent),
    against the host count."""
    k = counter.spec.k
    present = want_keys[rng.integers(0, len(want_keys), 2048)]
    rand = rng.integers(0, 4**k, 2048, dtype=np.int64)
    q = np.concatenate([present, rand])
    idx = np.clip(np.searchsorted(want_keys, q), 0, len(want_keys) - 1)
    want_q = np.where(want_keys[idx] == q, want_counts[idx], 0)
    strings = ["".join("ACGT"[(int(v) >> (2 * i)) & 3] for i in range(k))
               for v in q]
    got_q = np.asarray(counter.get_counts(strings))
    if not np.array_equal(got_q, want_q):
        raise AssertionError(f"{counter.backend} get_counts differs from "
                             f"the host count")
    phase("e2e_queries", backend=counter.backend, queries=len(q),
          present=int((want_q > 0).sum()))


def timed_count(counter: KmerCounter, path: Path) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counter.count_file(path, use_native=True)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def bench_file() -> Path:
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    path = build_dir / f"bench.{bench.N_READS}.fastq"
    bench.ensure_synth_fastq(path, bench.N_READS, seed=42)
    return path


def end_to_end(path: Path, want_keys, want_counts) -> dict:
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
    for name in SORT_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} not launched on the path")
    # two batches, one flush of two runs: one merge of the merge tree
    if launches["merge_sorted"] != 1:
        raise AssertionError(f"merge_sorted launched "
                             f"{launches['merge_sorted']} times, not once")

    check_queries(counter, want_keys, want_counts)

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


# --- phase 5 ----------------------------------------------------------------

def record_widths(counter: KmerCounter) -> list:
    """(reprobe index, width) of every split round the counter runs."""
    widths = []
    split_round = counter.table.split_round

    def spy(state, r, pos0, *args):
        widths.append((r, pos0.shape[0]))
        return split_round(state, r, pos0, *args)

    counter.table.split_round = spy
    return widths


def check_table(counter: KmerCounter, want_keys, want_counts, tag: str
                ) -> None:
    st = counter.stats()
    got_keys, got_counts = export(counter)
    phase("e2e_table", run=tag, total_kmers=st["total_kmers"],
          distinct=st["distinct_kmers"], spilled=st["spilled"],
          fill_factor=st["fill_factor"],
          probe_histogram=st["probe_histogram"])
    if st["spilled"] != 0:
        raise AssertionError(f"table {tag}: {st['spilled']} spilled")
    if st["fill_factor"] != len(want_keys) / counter.table.slots:
        raise AssertionError(f"table {tag}: fill factor {st['fill_factor']}")
    if not (np.array_equal(got_keys, want_keys)
            and np.array_equal(got_counts, want_counts)):
        raise AssertionError(f"table {tag}: export differs from the numpy "
                             f"host count")


def table_end_to_end(path: Path, want_keys, want_counts) -> dict:
    counter = KmerCounter(k=K, l=26, backend="table", batch_words=1 << 20,
                          device="cuda")
    widths = record_widths(counter)
    _build.reset_launch_counts()
    cold = timed_count(counter, path)
    launches = _build.launch_counts()
    total, distinct = counter.total_kmers, counter.distinct
    phase("e2e_table", run="cold", seconds=round(cold, 4),
          kmers_per_s=round(total / cold), total_kmers=total,
          distinct=distinct, launches=launches, rounds=widths)
    if (total, distinct) != (TOTAL_KMERS, DISTINCT_KMERS):
        raise AssertionError(f"table totals {total}/{distinct} != "
                             f"{TOTAL_KMERS}/{DISTINCT_KMERS}")
    check_table(counter, want_keys, want_counts, "k=14,l=26")
    for name in TABLE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} not launched on the "
                                 f"table path")
    # kernels 4 and 5 take every column of a split round in one launch
    for name in ("apply_sorted_unique", "gather_sorted"):
        if launches[name] != len(widths):
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {len(widths)} split rounds")
    # every tail of an insert is one launch of the residue kernel
    tails = counter.table.residue_launches
    if not 0 < launches["table_residue"] == tails:
        raise AssertionError(f"table_residue launched "
                             f"{launches['table_residue']} times in {tails} "
                             f"tails")
    phase("e2e_table", run="cold", split_rounds=len(widths),
          apply_sorted_unique_launches=launches["apply_sorted_unique"],
          gather_sorted_launches=launches["gather_sorted"],
          table_residue_launches=launches["table_residue"])
    check_queries(counter, want_keys, want_counts)
    counter.reset()
    widths.clear()
    warm = timed_count(counter, path)
    check_table(counter, want_keys, want_counts, "k=14,l=26 warm")
    phase("e2e_table", run="warm", seconds=round(warm, 4),
          kmers_per_s=round(counter.total_kmers / warm), rounds=widths)

    # 2 lanes, several batches into a non-empty table, about half full
    t0 = time.perf_counter()
    keys31, counts31 = host_count(path, 31)
    wide = KmerCounter(k=31, l=25, backend="table", batch_words=1 << 18,
                       device="cuda")
    t_wide = timed_count(wide, path)
    phase("e2e_table", run="k=31,l=25,batch_words=2^18",
          seconds=round(t_wide, 4), batches=wide.batches_processed,
          kmers_per_s=round(wide.total_kmers / t_wide),
          host_count_s=round(time.perf_counter() - t0 - t_wide, 3))
    check_table(wide, keys31, counts31, "k=31,l=25")
    check_queries(wide, keys31, counts31)
    del wide
    card_vs_cpu()
    return launches


def card_vs_cpu(k: int = K) -> None:
    """A small file counted on the card and on the CPU (plain versions of
    every kernel) at k: the table states must match word for word."""
    path = _build.BUILD_DIR / "small.2000.fastq"
    bench.ensure_synth_fastq(path, 2000, seed=7)
    states = []
    for dev in ("cuda", "cpu"):
        c = KmerCounter(k=k, l=22, backend="table", batch_words=1 << 14,
                        device=dev)
        widths = record_widths(c)
        c.count_file(path, use_native=True)
        states.append(c.table.state_to_reference(c.state))
    err = max(int(np.abs(states[0][f].astype(np.int64)
                         - states[1][f].astype(np.int64)).max())
              for f in states[0])
    phase("table_card_vs_cpu", fastq=path.name, k=k,
          batches=c.batches_processed,
          distinct=int(states[0]["n"]), rounds=len(widths),
          max_round=max(r for r, _ in widths), max_abs_err=err)
    if err:
        raise AssertionError("table state on the card differs from the CPU's")


# --- phase 6 ----------------------------------------------------------------

def check_lane_mix(results: dict) -> None:
    """The lane-mix kernel against its plain version at 8 lanes (k=127,
    the main path's shape) and 16 (k=256), 2^24 positions of full random
    words (the top lane masked), forward and inverse, and the round trip;
    timed forward at both (8 lanes in the kernels line) and inverse, each
    beside its bound: every lane word read and written once, 8 B a lane a
    position."""
    n = 1 << 24
    g = torch.Generator(device=DEV)
    g.manual_seed(127)
    worst, extra = 0, {}
    for k in (127, 256):
        spec = KmerSpec(k)
        mix = LaneMixBijection(spec)
        cols = [torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                              device=DEV, generator=g)
                for _ in range(spec.lanes)]
        cols[-1] &= spec.top_lane_mask
        for inverse in (False, True):
            err = max_err(lane_mix(cols, mix, inverse),
                          lane_mix_plain(cols, mix, inverse))
            phase("kernel", name="lane_mix", k=k, lanes=spec.lanes,
                  rows=n, inverse=inverse, max_abs_err=err)
            worst = max(worst, err)
        err = max_err(lane_mix(lane_mix(cols, mix), mix, inverse=True), cols)
        phase("kernel", name="lane_mix", k=k, case="round_trip", rows=n,
              max_abs_err=err)
        worst = max(worst, err)
        ms = cuda_ms(lambda: lane_mix(cols, mix))
        plain_ms = cuda_ms(lambda: lane_mix_plain(cols, mix))
        bound = bytes_ms(n * spec.lanes * 8)
        if k == 127:
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
        else:
            extra.update(ms_16_lanes=ms, plain_ms_16_lanes=plain_ms,
                         bound_ms_16_lanes=bound)
        extra[f"ms_inverse_{spec.lanes}_lanes"] = cuda_ms(
            lambda: lane_mix(cols, mix, inverse=True))
        del cols
    # no single PyTorch call computes the mix: library_ms is null
    results["lane_mix"] = dict(max_abs_err=worst, library_ms=None,
                               extra=extra, **timing)


def residue_table() -> tuple:
    """(table, state) of the table-k14 configuration at its 2^26 slots
    (its hash seed, 64 reprobes), a fifth of the slots used by random
    keys with random counts, as a tail of a job finds them."""
    from tsxcount_tpu_torch import GF2Hash, QuotientTable

    spec = KmerSpec(K)
    t = QuotientTable(spec, 26, GF2Hash(spec, seed=31836), max_reprobes=64,
                      device=DEV)
    st = t.init_state()
    g = torch.Generator(device=DEV)
    g.manual_seed(21)
    used = torch.rand(t.slots, device=DEV, generator=g) < 0.2
    st.slots[: t.slots] = torch.randint(
        -2**31, 2**31, (t.slots,), dtype=torch.int32, device=DEV,
        generator=g) & ~t._low_mask
    for c in range(spec.lanes, spec.lanes + 3):
        t._col(st.slots, c).copy_(torch.randint(
            0, 1 << 20, (t.slots,), dtype=torch.int32, device=DEV,
            generator=g) * used)
    t._col(st.slots, t.slot_cols - 1).copy_(used.to(torch.int32))
    return t, st


def residue_carry(t, g: torch.Generator, rows: int, repeat=None) -> tuple:
    """A tail's compacted carry of `rows` rows, 70 % of them active:
    unique random 14-mers in random order (a share of them `repeat`'s
    when given, so they match), counts up to 2^22 (so the second digit is
    not 0).  Returns (carry, keys)."""
    keys = torch.randint(0, 4**K, (2 * rows,), dtype=torch.int32,
                         device=DEV, generator=g).unique()
    if repeat is not None:
        old = repeat[: rows // 2]
        keys = torch.cat([old, keys[~torch.isin(keys, old)]])
    keys = keys[torch.randperm(keys.numel(), device=DEV, generator=g)][:rows]
    pos0, cleared = t._hash_cols(keys[:, None])
    counts = torch.randint(1, 1 << 22, (rows,), dtype=torch.int32,
                           device=DEV, generator=g)
    active = torch.arange(rows, device=DEV) < int(0.7 * rows)
    return (pos0, cleared, counts, active), keys


def residue_bytes(rows_in: list, resolved: int, won: int, lanes: int,
                  width: int) -> int:
    """Least bytes of a tail: the active flags once; in each round an
    entering row's pos0, key lanes, its slot's key lanes and used word; a
    resolved row's count and its slot's two digit words (read and
    written); a winner's key lanes and used word written."""
    per_probe = 4 + 4 * lanes + 4 * (lanes + 1)
    return (width + sum(rows_in) * per_probe + resolved * (4 + 16)
            + won * 4 * (lanes + 1))


def check_table_residue(results: dict) -> None:
    """The residue kernel against its plain rounds at table-k14's shape
    (the 2^26-slot table a fifth full): tails of 4-64K rows from rounds
    2-4, each carry inserted twice in turn (the second carry holds half
    the first's keys, so rows also match): slots, n, spilled, probe_hist
    and the rounds run word for word after each.  Timed on fresh carries
    (device time of the one launch against the plain rounds' wall between
    the same events, host syncs included), beside a bound from the
    checked run's bytes."""
    t, st = residue_table()
    g = torch.Generator(device=DEV)
    g.manual_seed(4)
    lanes = t.spec.lanes
    worst, extra, timing = 0, {}, None
    for rows, r0 in RESIDUE_TAILS:
        got = [st.slots.clone(), st.n, st.spilled, st.probe_hist]
        want = [st.slots.clone(), st.n, st.spilled, st.probe_hist]
        keys = None
        for turn in range(2):
            carry, keys = residue_carry(t, g, rows, keys)
            rounds = torch.zeros((), dtype=torch.int64, device=DEV)
            hist0 = got[3]
            got[1:] = table_residue(got[0], t.slots, carry, r0, rows,
                                    t.max_reprobes, *got[1:], rounds)
            *w, k = table_residue_plain(want[0], t.slots, carry, r0, rows,
                                        t.max_reprobes, *want[1:])
            want[1:] = w
            err = max(max_err([a.reshape(-1) for a in got],
                              [b.reshape(-1) for b in want]),
                      abs(int(rounds) - k))
            worst = max(worst, err)
            resolved_r = (got[3] - hist0).tolist()
            active = int(carry[3].sum())
            rows_in, left = [], active
            for r in range(r0, r0 + k):
                rows_in.append(left)
                left -= resolved_r[min(r, len(resolved_r) - 1)]
            phase("kernel", name="table_residue", rows=rows, r_start=r0,
                  turn=turn, active=active, rounds=k, rounds_kernel=int(
                      rounds), spilled=int(got[2]), max_abs_err=err)
            if turn == 0:
                won = int(got[1] - st.n)
                n_bytes = residue_bytes(rows_in, active - left, won, lanes,
                                        rows)
        del got, want
        fresh = iter([residue_carry(t, g, rows)[0] for _ in range(12)])
        tail_st = [st.slots.clone(), st.n, st.spilled, st.probe_hist]
        rounds = torch.zeros((), dtype=torch.int64, device=DEV)
        ms = cuda_ms(lambda: table_residue(tail_st[0], t.slots, next(fresh),
                                           r0, rows, t.max_reprobes,
                                           *tail_st[1:], rounds))
        plain_ms = cuda_ms(lambda: table_residue_plain(
            tail_st[0], t.slots, next(fresh), r0, rows, t.max_reprobes,
            *tail_st[1:]))
        del tail_st
        bound = bytes_ms(n_bytes)
        if timing is None:
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
        extra.update({f"ms_{rows}_r{r0}": ms, f"plain_ms_{rows}_r{r0}":
                      plain_ms, f"bound_ms_{rows}_r{r0}": bound})
    del st
    # no single PyTorch call runs the rounds: library_ms is null
    results["table_residue"] = dict(max_abs_err=worst, library_ms=None,
                                    extra=extra, **timing)


def wide_sorted(n: int, n_keys: int, g: torch.Generator,
                hi: int = 1 << 30) -> list:
    """n rows of n_keys int32 key words, ascending (unsigned): the first
    word below hi, the middle ones 0 or 1 and the last random, so equal
    prefixes are common and the last word decides."""
    words = [torch.randint(0, hi, (n,), device=DEV, generator=g)]
    words += [torch.randint(0, 2, (n,), device=DEV, generator=g)
              for _ in range(n_keys - 2)]
    words += [torch.randint(0, 1 << 32, (n,), device=DEV, generator=g)]
    words = [(w - (w >= 1 << 31).long() * (1 << 32)).to(torch.int32)
             for w in words]
    perm = lexsort_perm(words)
    return [w[perm] for w in words]


def wide_dedupe_run(n: int, n_keys: int, n_invalid: int, inv_min: int,
                    g: torch.Generator, unique: bool) -> tuple:
    """A sorted (key words, int64 count) run of n rows on the card whose
    last rows (at least n_invalid) are the invalid constant with count 0;
    unique: no repeated valid key, as in a store."""
    keys = wide_sorted(n - n_invalid, n_keys, g)
    if unique:
        first = torch.zeros(keys[0].numel(), dtype=torch.bool, device=DEV)
        first[0] = True
        for w in keys:
            first[1:] |= w[1:] != w[:-1]
        keys = [w[first] for w in keys]
    n_valid = keys[0].numel()
    keys = [torch.cat([w, w.new_full((n - n_valid,),
                                     inv_min if c == 0 else 0)])
            for c, w in enumerate(keys)]
    cnt = torch.randint(1, 1 << 40, (n,), device=DEV, generator=g)
    cnt[n_valid:] = 0
    return tuple(keys) + (cnt,)


def check_wide_kernels(results: dict) -> None:
    """Kernels 1-3 at the widths that only wide keys use, each against its
    plain version (exact) at the shapes the wide counts give it, and timed
    beside its bytes bound; the times go to the kernels' kernel_time lines
    as extras, named with their key words and rows."""
    g = torch.Generator(device=DEV)
    g.manual_seed(256)
    # kernel 2: the merge tree of two 2^24-position batches (batch_words
    # 2^20) at 8 (k=127), 9 and 17 (k=256) key words, int32 payload
    r2 = results["merge_sorted"]
    size = 1 << 24
    for n_keys in (8, 9, 17):
        a = tuple(wide_sorted(size, n_keys, g)) + (
            torch.arange(size, dtype=torch.int32, device=DEV),)
        b = tuple(wide_sorted(size, n_keys, g)) + (
            torch.arange(size, 2 * size, dtype=torch.int32, device=DEV),)
        err = max_err(merge_sorted(a, b, n_keys=n_keys),
                      merge_sorted_plain(a, b, n_keys=n_keys))
        phase("kernel", name="merge_sorted", case=f"n_keys{n_keys}_ties",
              rows=2 * size, n_keys=n_keys, max_abs_err=err)
        r2["max_abs_err"] = max(r2["max_abs_err"], err)
        tag = f"n_keys{n_keys}_rows2^25"
        r2["extra"][f"ms_{tag}"] = cuda_ms(
            lambda: merge_sorted(a, b, n_keys=n_keys))
        r2["extra"][f"bound_ms_{tag}"] = bytes_ms(
            2 * (2 * size) * (4 * n_keys + 4))
        del a, b
        torch.cuda.empty_cache()
    # kernel 3: the k=14 store merge (a 2^26-row store run, a quarter of it
    # invalid, + a 2^25-row batch run) at 3, 5, 8, 9 and 17 key words, and
    # the wide counts' store merge (l=25: a 2^25-row store + the 2^25 rows
    # of two merged batches) at 8 (k=127) and 17 (k=256)
    inv_min = 1 << 30
    r3 = results["merge_dedupe_sorted"]
    r3.setdefault("extra", {})
    cases = [(n_keys, 26, "") for n_keys in (3, 5, 8, 9, 17)]
    cases += [(n_keys, 25, "_rows2^25+2^25") for n_keys in (8, 17)]
    for n_keys, log_m, suffix in cases:
        m, n = 1 << log_m, 1 << 25
        a = wide_dedupe_run(m, n_keys, m >> 2, inv_min, g, unique=True)
        b = wide_dedupe_run(n, n_keys, n >> 5, inv_min, g, unique=False)
        got, g_runs, g_valid = merge_dedupe_sorted(a, b, n_keys, inv_min)
        want, w_runs, w_valid = merge_dedupe_sorted_plain(a, b, n_keys,
                                                          inv_min)
        runs = int(w_runs)
        if (int(g_runs), int(g_valid)) != (runs, int(w_valid)):
            raise AssertionError(f"merge_dedupe n_keys={n_keys}: runs/valid "
                                 f"{int(g_runs)}/{int(g_valid)} != "
                                 f"{runs}/{int(w_valid)}")
        err = max_err(got, want, runs)
        phase("kernel", name="merge_dedupe_sorted",
              case="store_merge" + suffix, rows=m + n, n_keys=n_keys,
              runs=runs, max_abs_err=err)
        r3["max_abs_err"] = max(r3["max_abs_err"], err)
        del got, want
        tag = f"n_keys{n_keys}{suffix}"
        r3["extra"][f"ms_{tag}"] = cuda_ms(
            lambda: merge_dedupe_sorted(a, b, n_keys, inv_min))
        r3["extra"][f"plain_ms_{tag}"] = cuda_ms(
            lambda: merge_dedupe_sorted_plain(a, b, n_keys, inv_min))
        # key words and count of every input row read, of every run written
        r3["extra"][f"bound_ms_{tag}"] = bytes_ms(
            (m + n + runs) * (4 * n_keys + 8))
        del a, b
        torch.cuda.empty_cache()
    # kernel 1: the k=256 dedupe's 17 key operands and the position column
    n = 1 << 24
    flag = torch.rand(n, device=DEV, generator=g) < 0.5
    cols = tuple(torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                               device=DEV, generator=g)
                 for _ in range(17)) + (
        torch.arange(n, dtype=torch.int32, device=DEV),)
    rows = int(flag.sum())
    err = max_err(compact_flagged(flag, cols),
                  compact_flagged_plain(flag, cols), rows)
    phase("kernel", name="compact_flagged", case="18_columns", rows=n,
          flagged=rows, max_abs_err=err)
    r1 = results["compact_flagged"]
    r1["max_abs_err"] = max(r1["max_abs_err"], err)
    r1["extra"]["ms_18_columns"] = cuda_ms(
        lambda: compact_flagged(flag, cols))
    r1["extra"]["bound_ms_18_columns"] = bytes_ms(n + 18 * 4 * (n + rows))


def host_lanes(path: Path, k: int) -> np.ndarray:
    """Every valid k-mer window of the FASTQ as uint32 lanes [n, lanes]
    (base i at bits 2i of the 2k-bit key, lsb lane first; A=0 C=1 G=2
    T=3), windows with a non-ACGT base skipped.  Numpy only."""
    lut = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
        lut[ord(chr(ch).lower())] = i
    sep = np.full(16, 255, np.uint8)  # no window crosses a read
    parts = []
    with open(path, "rb") as f:
        for ln, line in enumerate(f):
            if ln % 4 == 1:
                parts += [lut[np.frombuffer(line.rstrip(b"\r\n"),
                                            np.uint8)], sep]
    codes = np.concatenate(parts)
    n = codes.size
    bad = np.concatenate([[0], np.cumsum(codes == 255, dtype=np.int64)])
    pos = np.nonzero(bad[k:] - bad[: n - k + 1] == 0)[0]
    # w16[i]: the 16 bases from i as one word
    v = (codes & 3).astype(np.uint32)
    w16 = np.zeros(n - 15, np.uint32)
    for t in range(16):
        w16 |= v[t : n - 15 + t] << np.uint32(2 * t)
    spec = KmerSpec(k)
    keys = np.stack([w16[pos + 16 * j] for j in range(spec.lanes)], axis=1)
    keys[:, -1] &= np.uint32(spec.top_lane_mask)
    return keys


def fingerprint(keys: np.ndarray) -> np.ndarray:
    """A 64-bit multiply-xorshift fold of each key's lanes: an order in
    which to compare two key sets (equal fingerprints are then checked key
    by key)."""
    h = np.zeros(keys.shape[0], np.uint64)
    for j in range(keys.shape[1]):
        h = (h ^ keys[:, j].astype(np.uint64)) * np.uint64(
            0x9E3779B97F4A7C15)
        h ^= h >> np.uint64(29)
    return h


def host_count_lanes(path: Path, k: int) -> tuple:
    """Independent numpy count of multi-lane keys: (distinct keys,
    counts, fingerprints), in fingerprint order."""
    keys = host_lanes(path, k)
    fp = fingerprint(keys)
    order = np.argsort(fp, kind="stable")
    fp, keys = fp[order], keys[order]
    new = np.ones(fp.size, bool)
    new[1:] = fp[1:] != fp[:-1]
    tie = ~new[1:]
    if (keys[1:][tie] != keys[:-1][tie]).any():
        raise AssertionError(f"k={k}: host fingerprints collide")
    starts = np.nonzero(new)[0]
    return keys[starts], np.diff(np.append(starts, fp.size)), fp[starts]


def check_wide_export(counter: KmerCounter, want: tuple, tag: str) -> None:
    """The counter's full export (keys mapped back on the card) equals the
    numpy count, key by key and count by count."""
    check_wide_arrays(*export_lanes(counter), want, tag)


def check_wide_arrays(keys: np.ndarray, counts: np.ndarray, want: tuple,
                      tag: str) -> None:
    fp = fingerprint(keys)
    order = np.argsort(fp, kind="stable")
    if not (fp.size == want[2].size
            and np.array_equal(fp[order], want[2])
            and np.array_equal(keys[order], want[0])
            and np.array_equal(counts[order], want[1])):
        raise AssertionError(f"{tag}: export differs from the numpy count")


def traced(fn):
    """fn() under torch.profiler (host and card): the finished trace,
    which must hold device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if device_busy_us(prof) <= 0:
        raise AssertionError("the trace holds no device activity")
    return prof


def device_busy_ms(fn) -> float:
    """The card's busy time over fn() (ms): the union of the CUDA kernel and
    copy intervals of a torch.profiler trace, whatever the host did."""
    return device_busy_us(traced(fn)) / 1e3


def wide_end_to_end(path: Path) -> tuple[dict, tuple]:
    """The sort backend at k = 31, 63, 127 and 256 against numpy counts,
    and k=127 without the lane mix; cold and warm walls of both k=127
    counts.  Returns the launches summed over the cold counts (each read
    from counts zeroed just before it) and the numpy count at k=31 (keys,
    counts), which phase 7 folds to canonical, and phase 8 reuses at
    k=127: the numpy counts by k."""
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    wants = {}
    for k, hash_first in WIDE_RUNS:
        t0 = time.perf_counter()
        if k not in wants:
            wants[k] = host_count_lanes(path, k)
        want = wants[k]
        host_s = time.perf_counter() - t0
        counter = KmerCounter(k=k, l=WIDE_L, batch_words=1 << 20,
                              merge_every=4, hash_first=hash_first,
                              device="cuda")
        _build.reset_launch_counts()
        cold = timed_count(counter, path)
        run = _build.launch_counts()
        tag = f"k={k},hash_first={counter.hash_first}"
        total, distinct = counter.total_kmers, counter.distinct
        phase("e2e_wide", run=tag, cold_s=round(cold, 4),
              kmers_per_s=round(total / cold), total_kmers=total,
              distinct=distinct, operands=counter.store.n_ops,
              launches=run, host_count_s=round(host_s, 3))
        if (total, distinct) != (int(want[1].sum()), len(want[0])):
            raise AssertionError(f"{tag}: totals {total}/{distinct} != "
                                 f"{int(want[1].sum())}/{len(want[0])}")
        check_wide_export(counter, want, tag)
        for name in SORT_KERNELS + (("lane_mix",) if counter.hash_first
                                    else ()):
            if run[name] <= 0:
                raise AssertionError(f"{tag}: {name} not launched")
        if not counter.hash_first and run["lane_mix"]:
            raise AssertionError(f"{tag}: the lane mix ran")
        for name in launches:
            launches[name] += run[name]
        if k == 127:
            counter.reset()
            warm = timed_count(counter, path)
            check_wide_export(counter, want, tag + " warm")
            counter.reset()
            busy = device_busy_ms(lambda: counter.count_file(
                path, use_native=True))
            phase("e2e_wide", run=tag, warm_s=round(warm, 4),
                  kmers_per_s_warm=round(total / warm),
                  warm_device_busy_ms=round(busy, 3))
        del counter
    return launches, wants


# --- phase 7 ----------------------------------------------------------------

LSM_RUNS = (("lsm_growth8", dict(lsm=None)),       # the auto rule engages
            ("lsm_growth2", dict(lsm=None, lsm_growth=2)),
            ("flat", dict(lsm=False)))
ABSORB = "absorb_rows2^26+2^25"


def peak_checked(tag: str, fn, estimate):
    """fn() with the allocator's peak measured from just before it (so a
    counter that fn makes counts its state); estimate(fn's result) is the
    memory model's figure in MiB, which may not be below the peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    peak = torch.cuda.max_memory_allocated() - base
    est_mb = estimate(out)
    est_b = est_mb * 2**20
    phase("memory", run=tag, estimate_mb=round(est_mb, 1),
          peak_mb=round(peak / 2**20, 1), base_mb=round(base / 2**20, 1),
          estimate_over_peak=round(est_b / peak, 3))
    if est_b < peak:
        raise AssertionError(f"{tag}: memory estimate {est_mb:.1f} MB "
                             f"below the measured peak {peak / 2**20:.1f}")
    return out


def made_and_counted(path: Path, **kw) -> tuple:
    """(a new counter on the card, its cold count's wall seconds)."""
    c = KmerCounter(device="cuda", **kw)
    return c, timed_count(c, path)


def counter_estimate(made: tuple) -> float:
    return estimate_for(made[0]).total_mb


def check_export(counter: KmerCounter, want: tuple, tag: str) -> None:
    got = export(counter)
    if not all(np.array_equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"{tag}: export differs from the numpy count")


def require_kernels(run: dict, names, tag: str) -> None:
    for name in names:
        if run[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} not launched")


def lsm_counts(path: Path, want: tuple, results: dict) -> dict:
    """k=14, l=26, batch_words 2^16, merge_every 4 (the counter's
    defaults): the LSM store by the auto rule at growth 8 (levels 2^25,
    2^26) and 2 (2^23 .. 2^26, cascades during the count), and the flat
    store; each export against the numpy count, cold, warm and busy times.
    Then kernel 3 at the absorb shape on the growth-8 count's own levels.
    Returns the growth-8 cold count's launches (its collapse included)."""
    out = {}
    for tag, kw in LSM_RUNS:
        _build.reset_launch_counts()
        c, cold = peak_checked(
            f"{tag},cold", lambda: made_and_counted(
                path, k=K, l=26, batch_words=1 << 16, merge_every=4, **kw),
            counter_estimate)
        if c.lsm != (kw["lsm"] is None):
            raise AssertionError(f"{tag}: lsm={c.lsm}")
        levels = c.state if c.lsm else [c.state]
        rows = [int(st.n) for st in levels]
        l0 = levels[0] if tag == "lsm_growth8" else None  # pre-collapse
        c.distinct  # the collapse: part of the path
        launches = _build.launch_counts()
        require_kernels(launches, SORT_KERNELS, tag)
        check_export(c, want, tag)
        absorbs = c.store.absorbs if c.lsm else 0
        if l0 is not None:
            out = launches
            check_absorb(results, c.state[-1], l0, launches)
        c.reset()
        warm = timed_count(c, path)
        c.reset()
        busy = device_busy_ms(lambda: c.count_file(path, use_native=True))
        phase("e2e_lsm", run=tag, lsm=c.lsm,
              levels=[lv.capacity for lv in c.store.levels] if c.lsm
              else [c.store.capacity],
              level_rows_after_count=rows, absorbs_cold=absorbs,
              batches=c.batches_processed, cold_s=round(cold, 4),
              warm_s=round(warm, 4), warm_device_busy_ms=round(busy, 3),
              launches=launches)
        del c, levels, l0
    return out


def check_absorb(results: dict, top, l0, launches: dict) -> None:
    """Kernel 3 at the LSM absorb's shape: the collapsed 2^26-row top level
    and the 2^25-row L0 that held the whole count before the collapse (so
    every key meets its twin), exact against its plain version."""
    a = tuple(top.keys.unbind(0)) + (top.counts,)
    b = tuple(l0.keys.unbind(0)) + (l0.counts,)
    got, g_runs, g_valid = merge_dedupe_sorted(a, b, 1, INV14)
    want, w_runs, w_valid = merge_dedupe_sorted_plain(a, b, 1, INV14)
    runs = int(w_runs)
    if (int(g_runs), int(g_valid)) != (runs, int(w_valid)):
        raise AssertionError(f"absorb: runs/valid {int(g_runs)}/"
                             f"{int(g_valid)} != {runs}/{int(w_valid)}")
    err = max_err(got, want, runs)
    del got, want
    m, n = a[0].numel(), b[0].numel()
    phase("kernel", name="merge_dedupe_sorted", case="lsm_absorb",
          rows=m + n, store_rows=(int(top.n), int(l0.n)), runs=runs,
          max_abs_err=err)
    r3 = results["merge_dedupe_sorted"]
    r3["max_abs_err"] = max(r3["max_abs_err"], err)
    r3["extra"][f"ms_{ABSORB}"] = cuda_ms(
        lambda: merge_dedupe_sorted(a, b, 1, INV14))
    r3["extra"][f"plain_ms_{ABSORB}"] = cuda_ms(
        lambda: merge_dedupe_sorted_plain(a, b, 1, INV14))
    # (int32 key, int64 count) of every input row read, of every run written
    r3["extra"][f"bound_ms_{ABSORB}"] = bytes_ms((m + n + runs) * 12)
    r3["extra"]["launches_lsm_path"] = launches["merge_dedupe_sorted"]


def np_revcomp(keys: np.ndarray, k: int) -> np.ndarray:
    """Reverse complements of k <= 32 keys (uint64, base i at bits 2i):
    complement by NOT, reverse the 2-bit groups of the 64-bit word, shift
    the key down.  Numpy only."""
    x = ~keys.astype(np.uint64)
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        m, sh = np.uint64(m), np.uint64(sh)
        x = ((x & m) << sh) | ((x >> sh) & m)
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    return x >> np.uint64(64 - 2 * k)


def canonical_host(keys: np.ndarray, counts: np.ndarray, k: int) -> tuple:
    """A numpy count's canonical counts: min(key, revcomp), summed."""
    u = keys.astype(np.uint64)
    canon = np.minimum(u, np_revcomp(u, k))
    uniq, inv = np.unique(canon, return_inverse=True)
    return uniq.astype(np.int64), np.bincount(
        inv, weights=counts, minlength=len(uniq)).astype(np.int64)


def canonical_counts(path: Path, want14: tuple, want31: tuple) -> dict:
    """Canonical counting on the sort backend at k=31 (l=25) and on the
    table at k=14 (l=26), each export against a numpy canonical count
    (from phase 4's and phase 6's numpy counts), cold and warm walls
    beside the plain count's; returns the launches of both canonical cold
    counts."""
    lanes31 = want31[0].astype(np.uint64)
    keys31 = lanes31[:, 0] | (lanes31[:, 1] << np.uint64(32))
    cases = (("sort", 31, 25, canonical_host(keys31, want31[1], 31),
              SORT_KERNELS),
             ("table", 14, 26, canonical_host(*want14, 14), TABLE_KERNELS))
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    for backend, k, l, want, names in cases:
        walls = {}
        for canonical in (True, False):
            _build.reset_launch_counts()
            kw = dict(k=k, l=l, backend=backend, batch_words=1 << 20,
                      canonical=canonical)
            if canonical:
                c, cold = peak_checked(
                    f"canonical,{backend},k={k}",
                    lambda: made_and_counted(path, **kw), counter_estimate)
                run = _build.launch_counts()
                require_kernels(run, names, f"canonical {backend}")
                for name in run:
                    launches[name] += run[name]
                check_export(c, want, f"canonical {backend} k={k}")
            else:
                c, cold = made_and_counted(path, **kw)
            c.reset()
            walls[canonical] = (cold, timed_count(c, path))
            del c
        phase("e2e_canonical", backend=backend, k=k, l=l,
              distinct=len(want[0]), total=int(want[1].sum()),
              canonical_cold_s=round(walls[True][0], 4),
              canonical_warm_s=round(walls[True][1], 4),
              plain_cold_s=round(walls[False][0], 4),
              plain_warm_s=round(walls[False][1], 4))
    return launches


def split_fastq(path: Path) -> tuple[Path, Path]:
    """The FASTQ's first and second halves of reads as two files."""
    lines = path.read_bytes().splitlines(keepends=True)
    half = len(lines) // 8 * 4
    parts = (path.with_suffix(".half1.fastq"),
             path.with_suffix(".half2.fastq"))
    for part, chunk in zip(parts, (lines[:half], lines[half:])):
        part.write_bytes(b"".join(chunk))
    return parts


def split_runs(path: Path, want: tuple) -> dict:
    """Count the first half of the reads, save_counter, load_counter on the
    card, count the second half: the export equals the whole-file count,
    on the sort backend with the LSM store and on the table."""
    halves = split_fastq(path)
    ckpt = _build.BUILD_DIR / "split.npz"
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    for backend, bw in (("sort", 1 << 16), ("table", 1 << 20)):
        c = KmerCounter(k=K, l=26, backend=backend, batch_words=bw,
                        device="cuda")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        c.count_file(halves[0], use_native=True)
        t1 = time.perf_counter()
        save_counter(c, ckpt)
        t2 = time.perf_counter()
        del c
        c = load_counter(ckpt, batch_words=bw, device="cuda")
        t3 = time.perf_counter()
        c.count_file(halves[1], use_native=True)
        run = _build.launch_counts()
        require_kernels(run, SORT_KERNELS if backend == "sort"
                        else TABLE_KERNELS, f"split {backend}")
        for name in run:
            launches[name] += run[name]
        check_export(c, want, f"split-run {backend}")
        if c.total_kmers != TOTAL_KMERS:
            raise AssertionError(f"split-run {backend}: total {c.total_kmers}")
        phase("e2e_split_run", backend=backend, lsm=c.lsm,
              first_half_s=round(t1 - t0, 4), save_s=round(t2 - t1, 4),
              load_s=round(t3 - t2, 4),
              file_mb=round(ckpt.stat().st_size / 2**20, 1),
              total_kmers=c.total_kmers, distinct=c.distinct)
        del c
        ckpt.unlink()
    for part in halves:
        part.unlink()
    return launches


def golden_text(keys: np.ndarray, counts: np.ndarray, k: int) -> str:
    """A numpy count as `kmer\tcount` lines sorted by k-mer string: the
    form of the CLI's --dump (write_golden with sort=True)."""
    codes = (keys[:, None] >> (2 * np.arange(k))) & 3
    kmers = np.frombuffer(b"ACGT", np.uint8)[codes].view(f"S{k}").ravel()
    order = np.argsort(kmers, kind="stable")
    return "".join(f"{m}\t{c}\n" for m, c in zip(
        kmers[order].astype(f"U{k}").tolist(), counts[order].tolist()))


def cli_runs(path: Path, want: tuple) -> dict:
    """The command line: in process at its defaults on the bench FASTQ
    with --stats-json --save-state (totals, the memory estimate against the
    peak; 8c: its default --shards 1 is the sharded counter, so the line
    carries the sharded keys and the file n_shards 1, and the file loads
    back to the numpy count); one `python -m tsxcount_tpu_torch count`
    process on the small file with --dump --check (exit 0, the dump byte
    for byte the golden file); --checkabort against a one-line golden
    file whose count is off by one (exit 200) and a too-small --l (exit
    42), in process.  Returns the in-process default run's launches."""
    ckpt = _build.BUILD_DIR / "cli.npz"
    out = io.StringIO()
    _build.reset_launch_counts()

    def run():
        with contextlib.redirect_stdout(out):
            return cli.main(["count", "--input", str(path), "--stats-json",
                             "--save-state", str(ckpt)])

    def cli_estimate(_rc) -> float:
        # the estimate of the counter the CLI built, from its stats line
        return json.loads(out.getvalue().strip().splitlines()[-1])[
            "memory_estimate_mb"]

    rc = peak_checked("cli,defaults", run, cli_estimate)
    launches = _build.launch_counts()
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    phase("cli", run="defaults", rc=rc, total_kmers=stats["total_kmers"],
          distinct=stats["distinct_kmers"], lsm=stats["lsm"],
          wall_s=stats["wall_seconds"],
          kmers_per_s=stats["kmers_per_second"],
          state_mb=round(ckpt.stat().st_size / 2**20, 1), launches=launches)
    if rc != 0 or (stats["total_kmers"], stats["distinct_kmers"]) != (
            TOTAL_KMERS, DISTINCT_KMERS):
        raise AssertionError(f"cli defaults: rc {rc}, totals "
                             f"{stats['total_kmers']}/"
                             f"{stats['distinct_kmers']}")
    require_kernels(launches, SORT_KERNELS, "cli")
    sharded_keys = {"n_shards", "shard_distinct", "shard_imbalance",
                    "spill_recovered"}
    with np.load(ckpt) as data:
        saved_shards = json.loads(str(data["meta"]))["n_shards"]
    if not sharded_keys <= set(stats) or (stats["n_shards"],
                                          saved_shards) != (1, 1):
        raise AssertionError(f"8c: stats keys {sorted(stats)}, n_shards "
                             f"{stats.get('n_shards')}, saved {saved_shards}")
    loaded = load_counter(ckpt, batch_words=1 << 20, device="cuda")
    check_sharded(loaded, want, "8c load")
    phase("cli", run="8c sharded keys and state", n_shards=saved_shards,
          shard_distinct=stats["shard_distinct"],
          spill_recovered=stats["spill_recovered"],
          loaded=type(loaded).__name__)
    del loaded
    ckpt.unlink()

    small = _build.BUILD_DIR / "small.2000.fastq"
    bench.ensure_synth_fastq(small, 2000, seed=7)
    golden = golden_text(*host_count(small, K), K)
    Path(f"{small}.{K}.count").write_text(golden)
    dump = _build.BUILD_DIR / "small.dump.count"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tsxcount_tpu_torch", "count", "--input",
         str(small), "--dump", str(dump), "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    check_line = [ln for ln in proc.stderr.splitlines()
                  if ln.startswith("check:")]
    phase("cli", run="subprocess --dump --check", rc=proc.returncode,
          seconds=round(time.perf_counter() - t0, 3),
          check=repr(check_line[-1] if check_line else None))
    if proc.returncode != 0 or dump.read_text() != golden:
        raise AssertionError(f"cli subprocess: rc {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    kmer, count = golden.split("\n", 1)[0].split("\t")
    bad_path = _build.BUILD_DIR / "small.bad.count"
    bad_path.write_text(f"{kmer}\t{int(count) + 1}\n")  # off by one
    for tag, argv, want_rc in (
            ("checkabort", ["--checkabort", "--golden", str(bad_path)], 200),
            ("l=16", ["--l", "16"], 42)):
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["count", "--input", str(small), *argv])
        phase("cli", run=tag, rc=rc)
        if rc != want_rc:
            raise AssertionError(f"cli {tag}: exit {rc}, not {want_rc}")
    for f in (dump, bad_path):
        f.unlink()
    return launches


def user_surface(path: Path, want: tuple, want31: tuple,
                 results: dict) -> tuple:
    """Phase 7.  Returns (the LSM count's launches, the other counts'
    launches summed)."""
    lsm = lsm_counts(path, want, results)
    user = dict.fromkeys(_build.LAUNCHES, 0)
    for run in (canonical_counts(path, want, want31), split_runs(path, want),
                cli_runs(path, want)):
        for name in user:
            user[name] += run[name]
    return lsm, user


# --- phase 8 ----------------------------------------------------------------

def auto_batch_words(path: Path, k: int) -> int:
    """bench.py's auto_batch_words rule on the port's native reader: a
    prepass counts the packed words, then batches of about
    bench.TARGET_BATCH_WORDS words divide them evenly, rounded up to
    4096 words with 0.4 % slack."""
    batch = BatchSpec(KmerSpec(k), bench.TARGET_BATCH_WORDS, 384)
    reader = native.NativeFileReader(path, batch)
    for _ in reader:
        pass
    words = reader.stats.packed_words
    n = max(1, round(words / bench.TARGET_BATCH_WORDS))
    return -(-int(words * 1.004) // (n * 4096)) * 4096


def sharded_8a_shape(path: Path) -> tuple[int, int]:
    """(batch words, route_cap) of phase 8a: bench.py's auto batch words
    and the routing capacity at one shard, capacity_factor 1.5."""
    bw = auto_batch_words(path, K)
    positions = BatchSpec(KmerSpec(K), bw).positions
    return bw, route_capacity(positions, 1, 1.5)[0]


def sharded_arrays(c) -> tuple[np.ndarray, np.ndarray]:
    """Every shard's (keys uint32 [n, lanes] mapped back through the mix
    on the card, counts int64), gathered to every rank: a collective."""
    c.distinct  # folds pending runs, collapses an LSM
    keys, counts = c._shard_export()
    keys = torch.cat(c._gather_rows(keys))
    counts = torch.cat(c._gather_rows(counts))
    if c.hashed_store and keys.shape[0]:
        keys = c.route_map.inv_apply(keys)
    return keys.cpu().numpy().view(np.uint32), counts.cpu().numpy()


def flat_export(keys: np.ndarray, counts: np.ndarray) -> tuple:
    """(int64 keys ascending, counts) of k <= 32 keys."""
    keys = keys.astype(np.int64)
    flat = keys[:, 0] | (keys[:, 1] << 32 if keys.shape[1] > 1 else 0)
    order = np.argsort(flat, kind="stable")
    return flat[order], np.asarray(counts, np.int64)[order]


def check_sharded(c, want: tuple, tag: str) -> None:
    total, distinct = c.total_kmers, c.distinct
    if (total, distinct) != (int(want[1].sum()), len(want[0])):
        raise AssertionError(f"{tag}: totals {total}/{distinct}")
    got = flat_export(*sharded_arrays(c))
    if not all(np.array_equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"{tag}: export differs from the numpy count")


def made_sharded(path: Path, **kw) -> tuple:
    """(a new one-shard counter on the card, its cold count's seconds)."""
    c = ShardedKmerCounter(n_shards=1, device="cuda", **kw)
    return c, timed_count(c, path)


def sharded_counts(path: Path, want: tuple, want127: tuple) -> dict:
    """Phase 8.  8a: the reference's main path, ShardedKmerCounter at one
    shard (no process group) at bench.py's sharded defaults (k=14,
    l=24, merge_every 2, capacity_factor 1.5, its auto batch words):
    totals, export and queries against the numpy count, cold and warm
    walls and the card's busy time beside the plain KmerCounter at the
    same geometry, launches, the memory estimate against the peak; one
    more count on a one-rank NCCL group.  8b:
    the table at k=14, l=26 and the sort backend at k=127 (the mix and
    the prefix sort), at one shard, each export against its numpy count,
    the card's busy time beside the plain counter's.
    8d: two ranks on the one card over gloo.  Returns the launches of the
    one-shard counts (8a, 8b), each read from counts zeroed just before
    it."""
    bw, route_cap = sharded_8a_shape(path)
    geo = dict(k=K, l=24, merge_every=2, batch_words=bw)
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    _build.reset_launch_counts()
    c, cold = peak_checked("sharded_8a,cold", lambda: made_sharded(
        path, capacity_factor=1.5, **geo), counter_estimate)
    run = _build.launch_counts()
    require_kernels(run, SORT_KERNELS, "8a")
    check_sharded(c, want, "8a")
    check_queries(c, *want)
    st = c.stats()
    if (st["n_shards"], st["spill_recovered"], c.group.backend,
            c.route_cap) != (1, 0, None, route_cap):
        raise AssertionError(f"8a: stats {st}, group {c.group}, route_cap "
                             f"{c.route_cap} (phase 3 held {route_cap})")
    c.reset()
    warm = timed_count(c, path)
    check_sharded(c, want, "8a warm")
    c.reset()
    busy = device_busy_ms(lambda: c.count_file(path, use_native=True))
    phase("e2e_sharded", run="8a", batch_words=bw,
          batches=c.batches_processed, route_cap=c.route_cap,
          carry=c._carry_enabled, lsm=c.lsm, cold_s=round(cold, 4),
          warm_s=round(warm, 4), kmers_per_s_warm=round(TOTAL_KMERS / warm),
          warm_device_busy_ms=round(busy, 3), launches=run)
    for name in launches:
        launches[name] += run[name]
    del c
    # the same count with its collectives through a one-rank NCCL group
    t0 = time.perf_counter()
    torch.distributed.init_process_group(
        "nccl", store=torch.distributed.HashStore(), rank=0, world_size=1)
    try:
        _build.reset_launch_counts()
        c, cold = made_sharded(path, capacity_factor=1.5, **geo)
        run = _build.launch_counts()
        require_kernels(run, SORT_KERNELS, "8a nccl")
        if c.group.backend != "nccl":
            raise AssertionError(f"8a nccl: group {c.group}")
        check_sharded(c, want, "8a nccl")
        for name in launches:
            launches[name] += run[name]
        del c
    finally:
        torch.distributed.destroy_process_group()
    phase("e2e_sharded", run="8a on a one-rank NCCL group",
          cold_s=round(cold, 4),
          with_group_setup_s=round(time.perf_counter() - t0, 4))
    p = KmerCounter(device="cuda", **geo)
    p_cold = timed_count(p, path)
    p.reset()
    p_warm = timed_count(p, path)
    p.reset()
    p_busy = device_busy_ms(lambda: p.count_file(path, use_native=True))
    check_export(p, want, "8a plain")
    phase("e2e_sharded", run="8a plain KmerCounter, same geometry",
          cold_s=round(p_cold, 4), warm_s=round(p_warm, 4),
          kmers_per_s_warm=round(TOTAL_KMERS / p_warm),
          warm_device_busy_ms=round(p_busy, 3))
    del p

    for tag, kw, need in (
            ("8b table k=14 l=26", dict(k=K, l=26, backend="table"),
             TABLE_KERNELS + ("lane_mix",)),
            ("8b sort k=127 l=25", dict(k=127, l=WIDE_L),
             SORT_KERNELS + ("lane_mix",))):
        _build.reset_launch_counts()
        c, cold = made_sharded(path, batch_words=1 << 20, **kw)
        run = _build.launch_counts()
        require_kernels(run, need, tag)
        if kw["k"] == K:
            check_sharded(c, want, tag)
        else:
            check_wide_arrays(*sharded_arrays(c), want127, tag)
        c.reset()
        busy = device_busy_ms(lambda: c.count_file(path, use_native=True))
        phase("e2e_sharded", run=tag, cold_s=round(cold, 4),
              hashed_store=c.hashed_store, distinct=c.distinct,
              warm_device_busy_ms=round(busy, 3), launches=run)
        for name in launches:
            launches[name] += run[name]
        del c
        p = KmerCounter(device="cuda", batch_words=1 << 20, **kw)
        p.count_file(path, use_native=True)
        p.reset()
        p_busy = device_busy_ms(lambda: p.count_file(path, use_native=True))
        phase("e2e_sharded", run=tag + " plain KmerCounter",
              warm_device_busy_ms=round(p_busy, 3))
        del p
    two_ranks_on_one_card(path, want)
    return launches


RANKS_8D = 2
RANK_TIMEOUT_S = 300


def rank_8d(rank: int, init: str, path: str, out: str,
            routing: str = "mix") -> None:
    """One of 8d's (9d's) ranks (a process of its own): sort and table at
    k=14, l=26, 2^20-word batches, routed through `routing`, each rank
    its byte range of the file, on cuda:0 over gloo; rank 0 writes the
    gathered exports."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=RANKS_8D)
    res = {}
    for backend in ("sort", "table"):
        _build.reset_launch_counts()
        c = ShardedKmerCounter(k=K, n_shards=RANKS_8D, l=26, backend=backend,
                               batch_words=1 << 20, device="cuda:0",
                               dist_backend="gloo", routing_hash=routing)
        res[f"{backend}/seconds"] = timed_count(c, Path(path))
        res[f"{backend}/launches"] = json.dumps(_build.launch_counts())
        res[f"{backend}/keys"], res[f"{backend}/counts"] = flat_export(
            *sharded_arrays(c))
        res[f"{backend}/shard_distinct"] = c.stats()["shard_distinct"]
        del c
        torch.cuda.empty_cache()
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()


def two_ranks_on_one_card(path: Path, want: tuple, routing: str = "mix",
                          tag: str = "8d") -> None:
    """8d (9d: routing "gf2"): RANKS_8D processes on the one card, the
    CUDA tensors of the exchange staged through the host by gloo; exports
    against the numpy count."""
    tmp = _build.BUILD_DIR / f"ranks{tag}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    out = tmp / "rank0.npz"
    code = ("import sys, chip_smoke; chip_smoke.rank_8d(int(sys.argv[1]), "
            "sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5])")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), f"file://{tmp}/pg", str(path),
         str(out), routing], cwd=REPO) for r in range(RANKS_8D)]
    try:
        codes = [p.wait(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise AssertionError(f"{tag}: rank exit codes {codes}")
    res = dict(np.load(out))
    for backend in ("sort", "table"):
        got = (res[f"{backend}/keys"], res[f"{backend}/counts"])
        if not all(np.array_equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{tag} {backend}: export differs from "
                                 f"the numpy count")
        phase("e2e_sharded", run=f"{tag} {backend}, {RANKS_8D} ranks gloo "
              f"cuda:0, routing {routing}",
              cold_s=round(float(res[f"{backend}/seconds"]), 4),
              shard_distinct=res[f"{backend}/shard_distinct"].tolist(),
              rank0_launches=str(res[f"{backend}/launches"]))
    phase("e2e_sharded", run=tag, seconds=round(time.perf_counter() - t0,
                                                3))


# --- phase 9 ----------------------------------------------------------------

GF2_RUNS = ((K, 26), (63, WIDE_L))   # 9a: (k, l) of hash_first="gf2"
MIX_PREFIX_KS = (31, 127, 224)       # 9b: mix_prefix=True at l=WIDE_L


def check_last(counter, want: tuple, tag: str) -> None:
    """Totals and the full export against a numpy count: host_count's
    (keys, counts) at k <= 32, else host_count_lanes' triple."""
    total, distinct = counter.total_kmers, counter.distinct
    if (total, distinct) != (int(want[1].sum()), len(want[0])):
        raise AssertionError(f"{tag}: totals {total}/{distinct}")
    if len(want) == 2:
        check_export(counter, want, tag)
    else:
        check_wide_export(counter, want, tag)


def op_device_ms(prof, name: str) -> float | None:
    """Device time (ms) of the kernels under op `name` in a finished
    torch.profiler trace, or None where the trace shows none."""
    for e in prof.key_averages():
        if e.key == name:
            t = getattr(e, "device_time_total", 0.0)
            return t / 1e3 if t > 0 else None
    return None


def beside_default(path: Path, want: tuple, tag: str, option: dict,
                   need, peak: bool, **geo) -> tuple:
    """A new option's cold count (its launches read from counts zeroed
    just before it; with `peak`, the memory estimate against the
    allocator's peak), export, warm wall and busy time; then the default
    path at the same geometry: cold, warm wall and busy time.  Returns
    (the option's launches, its counter, its busy count's trace)."""
    def make():
        return made_and_counted(path, **geo, **option)

    _build.reset_launch_counts()
    c, cold = peak_checked(tag, make, counter_estimate) if peak else make()
    run = _build.launch_counts()
    require_kernels(run, need, tag)
    check_last(c, want, tag)
    c.reset()
    warm = timed_count(c, path)
    c.reset()
    prof = traced(lambda: c.count_file(path, use_native=True))
    d, d_cold = made_and_counted(path, **geo)
    d.reset()
    d_warm = timed_count(d, path)
    d.reset()
    d_busy = device_busy_ms(lambda: d.count_file(path, use_native=True))
    phase("e2e_last", run=tag, operands=c.store.n_ops,
          batches=c.batches_processed, cold_s=round(cold, 4),
          warm_s=round(warm, 4), kmers_per_s_warm=round(c.total_kmers / warm),
          warm_device_busy_ms=round(device_busy_us(prof) / 1e3, 3),
          default_hash_first=d.hash_first, default_cold_s=round(d_cold, 4),
          default_warm_s=round(d_warm, 4),
          default_warm_device_busy_ms=round(d_busy, 3), launches=run)
    del d
    return run, c, prof


def check_mix_prefix_kernels(results: dict, c: KmerCounter) -> None:
    """Kernels 2 and 3 at a mix_prefix count's own widths and rows: kernel
    3 folds the count's 2^25-row store into a copy of itself (every key
    meets its twin), kernel 2 merges two sorted 2^24-row runs (one
    2^20-word batch's histogram each) of as many key words with an int32
    count; each exact against its plain version, timed beside its bound."""
    n_keys, k = c.store.n_ops, c.spec.k
    tag = f"mix_prefix_k{k}_n_keys{n_keys}"
    st = c.state
    a = tuple(st.keys.unbind(0)) + (st.counts,)
    got, g_runs, g_valid = merge_dedupe_sorted(a, a, n_keys, c.store.inv_min)
    want, w_runs, w_valid = merge_dedupe_sorted_plain(a, a, n_keys,
                                                      c.store.inv_min)
    runs = int(w_runs)
    if (int(g_runs), int(g_valid)) != (runs, int(w_valid)):
        raise AssertionError(f"{tag}: runs/valid {int(g_runs)}/"
                             f"{int(g_valid)} != {runs}/{int(w_valid)}")
    err3 = max_err(got, want, runs)
    del got, want
    m = a[0].numel()
    r3 = results["merge_dedupe_sorted"]
    r3["max_abs_err"] = max(r3["max_abs_err"], err3)
    r3["extra"][f"ms_{tag}"] = cuda_ms(
        lambda: merge_dedupe_sorted(a, a, n_keys, c.store.inv_min))
    r3["extra"][f"plain_ms_{tag}"] = cuda_ms(
        lambda: merge_dedupe_sorted_plain(a, a, n_keys, c.store.inv_min))
    r3["extra"][f"bound_ms_{tag}"] = bytes_ms((2 * m + runs)
                                              * (4 * n_keys + 8))
    del a
    g = torch.Generator(device=DEV)
    g.manual_seed(k)
    size = BatchSpec(c.spec, 1 << 20).positions
    # the flag operand is 0 on every valid row: the first word below 1
    a = tuple(wide_sorted(size, n_keys, g, hi=1)) + (
        torch.randint(1, 1 << 20, (size,), dtype=torch.int32, device=DEV,
                      generator=g),)
    b = tuple(wide_sorted(size, n_keys, g, hi=1)) + (a[-1].flip(0),)
    err2 = max_err(merge_sorted(a, b, n_keys=n_keys),
                   merge_sorted_plain(a, b, n_keys=n_keys))
    r2 = results["merge_sorted"]
    r2["max_abs_err"] = max(r2["max_abs_err"], err2)
    r2["extra"][f"ms_{tag}"] = cuda_ms(
        lambda: merge_sorted(a, b, n_keys=n_keys))
    r2["extra"][f"plain_ms_{tag}"] = cuda_ms(
        lambda: merge_sorted_plain(a, b, n_keys=n_keys))
    r2["extra"][f"bound_ms_{tag}"] = bytes_ms(2 * (2 * size)
                                              * (4 * n_keys + 4))
    phase("kernel", name="merge_dedupe_sorted", case=tag, rows=2 * m,
          runs=runs, max_abs_err=err3)
    phase("kernel", name="merge_sorted", case=tag, rows=2 * size,
          max_abs_err=err2)
    del a, b
    torch.cuda.empty_cache()


def gf2_and_mix_times(gf2_fns: dict) -> None:
    """The GF(2) product of one 2^20-word batch's keys (9a's k, its
    unpack, matmul and pack) and the mix columns of one batch at 9b's k,
    event-timed on seeded keys; the mix columns equal the CPU's on a
    slice and stand beside their bytes bound (each lane read, two columns
    written)."""
    g = torch.Generator(device=DEV)
    g.manual_seed(9)
    for k, hash_fn in gf2_fns.items():
        spec = KmerSpec(k)
        p = BatchSpec(spec, 1 << 20).positions
        keys = torch.randint(-2**31, 2**31, (p, spec.lanes),
                             dtype=torch.int32, device=DEV, generator=g)
        keys[:, -1] &= spec.top_lane_mask
        phase("gf2_product", k=k, rows=p, bits=spec.bits,
              ms=round(cuda_ms(lambda: hash_fn.apply(keys)), 4))
        del keys
    for k in MIX_PREFIX_KS:
        spec = KmerSpec(k)
        p = BatchSpec(spec, 1 << 20).positions
        cols = [torch.randint(-2**31, 2**31, (p,), dtype=torch.int32,
                              device=DEV, generator=g)
                for _ in range(spec.lanes)]
        head = 1 << 16  # the CPU's int64 arithmetic on a slice
        got = mix_cols(cols)
        want = mix_cols([col[:head].cpu() for col in cols])
        if not all(torch.equal(x[:head].cpu(), y)
                   for x, y in zip(got, want)):
            raise AssertionError(f"mix_cols k={k}: card != CPU")
        ms = cuda_ms(lambda: mix_cols(cols))
        bound = bytes_ms(p * (4 * spec.lanes + 8))
        phase("mix_cols", k=k, lanes=spec.lanes, rows=p, ms=round(ms, 4),
              bound_ms=round(bound, 4), card_equals_cpu_rows=head)
        del cols, got, want


def last_options(path: Path, want14: tuple, wants: dict,
                 results: dict) -> dict:
    """Phase 9.  Returns the launches of its new-option counts (each read
    from counts zeroed just before it; the default-path comparisons
    excluded)."""
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    clock = [time.perf_counter()]

    def add(run):
        for name in launches:
            launches[name] += run[name]

    def lap(part: str) -> None:  # each part's seconds
        t = time.perf_counter()
        phase("last_options", part=part, seconds=round(t - clock[0], 3))
        clock[0] = t

    # 9a: hash_first="gf2", beside the default path at the same k
    gf2_fns = {}
    for k, l in GF2_RUNS:
        tag = f"9a hash_first=gf2 k={k} l={l}"
        run, c, prof = beside_default(
            path, want14 if k == K else wants[k], tag,
            dict(hash_first="gf2"), SORT_KERNELS, peak=k != K, k=k, l=l,
            batch_words=1 << 20)
        if c.hash_first != "gf2" or run["lane_mix"]:
            raise AssertionError(f"{tag}: hash_first {c.hash_first}, "
                                 f"launches {run}")
        add(run)
        mm = op_device_ms(prof, "aten::mm")
        phase("gf2_product", run=tag, batches=c.batches_processed,
              aten_mm_ms_per_batch=(None if mm is None else
                                    round(mm / c.batches_processed, 4)))
        if k == K:
            check_queries(c, *want14)
        gf2_fns[k] = c.hash_fn
        del c, prof
    lap("9a")
    # 9c: the sharded counter at one shard, GF(2) routing
    for tag, kw, need in (
            ("9c sharded routing_hash=gf2 table k=14 l=26",
             dict(backend="table", routing_hash="gf2"), TABLE_KERNELS),
            ("9c sharded identity_hash sort k=14 l=26",
             dict(identity_hash=True), SORT_KERNELS)):
        _build.reset_launch_counts()
        c, cold = peak_checked(tag, lambda: made_sharded(
            path, k=K, l=26, batch_words=1 << 20, **kw), counter_estimate)
        run = _build.launch_counts()
        require_kernels(run, need, tag)
        if c.routing_hash != "gf2" or run["lane_mix"]:
            raise AssertionError(f"{tag}: routing {c.routing_hash}, "
                                 f"launches {run}")
        add(run)
        check_sharded(c, want14, tag)
        check_queries(c, *want14)
        c.reset()
        busy = device_busy_ms(lambda: c.count_file(path, use_native=True))
        phase("e2e_last", run=tag, hashed_store=c.hashed_store,
              cold_s=round(cold, 4), warm_device_busy_ms=round(busy, 3),
              launches=run)
        del c
    lap("9c")
    # 9d: two ranks on the card, rows routed by their GF(2) owners; the
    # host counts k=224 for 9b meanwhile (beside 9d's cold walls)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host224 = pool.submit(timed_host_count, path, 224)
        two_ranks_on_one_card(path, want14, routing="gf2", tag="9d")
    lap("9d")
    # 9b: mix_prefix at k = 31, 127 and 224 (17 key operands)
    wants[224] = host224.result()
    for k in MIX_PREFIX_KS:
        tag = f"9b mix_prefix k={k} l={WIDE_L}"
        run, c, prof = beside_default(
            path, wants[k], tag, dict(mix_prefix=True), SORT_KERNELS,
            peak=k == 224, k=k, l=WIDE_L, batch_words=1 << 20)
        ops = KmerSpec(k).lanes + 3  # raw lanes, mix_lo, mix_hi, the flag
        if (not c.mix_prefix or c.hash_first or c.store.n_ops != ops
                or run["lane_mix"]):
            raise AssertionError(f"{tag}: operands {c.store.n_ops}, "
                                 f"launches {run}")
        add(run)
        if k != 31:
            check_mix_prefix_kernels(results, c)
        del c, prof
    lap("9b")
    gf2_and_mix_times(gf2_fns)
    del gf2_fns
    lap("gf2 product and mix columns")
    # 9e: save -> load -> continue, and the command line
    add(last_split_runs(path, want14, wants[127]))
    add(last_cli_runs(path))
    lap("9e")
    return launches


def timed_host_count(path: Path, k: int) -> tuple:
    """host_count_lanes, with a line giving its seconds."""
    t0 = time.perf_counter()
    want = host_count_lanes(path, k)
    phase("e2e_setup", k=k, host_count_s=round(time.perf_counter() - t0, 3))
    return want


def last_split_runs(path: Path, want14: tuple, want127: tuple) -> dict:
    """9e: the first half of the reads counted, saved, loaded on the card
    and the second half counted, for 9a (k=14), 9b (k=127) and 9c: each
    export equal to the whole count, the option restored from the file.
    The sort runs take 2^19-word batches, two a half: a merge tree on
    each side of the file.  Returns the launches of the three runs."""
    halves = split_fastq(path)
    ckpt = _build.BUILD_DIR / "last.npz"
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    runs = (
        ("9e 9a hash_first=gf2 k=14", want14, "hash_first", "gf2",
         lambda: KmerCounter(k=K, l=26, batch_words=1 << 19,
                             hash_first="gf2", device="cuda")),
        ("9e 9b mix_prefix k=127", want127, "mix_prefix", True,
         lambda: KmerCounter(k=127, l=WIDE_L, batch_words=1 << 19,
                             mix_prefix=True, device="cuda")),
        ("9e 9c sharded gf2 table k=14", want14, "routing_hash", "gf2",
         lambda: ShardedKmerCounter(k=K, n_shards=1, l=26, backend="table",
                                    batch_words=1 << 20, routing_hash="gf2",
                                    device="cuda")))
    for tag, want, attr, value, make in runs:
        c = make()
        c_words = c.batch.capacity_words
        _build.reset_launch_counts()
        c.count_file(halves[0], use_native=True)
        save_counter(c, ckpt)
        del c
        c = load_counter(ckpt, batch_words=c_words, device="cuda")
        c.count_file(halves[1], use_native=True)
        run = _build.launch_counts()
        require_kernels(run, TABLE_KERNELS if c.backend == "table"
                        else SORT_KERNELS, tag)
        for name in run:
            launches[name] += run[name]
        if getattr(c, attr) != value:
            raise AssertionError(f"{tag}: loaded {attr}={getattr(c, attr)}")
        if hasattr(c, "n_shards"):
            check_sharded(c, want, tag)
        else:
            check_last(c, want, tag)
        phase("e2e_split_run", run=tag, total_kmers=c.total_kmers,
              distinct=c.distinct, file_mb=round(ckpt.stat().st_size
                                                 / 2**20, 1))
        del c
        ckpt.unlink()
    for part in halves:
        part.unlink()
    return launches


def last_cli_runs(path: Path) -> dict:
    """9e: the command line in process with --shards 0 --mix-prefix,
    --shards 0 --hash-first gf2 and --routing-hash gf2 --mode table, each
    exit 0 with the k=14 totals.  Returns their launches."""
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    for argv in (["--shards", "0", "--mix-prefix"],
                 ["--shards", "0", "--hash-first", "gf2"],
                 ["--routing-hash", "gf2", "--mode", "table"]):
        out = io.StringIO()
        _build.reset_launch_counts()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["count", "--input", str(path), "--stats-json",
                           *argv])
        run = _build.launch_counts()
        stats = json.loads(out.getvalue().strip().splitlines()[-1])
        tag = " ".join(argv)
        phase("cli", run=tag, rc=rc, total_kmers=stats["total_kmers"],
              distinct=stats["distinct_kmers"],
              wall_s=stats["wall_seconds"], launches=run)
        if rc != 0 or (stats["total_kmers"], stats["distinct_kmers"]) != (
                TOTAL_KMERS, DISTINCT_KMERS):
            raise AssertionError(f"cli {tag}: rc {rc}, totals "
                                 f"{stats['total_kmers']}/"
                                 f"{stats['distinct_kmers']}")
        for name in run:
            launches[name] += run[name]
    return launches


# --- phase 10 ---------------------------------------------------------------

WIDE_TABLE = dict(k=256, l=25, backend="table", batch_words=1 << 20)


def busy_breakdown(prof, n: int = 6) -> dict:
    """Device ms in a finished trace: the n aten ops with the most self
    device time, and the port's own kernels (csrc/) by name."""
    ops = sorted(((e.key, getattr(e, "self_device_time_total", 0.0))
                  for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])[:n]
    own: dict = {}
    for e in prof.events():
        m = re.search(r"tsx::.*?(\w+_kernel)", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and m:
            own[m.group(1)] = (own.get(m.group(1), 0.0)
                               + e.time_range.end - e.time_range.start)
    return dict(top_ops_ms={k: round(v / 1e3, 3) for k, v in ops},
                own_kernels_ms={k: round(v / 1e3, 3)
                                for k, v in sorted(own.items())})


def check_wide_table(c, want: tuple, tag: str) -> None:
    """Totals, no spill, and the full export against the numpy count."""
    total, distinct = c.total_kmers, c.distinct
    if (total, distinct) != (int(want[1].sum()), len(want[0])):
        raise AssertionError(f"{tag}: totals {total}/{distinct} != "
                             f"{int(want[1].sum())}/{len(want[0])}")
    if int(c.state.spilled):
        raise AssertionError(f"{tag}: {int(c.state.spilled)} spilled")
    keys, counts = (sharded_arrays(c) if hasattr(c, "n_shards")
                    else export_lanes(c))
    check_wide_arrays(keys, counts, want, tag)


def wide_table(path: Path, want: tuple) -> dict:
    """Phase 10: the table at k = 256, l = 25 (20 slot columns: kernel 5
    on 17 of them a round, kernel 4 on 19), the bench FASTQ against phase
    6's numpy count at k = 256: cold and warm walls, warm device busy,
    the split rounds, the fill, the memory estimate against the peak; the
    same at one shard; and the small file's card and CPU table states at
    k = 209 and 256.  Returns the launches of the two cold counts (each
    read from counts zeroed just before it)."""
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    t0 = time.perf_counter()
    tag = "10 table k=256 l=25"

    def made() -> tuple:
        c = KmerCounter(device="cuda", **WIDE_TABLE)
        widths = record_widths(c)
        return c, widths, timed_count(c, path)

    _build.reset_launch_counts()
    c, widths, cold = peak_checked(tag, made, counter_estimate)
    run = _build.launch_counts()
    require_kernels(run, TABLE_KERNELS, tag)
    for name in ("apply_sorted_unique", "gather_sorted"):
        if run[name] != len(widths):
            raise AssertionError(f"{tag}: {name} launched {run[name]} "
                                 f"times in {len(widths)} split rounds")
    check_wide_table(c, want, tag)
    rounds = list(widths)
    c.reset()
    warm = timed_count(c, path)
    check_wide_table(c, want, tag + " warm")
    c.reset()
    prof = traced(lambda: c.count_file(path, use_native=True))
    busy = device_busy_us(prof) / 1e3
    check_wide_table(c, want, tag + " busy")
    st = c.stats()
    phase("e2e_wide_table", run=tag, slot_cols=c.table.slot_cols,
          cold_s=round(cold, 4), warm_s=round(warm, 4),
          kmers_per_s_warm=round(c.total_kmers / warm),
          warm_device_busy_ms=round(busy, 3), total_kmers=c.total_kmers,
          distinct=c.distinct, fill_factor=st["fill_factor"],
          spilled=st["spilled"], probe_histogram=st["probe_histogram"],
          split_rounds=len(rounds), rounds=rounds, launches=run,
          **busy_breakdown(prof))
    for name in launches:
        launches[name] += run[name]
    del c, prof
    phase("wide_table", part="plain",
          seconds=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    tag = "10 sharded table k=256 l=25, one shard"
    _build.reset_launch_counts()
    c, cold = peak_checked(tag, lambda: made_sharded(path, **WIDE_TABLE),
                           counter_estimate)
    run = _build.launch_counts()
    require_kernels(run, TABLE_KERNELS, tag)
    check_wide_table(c, want, tag)
    c.reset()
    prof = traced(lambda: c.count_file(path, use_native=True))
    busy = device_busy_us(prof) / 1e3
    check_wide_table(c, want, tag + " busy")
    phase("e2e_wide_table", run=tag, cold_s=round(cold, 4),
          warm_device_busy_ms=round(busy, 3), hashed_store=c.hashed_store,
          spill_recovered=c.stats()["spill_recovered"], launches=run,
          **busy_breakdown(prof))
    del prof
    for name in launches:
        launches[name] += run[name]
    del c
    phase("wide_table", part="one shard",
          seconds=round(time.perf_counter() - t0, 3))
    for k in (209, 256):
        t0 = time.perf_counter()
        card_vs_cpu(k)
        phase("wide_table", part=f"card_vs_cpu k={k}",
              seconds=round(time.perf_counter() - t0, 3))
    return launches


def check_errors(results: dict) -> None:
    for kname, r in results.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{kname} differs from its plain version")


def main() -> int:
    name, smi = environment()
    build()
    results: dict = {}
    path = bench_file()
    route_cap = sharded_8a_shape(path)[1]  # kernels 2 and 3 at 8a's shapes
    check_compact(results)
    check_merge(results, route_cap)
    check_merge_dedupe(results, route_cap)
    check_apply_kernels(results)
    check_lane_mix(results)
    check_wide_kernels(results)
    check_table_residue(results)
    check_errors(results)
    t0 = time.perf_counter()
    want_keys, want_counts = host_count(path, K)
    phase("e2e_setup", fastq=path.name, reads=bench.N_READS,
          host_count_s=round(time.perf_counter() - t0, 3),
          host_distinct=len(want_keys), host_total=int(want_counts.sum()))
    by_path = {"sort": end_to_end(path, want_keys, want_counts),
               "table": table_end_to_end(path, want_keys, want_counts)}
    by_path["wide"], wants = wide_end_to_end(path)
    t0 = time.perf_counter()
    by_path["lsm"], by_path["user"] = user_surface(
        path, (want_keys, want_counts), wants[31][:2], results)
    phase("user_surface", seconds=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    by_path["sharded"] = sharded_counts(path, (want_keys, want_counts),
                                        wants[127])
    phase("sharded", seconds=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    by_path["last_options"] = last_options(path, (want_keys, want_counts),
                                           wants, results)
    phase("last_options", seconds=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    by_path["wide_table"] = wide_table(path, wants[256])
    phase("wide_table", seconds=round(time.perf_counter() - t0, 3))
    check_errors(results)
    for kname, r in results.items():
        times = {k: v for k, v in r.items() if k not in ("max_abs_err",
                                                         "extra")}
        phase("kernel_time", name=kname,
              **{k: v if v is None else round(v, 4)
                 for k, v in (times | r.get("extra", {})).items()})
    # the contract's keys and the launches by path; the extras stay in the
    # kernel_time lines above
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": KERNELS[kname][0],
         "replaces": KERNELS[kname][1],
         "launches": sum(p[kname] for p in by_path.values()),
         "launches_by_path": {p: n[kname] for p, n in by_path.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": "bytes", "library_ms": r["library_ms"]}
        for kname, r in results.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
