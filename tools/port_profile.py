#!/usr/bin/env python3
"""Where the device time goes in the PyTorch/CUDA port, on one GPU.

    python3 tools/port_profile.py [--out DIR]

Traces with torch.profiler (CPU + CUDA activities):
  1. each port kernel once at chip_smoke.py's main-path shapes;
  2. one warm end-to-end count of the seed-42 bench FASTQ at k=14 with the
     CLI's defaults (the first, cold count is untraced), by the sort
     backend and by the table backend (l=26).
    python3 tools/port_profile.py --wide [--out DIR]

instead traces warm counts of the same file at k=127 on the sort backend,
with the lane mix (hash_first="mix", the auto rule from 8 lanes) and
without it (hash_first=False), in the order mix, full, full, mix (each
counter's cold count untraced), so the auto rule's A/B reads off one call.

Prints, per part, the device time by kernel name (key_averages, sorted by
device time), the part's wall time and the device's busy share over it;
writes the tables and a Chrome trace of the end-to-end part to DIR
(default tsxcount_tpu_torch/build/profile).  Needs a CUDA device; imports
no JAX.

    python3 tools/port_profile.py --ab OTHER_TREE

instead times kernels 1-5 at their main-path shapes in
OTHER_TREE (an unpacked checkout, e.g. the parent commit's `git archive`)
and in this tree, in the order other, this, this, other, each in its own
process (`--time-kernels TREE`, which imports that tree's
tsxcount_tpu_torch and builds its kernels), and prints one JSON line per
run:
  - kernel 3 on a 2^26-row store run + 2^25-row batch run (k=14);
  - kernel 2 on two 2^24-row runs of one key word and an int32 payload
    (the merge tree's shape), and on two 2^21-row runs of 2 and of 8 full
    32-bit key words; its partition launch alone where the tree has an
    entry point for it (`k2_partition_ms`, else null);
  - kernel 4 on one split round of 2^24 destinations into the k=14, l=26
    table's 2^26-slot columns, once as the per-column loop (five
    one-column calls, every tree has it) and once as one call over the four
    columns the table passes (where the tree's wrapper takes a column
    sequence);
  - kernel 5 on the same round's probe (every active row reads its slot)
    of the two k=14 probe columns, as the per-column loop and as one
    column-set call (where the tree's wrapper takes a sequence);
  - kernel 1 on 2^24 rows at density 0.5 with two int32 columns, with
    int32 flags and with bool flags (where the tree accepts them).
Medians of CUDA-event-timed calls (`*_ms`, the card's time), and for
kernels 5 and 1 also the host's time per wrapper call (`*_host_us`,
perf_counter over back-to-back calls with no device sleep ahead of them:
what the Python side of a wrapper costs on a host-bound path).

    python3 tools/port_profile.py --residue

instead times the table's residue phase (ops/table_residue.py) in the
k = 14, l = 26 table with a fifth of its slots used, from round 3, at
widths 2^10 to 2^18 with 70 % of the rows active: the kernel
(`table_residue`) against the plain rounds (`table_residue_plain`), each
as the wall of one call and its synchronize (`*_wall_ms`, the host's
clock: the plain rounds wait on the card every round), and the kernel's
device time alone (`kernel_ms`, CUDA events); one JSON line a width,
medians of 11 calls on fresh keys.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
HOST_REPS = 50  # wrapper calls per host-time figure


def traced(name: str, fn, out: Path, trace: bool = False) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from tsxcount_tpu_torch.utils.profiling import device_busy_us

    busy = device_busy_us(prof) / 1e6
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=60)
    head = (f"== {name}: wall {wall:.6f} s, device busy {busy:.6f} s "
            f"({100 * busy / wall:.1f}%)")
    print(head)
    print(table)
    (out / f"{name}.txt").write_text(head + "\n" + table)
    if trace:
        prof.export_chrome_trace(str(out / f"{name}.trace.json"))


def median_ms(fn, reps: int = 21) -> float:
    """Median device time of fn() over reps calls after one warm-up, each
    call between its own pair of CUDA events.  The calls queue up behind a
    ~50 ms device sleep, so the wrappers' Python time never leaves the
    card idle inside an event pair (device time, not launch overhead)."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for t0, t1 in events:
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return float(np.median([t0.elapsed_time(t1) for t0, t1 in events]))


def host_us(fn, reps: int = HOST_REPS) -> float:
    """Host microseconds per fn() call: perf_counter around reps
    back-to-back calls after one warm-up, the device free before them (the
    launches queue; the synchronize after the loop is not counted)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def time_kernels(tree: Path) -> dict:
    """Kernels 1-5 of the tsxcount_tpu_torch in `tree`, at their
    main-path shapes, on data made on the card from fixed seeds (the same
    in every tree)."""
    sys.path.insert(0, str(tree))
    from tsxcount_tpu_torch import _build
    from tsxcount_tpu_torch.ops import apply as apply_mod
    from tsxcount_tpu_torch.ops import compact as compact_mod
    from tsxcount_tpu_torch.ops.merge import merge_sorted
    from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted

    if Path(_build.__file__).resolve().parents[1] != tree.resolve():
        raise RuntimeError(f"imported {_build.__file__}, not from {tree}")
    dev = torch.device("cuda")
    _build.kernels()
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    res = {"tree": str(tree)}

    # kernel 3: store run (unique keys, invalid tail) + batch run, k=14
    inv14 = 1 << 28
    s_keys = torch.unique(torch.randint(0, 1 << 28, (1 << 26,), device=dev,
                                        generator=g))
    store = torch.full((1 << 26,), inv14, dtype=torch.int64, device=dev)
    store[: s_keys.numel()] = s_keys
    s_cnt = torch.randint(1, 1000, (1 << 26,), device=dev, generator=g)
    s_cnt[s_keys.numel() :] = 0
    batch = torch.sort(torch.randint(0, 1 << 28, (1 << 25,), device=dev,
                                     generator=g)).values
    batch[-(1 << 20) :] = inv14
    b_cnt = torch.randint(1, 100, (1 << 25,), device=dev, generator=g)
    b_cnt[-(1 << 20) :] = 0
    a, b = (store.to(torch.int32), s_cnt), (batch.to(torch.int32), b_cnt)
    _, n_runs, _ = merge_dedupe_sorted(a, b, 1, inv14)
    res["k3_rows"] = (1 << 26) + (1 << 25)
    res["k3_runs"] = int(n_runs)
    res["k3_ms"] = median_ms(lambda: merge_dedupe_sorted(a, b, 1, inv14))
    del store, s_cnt, batch, b_cnt, a, b, s_keys

    # kernel 2: the merge tree's runs (one key word, int32 payload), and
    # 2 and 8 full 32-bit key words; the partition launch alone where the
    # tree has an entry point for it
    def merge_run(rows: int, n_keys: int) -> tuple:
        if n_keys == 1:
            keys = (torch.sort(torch.randint(0, 1 << 29, (rows,), device=dev,
                                             generator=g)).values,)
        else:  # (word 0, word 1) ascending as one signed int64, then words
            hi = torch.randint(-(1 << 31), 1 << 31, (rows,), device=dev,
                               generator=g)
            lo = torch.randint(0, 1 << 32, (rows,), device=dev, generator=g)
            v = torch.sort((hi << 32) | lo).values
            keys = ((v >> 32) + (1 << 31), v & 0xFFFFFFFF, *(
                torch.randint(0, 1 << 32, (rows,), device=dev, generator=g)
                for _ in range(n_keys - 2)))
        return tuple(k.to(torch.int32) for k in keys) + (
            torch.arange(rows, dtype=torch.int32, device=dev),)

    for n_keys, rows, key in ((1, 1 << 24, "k2_ms"),
                              (2, 1 << 21, "k2_n_keys2_ms"),
                              (8, 1 << 21, "k2_n_keys8_ms")):
        a, b = merge_run(rows, n_keys), merge_run(rows, n_keys)
        res[key] = median_ms(lambda: merge_sorted(a, b, n_keys))
        if n_keys == 1:
            res["k2_partition_ms"] = None
            if "tsx_merge_partition" in _build._SIGNATURES:
                lib = _build.kernels()
                # the key count leads the arguments from the wide-key
                # build on
                keyed = len(_build._SIGNATURES["tsx_merge_scratch_elems"][1])
                scratch = torch.empty(
                    lib.tsx_merge_scratch_elems(
                        *((1,) if keyed == 3 else ()), rows, rows),
                    dtype=torch.int64, device=dev)
                pa, pb = _build.ptr_array(a[:1]), _build.ptr_array(b[:1])
                res["k2_partition_ms"] = median_ms(
                    lambda: lib.tsx_merge_partition(
                        pa, pb, 1, rows, rows, scratch.data_ptr(),
                        _build.stream()))
        del a, b

    # kernel 4: one split round of width 2^24, 12,582,912 active rows on
    # uniform slots of 2^26, the last row of each slot's run live
    s_col, width, active = 1 << 26, 1 << 24, 12 << 20
    pos = torch.sort(torch.randint(0, s_col, (active,), device=dev,
                                   generator=g)).values
    end = torch.ones_like(pos, dtype=torch.bool)
    end[:-1] = pos[1:] != pos[:-1]
    dsta = torch.cat([torch.where(end, 2 * pos + 1, 2 * pos),
                      torch.full((width - active,), 1 << 30, device=dev,
                                 dtype=torch.int64)]).to(torch.int32)
    # key word, digits 0-2, used flag of a round into an empty table
    vals = [torch.randint(1, 1 << 28, (width,), device=dev, generator=g,
                          dtype=torch.int32),
            torch.randint(1, 1000, (width,), device=dev, generator=g,
                          dtype=torch.int32),
            torch.zeros(width, dtype=torch.int32, device=dev),
            torch.zeros(width, dtype=torch.int32, device=dev),
            torch.ones(width, dtype=torch.int32, device=dev)]
    flat = torch.zeros(5 * s_col, dtype=torch.int32, device=dev)
    cols = [flat[c * s_col : (c + 1) * s_col] for c in range(5)]
    res["k4_live"] = int(end.sum())

    def loop():
        for col, val in zip(cols, vals):
            apply_mod.apply_sorted_unique(col, dsta, val)

    res["k4_per_column_loop_ms"] = median_ms(loop)
    res["k4_round_ms"] = None
    if hasattr(apply_mod, "MAX_APPLY_COLS"):  # one call over the columns
        keep = [0, 1, 2, 4]  # the table leaves out the digit-2 column
        sub_c, sub_v = [cols[c] for c in keep], [vals[c] for c in keep]
        res["k4_round_ms"] = median_ms(
            lambda: apply_mod.apply_sorted_unique(sub_c, dsta, sub_v))

    # kernel 5: the round's probe of the key word and the used flag
    dstg = torch.cat([2 * pos + 1, torch.full((width - active,), 1 << 30,
                                              device=dev, dtype=torch.int64)]
                     ).to(torch.int32)
    probe = [cols[0], cols[4]]

    def gather_loop():
        for col in probe:
            apply_mod.gather_sorted(col, dstg)

    res["k5_per_column_loop_ms"] = median_ms(gather_loop)
    res["k5_per_column_loop_host_us"] = host_us(gather_loop)
    res["k5_round_ms"] = res["k5_round_host_us"] = None
    if "cols" in inspect.signature(apply_mod.gather_sorted).parameters:
        gather_round = lambda: apply_mod.gather_sorted(probe, dstg)
        res["k5_round_ms"] = median_ms(gather_round)
        res["k5_round_host_us"] = host_us(gather_round)
    del flat, cols, vals, dsta, dstg, pos, end

    # kernel 1: the batch dedupe's shape, operand + position columns
    n = 1 << 24
    mask = torch.rand(n, device=dev, generator=g) < 0.5
    main = (torch.randint(0, 1 << 29, (n,), device=dev, generator=g,
                          dtype=torch.int32),
            torch.arange(n, dtype=torch.int32, device=dev))
    flag32 = mask.to(torch.int32)
    res["k1_flagged"] = int(mask.sum())
    compact32 = lambda: compact_mod.compact_flagged(flag32, main)
    res["k1_int32_flags_ms"] = median_ms(compact32)
    res["k1_int32_flags_host_us"] = host_us(compact32)
    res["k1_bool_flags_ms"] = res["k1_bool_flags_host_us"] = None
    if torch.bool in getattr(compact_mod, "FLAG_DTYPES", ()):
        compact8 = lambda: compact_mod.compact_flagged(mask, main)
        res["k1_bool_flags_ms"] = median_ms(compact8)
        res["k1_bool_flags_host_us"] = host_us(compact8)
    res["device"] = torch.cuda.get_device_name(0)
    return res


def ab(other: Path) -> int:
    """other, this, this, other: one --time-kernels process each."""
    me = Path(__file__).resolve()
    for tree in (other, REPO, REPO, other):
        proc = subprocess.run(
            [sys.executable, str(me), "--time-kernels", str(tree)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:])
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


def bench_fastq(_build, bench) -> Path:
    path = _build.BUILD_DIR / f"bench.{bench.N_READS}.fastq"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    bench.ensure_synth_fastq(path, bench.N_READS, seed=42)
    return path


def wide_counts(out: Path) -> int:
    """Warm k=127 sort counts with and without the lane mix, in turns."""
    import bench
    from tsxcount_tpu_torch import KmerCounter, _build

    _build.kernels()
    path = bench_fastq(_build, bench)
    counters = {}
    for hash_first in ("mix", False):
        c = KmerCounter(k=127, l=25, batch_words=1 << 20, merge_every=4,
                        hash_first=hash_first, device="cuda")
        c.count_file(path, use_native=True)  # cold, untraced
        counters[hash_first] = c
    for i, hash_first in enumerate(("mix", False, False, "mix")):
        c = counters[hash_first]
        c.reset()
        name = f"e2e_warm_k127_{hash_first or 'full'}_{i}"
        traced(name, lambda: c.count_file(path, use_native=True), out,
               trace=i == 0)
        print(f"{name}: distinct {c.distinct} total {c.total_kmers}")
    print("device:", torch.cuda.get_device_name(0))
    return 0


def residue_timing() -> int:
    sys.path.insert(0, str(REPO))
    from tsxcount_tpu_torch import GF2Hash, KmerSpec, QuotientTable
    from tsxcount_tpu_torch.ops.table_residue import (
        table_residue,
        table_residue_plain,
    )

    dev = torch.device("cuda")
    spec = KmerSpec(14)
    t = QuotientTable(spec, 26, GF2Hash(spec, seed=31836), device=dev)
    st = t.init_state()
    g = torch.Generator(device=dev).manual_seed(21)
    used = torch.rand(t.slots, device=dev, generator=g) < 0.2
    st.slots[: t.slots] = torch.randint(-2**31, 2**31, (t.slots,),
                                        dtype=torch.int32, device=dev,
                                        generator=g) & ~t._low_mask
    t._col(st.slots, t.slot_cols - 1).copy_(used.to(torch.int32))
    rounds = torch.zeros((), dtype=torch.int64, device=dev)

    def carry(w):
        keys = torch.randint(0, 4**14, (w, 1), dtype=torch.int32, device=dev,
                             generator=g)
        pos0, cleared = t._hash_cols(keys)
        counts = torch.ones(w, dtype=torch.int32, device=dev)
        return (pos0, cleared, counts,
                torch.arange(w, device=dev) < int(0.7 * w))

    def wall_ms(fn, w):
        out = []
        for _ in range(11):
            c = carry(w)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(c)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    for w in [1 << b for b in range(10, 19)]:
        args = lambda c: (st.slots, t.slots, c, 3, w, t.max_reprobes, st.n,
                          st.spilled, st.probe_hist)
        plain_rounds = []
        carries = iter([carry(w) for _ in range(22)])
        line = dict(
            width=w, active=int(0.7 * w),
            kernel_wall_ms=wall_ms(lambda c: table_residue(*args(c), rounds),
                                   w),
            plain_wall_ms=wall_ms(lambda c: plain_rounds.append(
                table_residue_plain(*args(c))[3]), w),
            plain_rounds=float(np.median(plain_rounds)),
            kernel_ms=median_ms(lambda: table_residue(*args(next(carries)),
                                                      rounds)),
            device=torch.cuda.get_device_name(0))
        print(json.dumps(line), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--ab", type=Path, default=None)
    ap.add_argument("--time-kernels", type=Path, default=None)
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--residue", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    if args.residue:
        return residue_timing()
    if args.time_kernels is not None:
        print(json.dumps(time_kernels(args.time_kernels)))
        return 0
    if args.ab is not None:
        return ab(args.ab)
    sys.path.insert(0, str(REPO))
    import bench
    from tsxcount_tpu_torch import KmerCounter, _build
    from tsxcount_tpu_torch.ops.compact import compact_flagged
    from tsxcount_tpu_torch.ops.merge import merge_sorted
    from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted

    out = Path(args.out or _build.BUILD_DIR / "profile")
    out.mkdir(parents=True, exist_ok=True)
    if args.wide:
        return wide_counts(out)
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    _build.kernels()

    n = 1 << 24
    flag = torch.from_numpy(rng.random(n) < 0.5).to(dev)  # bool, as callers
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

    path = bench_fastq(_build, bench)
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
