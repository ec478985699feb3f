#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, through a thread emulation, and
hold them against their plain PyTorch versions (exact equality).

    python3 tools/cuda_emu/emulate.py

For a machine without a GPU or nvcc: it copies tsxcount_tpu_torch/csrc to
tsxcount_tpu_torch/build/emu/, rewrites each `kernel<<<grid, block, smem,
stream>>>(args)` into an emulated launch, compiles the copies with g++
against tools/cuda_emu/cuda_runtime.h (one std::thread per CUDA thread),
loads the result through the same C interface as the real library, and
runs seeded cases of every kernel at small sizes.  It catches logic
errors in the kernels (indices, races on shared memory, scan order); it
does not replace the build and the checks on the card.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

from tsxcount_tpu_torch import _build  # noqa: E402
from tsxcount_tpu_torch.ops.apply import (  # noqa: E402
    apply_sorted_unique_plain,
    gather_sorted_plain,
)
from tsxcount_tpu_torch.ops.compact import compact_flagged_plain  # noqa: E402
from tsxcount_tpu_torch.ops.merge import merge_sorted_plain  # noqa: E402
from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted_plain  # noqa: E402
from tsxcount_tpu_torch.config import KmerSpec  # noqa: E402
from tsxcount_tpu_torch.ops.mix import (  # noqa: E402
    LaneMixBijection,
    lane_mix_plain,
)
from tsxcount_tpu_torch.ops.table_residue import (  # noqa: E402
    table_residue_plain,
)

HERE = Path(__file__).resolve().parent
OUT = _build.BUILD_DIR / "emu"
_LAUNCH = re.compile(r"([\w:]+(?:<[\w, ]+>)?)\s*<<<(.*?)>>>\s*\(", re.S)


def _split_top(s: str) -> list[str]:
    """Split on commas outside brackets."""
    parts, depth, cur = [], 0, ""
    for ch in s:
        depth += (ch in "(<[{") - (ch in ")>]}")
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def rewrite_launches(src: str) -> str:
    while m := _LAUNCH.search(src):
        i, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        grid, block = _split_top(m.group(2))[:2]
        src = (src[: m.start()]
               + f"emu::launch(dim3({grid}), dim3({block}), [=] {{ "
               f"{m.group(1)}({src[m.end() : i - 1]}); }})" + src[i:])
    return src


def build(sources=None, out: Path = OUT) -> ctypes.CDLL:
    """The emulated library of `sources` (default: every kernel source),
    built in `out`, its entry points bound as the real library's: every
    one of them when every source is built, those it has otherwise."""
    out.mkdir(parents=True, exist_ok=True)
    objs = []
    for f in sorted(_build.CSRC.iterdir()):
        (out / f.name).write_text(rewrite_launches(f.read_text()))
    for f in sources or _build.sources():
        obj = out / (f.stem + ".o")
        subprocess.run(
            ["g++", "-std=c++20", "-O1", "-fPIC", f"-I{HERE}", "-x", "c++",
             "-Wno-unknown-pragmas", "-c", str(out / f.name), "-o", str(obj)],
            check=True,
        )
        objs.append(str(obj))
    lib_path = out / "libtsxemu.so"
    subprocess.run(["g++", "-shared", "-o", str(lib_path), *objs,
                    "-lpthread"], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, (res, args) in _build._SIGNATURES.items():
        if sources and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


# The table's residue phase: (id, key lanes, log2 slots, rows, width2,
# r_start, max_reprobes, distinct probe starts or 0 for any, share of the
# slots used before, counts up to).  Each case inserts two batches, the
# second holding half the first's keys, so rows also match.
RESIDUE_CASES = [
    ("contention-2^8", 1, 8, 600, 600, 0, 16, 3, 0.2, 100),
    ("contention-2^10", 1, 10, 1500, 1500, 2, 24, 8, 0.3, 100),
    ("lost-past-width2", 1, 13, 3000, 2000, 2, 64, 0, 0.3, 100),
    ("spills-last-bin", 1, 10, 2000, 2000, 0, 5, 0, 0.9, 100),
    ("spills-one-round", 1, 10, 2000, 2000, 4, 5, 0, 0.9, 100),
    ("no-round", 1, 10, 500, 500, 5, 5, 0, 0.5, 100),
    ("r_start-6", 2, 15, 4000, 4000, 6, 64, 0, 0.5, 100),
    ("counts-2^20-up", 2, 13, 2500, 2500, 2, 64, 0, 0.4, 2**32),
    ("lanes-16", 16, 12, 1500, 1500, 0, 64, 0, 0.3, 2**21),
    ("one-chunk", 1, 18, 1 << 16, 1 << 16, 0, 64, 0, 0.3, 2**21),
    ("two-chunks", 1, 18, 70_000, 70_000, 0, 64, 0, 0.3, 2**21),
]


def residue_case(case, seed: int = 0):
    """(slots, n_slots, carries, r_start, width2, max_reprobes) of a
    case: a table with a share of its slots used by random keys and two
    carries of unique keys (pos0, cleared lanes), the second holding half
    the first's keys."""
    _, lanes, l_bits, rows, width2, r_start, max_reprobes, starts, used, \
        top = case
    rng = np.random.default_rng(seed)
    s, cols = 1 << l_bits, lanes + 4
    low = (1 << l_bits) - 1
    slots = np.zeros((cols, s), dtype=np.uint32)
    full = rng.random(s) < used
    slots[:lanes, full] = rng.integers(0, 2**32, (lanes, int(full.sum())),
                                       dtype=np.uint32)
    slots[0, full] = (slots[0, full] & ~np.uint32(low)) | rng.integers(
        0, 8, int(full.sum()), dtype=np.uint32)
    slots[lanes : lanes + 3, full] = rng.integers(
        0, 1 << 20, (3, int(full.sum())), dtype=np.uint32)
    slots[-1, full] = 1

    def keys(k):
        pos0 = (rng.integers(0, starts, k) * (s // starts) if starts
                else rng.integers(0, s, k)).astype(np.uint32)
        cl = rng.integers(0, 2**32, (lanes, k), dtype=np.uint32)
        cl[0] &= ~np.uint32(low)
        return np.concatenate([pos0[None], cl])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    first = keys(rows)
    second = np.concatenate([first[:, rng.permutation(rows)[: rows // 2]],
                             keys(rows - rows // 2)], axis=1)
    carries = []
    for kk in (first, second):
        kk = np.unique(kk, axis=1)  # unique keys, in no particular order
        kk = kk[:, rng.permutation(kk.shape[1])]
        k = kk.shape[1]
        counts = rng.integers(1, top, k, dtype=np.uint64).astype(np.uint32)
        active = rng.random(k) < 0.9
        carries.append((t(kk[0]), tuple(t(c) for c in kk[1:]), t(counts),
                        torch.from_numpy(active)))
    flat = torch.from_numpy(slots.reshape(-1).view(np.int32))
    return flat, s, carries, r_start, min(width2, *(
        c[3].numel() for c in carries)), max_reprobes


def check_residue(lib, case, seed: int = 0) -> None:
    """Both carries of a case through the emulated kernel and through the
    plain rounds, from one state: every slot word, n, spilled, the probe
    histogram and the rounds run must be equal after each."""
    slots, s, carries, r_start, width2, max_reprobes = residue_case(case,
                                                                    seed)
    hist0 = torch.arange(max_reprobes, dtype=torch.int64) * 3
    got = [slots.clone(), torch.tensor(5), torch.tensor(7), hist0.clone()]
    want = [slots.clone(), torch.tensor(5), torch.tensor(7), hist0.clone()]
    for pos0, cleared, counts, active in carries:
        outs = [torch.empty_like(t) for t in got[1:]]
        rounds = torch.tensor(11)
        # stale scratch: the kernel must not read what it did not write
        masks = torch.full((lib.tsx_table_residue_scratch_words(width2),),
                           -1, dtype=torch.int64)
        assert lib.tsx_table_residue(
            got[0].data_ptr(), s, len(cleared), pos0.data_ptr(),
            _build.ptr_array(cleared), counts.data_ptr(), active.data_ptr(),
            active.numel(), width2, r_start, max_reprobes, got[1].data_ptr(),
            got[2].data_ptr(), got[3].data_ptr(), max_reprobes,
            *(o.data_ptr() for o in outs), rounds.data_ptr(),
            masks.data_ptr(), masks.numel(), None) == 0
        got[1:] = outs
        n, spilled, hist, n_rounds = table_residue_plain(
            want[0], s, (pos0, cleared, counts, active), r_start, width2,
            max_reprobes, *want[1:])
        want[1:] = n, spilled, hist
        for name, g, w in zip(("slots", "n", "spilled", "probe_hist"), got,
                              want):
            assert torch.equal(g, w), ("table_residue", case[0], name)
        assert int(rounds) == 11 + n_rounds, ("table_residue", case[0],
                                              "rounds")


def main() -> int:
    lib = build()
    P, W = _build.ptr_array, _build.width_array
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(
        a.view(np.int32) if a.dtype == np.uint32 else a)

    # kernel 1: 4096-row tiles; bool and int32 flags, an int32 and an int64
    # column, lengths off the 4-row vector width, 18 tiles, and offset
    # (unaligned) views of flags and columns (the scalar paths)
    def compact(flag, cols):
        out = tuple(torch.full_like(c, -7) for c in cols)
        total = flag.numel()
        scratch = torch.empty(lib.tsx_compact_scratch_bytes(total),
                              dtype=torch.uint8)
        assert lib.tsx_compact_flagged(
            flag.data_ptr(), flag.element_size(), P(cols), P(out), W(cols),
            len(cols), total, scratch.data_ptr(), None) == 0
        n = int((flag != 0).sum())
        for g, w in zip(out, compact_flagged_plain(flag, cols)):
            assert torch.equal(g[:n], w[:n]), ("compact", total, flag.dtype)

    for total, density, offset in [(1, 1.0, 0), (5000, 0.5, 0),
                                   (9000, 0.0, 0), (9000, 1.0, 0),
                                   (12345, 0.1, 0), (70001, 0.5, 0),
                                   (70001, 0.7, 1), (4099, 0.5, 3)]:
        flag = rng.random(total + offset) < density
        cols = (t(rng.integers(0, 2**32, total + offset, dtype=np.uint32)),
                t(rng.integers(-2**62, 2**62, total + offset)))
        cols = tuple(c[offset:] for c in cols)
        for dtype in (torch.bool, torch.int32):
            compact(torch.from_numpy(flag).to(dtype)[offset:], cols)
    # 18 columns: the k = 256 dedupe's 17 key operands and a position
    flag = torch.from_numpy(rng.random(9000) < 0.5)
    compact(flag, tuple(t(rng.integers(0, 2**32, 9000, dtype=np.uint32))
                        for _ in range(17)) + (torch.arange(9000).int(),))
    print("compact_flagged: ok")

    def run(n, n_keys, hi, extra):
        keys = rng.integers(0, hi, size=(n, n_keys), dtype=np.uint64)
        keys = keys.astype(np.uint32)[np.lexsort(keys.T[::-1])]
        return tuple(t(np.ascontiguousarray(keys[:, j]))
                     for j in range(n_keys)) + extra(n)

    # kernel 2: tiles of 1024 rows up to 8 key words, 512 beyond; the cases
    # after the first six cross 16 tiles or more at 1, 3, 8, 9 and 17 key
    # words, with an int32 and an int64 payload column: full 32-bit words
    # (top bit set), lengths off the tile, one run empty, and every key
    # equal (stability: A's rows first, each run in order); at 9 and 17,
    # words drawn from 0..2 so that ties reach the last word
    for m, n, nk, hi in [(1024, 1024, 1, 2**32), (2000, 48, 1, 50),
                         (0, 2048, 2, 2**32), (3000, 1500, 2, 4),
                         (700, 2900, 3, 3), (5, 0, 1, 9),
                         (20001, 17000, 1, 2**32), (19000, 18111, 3, 2**32),
                         (9000, 8501, 8, 2**32), (40000, 0, 1, 2**32),
                         (0, 33000, 3, 5), (0, 17000, 8, 3),
                         (21000, 16500, 1, 1), (18000, 19001, 3, 1),
                         (9500, 9000, 8, 1), (5000, 4301, 9, 2**32),
                         (4700, 4000, 9, 3), (4100, 4600, 17, 3),
                         (0, 9000, 17, 2**32), (4000, 4500, 17, 1)]:
        pay = lambda k: (torch.arange(k, dtype=torch.int32),
                         t(rng.integers(0, 2**40, k)))[: 18 - nk]  # 18 cols
        a, b = run(m, nk, hi, pay), run(n, nk, hi, pay)
        out = tuple(torch.full((m + n,), -7, dtype=c.dtype) for c in a)
        scratch = torch.empty(lib.tsx_merge_scratch_elems(nk, m, n),
                              dtype=torch.int64)
        assert lib.tsx_merge_sorted(P(a), P(b), P(out), W(a), len(a), nk, m,
                                    n, scratch.data_ptr(), None) == 0
        for g, w in zip(out, merge_sorted_plain(a, b, nk)):
            assert torch.equal(g, w), ("merge", m, n, nk)
        # the partition alone: A rows before each tile boundary, as the
        # stable merge places them
        from_a = torch.cat([torch.ones(m, dtype=torch.int64),
                            torch.zeros(n, dtype=torch.int64)])
        diags = torch.arange(scratch.numel()) * (1024 if nk <= 8 else 512)
        before = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(
            merge_sorted_plain(a[:nk] + (from_a[:m],), b[:nk] + (from_a[m:],),
                               nk)[nk], 0)])
        scratch.fill_(-7)
        assert lib.tsx_merge_partition(P(a[:nk]), P(b[:nk]), nk, m, n,
                                       scratch.data_ptr(), None) == 0
        assert torch.equal(scratch, before[diags.clamp(max=m + n)]), (
            "merge_partition", m, n, nk)
    # no payload column: the keys alone, across many tiles
    for nk in (1, 8, 17):
        a = run(20000, nk, 2**32, lambda k: ())
        b = run(17001, nk, 2**32, lambda k: ())
        out = tuple(torch.full((37001,), -7, dtype=torch.int32)
                    for _ in range(nk))
        scratch = torch.empty(lib.tsx_merge_scratch_elems(nk, 20000, 17001),
                              dtype=torch.int64)
        assert lib.tsx_merge_sorted(P(a), P(b), P(out), W(a), nk, nk, 20000,
                                    17001, scratch.data_ptr(), None) == 0
        for g, w in zip(out, merge_sorted_plain(a, b, nk)):
            assert torch.equal(g, w), ("merge keys only", nk)
    print("merge_sorted: ok")

    # kernel 3: tiles of 2048 rows (1024 beyond 3 key words, 512 beyond
    # 8); the last five cases cross 16 tiles or more, one of them with a
    # single key over every tile, two at 9 and 17 key words whose words
    # are drawn from 0..1 (runs decided by the last word)
    inv_min = 1 << 30
    for m, n, nk, hi, n_inv in [(4096, 2048, 1, 3000, 37),
                                (6000, 3000, 2, 30, 0), (9000, 100, 1, 2, 5),
                                (0, 10, 1, 5, 3), (3, 0, 3, 2, 0),
                                (0, 5000, 2, 40, 7), (2500, 0, 1, 90, 0),
                                (40000, 30000, 1, 2**30, 100),
                                (40000, 30000, 1, 1, 0),
                                (12000, 8000, 8, 2, 11),
                                (6000, 4000, 9, 2, 13),
                                (5000, 4000, 17, 2, 7)]:
        def with_invalid(k):
            cols = run(k, nk, hi, lambda q: (
                t(rng.integers(2**31, 2**32 - 1, q)),))
            inv = min(n_inv, k)
            cols[0][k - inv :] = inv_min
            for c in cols[1:nk]:
                c[k - inv :] = 0
            cols[nk][k - inv :] = 0
            return cols

        a, b = with_invalid(m), with_invalid(n)
        out = tuple(torch.full((m + n,), -7, dtype=c.dtype) for c in a)
        stats = torch.full((2,), -7, dtype=torch.int64)
        scratch = torch.empty(
            max(1, lib.tsx_merge_dedupe_scratch_bytes(nk, m, n)),
            dtype=torch.uint8)
        assert lib.tsx_merge_dedupe_sorted(
            P(a), P(b), P(out), nk, m, n, inv_min, stats.data_ptr(),
            scratch.data_ptr(), None) == 0
        want, n_runs, n_valid = merge_dedupe_sorted_plain(a, b, nk, inv_min)
        assert stats.tolist() == [int(n_runs), int(n_valid)], stats
        r = int(n_runs)
        for g, w in zip(out, want):
            assert torch.equal(g[:r], w[:r]), ("merge_dedupe", m, n, nk)
    print("merge_dedupe_sorted: ok")

    # kernels 2 and 3 on runs out of order (a batch sorted only on its
    # uniform prefix, before the counter reads its collision flag and
    # recounts): the rows are unspecified, but every read must stay inside
    # the runs and every write inside out.  Each column sits between guards
    # of -1, which no key word (< 2^31 - 1) or row id of the data holds;
    # every output row must be a copy of an input row (kernel 2: its row id
    # names the row) or an input key (kernel 3), and out's guards stay -7.
    # A first word from 0..15 makes every prefix run span many tiles, so
    # the merge-path split points are not monotone.
    guard = 4096

    def guarded(vals, fill):
        buf = torch.full((vals.numel() + 2 * guard,), fill, dtype=vals.dtype)
        buf[guard:-guard] = vals
        return buf, buf[guard:-guard]

    def disordered(k, nk, how):
        keys = rng.integers(0, 2**31 - 1, (k, nk)).astype(np.int32)
        keys[:, 0] = np.sort(rng.integers(0, 16, k))
        if how == "inversion":  # a descending block of the first word too
            keys[k // 3 : k // 3 + 3000, 0] = keys[k // 3 : k // 3 + 3000,
                                                   0][::-1]
        elif how == "shuffled":
            rng.shuffle(keys)
        return keys

    def as_rows(keys):
        return np.ascontiguousarray(keys).view(
            np.dtype((np.void, keys.shape[1] * 4))).ravel()

    for nk, how in [(2, "prefix"), (3, "inversion"), (1, "shuffled"),
                    (8, "prefix"), (9, "inversion"), (17, "prefix"),
                    (17, "shuffled")]:
        m, n = 20000, 17001
        ka, kb = disordered(m, nk, how), disordered(n, nk, how)
        every = np.concatenate([ka, kb])
        held = []  # the guarded buffers behind the views

        def cols(keys, extra, fill):
            views = []
            for c in [torch.from_numpy(keys[:, j].copy())
                      for j in range(nk)] + [extra]:
                buf, v = guarded(c, fill)
                held.append(buf)
                views.append(v)
            return tuple(views)

        def fresh(like):
            bufs = [torch.full((m + n + 2 * guard,), -7, dtype=c.dtype)
                    for c in like]
            return bufs, tuple(b[guard:-guard] for b in bufs)

        def guards_kept(bufs):
            return all(bool((b[:guard] == -7).all() and (b[-guard:] == -7)
                            .all()) for b in bufs)

        # kernel 2, an int32 row id as payload
        a = cols(ka, torch.arange(m, dtype=torch.int32), -1)
        b = cols(kb, torch.arange(m, m + n, dtype=torch.int32), -1)
        bufs, out = fresh(a)
        scratch = torch.empty(lib.tsx_merge_scratch_elems(nk, m, n),
                              dtype=torch.int64)
        assert lib.tsx_merge_sorted(P(a), P(b), P(out), W(a), len(a), nk, m,
                                    n, scratch.data_ptr(), None) == 0
        ids = out[nk].numpy()
        assert guards_kept(bufs), ("merge out of order: write", nk, how)
        assert ((ids >= 0) & (ids < m + n)).all(), ("merge out of order", nk,
                                                    how)
        got = np.stack([c.numpy() for c in out[:nk]], axis=1)
        assert (got == every[ids]).all(), ("merge out of order", nk, how)
        # kernel 3, an int64 count
        a = cols(ka, torch.ones(m, dtype=torch.int64), -1)
        b = cols(kb, torch.ones(n, dtype=torch.int64), -1)
        bufs, out = fresh(a)
        stats = torch.full((2,), -7, dtype=torch.int64)
        scratch = torch.empty(lib.tsx_merge_dedupe_scratch_bytes(nk, m, n),
                              dtype=torch.uint8)
        assert lib.tsx_merge_dedupe_sorted(
            P(a), P(b), P(out), nk, m, n, 1 << 31, stats.data_ptr(),
            scratch.data_ptr(), None) == 0
        r = int(stats[0])
        assert 0 < r <= m + n and guards_kept(bufs), (
            "merge_dedupe out of order", nk, how, r)
        got = np.stack([c[:r].numpy() for c in out[:nk]], axis=1)
        written = (got != -7).any(axis=1)
        assert np.isin(as_rows(got[written]), as_rows(every)).all(), (
            "merge_dedupe out of order", nk, how)
    print("merge out of order: ok")

    # kernels 4 and 5: sorted doubled destinations, live (odd) addresses
    # distinct, dead (even) ones between them and a 1 << 30 tail
    for s, n_live, n_dead, tail in [(4096, 1500, 500, 64), (2048, 2048, 0, 0),
                                    (2048, 0, 300, 100), (1000, 2, 0, 5),
                                    (3000, 1, 2000, 0)]:
        live = np.sort(rng.choice(s, n_live, replace=False))
        if n_live == 2:  # the first and the last word
            live = np.array([0, s - 1])
        dst2 = np.sort(np.concatenate([
            2 * live + 1, 2 * rng.integers(0, s + 1, n_dead)]))
        dst2 = t(np.concatenate([dst2, np.full(tail, 1 << 30)])
                 .astype(np.int32))
        n = dst2.numel()
        val = t(rng.integers(0, 2**32, n, dtype=np.uint32))
        # kernel 5 over column sets of 1, 2 and 5 regions of one flat
        # array, and over an offset dst2 view; at one s also 17 (the probe
        # of k = 241-256) and 20 (the cap, a whole slot at k = 256)
        wide = (17, 20) if s == 4096 else ()
        flat = t(rng.integers(0, 2**32, max((5,) + wide) * s,
                              dtype=np.uint32))
        for n_cols, d in [(1, dst2), (2, dst2), (5, dst2), (2, dst2[1:])] + [
                (w, dst2) for w in wide]:
            cols = [flat[c * s : (c + 1) * s] for c in range(n_cols)]
            outs = [torch.full_like(d, -7) for _ in cols]
            assert lib.tsx_gather_sorted(P(cols), P(outs), n_cols, s,
                                         d.data_ptr(), d.numel(), None) == 0
            want, _ = gather_sorted_plain(cols, d)
            assert all(map(torch.equal, outs, want)), ("gather", s, n_live,
                                                       n_cols)
        # kernel 4 with one column, and with five regions of one flat
        # array: random values, zeros, some zeros, wrapping adds, 0/1; at
        # one s also 19 (the round of k = 241-256) and 20 (the cap)
        wide = (19, 20) if s == 4096 else ()
        flat = t(rng.integers(2**31, 2**32, max((5,) + wide) * s,
                              dtype=np.uint32))
        vals = (val, torch.zeros_like(val),
                val * t((rng.random(n) < 0.5).astype(np.int32)),
                t(rng.integers(2**31, 2**32, n, dtype=np.uint32)),
                t((rng.random(n) < 0.5).astype(np.int32)))
        vals = vals * 4  # 20 value columns, the five kinds in turn
        for n_cols in (1, 5) + wide:
            got = flat.clone()
            cols = [got[c * s : (c + 1) * s] for c in range(n_cols)]
            assert lib.tsx_apply_sorted_unique(
                P(cols), P(vals[:n_cols]), n_cols, s, dst2.data_ptr(), n,
                None) == 0
            want = flat.clone()
            apply_sorted_unique_plain(
                [want[c * s : (c + 1) * s] for c in range(n_cols)], dst2,
                vals[:n_cols])
            assert torch.equal(got, want), ("apply", s, n_live, n_cols)
    # the table's probe: every row of a run reads the same word
    s = 2048
    cols = [t(rng.integers(0, 2**32, s, dtype=np.uint32)) for _ in range(2)]
    dst2 = t((2 * np.sort(rng.integers(0, 300, 3001)) + 1).astype(np.int32))
    outs = [torch.empty_like(dst2) for _ in cols]
    assert lib.tsx_gather_sorted(P(cols), P(outs), 2, s, dst2.data_ptr(),
                                 dst2.numel(), None) == 0
    assert all(map(torch.equal, outs, gather_sorted_plain(cols, dst2)[0])), (
        "runs")
    print("gather_sorted: ok")
    print("apply_sorted_unique: ok")

    # the lane mix at every lane count the sort backend meets, forward and
    # inverse, on full 32-bit words (the top lane masked to the key)
    for k in (7, 16, 31, 32, 63, 113, 127, 128, 200, 256):
        spec = KmerSpec(k)
        mix = LaneMixBijection(spec)
        n = 3001
        keys = rng.integers(0, 2**32, (spec.lanes, n), dtype=np.uint32)
        keys[-1] &= np.uint32(spec.top_lane_mask)
        cols = [t(np.ascontiguousarray(c)) for c in keys]
        for inverse in (False, True):
            out = [torch.full_like(c, -7) for c in cols]
            assert lib.tsx_lane_mix(
                P(cols), P(out), spec.lanes, n, int(inverse),
                spec.top_lane_mask, mix._odd1, mix._odd2, mix._inv1,
                mix._inv2, mix._shift, mix._unshift_steps, None) == 0
            want = lane_mix_plain(cols, mix, inverse)
            assert all(map(torch.equal, out, want)), ("lane_mix", k, inverse)
    print("lane_mix: ok")

    for case in RESIDUE_CASES:
        check_residue(lib, case)
    print("table_residue: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
