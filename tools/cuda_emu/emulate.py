#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, through a thread emulation, and
hold them against their plain PyTorch versions (exact equality).

    python3 tools/cuda_emu/emulate.py

For a machine without a GPU or nvcc: it copies tsxcount_tpu_torch/csrc to
tsxcount_tpu_torch/build/emu/, rewrites each `kernel<<<grid, block, smem,
stream>>>(args)` into an emulated launch, compiles the copies with g++
against tools/cuda_emu/cuda_runtime.h (one std::thread per CUDA thread),
loads the result through the same C interface as the real library, and
runs seeded cases of all three kernels at small sizes.  It catches logic
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
from tsxcount_tpu_torch.ops.compact import compact_flagged_plain  # noqa: E402
from tsxcount_tpu_torch.ops.merge import merge_sorted_plain  # noqa: E402
from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted_plain  # noqa: E402

HERE = Path(__file__).resolve().parent
OUT = _build.BUILD_DIR / "emu"
_LAUNCH = re.compile(r"([\w:]+(?:<\w+>)?)\s*<<<(.*?)>>>\s*\(", re.S)


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


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    objs = []
    for f in sorted(_build.CSRC.iterdir()):
        (OUT / f.name).write_text(rewrite_launches(f.read_text()))
    for f in _build.sources():
        obj = OUT / (f.stem + ".o")
        subprocess.run(
            ["g++", "-std=c++20", "-O1", "-fPIC", f"-I{HERE}", "-x", "c++",
             "-Wno-unknown-pragmas", "-c", str(OUT / f.name), "-o", str(obj)],
            check=True,
        )
        objs.append(str(obj))
    lib_path = OUT / "libtsxemu.so"
    subprocess.run(["g++", "-shared", "-o", str(lib_path), *objs,
                    "-lpthread"], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, (res, args) in _build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def main() -> int:
    lib = build()
    P, W = _build.ptr_array, _build.width_array
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(
        a.view(np.int32) if a.dtype == np.uint32 else a)

    for total, density in [(1, 1.0), (5000, 0.5), (9000, 0.0), (9000, 1.0),
                           (12345, 0.1)]:
        flag = t((rng.random(total) < density).astype(np.int32))
        cols = (t(rng.integers(0, 2**32, total, dtype=np.uint32)),
                t(rng.integers(-2**62, 2**62, total)))
        out = tuple(torch.full_like(c, -7) for c in cols)
        scratch = torch.empty(lib.tsx_compact_scratch_elems(total),
                              dtype=torch.int64)
        assert lib.tsx_compact_flagged(
            flag.data_ptr(), P(cols), P(out), W(cols), 2, total,
            scratch.data_ptr(), None) == 0
        n = int((flag != 0).sum())
        for g, w in zip(out, compact_flagged_plain(flag, cols)):
            assert torch.equal(g[:n], w[:n]), ("compact", total, density)
    print("compact_flagged: ok")

    def run(n, n_keys, hi, extra):
        keys = rng.integers(0, hi, size=(n, n_keys), dtype=np.uint64)
        keys = keys.astype(np.uint32)[np.lexsort(keys.T[::-1])]
        return tuple(t(np.ascontiguousarray(keys[:, j]))
                     for j in range(n_keys)) + extra(n)

    for m, n, nk, hi in [(1024, 1024, 1, 2**32), (2000, 48, 1, 50),
                         (0, 2048, 2, 2**32), (3000, 1500, 2, 4),
                         (700, 2900, 3, 3), (5, 0, 1, 9)]:
        pay = lambda k: (torch.arange(k, dtype=torch.int32),
                         t(rng.integers(0, 2**40, k)))
        a, b = run(m, nk, hi, pay), run(n, nk, hi, pay)
        out = tuple(torch.full((m + n,), -7, dtype=c.dtype) for c in a)
        scratch = torch.empty(lib.tsx_merge_scratch_elems(m, n),
                              dtype=torch.int64)
        assert lib.tsx_merge_sorted(P(a), P(b), P(out), W(a), len(a), nk, m,
                                    n, scratch.data_ptr(), None) == 0
        for g, w in zip(out, merge_sorted_plain(a, b, nk)):
            assert torch.equal(g, w), ("merge", m, n, nk)
    print("merge_sorted: ok")

    inv_min = 1 << 30
    for m, n, nk, hi, n_inv in [(4096, 2048, 1, 3000, 37),
                                (6000, 3000, 2, 30, 0), (9000, 100, 1, 2, 5),
                                (0, 10, 1, 5, 3), (3, 0, 3, 2, 0)]:
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
