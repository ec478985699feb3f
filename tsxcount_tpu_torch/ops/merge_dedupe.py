"""Merge + dedupe + 64-bit sum of two sorted (key, count) runs (kernel 3,
csrc/merge_dedupe.cu).

Replaces the TPU kernel `merge_dedupe_sorted`
(tsxcount_tpu/ops/pallas_merge_dedupe.py).  Each run is `n_keys` uint32 key
words (int32 bit patterns, most significant first) followed by ONE int64
count column — the TPU kernel's (lo uint32, hi int32) pair as one word.
Both runs are ascending (unsigned lexicographic), and their invalid rows form
one constant run at the end whose first key word is >= `inv_min`.

Returns (cols, n_runs, n_valid): cols has M + N rows per column, rows
[0, n_runs) the distinct keys ascending with their summed counts (rows past
that are unspecified); n_valid excludes the trailing invalid run.  The two
counts are 0-d int64 tensors on the runs' device, so the caller decides
when to synchronise.
"""

from __future__ import annotations

import torch

from tsxcount_tpu_torch import _build
from tsxcount_tpu_torch.ops.lanes import u32
from tsxcount_tpu_torch.ops.merge import (
    check_kernel_width,
    check_runs,
    merge_sorted_plain,
)


def merge_dedupe_sorted_plain(a_cols, b_cols, n_keys: int, inv_min: int):
    """Plain PyTorch version: rows past n_runs are zero."""
    merged = merge_sorted_plain(a_cols, b_cols, n_keys)
    keys, cnt = merged[:n_keys], merged[n_keys]
    t = cnt.shape[0]
    dev = cnt.device
    ends = torch.ones(t, dtype=torch.bool, device=dev)
    if t:
        diff = torch.zeros(t - 1, dtype=torch.bool, device=dev)
        for k in keys:
            diff |= k[1:] != k[:-1]
        ends[:-1] = diff
    idx = torch.nonzero(ends).squeeze(1)
    n_runs = idx.numel()
    out = [torch.zeros_like(c) for c in merged]
    for o, k in zip(out, keys):
        o[:n_runs] = k[idx]
    s = torch.cumsum(cnt, 0)[idx]
    out[n_keys][:n_runs] = s - torch.cat([s.new_zeros(1), s[:-1]])[:n_runs]
    invalid_last = n_runs > 0 and int(u32(out[0][n_runs - 1])) >= inv_min
    n_valid = n_runs - int(invalid_last)
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    return tuple(out), as_t(n_runs), as_t(n_valid)


def merge_dedupe_sorted(a_cols, b_cols, n_keys: int, inv_min: int):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    on the current stream (no synchronisation)."""
    a_cols, b_cols = tuple(a_cols), tuple(b_cols)
    name = "merge_dedupe_sorted"
    if len(a_cols) != n_keys + 1:
        raise ValueError(f"{name}: expected n_keys key columns + 1 count")
    dev = check_runs(name, a_cols, b_cols, n_keys)
    if a_cols[n_keys].dtype != torch.int64:
        raise TypeError(f"{name}: the count column must be int64")
    if not 0 <= inv_min <= 0xFFFFFFFF:
        raise ValueError(f"{name}: inv_min must be a uint32")
    if dev.type == "cpu":
        return merge_dedupe_sorted_plain(a_cols, b_cols, n_keys, inv_min)
    _build.require_cuda(name, dev)
    check_kernel_width(name, len(a_cols), n_keys)
    m, n = a_cols[0].shape[0], b_cols[0].shape[0]
    out = tuple(
        torch.empty(m + n, dtype=a.dtype, device=dev) for a in a_cols
    )
    stats = torch.empty(2, dtype=torch.int64, device=dev)
    lib = _build.kernels()
    scratch = torch.empty(
        max(1, lib.tsx_merge_dedupe_scratch_bytes(n_keys, m, n)),
        dtype=torch.uint8, device=dev,
    )
    rc = lib.tsx_merge_dedupe_sorted(
        _build.ptr_array(a_cols), _build.ptr_array(b_cols),
        _build.ptr_array(out), n_keys, m, n, inv_min, stats.data_ptr(),
        scratch.data_ptr(), _build.stream(),
    )
    _build.check(rc, name)
    _build.count_launch(name, m=m, n=n, n_keys=n_keys)
    return out, stats[0], stats[1]
