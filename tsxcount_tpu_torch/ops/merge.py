"""Stable merge of two sorted runs (kernel 2, csrc/merge.cu).

Replaces the TPU kernel `merge_sorted` with `merge_path_partition`
(tsxcount_tpu/ops/pallas_merge.py).  Each run is a tuple of equal-length
columns; the first `n_keys` are uint32 key words (int32 bit patterns), most
significant first, ascending under the unsigned lexicographic order; the
rest are payload (int32 or int64, the same dtype in both runs).  The result
has M + N rows; on ties A's rows come first and each run keeps its order.
Unlike the TPU kernel there is no length or MAX_KEY restriction; the plain
version takes any number of key words, the CUDA kernel up to MAX_KEYS (k =
256: 16 lanes and the invalid flag) and _build.MAX_COLS columns in all.
"""

from __future__ import annotations

import torch

from tsxcount_tpu_torch import _build
from tsxcount_tpu_torch.ops.lanes import lexsort_perm

MAX_KEYS = 17  # kMaxKeys of csrc/merge.cuh
_COL_DTYPES = (torch.int32, torch.int64)


def merge_sorted_plain(a_cols, b_cols, n_keys: int = 1) -> tuple:
    """Plain PyTorch version: concatenate and stable-sort (A precedes B)."""
    cols = [torch.cat([a, b]) for a, b in zip(a_cols, b_cols)]
    perm = lexsort_perm(cols[:n_keys])
    return tuple(c[perm] for c in cols)


def check_runs(name: str, a_cols, b_cols, n_keys: int) -> torch.device:
    """Validate two runs of columns for the merge kernels; return device."""
    if len(a_cols) != len(b_cols) or not a_cols:
        raise ValueError(f"{name}: runs need the same number of columns")
    if not 1 <= n_keys <= len(a_cols):
        raise ValueError(f"{name}: n_keys must be in [1, {len(a_cols)}]")
    dev = _build.check_columns(name, a_cols, _COL_DTYPES,
                               a_cols[0].shape[0])
    _build.check_columns(name, b_cols, _COL_DTYPES, b_cols[0].shape[0], dev)
    for i, (a, b) in enumerate(zip(a_cols, b_cols)):
        if a.dtype != b.dtype or (i < n_keys and a.dtype != torch.int32):
            raise TypeError(f"{name}: column {i} dtypes {a.dtype}/{b.dtype}")
    return dev


def check_kernel_width(name: str, n_cols: int, n_keys: int) -> None:
    """Raise unless the CUDA kernels take this many columns and keys."""
    if n_cols > _build.MAX_COLS or n_keys > MAX_KEYS:
        raise ValueError(f"{name}: the kernel takes at most {MAX_KEYS} key "
                         f"words and {_build.MAX_COLS} columns")


def merge_sorted(a_cols, b_cols, n_keys: int = 1) -> tuple:
    """Stable merge of two sorted runs.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    a_cols, b_cols = tuple(a_cols), tuple(b_cols)
    dev = check_runs("merge_sorted", a_cols, b_cols, n_keys)
    if dev.type == "cpu":
        return merge_sorted_plain(a_cols, b_cols, n_keys)
    _build.require_cuda("merge_sorted", dev)
    check_kernel_width("merge_sorted", len(a_cols), n_keys)
    m, n = a_cols[0].shape[0], b_cols[0].shape[0]
    out = tuple(
        torch.empty(m + n, dtype=a.dtype, device=dev) for a in a_cols
    )
    if m + n == 0:
        return out
    lib = _build.kernels()
    scratch = torch.empty(
        lib.tsx_merge_scratch_elems(n_keys, m, n), dtype=torch.int64,
        device=dev
    )
    rc = lib.tsx_merge_sorted(
        _build.ptr_array(a_cols), _build.ptr_array(b_cols),
        _build.ptr_array(out), _build.width_array(a_cols), len(a_cols),
        n_keys, m, n, scratch.data_ptr(), _build.stream(),
    )
    _build.check(rc, "merge_sorted")
    _build.count_launch("merge_sorted", m=m, n=n, n_keys=n_keys,
                        payload_cols=len(a_cols) - n_keys)
    return out
