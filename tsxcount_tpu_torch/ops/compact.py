"""Stable stream compaction of flagged rows (kernel 1, csrc/compact.cu).

Replaces the TPU kernel `compact_flagged` (tsxcount_tpu/ops/pallas_compact.py).
Rows with flag != 0 move, in order, to the front of every column.  The
output columns have the input's length; rows [0, sum(flag != 0)) hold the
result and the rest is unspecified (the TPU kernel returned TOTAL + 1024
rows with a junk tail; callers slice and mask by the count either way).
"""

from __future__ import annotations

import torch

from tsxcount_tpu_torch import _build

FLAG_DTYPES = (torch.int32, torch.bool)
_COL_DTYPES = (torch.int32, torch.int64)


def compact_flagged_plain(flag: torch.Tensor, cols) -> tuple:
    """Plain PyTorch version: rows past the flagged prefix are zero."""
    idx = torch.nonzero(flag != 0).squeeze(1)
    out = []
    for c in cols:
        o = torch.zeros_like(c)
        o[: idx.numel()] = c[idx]
        out.append(o)
    return tuple(out)


def compact_flagged(flag: torch.Tensor, cols) -> tuple:
    """flag int32 or bool [T]; cols: int32/int64 [T] columns (at most
    _build.MAX_COLS for the kernel).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation); any other device raises.
    """
    cols = tuple(cols)
    n = flag.shape[0]
    dev = _build.check_columns("compact_flagged", [flag], FLAG_DTYPES)
    _build.check_columns("compact_flagged", cols, _COL_DTYPES, n, dev)
    if dev.type == "cpu":
        return compact_flagged_plain(flag, cols)
    _build.require_cuda("compact_flagged", dev)
    if len(cols) > _build.MAX_COLS:
        raise ValueError(f"compact_flagged: at most {_build.MAX_COLS} "
                         f"columns")
    out = tuple(torch.empty_like(c) for c in cols)
    if n == 0:
        return out
    lib = _build.kernels()
    scratch = torch.empty(lib.tsx_compact_scratch_bytes(n), dtype=torch.uint8,
                          device=dev)
    rc = lib.tsx_compact_flagged(
        flag.data_ptr(), flag.element_size(), _build.ptr_array(cols),
        _build.ptr_array(out), _build.width_array(cols), len(cols), n,
        scratch.data_ptr(), _build.stream(),
    )
    _build.check(rc, "compact_flagged")
    _build.count_launch("compact_flagged", rows=n, cols=len(cols))
    return out
