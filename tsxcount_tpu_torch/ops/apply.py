"""The table's slot update and slot probe (kernels 4 and 5, csrc/apply.cu).

Replace the TPU kernels `apply_sorted_unique` and `gather_sorted`
(tsxcount_tpu/ops/pallas_apply.py).  Both address column regions of the
table's flat slot array (S uint32 words each, carried as int32 bit
patterns) through "doubled" destinations: element e of `dst2` (int32) is
live iff it is odd, and then names word `dst2[e] >> 1`.  Dead elements
(even values, and the `1 << 30` tail of inactive rows) are ignored.  The
callers sort by slot, so `dst2` is non-decreasing.  apply_sorted_unique
relies on its live words being distinct; gather_sorted needs neither
order nor distinct words (the table's probe reads one word for every row
of a run).  Each takes the column set of a table round in one launch.

Each function returns, beside its result, the TPU kernel's window-overflow
count: a device int32 zero here (no window exists to overflow), which the
table keeps adding into `spilled` as the JAX package does.
"""

from __future__ import annotations

import torch

from tsxcount_tpu_torch import _build
from tsxcount_tpu_torch.ops.lanes import i32, u32

# kMaxApplyCols of csrc/apply.cu: a whole slot's columns at k = 256 (a round
# probes lanes + 1 of them and applies lanes + 3)
MAX_APPLY_COLS = 20


def _live(col: torch.Tensor, dst2: torch.Tensor):
    """(live mask, word address int64) of each element of dst2."""
    d = u32(dst2)
    addr = d >> 1
    return ((d & 1) == 1) & (addr < col.shape[0]), addr


def _columns(cols) -> tuple[tuple, bool]:
    """(columns tuple, whether one column came as a bare tensor)."""
    if isinstance(cols, torch.Tensor):
        return (cols,), True
    return tuple(cols), False


def gather_sorted_plain(cols, dst2: torch.Tensor):
    """Plain PyTorch version of gather_sorted (same forms)."""
    cols_t, single = _columns(cols)
    live, addr = _live(cols_t[0], dst2)
    idx = torch.where(live, addr, 0)
    outs = tuple(torch.where(live, c[idx], 0) for c in cols_t)
    zero = torch.zeros((), dtype=torch.int32, device=dst2.device)
    return (outs[0] if single else outs), zero


def gather_sorted(cols, dst2: torch.Tensor):
    """outs[c][e] = cols[c][dst2[e] >> 1] for odd dst2[e], else 0.

    cols: one int32 column region [S] (uint32 bit patterns), or a sequence
    of 1..MAX_APPLY_COLS (20) such regions of one length; dst2: int32
    [W].  Returns (out int32 [W], or a tuple of one out per column, and an
    overflow int32 0-d zero).  A column set is that many calls of the TPU kernel in ONE
    launch, which reads dst2 once.  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream (no
    synchronisation); any other device raises.
    """
    name = "gather_sorted"
    cols_t, single = _columns(cols)
    if not 1 <= len(cols_t) <= MAX_APPLY_COLS:
        raise ValueError(f"{name}: 1..{MAX_APPLY_COLS} columns")
    dev = _build.check_columns(name, list(cols_t), (torch.int32,),
                               cols_t[0].shape[0])
    _build.check_columns(name, [dst2], (torch.int32,), device=dev)
    if dev.type == "cpu":
        return gather_sorted_plain(cols, dst2)
    _build.require_cuda(name, dev)
    outs = tuple(torch.empty_like(dst2) for _ in cols_t)
    over = torch.zeros((), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    rc = lib.tsx_gather_sorted(
        _build.ptr_array(cols_t), _build.ptr_array(outs), len(cols_t),
        cols_t[0].shape[0], dst2.data_ptr(), dst2.shape[0], _build.stream())
    _build.check(rc, name)
    _build.count_launch(name, elements=dst2.shape[0], cols=len(cols_t))
    return (outs[0] if single else outs), over


def apply_sorted_unique_plain(cols, dst2: torch.Tensor, vals):
    """Plain PyTorch version of apply_sorted_unique (also in place)."""
    cols_t, single = _columns(cols)
    vals_t = (vals,) if single else tuple(vals)
    live, addr = _live(cols_t[0], dst2)
    a = addr[live]
    for col, val in zip(cols_t, vals_t):
        col[a] = i32(u32(col[a]) + u32(val[live]))
    return cols, torch.zeros((), dtype=torch.int32, device=dst2.device)


def apply_sorted_unique(cols, dst2: torch.Tensor, vals
                        ) -> tuple[object, torch.Tensor]:
    """cols[c][dst2[e] >> 1] += vals[c][e] for odd dst2[e] and every c,
    modulo 2^32, IN PLACE.

    cols: C <= MAX_APPLY_COLS (20) int32 column regions [S] of one slot
    array (uint32 bit patterns), or one such tensor; vals: as many int32
    [W] value columns (or one tensor); dst2: int32 [W], shared by every
    column, live destinations distinct.  Returns (cols itself, overflow int32 0-d zero).
    One call is C calls of the TPU kernel, one per column, in one launch.
    The update is in place because the columns are regions of the table's
    whole slot array: the JAX package donates that array to the round, and
    an out-of-place update here would copy a 2^26-word column twice per
    column per round.  CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream; any other device raises.
    """
    name = "apply_sorted_unique"
    cols_t, single = _columns(cols)
    vals_t = (vals,) if single else tuple(vals)
    if not 1 <= len(cols_t) <= MAX_APPLY_COLS or len(vals_t) != len(cols_t):
        raise ValueError(f"{name}: 1..{MAX_APPLY_COLS} columns, one value "
                         f"column each")
    dev = _build.check_columns(name, list(cols_t), (torch.int32,),
                               cols_t[0].shape[0])
    _build.check_columns(name, [dst2], (torch.int32,), device=dev)
    _build.check_columns(name, list(vals_t), (torch.int32,), dst2.shape[0],
                         dev)
    if dev.type == "cpu":
        return apply_sorted_unique_plain(cols, dst2, vals)
    _build.require_cuda(name, dev)
    over = torch.zeros((), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    rc = lib.tsx_apply_sorted_unique(
        _build.ptr_array(cols_t), _build.ptr_array(vals_t), len(cols_t),
        cols_t[0].shape[0], dst2.data_ptr(), dst2.shape[0], _build.stream())
    _build.check(rc, name)
    _build.count_launch(name, elements=dst2.shape[0], cols=len(cols_t))
    return cols, over
