"""The table's residue phase (csrc/table_residue.cu) and its plain twin.

The residue phase finishes an insert into the quotient table
(core/table.py) from the carry of its split rounds: the rows still
unresolved, compacted to a prefix, at a width of a few thousand rows.  It
runs reprobe rounds until every row has its slot or `max_reprobes` is
reached.  In round r a row probes (pos0 + r(r+1)/2) mod S and either
matches its key there, wins the empty slot (the LOWEST row among the
round's contenders for it, as in the JAX package), or goes on to round
r + 1.

`table_residue_plain` runs the rounds one at a time in plain PyTorch, one
host check a round: the CPU's path and the tests' reference.
`table_residue` runs every round in one launch of one block, at any width,
with no host sync.  It replaces no TPU kernel: the JAX package runs these
rounds as XLA ops.

Both update the slot array IN PLACE (every column of the flat int32 array,
column c of slot i at c * S + i), and return the state's counters anew:
n (int64 0-d, += winners), spilled (int64 0-d, += rows active past
`width2` and rows unresolved after the last round) and probe_hist (int64
[H], bin min(r, H - 1) += the rows resolved in round r).
"""

from __future__ import annotations

import torch

from tsxcount_tpu_torch import _build
from tsxcount_tpu_torch.config import COUNT_DIGIT_BITS, COUNT_DIGIT_MASK
from tsxcount_tpu_torch.ops.lanes import i32, u32
from tsxcount_tpu_torch.utils.profiling import span

MAX_LANES = 16  # kMaxLanes of csrc/table_residue.cu


def triangular(r):
    """The probe offset of reprobe r: r(r+1)/2."""
    return (r * (r + 1)) // 2


def bump_hist(hist: torch.Tensor, r: int, k: torch.Tensor) -> torch.Tensor:
    """hist with k added to bin r: a reprobe index past the histogram lands
    in its last bin, as the JAX package's clamped index does."""
    hist = hist.clone()
    hist[min(r, hist.shape[0] - 1)] += k
    return hist


def table_residue_plain(slots: torch.Tensor, n_slots: int, carry,
                        r_start: int, width2: int, max_reprobes: int,
                        n: torch.Tensor, spilled: torch.Tensor,
                        hist: torch.Tensor):
    """The rounds in plain PyTorch: gathers and masked scatters, one host
    check a round.  carry: (pos0 int32 [R], cleared: a tuple of int32 [R]
    key-lane columns, counts int32 [R], active bool [R]), R >= width2.
    Returns (n, spilled, probe_hist, rounds run)."""
    s = n_slots
    pos0_f, cleared_f, counts_f, active_f = carry
    lanes = len(cleared_f)
    cols = lanes + 4
    lost = active_f.sum() - active_f[:width2].sum()
    pos0 = pos0_f[:width2].to(torch.int64)
    cleared = tuple(c[:width2] for c in cleared_f)
    counts = counts_f[:width2]
    d0 = counts & COUNT_DIGIT_MASK
    d1 = (counts >> COUNT_DIGIT_BITS) & COUNT_DIGIT_MASK
    zeros_w = torch.zeros_like(counts)
    probe_cols = list(range(lanes)) + [cols - 1]
    unresolved = active_f[:width2].clone()
    r = r_start
    rounds = 0
    while r < max_reprobes:
        with span("sync"):
            if not bool(unresolved.any()):
                break
        rounds += 1
        pos = (pos0 + triangular(r)) % s
        slotkey0 = cleared[0] | r
        g_cols = [slots[c * s + pos] for c in probe_cols]
        used_g = g_cols[-1] != 0
        key_eq = g_cols[0] == slotkey0
        for j in range(1, lanes):
            key_eq &= g_cols[j] == cleared[j]
        match = unresolved & used_g & key_eq
        empty = unresolved & ~used_g
        ckey_s, perm = torch.sort(torch.where(empty, pos, s), stable=True)
        first = torch.ones_like(empty)
        first[1:] = ckey_s[1:] != ckey_s[:-1]
        winner = torch.zeros_like(empty)
        winner[perm] = first & (ckey_s < s)
        upd = match | winner
        val_cols = (
            [torch.where(winner, slotkey0, 0)]
            + [torch.where(winner, cleared[j], 0) for j in range(1, lanes)]
            + [d0, d1, zeros_w, winner.to(torch.int32)]
        )
        p = pos[upd]
        for c in range(cols):
            e = c * s + p
            slots[e] = i32(u32(slots[e]) + u32(val_cols[c][upd]))
        n = n + winner.sum()
        hist = bump_hist(hist, r, upd.sum())
        unresolved &= ~upd
        r += 1
    spilled = spilled + lost + unresolved.sum()
    return n, spilled, hist, rounds


def table_residue(slots: torch.Tensor, n_slots: int, carry, r_start: int,
                  width2: int, max_reprobes: int, n: torch.Tensor,
                  spilled: torch.Tensor, hist: torch.Tensor,
                  rounds: torch.Tensor):
    """Every round of the residue phase in one launch (see the module
    docstring); the forms of `table_residue_plain`, with `rounds` an int64
    0-d tensor on the state's device into which the rounds run are added.
    Returns (n, spilled, probe_hist).

    carry's columns must be contiguous and hold 1..MAX_LANES key lanes.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream with O(width2) scratch (no synchronisation); any
    other device raises.
    """
    name = "table_residue"
    pos0, cleared, counts, active = carry
    cleared = tuple(cleared)
    lanes = len(cleared)
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"{name}: 1..{MAX_LANES} key lanes")
    if n_slots < 1 or n_slots & (n_slots - 1):
        raise ValueError(f"{name}: slots must be a power of two")
    dev = _build.check_columns(name, [slots], (torch.int32,),
                               (lanes + 4) * n_slots)
    n_rows = active.shape[0]
    _build.check_columns(name, [pos0, *cleared, counts], (torch.int32,),
                         n_rows, dev)
    _build.check_columns(name, [active], (torch.bool,), device=dev)
    _build.check_columns(name, [hist], (torch.int64,), device=dev)
    for t in (n, spilled, rounds):
        if t.dtype != torch.int64 or t.dim() != 0 or t.device != dev:
            raise ValueError(f"{name}: n, spilled and rounds must be int64 "
                             f"0-d tensors on {dev}")
    if not 0 <= width2 <= n_rows:
        raise ValueError(f"{name}: width2 {width2} outside [0, {n_rows}]")
    if dev.type == "cpu":
        n, spilled, hist, k = table_residue_plain(
            slots, n_slots, carry, r_start, width2, max_reprobes, n, spilled,
            hist)
        rounds += k
        return n, spilled, hist
    _build.require_cuda(name, dev)
    n_out, spilled_out = torch.empty_like(n), torch.empty_like(spilled)
    hist_out = torch.empty_like(hist)
    lib = _build.kernels()
    masks = torch.empty(lib.tsx_table_residue_scratch_words(width2),
                        dtype=torch.int64, device=dev)
    rc = lib.tsx_table_residue(
        slots.data_ptr(), n_slots, lanes, pos0.data_ptr(),
        _build.ptr_array(cleared), counts.data_ptr(), active.data_ptr(),
        n_rows, width2, r_start, max_reprobes, n.data_ptr(),
        spilled.data_ptr(), hist.data_ptr(), hist.shape[0], n_out.data_ptr(),
        spilled_out.data_ptr(), hist_out.data_ptr(), rounds.data_ptr(),
        masks.data_ptr(), masks.numel(), _build.stream())
    _build.check(rc, name)
    _build.count_launch(name, rows=width2, cols=lanes + 4, r_start=r_start)
    return n_out, spilled_out, hist_out
