"""Exact batch histogram: sort, run-boundary flags, compaction.

Occurrences of equal k-mers are brought together by a sort and reduced
without any contended update: after `torch.sort` (the JAX package sorts
with `lax.sort`, outside any kernel), the first row of every run of equal
keys is flagged, the flagged rows and their positions are compacted to the
front by kernel 1 (ops/compact.py), and each run's count is the difference
of adjacent positions.

Keys travel as msb-first "operands": uint32 words (int32 bit patterns)
with the invalid flag packed into the first spare bit above the key, so
invalid windows sort after every real k-mer and never alias one (poly-T
included).  At k % 16 == 0 the top lane is full and the flag is a separate
0/1 column in front.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from tsxcount_tpu_torch.config import KmerSpec
from tsxcount_tpu_torch.ops.compact import compact_flagged
from tsxcount_tpu_torch.ops.lanes import i32, lexsort_perm, u32


class UniqueCounts(NamedTuple):
    """Compacted unique-key histogram of one batch (fixed shape).  Rows
    [0, n_unique) are real and ascending; the rest is unspecified."""

    keys: torch.Tensor      # int32 [P, lanes] (uint32 bit patterns)
    counts: torch.Tensor    # int32 [P]
    valid: torch.Tensor     # bool  [P]
    n_unique: torch.Tensor  # int64 0-d


def flag_ops(spec: KmerSpec) -> int:
    """Number of operand columns for (invalid flag | key)."""
    return spec.lanes if spec.top_lane_bits < 32 else spec.lanes + 1


def invalid_constants(spec: KmerSpec) -> list[int]:
    """Operand values of an invalid or unused row: the flag alone."""
    msb = 1 << spec.top_lane_bits if spec.top_lane_bits < 32 else 1
    return [msb] + [0] * (flag_ops(spec) - 1)


def pack_flag_key(kmers: torch.Tensor, invalid: torch.Tensor,
                  spec: KmerSpec) -> tuple[torch.Tensor, ...]:
    """(..., lanes) keys + invalid flag -> msb-first int32 operands."""
    return pack_flag_key_cols(
        [kmers[..., j] for j in range(kmers.shape[-1])], invalid, spec
    )


def pack_flag_key_cols(cols: Sequence[torch.Tensor], invalid: torch.Tensor,
                       spec: KmerSpec) -> tuple[torch.Tensor, ...]:
    """Lane columns (lsb lane first) + invalid flag -> msb-first operands."""
    if spec.top_lane_bits < 32:
        inv = invalid.to(torch.int64) << spec.top_lane_bits
        top = i32(u32(cols[-1]) | inv)
        return (top,) + tuple(c.contiguous() for c in reversed(cols[:-1]))
    return (invalid.to(torch.int32),) + tuple(
        c.contiguous() for c in reversed(cols)
    )


def unpack_flag_key(ops: Sequence[torch.Tensor], spec: KmerSpec
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack_flag_key -> (keys (P, lanes) int32, invalid bool)."""
    lanes = spec.lanes
    if spec.top_lane_bits < 32:
        top = ops[0]
        invalid = (u32(top) >> spec.top_lane_bits) != 0
        lanes_list = list(reversed(ops[1:lanes])) + [top & spec.top_lane_mask]
    else:
        invalid = ops[0] != 0
        lanes_list = list(reversed(ops[1 : lanes + 1]))
    return torch.stack(lanes_list, dim=-1), invalid


def invalid_bits(ops: Sequence[torch.Tensor], spec: KmerSpec
                 ) -> torch.Tensor:
    """Per-row invalid flag of packed operands."""
    if spec.top_lane_bits < 32:
        return (u32(ops[0]) >> spec.top_lane_bits) != 0
    return ops[0] != 0


def boundary_flags(ops_sorted: Sequence[torch.Tensor]) -> torch.Tensor:
    """bool [P]: row starts a new run of equal operands."""
    p = ops_sorted[0].shape[0]
    flag = torch.ones(p, dtype=torch.bool, device=ops_sorted[0].device)
    if p > 1:
        neq = ops_sorted[0][1:] != ops_sorted[0][:-1]
        for op in ops_sorted[1:]:
            neq |= op[1:] != op[:-1]
        flag[1:] = neq
    return flag


def sort_ops(ops: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Rows of msb-first operands in unsigned lexicographic order."""
    if len(ops) == 1:
        return [i32(torch.sort(u32(ops[0])).values)]
    perm = lexsort_perm(ops)
    return [op[perm] for op in ops]


def count_unique(kmers, valid: torch.Tensor,
                 spec: KmerSpec) -> UniqueCounts:
    """Exact histogram of the valid rows of `kmers`.

    kmers: (P, lanes) int32 keys, or a sequence of per-lane columns (lsb
    lane first, as extract_kmer_cols returns them).
    """
    if isinstance(kmers, (list, tuple)):
        ops = pack_flag_key_cols(kmers, ~valid, spec)
    else:
        ops = pack_flag_key(kmers, ~valid, spec)
    p = ops[0].shape[0]
    dev = ops[0].device
    ops_sorted = sort_ops(ops)
    flag = boundary_flags(ops_sorted)
    arange = torch.arange(p, dtype=torch.int32, device=dev)
    rep = compact_flagged(flag.to(torch.int32), tuple(ops_sorted) + (arange,))
    n_flags = flag.sum()
    # past the last run, clamp positions to p so the differences vanish
    pos = torch.where(arange < n_flags, rep[-1], p)
    pos_next = torch.cat([pos[1:], pos.new_full((1,), p)])
    counts = pos_next - pos
    ukeys, _ = unpack_flag_key(rep[:-1], spec)
    n_unique = (flag & ~invalid_bits(ops_sorted, spec)).sum()
    return UniqueCounts(
        keys=ukeys, counts=counts, valid=arange < n_unique,
        n_unique=n_unique,
    )
