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

Keys that are the images of a bijection with a uniform msb prefix (the lane
mix, ops/mix.py) need only that prefix sorted: `uniform_prefix=True` sorts
on the first operands covering >= 64 key bits and carries the rest.  Equal
keys still meet; two distinct valid keys that agree on the whole prefix
(probability ~P^2 / 2^65 a batch) would split a run, and are detected
exactly in `UniqueCounts.collided` for the caller to recount with the full
sort.

`count_unique_ops` hands the histogram over as kernel 1 compacted it, in
operand columns; `histogram_run` (`unique_run`) masks those into the run
that the store merge takes (core/store.py `merge_runs`), so a caller that
folds the histogram straight into a store never builds the [P, lanes] key
rows; `unique_rows` builds them for the table.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from tsxcount_tpu_torch.config import KmerSpec
from tsxcount_tpu_torch.ops.compact import compact_flagged
from tsxcount_tpu_torch.ops.lanes import i32, lexsort_perm, u32


class UniqueOps(NamedTuple):
    """count_unique_ops' histogram of one batch, as kernel 1 compacted it
    (fixed shape).  Rows [0, n_unique) are real and ascending; row
    n_unique is the invalid run's representative where the batch has
    invalid windows; the rest is unspecified."""

    ops: tuple              # int32 [P] each: msb-first flagged operands
    counts: torch.Tensor    # int32 [P]
    n_unique: torch.Tensor  # int64 0-d
    collided: torch.Tensor | None = None  # as UniqueCounts.collided


class UniqueCounts(NamedTuple):
    """Compacted unique-key histogram of one batch (fixed shape).  Rows
    [0, n_unique) are real and ascending; the rest is unspecified."""

    keys: torch.Tensor      # int32 [P, lanes] (uint32 bit patterns)
    counts: torch.Tensor    # int32 [P]
    valid: torch.Tensor     # bool  [P]
    n_unique: torch.Tensor  # int64 0-d
    # bool 0-d with uniform_prefix (else None): two distinct valid keys
    # agreed on the sorted prefix, so this histogram may be wrong
    collided: torch.Tensor | None = None


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


def unpack_flag_key_cols(ops: Sequence[torch.Tensor], spec: KmerSpec
                         ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Inverse of pack_flag_key_cols -> (lane columns, lsb lane first;
    invalid bool)."""
    lanes = spec.lanes
    if spec.top_lane_bits < 32:
        top = ops[0]
        invalid = (u32(top) >> spec.top_lane_bits) != 0
        return (list(reversed(ops[1:lanes])) + [top & spec.top_lane_mask],
                invalid)
    return list(reversed(ops[1 : lanes + 1])), ops[0] != 0


def unpack_flag_key(ops: Sequence[torch.Tensor], spec: KmerSpec
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack_flag_key -> (keys (P, lanes) int32, invalid bool)."""
    cols, invalid = unpack_flag_key_cols(ops, spec)
    return torch.stack(cols, dim=-1), invalid


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


def uniform_prefix_nk(spec: KmerSpec) -> int:
    """Operands covering >= 64 uniform key bits: the msb operand holds
    spec.top_lane_bits of key beside the invalid flag (none when the top
    lane is full and the flag stands alone), every further one 32."""
    key_bits_in_top = spec.top_lane_bits if spec.top_lane_bits < 32 else 0
    return 1 + -(-max(1, 64 - key_bits_in_top) // 32)


def sort_uniform_prefix(ops: Sequence[torch.Tensor], spec: KmerSpec
                        ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Rows sorted on the uniform prefix (stably), the other operands
    riding along, and whether two distinct valid keys collided: adjacent
    rows equal on the prefix and different after it.  A valid row and an
    invalid one never agree on the prefix (the flag is in its first
    operand), so the first row's validity decides."""
    nk = uniform_prefix_nk(spec)
    if len(ops) <= nk:
        return sort_ops(ops), torch.zeros((), dtype=torch.bool,
                                          device=ops[0].device)
    perm = lexsort_perm(ops[:nk])
    s = [op[perm] for op in ops]
    same = s[0][1:] == s[0][:-1]
    for op in s[1:nk]:
        same &= op[1:] == op[:-1]
    diff = s[nk][1:] != s[nk][:-1]
    for op in s[nk + 1 :]:
        diff |= op[1:] != op[:-1]
    row_valid = ~invalid_bits((s[0][:-1],), spec)
    return s, (same & diff & row_valid).any()


def _flagged_ops(kmers, valid: torch.Tensor, spec: KmerSpec) -> tuple:
    """Rows or lane columns + validity -> msb-first flagged operands."""
    if isinstance(kmers, (list, tuple)):
        return pack_flag_key_cols(kmers, ~valid, spec)
    return pack_flag_key(kmers, ~valid, spec)


def count_unique(kmers, valid: torch.Tensor, spec: KmerSpec,
                 uniform_prefix: bool = False,
                 weights: torch.Tensor | None = None) -> UniqueCounts:
    """Exact histogram of the valid rows of `kmers`.

    kmers: (P, lanes) int32 keys, or a sequence of per-lane columns (lsb
    lane first, as extract_kmer_cols returns them).  uniform_prefix: the
    keys carry a uniform >= 64-bit msb prefix (lane-mix images); sort on
    it and report collisions (sort_uniform_prefix).  weights: int32 [P]
    multiplicities of the rows (default 1); a key's count is then the sum
    of its rows' weights, exact at any number of rows a key (the JAX
    package bounds that number with `max_multiplicity`).  Weighted
    histograms take the full sort.
    """
    if weights is not None:
        return _count_weighted(_flagged_ops(kmers, valid, spec), weights,
                               spec)
    return unique_rows(count_unique_ops(kmers, valid, spec, uniform_prefix),
                       spec)


def count_unique_ops(kmers, valid: torch.Tensor, spec: KmerSpec,
                     uniform_prefix: bool = False) -> UniqueOps:
    """count_unique (unweighted) with the keys left as kernel 1 wrote
    them: msb-first flagged operand columns, not [P, lanes] rows."""
    ops = _flagged_ops(kmers, valid, spec)
    p = ops[0].shape[0]
    dev = ops[0].device
    collided = None
    if uniform_prefix:
        ops_sorted, collided = sort_uniform_prefix(ops, spec)
    else:
        ops_sorted = sort_ops(ops)
    flag = boundary_flags(ops_sorted)
    arange = torch.arange(p, dtype=torch.int32, device=dev)
    rep = compact_flagged(flag, tuple(ops_sorted) + (arange,))
    n_flags = flag.sum()
    # past the last run, clamp positions to p so the differences vanish
    pos = torch.where(arange < n_flags, rep[-1], p)
    pos_next = torch.cat([pos[1:], pos.new_full((1,), p)])
    n_unique = (flag & ~invalid_bits(ops_sorted, spec)).sum()
    return UniqueOps(ops=rep[:-1], counts=pos_next - pos,
                     n_unique=n_unique, collided=collided)


def histogram_run(ops: Sequence[torch.Tensor], counts: torch.Tensor,
                  valid: torch.Tensor, spec: KmerSpec) -> tuple:
    """A batch histogram's flagged operands and counts as one ascending
    run of the store merge (core/store.py `merge_runs`): the rows where
    `valid` is False become the invalid constant with count 0, so the
    invalid run's representative and the unspecified tail sort last as
    one constant run.  Returns (operands..., int32 counts)."""
    run = [torch.where(valid, op, const)
           for op, const in zip(ops, invalid_constants(spec))]
    return tuple(run) + (torch.where(valid, counts.to(torch.int32), 0),)


def unique_rows(uo: UniqueOps, spec: KmerSpec) -> UniqueCounts:
    """count_unique_ops' histogram as count_unique returns it: [P, lanes]
    key rows and their validity."""
    ukeys, _ = unpack_flag_key(uo.ops, spec)
    arange = torch.arange(ukeys.shape[0], device=ukeys.device)
    return UniqueCounts(
        keys=ukeys, counts=uo.counts, valid=arange < uo.n_unique,
        n_unique=uo.n_unique, collided=uo.collided,
    )


def unique_run(uo: UniqueOps, spec: KmerSpec) -> tuple:
    """count_unique_ops' histogram as one run of the store merge: its
    real rows through histogram_run."""
    rows = torch.arange(uo.counts.shape[0], device=uo.counts.device)
    return histogram_run(uo.ops, uo.counts, rows < uo.n_unique, spec)


def _count_weighted(ops: Sequence[torch.Tensor], weights: torch.Tensor,
                    spec: KmerSpec) -> UniqueCounts:
    """count_unique with row weights: the rows sorted with their weights
    carried, then each run's sum as a difference of the inclusive int64
    prefix sums at its ends; kernel 1 compacts the runs' first rows and
    their sums."""
    p = ops[0].shape[0]
    dev = ops[0].device
    perm = lexsort_perm(ops)
    ops_sorted = [op[perm] for op in ops]
    csum = torch.cumsum(weights[perm].to(torch.int64), 0)
    flag = boundary_flags(ops_sorted)
    # the row before the next run's first row ends this run
    last = torch.ones_like(flag)
    last[:-1] = flag[1:]
    ends = csum[last]
    run_sum = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
    sums = torch.zeros(p, dtype=torch.int64, device=dev)
    sums[flag] = run_sum
    rep = compact_flagged(flag, tuple(ops_sorted) + (sums,))
    n_unique = (flag & ~invalid_bits(ops_sorted, spec)).sum()
    arange = torch.arange(p, device=dev)
    ukeys, _ = unpack_flag_key(rep[:-1], spec)
    counts = torch.where(arange < n_unique, rep[-1], 0).to(torch.int32)
    return UniqueCounts(keys=ukeys, counts=counts, valid=arange < n_unique,
                        n_unique=n_unique)
