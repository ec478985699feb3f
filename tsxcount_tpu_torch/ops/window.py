"""Batched k-mer window extraction on the device.

With bases packed 16-per-uint32 LSB-first and positions p = 16q + s
(s in 0..15), lane j of the window starting at p is bits
[32(q+j) + 2s, 32(q+j+1) + 2s) of the base stream:

    lane_j(p) = (words[q+j] >> 2s) | (words[q+j+1] << (32-2s))

and lane j of the window at p equals lane 0 of the window at p + 16j, so
one shifted base stream serves every lane as a slice.  Words are uint32 bit
patterns in int32 tensors (ops/lanes.py); the shifts run on int64.
"""

from __future__ import annotations

import torch

from tsxcount_tpu_torch.config import BASES_PER_WORD, BatchSpec
from tsxcount_tpu_torch.ops.lanes import MASK32, i32, u32


def extract_kmer_cols(words: torch.Tensor,
                      batch: BatchSpec) -> list[torch.Tensor]:
    """words int32 [total_words] -> per-lane window columns, each int32
    [positions], lsb lane first; the top lane is masked to the key width.
    Invalid positions hold garbage; intervals_to_valid says which."""
    spec = batch.spec
    lanes = spec.lanes
    p_total = batch.positions
    q_ext = batch.capacity_words + lanes - 1
    w = u32(words)
    sh = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int64,
                          device=words.device)
    stream = i32(
        (w[:q_ext, None] >> sh) | (w[1 : q_ext + 1, None] << (32 - sh))
    ).reshape(-1)
    cols = [stream[16 * j : 16 * j + p_total] for j in range(lanes)]
    if spec.top_lane_bits < 32:
        cols[-1] = cols[-1] & spec.top_lane_mask
    return cols


def extract_kmers(words: torch.Tensor, batch: BatchSpec) -> torch.Tensor:
    """words -> kmers int32 [positions, lanes] (row p = window at p)."""
    return torch.stack(extract_kmer_cols(words, batch), dim=-1)


def expand_vmask(vmask: torch.Tensor, batch: BatchSpec) -> torch.Tensor:
    """Dense validity bitmask int32 [vmask_words] -> bool [positions]: bit
    p % 32 of word p // 32 marks window position p valid."""
    sh = torch.arange(32, dtype=torch.int64, device=vmask.device)
    bits = (u32(vmask)[:, None] >> sh) & 1
    return bits.reshape(batch.positions).to(torch.bool)


def intervals_to_valid(ivs: torch.Tensor, batch: BatchSpec) -> torch.Tensor:
    """Interval-coded validity -> bool [positions].

    ivs int32 [2 * max_intervals] = [starts | ends]: sorted disjoint
    [start, end) runs of valid window positions; unused slots hold the
    sentinel 0xFFFFFFFF (-1 as int32).  A difference array (+1 at each
    start, -1 at each end) and a prefix sum give the mask; sentinel slots
    add to an extra trailing cell that is dropped.
    """
    m = batch.max_intervals
    p = batch.positions
    starts = u32(ivs[:m])
    ends = u32(ivs[m : 2 * m])
    real = starts != MASK32
    diff = torch.zeros(p + 1, dtype=torch.int32, device=ivs.device)
    one = torch.ones(m, dtype=torch.int32, device=ivs.device)
    diff.index_add_(0, torch.where(real, starts, p), one)
    diff.index_add_(0, torch.where(real, ends, p), -one)
    return torch.cumsum(diff[:p], 0) > 0
