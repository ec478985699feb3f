"""Canonical k-mers: min(kmer, reverse_complement(kmer)).

The port of `tsxcount_tpu/ops/canonical.py`, which XLA computes outside
any Pallas kernel; here it is plain PyTorch elementwise work on the lane
words (int32 bit patterns, ops/lanes.py).  In the 2-bit code the
complement is a bitwise NOT (A=00 <-> T=11, C=01 <-> G=10) and the reverse
a mask-shift network over the 2-bit groups.  Every shift runs on the
unsigned value widened to int64: on int32, torch's `>>` is arithmetic and
would drag the sign bit into the key.

The minimum is taken in the unsigned lexicographic lane order (top lane
first), which for a (kmer, revcomp) pair picks the same element as string
order (see the JAX module), so dumps of canonical counts match the usual
string-min convention.
"""

from __future__ import annotations

import torch

from tsxcount_tpu_torch.config import KmerSpec
from tsxcount_tpu_torch.ops.lanes import MASK32, i32, u32


def _reverse_pairs(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit groups of each word (int64 in [0, 2^32))."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & MASK32


def _revcomp_u(cols: list[torch.Tensor], spec: KmerSpec
               ) -> list[torch.Tensor]:
    """Unsigned lane values (int64, lsb lane first) -> those of the
    reverse complements."""
    lanes = len(cols)
    rev = [_reverse_pairs(~c & MASK32) for c in reversed(cols)]
    # the key now fills the TOP 2k bits of the lane vector: shift it down
    shift = lanes * 32 - spec.bits
    if shift:
        rev = [(rev[j] >> shift)
               | ((rev[j + 1] << (32 - shift)) & MASK32 if j + 1 < lanes
                  else 0)
               for j in range(lanes)]
    if spec.top_lane_bits < 32:
        rev[-1] = rev[-1] & spec.top_lane_mask
    return rev


def _less_u(a: list[torch.Tensor], b: list[torch.Tensor]) -> torch.Tensor:
    """Unsigned lexicographic a < b over lsb-first unsigned lane values."""
    lt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(lt)
    for aj, bj in zip(reversed(a), reversed(b)):
        lt = lt | (eq & (aj < bj))
        eq = eq & (aj == bj)
    return lt


def canonicalize_cols(cols: list[torch.Tensor], spec: KmerSpec
                      ) -> list[torch.Tensor]:
    """Per-lane int32 columns (lsb lane first, as extract_kmer_cols gives
    them) -> the canonical keys' columns."""
    fwd = [u32(c) for c in cols]
    rc = _revcomp_u(fwd, spec)
    take_rc = _less_u(rc, fwd)
    return [i32(torch.where(take_rc, r, f)) for r, f in zip(rc, fwd)]


def reverse_complement(kmers: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    """(N, lanes) int32 keys -> their reverse complements, same layout."""
    rc = _revcomp_u([u32(kmers[..., j]) for j in range(kmers.shape[-1])],
                    spec)
    return torch.stack([i32(r) for r in rc], dim=-1)


def canonicalize(kmers: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    """(N, lanes) int32 keys -> min(kmer, revcomp) row by row."""
    return torch.stack(
        canonicalize_cols(list(kmers.unbind(-1)), spec), dim=-1)
