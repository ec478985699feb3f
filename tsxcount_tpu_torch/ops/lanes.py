"""uint32 key words held as int32 bit patterns.

torch.uint32 has no shifts, comparisons, addition or sort support worth the
name, so the port carries every 32-bit key word as the int32 with the same
bits.  Kernels read those bits as uint32.  Plain PyTorch code widens a word
to int64 (`u32`) wherever order or arithmetic needs the unsigned value, and
narrows back with `i32`.  Multi-word keys are compared lexicographically on
the unsigned values; a signed compare would misorder every word with its top
bit set (a full-width top lane at k % 16 == 0, the 0xFFFFFFFF interval
sentinel).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_SIGN32 = 1 << 31
_SIGN64 = -(1 << 63)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & MASK32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 holding its low 32 bits (exact, no overflowing cast)."""
    return (((x & MASK32) ^ _SIGN32) - _SIGN32).to(torch.int32)


def unpack_bits(keys: torch.Tensor, nbits: int,
                dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(..., lanes) int32 bit patterns -> (..., nbits) bit planes (LSB
    first).  An arithmetic shift of an int32 word leaves bit j of the
    pattern at bit 0, so no widening is needed."""
    sh = torch.arange(32, dtype=torch.int32, device=keys.device)
    bits = (keys[..., :, None] >> sh) & 1                 # (..., lanes, 32)
    flat = bits.reshape(*keys.shape[:-1], keys.shape[-1] * 32)
    return flat[..., :nbits].to(dtype)


def pack_bits(bits: torch.Tensor, lanes: int) -> torch.Tensor:
    """(..., nbits) 0/1 values -> (..., lanes) int32 bit patterns (LSB
    first)."""
    pad = lanes * 32 - bits.shape[-1]
    b = bits.to(torch.int64)
    if pad:
        b = torch.cat([b, b.new_zeros((*b.shape[:-1], pad))], dim=-1)
    b = b.reshape(*b.shape[:-1], lanes, 32)
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)
    return i32((b << sh).sum(dim=-1))


def keys_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane-wise equality of (..., lanes) keys, reduced over the lanes."""
    return (a == b).all(dim=-1)


def keys_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned lexicographic a < b over little-endian (..., lanes) keys."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(lt)
    for j in reversed(range(a.shape[-1])):
        aj, bj = u32(a[..., j]), u32(b[..., j])
        lt = lt | (eq & (aj < bj))
        eq = eq & (aj == bj)
    return lt


def sort_words(cols) -> list[torch.Tensor]:
    """Msb-first uint32 columns -> int64 sort words, most significant first,
    each ordering like the unsigned concatenation of (up to) two columns:
    (hi << 32 | lo) with bit 63 flipped so signed order is unsigned order.
    A lone last column is widened as is."""
    words = []
    for i in range(0, len(cols), 2):
        if i + 1 < len(cols):
            words.append(((u32(cols[i]) << 32) | u32(cols[i + 1])) ^ _SIGN64)
        else:
            words.append(u32(cols[i]))
    return words


def lexsort_perm(cols) -> torch.Tensor:
    """Stable permutation sorting rows by msb-first uint32 key columns
    (unsigned lexicographic): least-significant word first, then stable
    passes up to the most significant."""
    words = sort_words(cols)
    perm = None
    for w in reversed(words):
        if perm is not None:
            w = w[perm]
        idx = torch.sort(w, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm
