"""K-mer geometry and batch-shape configuration.

The reference stores a k-mer as a 2k-bit UBigInt over uint8 fields
(reference src/tsxutils/UBigInt.h:188-217).  On TPU the natural unit is a
32-bit lane: a k-mer is `lanes = ceil(2k/32)` stacked uint32 values,
little-endian (lane 0 holds bases 0..15).  Base i occupies bits [2i, 2i+1]
of the flattened bit string with A=00, C=01, G=10, T=11 — identical bit
layout to the reference encoder (reference src/utils/SequenceUtils.h:86-160).
"""

from __future__ import annotations

import dataclasses

BASES_PER_WORD = 16          # 16 bases x 2 bits = one uint32 word
WORD_BITS = 32

# Counts are stored as 3 little-endian base-2^20 digits in int32 lanes
# (60 usable bits).  This is the TPU analog of the reference's multi-digit
# count assembly — primary s-bit value plus overflow-entry digits OR-ed
# together (reference src/tsxcount/TSXHashMap.h:548-638) — but with wide
# fixed-width digits so segment-sums never overflow int32.
COUNT_DIGITS = 3
COUNT_DIGIT_BITS = 20
COUNT_DIGIT_MASK = (1 << COUNT_DIGIT_BITS) - 1


@dataclasses.dataclass(frozen=True)
class KmerSpec:
    """Static k-mer geometry: everything shape-determining for the kernels."""

    k: int

    def __post_init__(self):
        if not (1 <= self.k <= 256):
            raise ValueError(f"k must be in [1, 256], got {self.k}")

    @property
    def bits(self) -> int:
        """Total key width in bits (2 bits per base)."""
        return 2 * self.k

    @property
    def lanes(self) -> int:
        """Number of uint32 lanes per k-mer key."""
        return (self.bits + WORD_BITS - 1) // WORD_BITS

    @property
    def top_lane_bits(self) -> int:
        """Number of used bits in the most-significant lane."""
        rem = self.bits - (self.lanes - 1) * WORD_BITS
        return rem

    @property
    def top_lane_mask(self) -> int:
        """Mask of used bits in the most-significant lane."""
        if self.top_lane_bits == WORD_BITS:
            return 0xFFFFFFFF
        return (1 << self.top_lane_bits) - 1


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Fixed device-batch geometry.

    A batch is `capacity_words` uint32 words of packed bases plus `pad_words`
    trailing zero words so the window-extraction shift network never reads out
    of bounds.  `positions` is the number of candidate window start positions
    the device evaluates per batch (invalid ones are masked, never branched).
    """

    spec: KmerSpec
    capacity_words: int
    # expected read length (bases): sizes the interval-coded validity budget
    # so one-interval-per-read streams fill the batch before exhausting
    # interval slots.  384 reproduces the historical positions//384 budget;
    # counters auto-detect the hint from the first read (read_len_hint=0).
    read_len_hint: int = 384

    def __post_init__(self):
        if self.capacity_words % 2:
            raise ValueError("capacity_words must be even (vmask packs 32 "
                             "window bits per uint32)")
        if self.read_len_hint < 1:
            raise ValueError("read_len_hint must be >= 1")

    @property
    def pad_words(self) -> int:
        return self.spec.lanes

    @property
    def total_words(self) -> int:
        return self.capacity_words + self.pad_words

    @property
    def positions(self) -> int:
        return BASES_PER_WORD * self.capacity_words

    @property
    def vmask_words(self) -> int:
        """uint32 words of the dense validity bitmask: 1 bit per window
        position (positions = 16 * capacity_words, packed 32 per word).
        The dense form is the multi-chip wire format and the debug view;
        the single-chip hot path ships intervals instead (max_intervals)."""
        return self.capacity_words // 2

    @property
    def max_intervals(self) -> int:
        """Capacity of the interval-coded validity list per batch.

        Window validity is a union of disjoint [start, end) runs — one per
        read segment, plus splits around N bases — so the packer ships runs
        (8 bytes each) instead of the dense 1-bit-per-position mask: far
        fewer H2D bytes than the dense mask for realistic read lengths.
        When a batch accumulates more runs than this, the packer flushes it
        early (partially filled), trading fill for the fixed shape jit
        needs.  The budget scales with the reads-per-batch the hint implies:
        a read of `read_len_hint` bases occupies ceil(hint/16) words, so
        capacity_words // floor(hint/16) intervals (floor gives natural
        headroom for N splits and slightly-shorter reads) cover a full
        batch.  A 150 bp Illumina stream that exhausted the old fixed
        positions//384 budget at ~40% word fill now reaches full batches."""
        words_per_read = max(1, self.read_len_hint // BASES_PER_WORD)
        return max(1024, self.capacity_words // words_per_read)

    @property
    def buf_words(self) -> int:
        """uint32 length of the combined device buffer: packed base words
        followed by interval starts then ends (ONE H2D transfer/batch)."""
        return self.total_words + 2 * self.max_intervals

    @property
    def capacity_bases(self) -> int:
        return BASES_PER_WORD * self.capacity_words


def counts_to_int(d0, d1, d2) -> int:
    """Assemble a python int from the 3 base-2^20 count digits."""
    return int(d0) + (int(d1) << COUNT_DIGIT_BITS) + (int(d2) << (2 * COUNT_DIGIT_BITS))


def int_to_counts(value: int):
    """Split a python int count into 3 base-2^20 digits."""
    if value < 0 or value >= 1 << (3 * COUNT_DIGIT_BITS):
        raise ValueError(f"count out of range: {value}")
    return (
        value & COUNT_DIGIT_MASK,
        (value >> COUNT_DIGIT_BITS) & COUNT_DIGIT_MASK,
        (value >> (2 * COUNT_DIGIT_BITS)) & COUNT_DIGIT_MASK,
    )
