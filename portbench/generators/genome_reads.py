"""Short reads of a seeded genome, with sequencing errors.

A genome of `genome_len` uniform bases, then reads of `read_len` [low,
high) from uniform starts, on either strand where `strands` is 2, at
`coverage` (reads = round(coverage * genome_len / mean length)).  Each
base of a read is, with probability `error_rate`, replaced by one of the
three other bases, uniformly: wgsim's model of sequencing errors
(substitutions only, uniform over positions).
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_reads(p: dict, rng: np.random.Generator) -> list[np.ndarray]:
    g = p["genome_len"]
    lo, hi = p["read_len"]["low"], p["read_len"]["high"]
    genome = rng.integers(0, 4, size=g, dtype=np.uint8)
    n = int(round(p["coverage"] * g / ((lo + hi - 1) / 2)))
    lens = rng.integers(lo, hi, size=n)
    starts = rng.integers(0, g - lens + 1)
    minus = rng.integers(0, p.get("strands", 1), size=n).astype(bool)
    ends = np.cumsum(lens)
    offs = np.arange(ends[-1]) - np.repeat(ends - lens, lens)
    s, ln, m = (np.repeat(x, lens) for x in (starts, lens, minus))
    codes = genome[np.where(m, s + ln - 1 - offs, s + offs)]
    codes = np.where(m, 3 - codes, codes).astype(np.uint8)
    hit = np.flatnonzero(rng.random(codes.size) < p["error_rate"])
    codes[hit] = (codes[hit] + rng.integers(1, 4, size=hit.size)) % 4
    return np.split(BASES[codes], ends[:-1])
