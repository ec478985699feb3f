"""Independent reads of uniform bases, each with an optional homopolymer
tail: the upstream's own benchmark generator (generateFakeSequences.py).

Each read draws its length from numpy's half-open `read_len` [low, high),
then a tail length from `tail` [low, high), then its bases, in that order
from the one generator: as the repo's `bench.py` draws it, so that seed 42
with the `synth-long` mix gives its file.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_reads(p: dict, rng: np.random.Generator) -> list[np.ndarray]:
    lo, hi = p["read_len"]["low"], p["read_len"]["high"]
    tail = p.get("tail")
    reads = []
    for _ in range(p["reads"]):
        n = int(rng.integers(lo, hi))
        t = int(rng.integers(tail["low"], tail["high"])) if tail else 0
        body = BASES[rng.integers(0, 4, size=n)]
        if t:
            body = np.concatenate(
                [body, np.full(t, ord(tail["base"]), dtype=np.uint8)])
        reads.append(body)
    return reads
