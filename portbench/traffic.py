"""The benchmark's traffic: a FASTQ file from a mix's parameters
(`traffic/<name>.json`) and a seed.

A mix names its generator (`"generator": "<g>"`), a module
`portbench/generators/<g>.py` whose `make_reads(params, rng)` returns the
reads (ASCII bases, one uint8 array each), drawn from the one
`numpy.random.default_rng(seed)` it is given.  Every record is
`@<header><i>`, the read, `+`, and one quality letter repeated.  The same
mix and seed give the same bytes.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np


def generator(name: str):
    """The generator module of that name."""
    return importlib.import_module(f"portbench.generators.{name}")


def make_reads(p: dict, seed: int) -> list[np.ndarray]:
    """The mix's reads (ASCII bases, one uint8 array each)."""
    return generator(p["generator"]).make_reads(
        p, np.random.default_rng(seed))


def write_fastq(p: dict, seed: int, path: str | Path) -> None:
    qual = p.get("quality", "I").encode()
    head = p.get("header", "read").encode()
    parts = []
    for i, seq in enumerate(make_reads(p, seed)):
        b = seq.tobytes()
        parts.append(b"@%s%d\n%s\n+\n%s\n" % (head, i, b, qual * len(b)))
    Path(path).write_bytes(b"".join(parts))
