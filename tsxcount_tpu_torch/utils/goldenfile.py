"""Reader/writer for the reference `kmer\tcount` TSV format.

The reference verifies counts against `<input>.<k>.count` files streamed line
by line (reference src/mains/main.cpp:224-317, loader at
src/mains/testExecution.h:119-143).  Shipped golden file:
data/small_t7.1000.fastq.14.count (194 697 entries).
"""

from __future__ import annotations

import gzip
from pathlib import Path


def _open(path: str | Path, mode: str):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_golden(path: str | Path) -> dict[str, int]:
    """Load a kmer\tcount TSV into a dict."""
    counts: dict[str, int] = {}
    with _open(path, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            kmer, cnt = line.split("\t")
            counts[kmer] = int(cnt)
    return counts


def write_golden(path: str | Path, counts: dict[str, int], sort: bool = False) -> None:
    """Write counts in the reference TSV format (optionally kmer-sorted)."""
    items = sorted(counts.items()) if sort else counts.items()
    with _open(path, "wt") as fh:
        for kmer, cnt in items:
            fh.write(f"{kmer}\t{cnt}\n")
