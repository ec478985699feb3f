"""Streaming FASTQ/FASTA reader (gzip-transparent), pure Python fallback.

Mirrors the capability surface of the reference reader — format templating
over FASTQ (4-line records) and FASTA (header + sequence lines) with chunked
zlib inflation (reference src/fastxutils/FastXReader.h:118-478, gzip at
387-440) — but the hot path is the native C++ packer (io/native.py); this
module is the dependency-free fallback and the reference implementation for
tests.
"""

from __future__ import annotations

import gzip
import io
import itertools
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

GZIP_MAGIC = b"\x1f\x8b"


@dataclass
class SeqRecord:
    name: bytes
    seq: bytes


def open_maybe_gzip(path: str | Path) -> io.BufferedReader:
    fh = open(path, "rb")
    magic = fh.peek(2)[:2]
    if magic == GZIP_MAGIC:
        return io.BufferedReader(gzip.GzipFile(fileobj=fh))  # type: ignore[arg-type]
    return fh


def sniff_format(fh: io.BufferedReader) -> str:
    first = fh.peek(1)[:1]
    if first == b"@":
        return "fastq"
    if first == b">":
        return "fasta"
    raise ValueError(f"unrecognized FASTX leader byte: {first!r}")


def read_fastx(path: str | Path) -> Iterator[SeqRecord]:
    """Yield records from a FASTQ/FASTA file, gzip-transparent."""
    with open_maybe_gzip(path) as fh:
        fmt = sniff_format(fh)
        if fmt == "fastq":
            yield from _read_fastq(fh)
        else:
            yield from _read_fasta(fh)


def peek_read_lens(path: str | Path, n: int) -> list[int]:
    """Lengths of the first `n` records (for interval-budget sizing)."""
    return [len(rec.seq) for rec in itertools.islice(read_fastx(path), n)]


def _read_fastq(fh) -> Iterator[SeqRecord]:
    while True:
        header = fh.readline()
        if not header:
            return
        seq = fh.readline().rstrip(b"\r\n")
        plus = fh.readline()
        qual = fh.readline()
        if not header.startswith(b"@") or not plus.startswith(b"+"):
            raise ValueError("malformed FASTQ record")
        del qual
        yield SeqRecord(name=header[1:].rstrip(b"\r\n"), seq=seq)


def _read_fasta(fh) -> Iterator[SeqRecord]:
    name: bytes | None = None
    chunks: list[bytes] = []
    for line in fh:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if name is not None:
                yield SeqRecord(name=name, seq=b"".join(chunks))
            name = line[1:]
            chunks = []
        elif line:
            chunks.append(line)
    if name is not None:
        yield SeqRecord(name=name, seq=b"".join(chunks))
