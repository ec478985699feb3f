"""The plain reference: an exact k-mer count of a FASTQ file in numpy, and
the comparison that decides `correct`.

Frozen in the benchmark.  It imports nothing of the program, of `jax` or of
`tsxcount_tpu`, and takes nothing the program made: it reads the FASTQ file
that the benchmark wrote, and it reads the program's export only to judge
it.  Its window rules are those of the counter with `n_policy` drop and
no homopolymer collapse: a window is k consecutive bases of one read, each
of A, C, G or T in either case; any other byte ends it.  With `canonical`
a window counts as the lesser, in string order, of itself and its reverse
complement.

A key is held as ceil(k / 32) uint64 words, base j of the window at bits
2 (31 - j mod 32) of word j // 32 with A, C, G, T = 0, 1, 2, 3, so that
keys compare word by word as their strings do.  The program's layout does
not matter: its export is decoded from the k-mer strings.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i  # lower case
_NEWLINE = 10


def read_fastq(path: str | Path) -> np.ndarray:
    """The bytes of every sequence line of a 4-line FASTQ file, each line
    followed by its newline (which no window crosses)."""
    buf = np.fromfile(path, dtype=np.uint8)
    if buf.size and buf[-1] != _NEWLINE:
        buf = np.append(buf, np.uint8(_NEWLINE))
    ends = np.flatnonzero(buf == _NEWLINE)
    starts = np.concatenate([[0], ends[:-1] + 1])
    if len(ends) % 4 or (buf[starts[::4]] != ord("@")).any():
        raise ValueError(f"{path}: not a 4-line FASTQ file")
    mark = np.zeros(buf.size + 1, dtype=np.int8)
    mark[starts[1::4]] = 1
    mark[ends[1::4] + 1] = -1  # the newline stays in
    return buf[np.cumsum(mark[:-1], dtype=np.int8) > 0]


def window_starts(seq: np.ndarray, k: int) -> np.ndarray:
    """Indices into `seq` of every valid window."""
    bad = _CODE[seq] == 255
    c = np.concatenate([[0], np.cumsum(bad, dtype=np.int64)])
    return np.flatnonzero(c[k:] == c[:-k])


def window_keys(seq: np.ndarray, k: int, starts: np.ndarray,
                canonical: bool = False) -> np.ndarray:
    """Keys [n, words] uint64 of the windows at `starts`."""
    codes = _CODE[seq]
    codes = np.where(codes == 255, 0, codes).astype(np.uint64)
    fwd = _pack(codes, k, starts, lambda j: j)
    if not canonical:
        return fwd
    # base j of the reverse complement is the complement of base k - 1 - j
    rc = _pack(np.uint64(3) - codes, k, starts, lambda j: k - 1 - j)
    less = np.zeros(starts.size, dtype=bool)
    decided = np.zeros(starts.size, dtype=bool)
    for w in range(fwd.shape[1]):
        less |= ~decided & (rc[:, w] < fwd[:, w])
        decided |= rc[:, w] != fwd[:, w]
    fwd[less] = rc[less]
    return fwd


def _pack(codes: np.ndarray, k: int, starts: np.ndarray, src) -> np.ndarray:
    """Keys [n, words] of the windows at `starts` whose base j is
    `codes[start + src(j)]`."""
    n = codes.size - k + 1
    keys = np.empty((starts.size, (k + 31) // 32), dtype=np.uint64)
    word, tmp = (np.empty(max(n, 0), dtype=np.uint64) for _ in range(2))
    for w in range(keys.shape[1]):
        word[:] = 0
        for j in range(32 * w, min(k, 32 * w + 32)):
            i = src(j)
            np.left_shift(codes[i : i + n], np.uint64(62 - 2 * (j % 32)),
                          out=tmp)
            np.bitwise_or(word, tmp, out=word)
        keys[:, w] = word[starts]
    return keys


def rows(keys: np.ndarray) -> np.ndarray:
    """One comparable value a key: its word, or its words' bytes."""
    if keys.shape[1] == 1:
        return keys[:, 0]
    keys = np.ascontiguousarray(keys)
    return keys.view(np.dtype((np.void, keys.shape[1] * 8))).ravel()


def encode_kmers(blob: bytes, k: int) -> np.ndarray:
    """The `rows` of n k-mer strings joined into one blob."""
    codes = _CODE[np.frombuffer(blob, dtype=np.uint8)]
    if codes.size % k or (codes == 255).any():
        raise ValueError("an exported k-mer is not k bases of ACGT")
    codes = codes.reshape(-1, k)
    keys = np.zeros((codes.shape[0], (k + 31) // 32), dtype=np.uint64)
    for j in range(k):
        keys[:, j // 32] |= (codes[:, j].astype(np.uint64)
                             << np.uint64(62 - 2 * (j % 32)))
    return rows(keys)


def count_keys(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(distinct keys as `rows`, ascending; their counts)."""
    return np.unique(rows(keys), return_counts=True)


def reference_count(path: str | Path, k: int, canonical: bool = False
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The exact count of a FASTQ file: (distinct keys, counts int64)."""
    seq = read_fastq(path)
    return count_keys(window_keys(seq, k, window_starts(seq, k), canonical))


def control_count(path: str | Path, k: int, chunk_bases: int,
                  canonical: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The control: the reference with every window that straddles a seam
    between two chunks of `chunk_bases` bases of the read stream left out,
    as a feed that drops the k - 1 bases carried over from one batch to the
    next would count.  It breaks the guarantee that every window of every
    read is counted."""
    seq = read_fastq(path)
    starts = window_starts(seq, k)
    # position in the stream of bases, newlines taken out
    stream = starts - np.cumsum(seq == _NEWLINE)[starts]
    keep = stream // chunk_bases == (stream + k - 1) // chunk_bases
    return count_keys(window_keys(seq, k, starts[keep], canonical))


def compare(want: tuple[np.ndarray, np.ndarray],
            got: tuple[np.ndarray, np.ndarray]) -> dict[str, int]:
    """Numbers of the comparison of an export (keys as `rows`, counts)
    with the reference's (distinct keys, counts).  Each is 0 when the
    export is exact."""
    ref_keys, ref_counts = want
    got_rows, got_counts = got
    order = np.argsort(got_rows, kind="stable")
    got_rows, got_counts = got_rows[order], np.asarray(got_counts)[order]
    dup = np.zeros(got_rows.size, dtype=bool)
    dup[1:] = got_rows[1:] == got_rows[:-1]
    uniq, uniq_counts = got_rows[~dup], got_counts[~dup]
    both, ia, ib = np.intersect1d(ref_keys, uniq, assume_unique=True,
                                  return_indices=True)
    return {
        "missing": int(ref_keys.size - both.size),
        "extra": int(uniq.size - both.size),
        "wrong_count": int((ref_counts[ia] != uniq_counts[ib]).sum()),
        "duplicate": int(dup.sum()),
        "windows_off": abs(int(np.asarray(got_counts, dtype=np.int64).sum())
                           - int(ref_counts.sum())),
    }
