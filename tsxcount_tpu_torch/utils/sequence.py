"""Host-side sequence <-> 2-bit code conversions (numpy).

Bit layout matches the reference encoder exactly: base i of a sequence is
stored at bits [2i, 2i+1] (little-endian within the k-mer) with
A=00, C=01, G=10, T=11 (reference src/utils/SequenceUtils.h:86-160, decode at
47-84).  Non-ACGT bases get code 0 here plus an `invalid` flag — the
reference instead substitutes *random* bits (SequenceUtils.h:126-137), a
nondeterminism this framework only emulates behind an explicit
`n_policy="random"` option.
"""

from __future__ import annotations

import codecs

import numpy as np

from tsxcount_tpu_torch.config import BASES_PER_WORD, KmerSpec

# ASCII -> 2-bit code lookup; 255 marks invalid.
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _CODE_LUT[_b] = _c
    _CODE_LUT[ord(chr(_b).lower())] = _c

_BASE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
# byte -> the letters of its 4 bases (base j at bits [2j, 2j+1]) as one
# little-endian uint32
_BYTE_LETTERS = np.ascontiguousarray(
    _BASE_LUT[(np.arange(256)[:, None] >> 2 * np.arange(4)) & 3]
).view("<u4").ravel()
_DECODE_ROWS = 1 << 16  # rows a block of kmers_to_strings


def encode_bases(seq: str | bytes) -> tuple[np.ndarray, np.ndarray]:
    """Encode a sequence to (codes uint8 in 0..3, invalid bool) arrays."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _CODE_LUT[raw]
    invalid = codes == 255
    codes = np.where(invalid, np.uint8(0), codes)
    return codes, invalid


def decode_bases(codes: np.ndarray) -> str:
    """Decode 2-bit codes (0..3) back to an ACGT string."""
    return _BASE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def pack_codes(codes: np.ndarray, out_words: int | None = None) -> np.ndarray:
    """Pack base codes into uint32 words, 16 bases per word, LSB-first.

    Vectorized equivalent of UBigInt bit packing for the 2-bit alphabet
    (reference src/tsxutils/UBigInt.h:1012-1122 `copy_content_to_array`).
    """
    n = len(codes)
    nwords = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    if out_words is None:
        out_words = nwords
    padded = np.zeros(out_words * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    lanes = padded.reshape(out_words, BASES_PER_WORD)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)


def unpack_words(words: np.ndarray, n_bases: int) -> np.ndarray:
    """Inverse of pack_codes: uint32 words -> base codes uint8."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    codes = ((words[:, None] >> shifts) & 3).reshape(-1)
    return codes[:n_bases].astype(np.uint8)


def string_to_kmer(kmer: str, spec: KmerSpec) -> np.ndarray:
    """Encode a k-length string into its uint32 lane representation."""
    if len(kmer) != spec.k:
        raise ValueError(f"expected length {spec.k}, got {len(kmer)}")
    codes, invalid = encode_bases(kmer)
    if invalid.any():
        raise ValueError(f"non-ACGT base in kmer {kmer!r}")
    return pack_codes(codes, out_words=spec.lanes)


def strings_to_kmers(kmers: list[str] | np.ndarray, spec: KmerSpec) -> np.ndarray:
    """Vectorized batch version of string_to_kmer -> (N, lanes) uint32."""
    if len(kmers) == 0:
        return np.zeros((0, spec.lanes), dtype=np.uint32)
    joined = "".join(kmers) if not isinstance(kmers, np.ndarray) else "".join(kmers.tolist())
    codes, invalid = encode_bases(joined)
    if invalid.any():
        raise ValueError("non-ACGT base in kmer batch")
    n = len(kmers)
    codes = codes.reshape(n, spec.k)
    # pad each row to lanes*16 bases and pack per row
    padded = np.zeros((n, spec.lanes * BASES_PER_WORD), dtype=np.uint32)
    padded[:, : spec.k] = codes
    lanes = padded.reshape(n, spec.lanes, BASES_PER_WORD)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, None, :]
    return np.bitwise_or.reduce(lanes << shifts, axis=2).astype(np.uint32)


def kmer_to_string(lanes: np.ndarray, spec: KmerSpec) -> str:
    """Decode a (lanes,) uint32 key back to its ACGT string."""
    codes = unpack_words(np.asarray(lanes, dtype=np.uint32), spec.k)
    return decode_bases(codes)


def kmers_to_strings(keys: np.ndarray, spec: KmerSpec) -> list[str]:
    """Vectorized batch decode of (N, lanes) uint32 keys -> ACGT strings.

    One table lookup a key byte gives the letters of its 4 bases, so a row
    of lanes words decodes to lanes x 16 letters, of which the first k are
    the k-mer.  Rows go in blocks of _DECODE_ROWS: no intermediate grows
    with N."""
    keys = np.asarray(keys, dtype="<u4")
    k, width = spec.k, keys.shape[-1] * BASES_PER_WORD
    out: list[str] = []
    for off in range(0, keys.shape[0], _DECODE_ROWS):
        block = np.ascontiguousarray(keys[off : off + _DECODE_ROWS])
        text, _ = codecs.ascii_decode(_BYTE_LETTERS[block.view(np.uint8)])
        out.extend([text[i : i + k] for i in range(0, len(text), width)])
    return out
