"""Bijective GF(2) matrix hash of multi-lane k-mer keys.

A 2k-bit key is multiplied by a random invertible 2k x 2k binary matrix
over GF(2): each output bit is the parity of (matrix row AND key).  The
inverse matrix lets the table rebuild k-mers from its slots.  The matrix
comes from seeded numpy, so a seed gives the same matrix here as in the
JAX package.

On the device the product is one matrix multiplication of 0/1 bit planes
followed by `& 1`.  PyTorch has no integer matmul on CUDA, so the planes are
float32: every dot product is an integer of at most 2k <= 254, which
float32 (and TF32, whose inputs here are 0 and 1) holds exactly.  Rows go
through in chunks so that the planes of a full batch never exist at once
(2^24 rows x 254 bits of float32 would be 17 GB).
"""

from __future__ import annotations

import numpy as np
import torch

from tsxcount_tpu_torch.config import KmerSpec
from tsxcount_tpu_torch.ops.lanes import pack_bits, unpack_bits

DEFAULT_SEED = 0x7C5C
_CHUNK_ROWS = 1 << 20


def _gf2_invert(a: np.ndarray) -> np.ndarray | None:
    """Invert a binary matrix over GF(2) (Gauss-Jordan); None if singular."""
    n = a.shape[0]
    aug = np.concatenate([a.astype(np.uint8) & 1, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivots = np.nonzero(aug[col:, col])[0]
        if pivots.size == 0:
            return None
        piv = col + int(pivots[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        rows = np.nonzero(aug[:, col])[0]
        rows = rows[rows != col]
        aug[rows] ^= aug[col]
    return aug[:, n:]


def random_invertible_gf2(bits: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Sample a random invertible GF(2) matrix and its inverse."""
    rng = np.random.default_rng(seed)
    while True:
        a = rng.integers(0, 2, size=(bits, bits), dtype=np.uint8)
        ai = _gf2_invert(a)
        if ai is not None:
            return a, ai


class GF2Hash:
    """Batched bijective hash over (N, lanes) int32 key bit patterns."""

    def __init__(self, spec: KmerSpec, seed: int = DEFAULT_SEED,
                 identity: bool = False):
        self.spec = spec
        self.bits = spec.bits
        self.identity = identity
        if identity:
            self.matrix = np.eye(self.bits, dtype=np.uint8)
            self.inverse = np.eye(self.bits, dtype=np.uint8)
        else:
            self.matrix, self.inverse = random_invertible_gf2(self.bits, seed)
        # transposed float32 copies (bits @ A^T), one per device
        self._mats: dict = {}

    def load(self, matrix: np.ndarray, inverse: np.ndarray) -> None:
        """Take these matrices (a checkpoint's: they define the table's
        layout) in place of the seeded ones."""
        self.matrix, self.inverse = matrix, inverse
        self._mats.clear()

    def _mat_t(self, which: str, dev: torch.device) -> torch.Tensor:
        key = (which, dev)
        if key not in self._mats:
            m = self.matrix if which == "apply" else self.inverse
            self._mats[key] = torch.from_numpy(
                m.T.astype(np.float32)).to(dev)
        return self._mats[key]

    def _apply(self, keys: torch.Tensor, which: str) -> torch.Tensor:
        if self.identity:
            return keys
        mat_t = self._mat_t(which, keys.device)
        out = torch.empty_like(keys)
        for lo in range(0, keys.shape[0], _CHUNK_ROWS):
            bits = unpack_bits(keys[lo : lo + _CHUNK_ROWS], self.bits,
                               dtype=torch.float32)
            hbits = (bits @ mat_t).to(torch.int32) & 1
            out[lo : lo + _CHUNK_ROWS] = pack_bits(hbits, self.spec.lanes)
        return out

    def apply(self, keys: torch.Tensor) -> torch.Tensor:
        """kmer lanes -> hash lanes (on the keys' device)."""
        return self._apply(keys, "apply")

    def inv_apply(self, hashes: torch.Tensor) -> torch.Tensor:
        """hash lanes -> kmer lanes (on the hashes' device)."""
        return self._apply(hashes, "inverse")

    # host mirrors (numpy uint32 keys)
    def _apply_host(self, keys: np.ndarray, mat: np.ndarray) -> np.ndarray:
        n, lanes = keys.shape
        sh = np.arange(32, dtype=np.uint32)
        bits = ((keys[:, :, None] >> sh) & 1).reshape(n, lanes * 32)[:, : self.bits]
        hbits = (bits.astype(np.int64) @ mat.T.astype(np.int64)) & 1
        pad = lanes * 32 - self.bits
        hb = np.concatenate([hbits, np.zeros((n, pad), np.int64)], axis=1)
        hb = hb.reshape(n, lanes, 32).astype(np.uint32)
        return np.bitwise_or.reduce(hb << sh, axis=2).astype(np.uint32)

    def apply_host(self, keys: np.ndarray) -> np.ndarray:
        return self._apply_host(keys, self.matrix)

    def inv_apply_host(self, hashes: np.ndarray) -> np.ndarray:
        return self._apply_host(hashes, self.inverse)
