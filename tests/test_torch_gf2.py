"""The port's GF(2) hash and bit-plane helpers against the JAX package's, on
seeded keys.  All values are integer bit patterns: exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.ops import lanes as jlanes  # noqa: E402
from tsxcount_tpu.ops.gf2 import GF2Hash as JGF2Hash  # noqa: E402
from tsxcount_tpu_torch import GF2Hash  # noqa: E402
from tsxcount_tpu_torch.config import KmerSpec  # noqa: E402
from tsxcount_tpu_torch.ops import gf2  # noqa: E402
from tsxcount_tpu_torch.ops.lanes import pack_bits, unpack_bits  # noqa: E402


def _keys(k: int, n: int, seed: int) -> np.ndarray:
    spec = KmerSpec(k)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=(n, spec.lanes), dtype=np.uint32)
    keys[:, -1] &= np.uint32(spec.top_lane_mask)
    keys[:3] = 0
    keys[1, :] = np.uint32(0xFFFFFFFF)
    keys[1, -1] = np.uint32(spec.top_lane_mask)
    return keys


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("k,seed", [(14, gf2.DEFAULT_SEED), (33, 5),
                                    (127, 11)])
def test_same_seed_same_matrix(k, seed):
    port, ref = GF2Hash(KmerSpec(k), seed=seed), JGF2Hash(JKmerSpec(k),
                                                          seed=seed)
    assert np.array_equal(port.matrix, ref.matrix)
    assert np.array_equal(port.inverse, ref.inverse)
    eye = (port.matrix.astype(np.int64) @ port.inverse.astype(np.int64)) & 1
    assert np.array_equal(eye, np.eye(2 * k, dtype=np.int64))


@pytest.mark.parametrize("k", [14, 16, 31, 33, 127])
def test_apply_and_inverse_match_jax(k):
    keys = _keys(k, 500, k)
    port, ref = GF2Hash(KmerSpec(k)), JGF2Hash(JKmerSpec(k))
    h = port.apply(_t(keys)).numpy().view(np.uint32)
    assert np.array_equal(h, np.asarray(ref.apply(jnp.asarray(keys))))
    back = port.inv_apply(_t(h)).numpy().view(np.uint32)
    assert np.array_equal(
        back, np.asarray(ref.inv_apply(jnp.asarray(h))))
    assert np.array_equal(back, keys)  # round trip


def test_apply_chunks_rows(monkeypatch):
    """Rows beyond one chunk hash as they do in one piece."""
    keys = _keys(31, 700, 3)
    port = GF2Hash(KmerSpec(31))
    whole = port.apply(_t(keys))
    monkeypatch.setattr(gf2, "_CHUNK_ROWS", 64)
    assert torch.equal(port.apply(_t(keys)), whole)


def test_identity_and_host_mirrors():
    keys = _keys(33, 200, 9)
    ident = GF2Hash(KmerSpec(33), identity=True)
    assert torch.equal(ident.apply(_t(keys)), _t(keys))
    assert np.array_equal(ident.apply_host(keys), keys)
    port, ref = GF2Hash(KmerSpec(33), seed=4), JGF2Hash(JKmerSpec(33), seed=4)
    h = port.apply_host(keys)
    assert np.array_equal(h, ref.apply_host(keys))
    assert np.array_equal(h, port.apply(_t(keys)).numpy().view(np.uint32))
    assert np.array_equal(port.inv_apply_host(h), keys)


@pytest.mark.parametrize("nbits,lanes", [(28, 1), (62, 2), (64, 2),
                                         (254, 8)])
def test_bit_planes_match_jax(nbits, lanes):
    rng = np.random.default_rng(nbits)
    keys = rng.integers(0, 2**32, size=(40, lanes), dtype=np.uint32)
    top = nbits - 32 * (lanes - 1)
    keys[:, -1] &= np.uint32((1 << top) - 1)
    bits = unpack_bits(_t(keys), nbits)
    want = np.asarray(jlanes.unpack_bits(jnp.asarray(keys), nbits))
    assert np.array_equal(bits.numpy(), want.astype(np.int32))
    assert np.array_equal(pack_bits(bits, lanes).numpy().view(np.uint32),
                          np.asarray(jlanes.pack_bits(jnp.asarray(want),
                                                      lanes)))
    assert np.array_equal(pack_bits(bits, lanes).numpy().view(np.uint32),
                          keys)
