"""count_unique (the exact batch histogram: sort, run flags, kernel 1's
plain version) against the JAX package's count_unique, on the same seeded
numpy keys.  Outputs are integers and booleans: exact equality over the
valid prefix (rows past n_unique are unspecified in both packages)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.ops.count import count_unique as jax_count_unique  # noqa: E402
from tsxcount_tpu_torch.config import KmerSpec  # noqa: E402
from tsxcount_tpu_torch.ops import count  # noqa: E402


def _keys(rng, p, k, vocab):
    """p random k-mers drawn from a vocabulary of `vocab` keys."""
    spec = KmerSpec(k)
    voc = rng.integers(0, 2**32, size=(vocab, spec.lanes), dtype=np.uint32)
    voc[:, -1] &= np.uint32(spec.top_lane_mask)
    return voc[rng.integers(0, vocab, p)]


def _check(kmers: np.ndarray, valid: np.ndarray, k: int):
    want = jax_count_unique(jnp.asarray(kmers), jnp.asarray(valid),
                            spec=JKmerSpec(k))
    got = count.count_unique(torch.from_numpy(kmers.view(np.int32)),
                             torch.from_numpy(valid), KmerSpec(k))
    n = int(want.n_unique)
    assert int(got.n_unique) == n
    np.testing.assert_array_equal(got.keys.numpy().view(np.uint32)[:n],
                                  np.asarray(want.keys)[:n])
    np.testing.assert_array_equal(got.counts.numpy()[:n],
                                  np.asarray(want.counts)[:n])
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    return got


@pytest.mark.parametrize("k,vocab", [(14, 300), (16, 300), (31, 2000),
                                     (33, 50), (112, 40)])
def test_count_unique_matches_jax(k, vocab):
    rng = np.random.default_rng(k)
    kmers = _keys(rng, 4096, k, vocab)
    valid = rng.random(4096) < 0.8
    got = _check(kmers, valid, k)
    assert int(got.counts[: int(got.n_unique)].sum()) == int(valid.sum())


def test_count_unique_columns_input():
    """The hot path hands lane columns straight from extract_kmer_cols."""
    rng = np.random.default_rng(4)
    kmers = _keys(rng, 1000, 33, 30)
    valid = rng.random(1000) < 0.5
    cols = [torch.from_numpy(np.ascontiguousarray(kmers[:, j]).view(np.int32))
            for j in range(kmers.shape[1])]
    a = count.count_unique(cols, torch.from_numpy(valid), KmerSpec(33))
    b = _check(kmers, valid, 33)
    assert torch.equal(a.keys, b.keys) and torch.equal(a.counts, b.counts)


def test_full_top_lane_flag_column():
    """k % 16 == 0: the flag is a separate operand, and a key word with its
    top bit set must sort as unsigned."""
    spec = KmerSpec(16)
    assert count.flag_ops(spec) == 2
    kmers = np.array([[0xFFFFFFFF], [0x80000000], [0x7FFFFFFF], [1],
                      [0x80000000], [0xFFFFFFFF]], np.uint32)
    got = _check(kmers, np.ones(6, bool), 16)
    np.testing.assert_array_equal(
        got.keys.numpy().view(np.uint32)[:4, 0],
        [1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])


def test_poly_t_not_confused_with_invalid():
    kmers = np.full((8, 1), 0xFFFFFFFF, np.uint32)
    valid = np.array([True] * 5 + [False] * 3)
    got = _check(kmers, valid, 16)
    assert int(got.n_unique) == 1 and int(got.counts[0]) == 5


@pytest.mark.parametrize("all_valid", [True, False])
def test_all_and_none_valid(all_valid):
    rng = np.random.default_rng(7)
    kmers = _keys(rng, 4096, 14, 9)
    got = _check(kmers, np.full(4096, all_valid), 14)
    want = len(np.unique(kmers, axis=0)) if all_valid else 0
    assert int(got.n_unique) == want


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    for k in (5, 16, 47, 112):
        spec = KmerSpec(k)
        kmers = torch.from_numpy(_keys(rng, 100, k, 100).view(np.int32))
        invalid = torch.from_numpy(rng.random(100) < 0.3)
        ops = count.pack_flag_key(kmers, invalid, spec)
        assert len(ops) == count.flag_ops(spec)
        back, inv = count.unpack_flag_key(ops, spec)
        assert torch.equal(back, kmers) and torch.equal(inv, invalid)
