"""Window extraction and interval validity: the port against the JAX
package on the same packed batches (seeded reads with N bases, packed by
the JAX package's packer, whose copy in the port must pack the identical
buffer).  All outputs are integers or booleans: exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tsxcount_tpu.config import BatchSpec as JBatchSpec, KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.io.packer import pack_reads as jax_pack_reads  # noqa: E402
from tsxcount_tpu.ops import window as jwin  # noqa: E402
from tsxcount_tpu_torch.config import BatchSpec, KmerSpec  # noqa: E402
from tsxcount_tpu_torch.io.packer import pack_reads  # noqa: E402
from tsxcount_tpu_torch.ops import window  # noqa: E402

from tests.test_packer import rand_reads  # noqa: E402


@pytest.mark.parametrize("k", [1, 7, 14, 16, 31, 33, 112])
def test_window_and_validity_match_jax(k):
    rng = np.random.default_rng(200 + k)
    reads = rand_reads(rng, 12, max(1, k - 3), 3 * k + 60, alphabet="ACGTN")
    jbatch = JBatchSpec(JKmerSpec(k), capacity_words=64)
    batch = BatchSpec(KmerSpec(k), capacity_words=64)
    tw = batch.total_words
    n = 0
    for jpb, pb in zip(jax_pack_reads(reads, jbatch), pack_reads(reads, batch),
                       strict=True):
        np.testing.assert_array_equal(pb.buf, jpb.buf)
        buf = torch.from_numpy(jpb.buf.view(np.int32))
        want_cols = jwin.extract_kmer_cols(jnp.asarray(jpb.words), jbatch)
        got_cols = window.extract_kmer_cols(buf[:tw], batch)
        assert len(got_cols) == len(want_cols) == KmerSpec(k).lanes
        for g, w in zip(got_cols, want_cols):
            np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                          np.asarray(w))
        np.testing.assert_array_equal(
            window.extract_kmers(buf[:tw], batch).numpy().view(np.uint32),
            np.asarray(jwin.extract_kmers(jnp.asarray(jpb.words), jbatch)),
        )
        want_valid = np.asarray(
            jwin.intervals_to_valid(jnp.asarray(jpb.buf[tw:]), jbatch))
        np.testing.assert_array_equal(
            window.intervals_to_valid(buf[tw:], batch).numpy(), want_valid)
        # the dense mask (debug / multi-chip wire format) agrees too
        vmask = torch.from_numpy(jpb.vmask.view(np.int32))
        np.testing.assert_array_equal(
            window.expand_vmask(vmask, batch).numpy(), want_valid)
        n += 1
    assert n >= 1


def test_top_lane_masked_and_sentinels():
    """Garbage above the key width never leaks into the top lane, and an
    all-sentinel interval list (0xFFFFFFFF = -1 as int32) is all invalid."""
    batch = BatchSpec(KmerSpec(14), capacity_words=8)
    words = torch.full((batch.total_words,), -1, dtype=torch.int32)
    cols = window.extract_kmer_cols(words, batch)
    assert int(cols[0].max()) == (1 << 28) - 1
    ivs = torch.full((2 * batch.max_intervals,), -1, dtype=torch.int32)
    assert not window.intervals_to_valid(ivs, batch).any()
