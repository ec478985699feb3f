"""Canonical k-mers in the port (ops/canonical.py and canonical=True in the
counter) against the JAX package's functions and counters and a Python
count of string minima, at the lane-boundary k values.  Exact."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu.ops.canonical import (  # noqa: E402
    canonicalize as j_canonicalize,
    reverse_complement as j_reverse_complement,
)
from tsxcount_tpu_torch import KmerCounter, KmerSpec  # noqa: E402
from tsxcount_tpu_torch.ops.canonical import (  # noqa: E402
    canonicalize,
    canonicalize_cols,
    reverse_complement,
)

from tests.test_hp_collapse import _hp_reads  # noqa: E402
from tests.test_packer import rand_reads  # noqa: E402

LANE_BOUNDARY_K = (1, 15, 16, 17, 31, 32, 33, 63, 64, 127, 128, 256)
_COMP = str.maketrans("ACGT", "TGCA")


def _canonical_counts(reads, k):
    """Python reference: the string minimum of each window and its
    reverse complement (windows with a non-ACGT base skipped)."""
    out = collections.Counter()
    for seq in reads:
        for i in range(len(seq) - k + 1):
            w = seq[i : i + k]
            if all(c in "ACGT" for c in w):
                out[min(w, w.translate(_COMP)[::-1])] += 1
    return out


@pytest.mark.parametrize("k", LANE_BOUNDARY_K)
def test_reverse_complement_and_canonicalize_match_jax(k):
    spec = KmerSpec(k)
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 2**32, size=(700, spec.lanes), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    keys[:, -1] &= np.uint32(spec.top_lane_mask)
    keys[0] = 0  # all-A: its revcomp is all-T
    keys[1] = keys[0] ^ np.uint32(0xFFFFFFFF)
    keys[1, -1] &= np.uint32(spec.top_lane_mask)
    t = torch.from_numpy(keys.view(np.int32))
    rc = reverse_complement(t, spec).numpy().view(np.uint32)
    want_rc = np.asarray(j_reverse_complement(jnp.asarray(keys),
                                              JKmerSpec(k)))
    np.testing.assert_array_equal(rc, want_rc)
    can = canonicalize(t, spec).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        can, np.asarray(j_canonicalize(jnp.asarray(keys), JKmerSpec(k))))
    # an involution, and the column form agrees with the stacked one
    back = reverse_complement(torch.from_numpy(rc.view(np.int32)), spec)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), keys)
    cols = canonicalize_cols(list(t.unbind(-1)), spec)
    np.testing.assert_array_equal(
        torch.stack(cols, -1).numpy().view(np.uint32), can)


@pytest.mark.parametrize("backend,k", [
    ("sort", 14), ("sort", 31), ("sort", 127),
    ("table", 14), ("table", 31), ("table", 127),
], ids=str)
def test_canonical_counter_matches_jax(backend, k):
    rng = np.random.default_rng(100 + k)
    reads = rand_reads(rng, 30, max(1, k - 5), 2 * k + 60, alphabet="ACGTN")
    kw = dict(k=k, l=12, backend=backend, batch_words=64, merge_every=2,
              canonical=True)
    port = KmerCounter(device="cpu", **kw)
    ref = JKmerCounter(**kw)
    for c in (port, ref):
        c.add_reads(reads)
        c.finish()
    want = _canonical_counts(reads, k)
    assert port.to_dict() == ref.to_dict() == dict(want)
    assert port.total_kmers == ref.total_kmers == sum(want.values())
    # the stored state too: at k=127 the sort backend holds the lane-mix
    # images of the canonical keys, the table its slot words
    if backend == "sort":
        assert port.hash_first == ref.hash_first
        got = port.store.state_to_reference(port.state)
        n = int(got["n"])
        assert n == int(ref.state.n)
        for f in ("keys", "digits"):
            np.testing.assert_array_equal(
                got[f][:n], np.asarray(getattr(ref.state, f))[:n])
    else:
        got = port.table.state_to_reference(port.state)
        for f, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(getattr(ref.state,
                                                                f)))
    # both spellings of a k-mer see its canonical count
    queries = list(want)[:20]
    rcs = [q.translate(_COMP)[::-1] for q in queries]
    assert port.get_counts(queries) == port.get_counts(rcs) == \
        ref.get_counts(rcs) == [want[q] for q in queries]


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_canonical_hp_collapse_matches_jax(backend):
    """Homopolymer collapse with canonical keys: the all-A and all-T bonus
    fold into the all-A key, and both spellings answer with it."""
    rng = np.random.default_rng(3)
    k = 9
    reads = _hp_reads(rng, k=k)
    kw = dict(k=k, l=14, backend=backend, batch_words=256, canonical=True,
              collapse_homopolymers=True)
    port = KmerCounter(device="cpu", **kw)
    ref = JKmerCounter(**kw)
    for c in (port, ref):
        c.add_reads(reads)
        c.finish()
    assert sum(port.packer.stats.hp_bonus) > 0
    assert port.packer.stats.hp_bonus == ref.packer.stats.hp_bonus
    want = _canonical_counts(reads, k)
    assert port.to_dict() == ref.to_dict() == dict(want)
    assert port.total_kmers == ref.total_kmers
    polys = [c * k for c in "ACGT"]
    assert port.get_counts(polys) == ref.get_counts(polys)
    assert port.get_counts(["A" * k])[0] == port.get_counts(["T" * k])[0]
