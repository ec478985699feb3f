"""The mix-prefix extended key on the port's sort backend (ops/mix.py
mix_cols, extend_*, make_ext_spec; KmerCounter(mix_prefix=True)): the
mixing hash bit for bit, whole counts whose store states and sorted dumps
equal the JAX package's at k = 9, 31, 127 and 224 (canonical at 31), a
real prefix collision recounted, and the k = 225 ceiling.  Everything here
is integers: equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu.ops import mix as jmix  # noqa: E402
from tsxcount_tpu_torch import KmerCounter, KmerSpec  # noqa: E402
from tsxcount_tpu_torch.core.counter import PrefixCollision  # noqa: E402
from tsxcount_tpu_torch.ops.mix import (  # noqa: E402
    MIX_LANES,
    extend_cols,
    extend_keys,
    extend_keys_host,
    make_ext_spec,
    mix_cols,
    mix_cols_host,
    strip_mix,
)

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402

STORE_FIELDS = ("keys", "digits", "used", "n", "overflowed")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(
        np.int32))


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 14, 16, 18])
def test_mix_cols_match_jax(lanes):
    """mix_cols (torch, int64 arithmetic) and mix_cols_host equal the JAX
    package's mix_cols and mix_cols_host bit for bit, extremes included;
    the extended keys and strip_mix agree too."""
    keys = np.random.default_rng(lanes).integers(0, 2**32, (3000, lanes),
                                                 dtype=np.uint32)
    keys[0], keys[1] = 0, np.uint32(0xFFFFFFFF)
    jlo, jhi = jmix.mix_cols([jnp.asarray(keys[:, j]) for j in range(lanes)])
    want = (np.asarray(jlo), np.asarray(jhi))
    for got, ref in zip(mix_cols_host(keys), jmix.mix_cols_host(keys)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(mix_cols([_t(keys[:, j]) for j in range(lanes)]),
                        want):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    ext = jmix.extend_keys_host(keys)
    np.testing.assert_array_equal(extend_keys_host(keys), ext)
    np.testing.assert_array_equal(
        extend_keys(_t(keys)).numpy().view(np.uint32), ext)
    cols = extend_cols([_t(keys[:, j]) for j in range(lanes)])
    np.testing.assert_array_equal(
        torch.stack(cols, -1).numpy().view(np.uint32), ext)
    np.testing.assert_array_equal(strip_mix(ext), keys)
    assert ext.shape[1] == lanes + MIX_LANES


@pytest.mark.parametrize("k", [1, 9, 16, 31, 113, 127, 224])
def test_ext_spec_matches_jax(k):
    ext = make_ext_spec(KmerSpec(k))
    ref = jmix.make_ext_spec(JKmerSpec(k))
    assert (ext.k, ext.lanes, ext.top_lane_bits) == (
        ref.k, ref.lanes, ref.top_lane_bits)
    assert ext.lanes == KmerSpec(k).lanes + 2 and ext.top_lane_bits == 32


def test_k225_is_refused():
    with pytest.raises(ValueError, match="k <= 224"):
        make_ext_spec(KmerSpec(225))
    with pytest.raises(ValueError, match="k <= 224"):
        KmerCounter(k=225, l=8, mix_prefix=True, device="cpu")
    with pytest.raises(ValueError, match="k <= 224"):
        JKmerCounter(k=225, l=8, mix_prefix=True)
    assert KmerCounter(k=224, l=8, mix_prefix=True,
                       device="cpu").store.n_ops == 17


def _reads(rng, k, n=30, dups=8):
    """Reads of k to k + 80 bases, about one N in 4 max(8, k / 4) + 1,
    some repeated (counts above 1, across batches)."""
    reads = rand_reads(rng, n, k, k + 80,
                       alphabet="ACGT" * max(8, k // 4) + "N")
    return reads + [reads[i] for i in rng.integers(0, n, dups)]


@pytest.mark.parametrize("k,canonical", [(9, False), (31, False),
                                         (31, True), (127, False),
                                         (224, False)], ids=str)
def test_counter_matches_jax(k, canonical):
    """The same options resolved, sorted dumps, queries and store states
    of extended keys (rows [0, n): the JAX XLA merge leaves junk past n)
    as the JAX package's KmerCounter(mix_prefix=True)."""
    reads = _reads(np.random.default_rng(k + canonical), k)
    common = dict(l=11, batch_words=64, merge_every=3, lsm=False,
                  mix_prefix=True, canonical=canonical)
    ref = JKmerCounter(k=k, **common)
    ref.add_reads(reads)
    ref.finish()
    port = KmerCounter(k=k, device="cpu", **common)
    port.add_reads(reads)
    port.finish()
    assert port.mix_prefix and ref.mix_prefix
    assert port.hash_first is ref.hash_first is False  # also at k >= 113
    assert port.store_spec.lanes == ref.store_spec.lanes
    want = ref.to_dict()
    assert len(want) > 100
    assert port.to_dict() == want
    if not canonical:
        assert want == dict(naive_kmers(reads, k))
    assert list(port.items()) == list(ref.items())
    queries = list(want)[:30] + ["A" * k, "C" * (k - 1) + "G"]
    assert port.get_counts(queries) == ref.get_counts(queries)
    got = port.store.state_to_reference(port.state)
    n = int(ref.state.n)
    for f in STORE_FIELDS:
        a, b = np.asarray(got[f]), np.asarray(getattr(ref.state, f))
        if f in ("keys", "digits"):
            a, b = a[:n], b[:n]
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("kw,want_hash,want_mix", [
    (dict(k=127, mix_prefix=True), False, True),
    (dict(k=127, mix_prefix=None), "mix", False),
    (dict(k=31, mix_prefix=None), False, False),
    (dict(k=31, mix_prefix=True, backend="table"), False, False),
], ids=str)
def test_options_resolve_as_in_jax(kw, want_hash, want_mix):
    """mix_prefix keeps the lane mix's auto rule off; None leaves the
    extended key off (the JAX auto rule never engages); the table ignores
    it."""
    port = KmerCounter(l=8, device="cpu", **kw)
    ref = JKmerCounter(l=8, lsm=False, **kw)
    assert (port.hash_first, port.mix_prefix) == (want_hash, want_mix)
    assert (ref.hash_first, ref.mix_prefix) == (want_hash, want_mix)


def test_exclusive_with_hash_first():
    for hash_first in ("mix", "gf2", True):
        with pytest.raises(ValueError, match="exclusive"):
            KmerCounter(k=31, l=8, mix_prefix=True, hash_first=hash_first,
                        device="cpu")


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def test_real_prefix_collision_recounts(tmp_path, monkeypatch, capsys):
    """A prefix of one operand (the flag alone): distinct extended keys
    really collide, the flag fires, count_file recounts with the full
    sort and is exact; add_reads + finish raise PrefixCollision."""
    from tsxcount_tpu_torch.ops import count as count_mod

    monkeypatch.setattr(count_mod, "uniform_prefix_nk", lambda spec: 1)
    k = 31
    reads = _reads(np.random.default_rng(5), k, n=40)
    fastq = tmp_path / "r.fastq"
    _write_fastq(fastq, reads)
    c = KmerCounter(k=k, l=13, batch_words=64, merge_every=2,
                    mix_prefix=True, device="cpu")
    c.count_file(fastq, use_native=False)
    assert c._mix_full_sort and c.batches_processed > c.merge_every
    assert "recounting with the full-comparator sort" in (
        capsys.readouterr().err)
    want = dict(naive_kmers(reads, k))
    assert c.to_dict() == want and c.total_kmers == sum(want.values())
    stream = KmerCounter(k=k, l=13, batch_words=64, mix_prefix=True,
                         device="cpu")
    stream.add_reads(reads)
    with pytest.raises(PrefixCollision):
        stream.finish()
