"""The port's LSM store (core/lsm.py) against the flat store, a Python
count and the JAX package's LSMStore: dumps, lookups, and every level's
state after every flush (cascades included).  Counts are integers: exact."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu.core.lsm import LSMStore as JLSMStore  # noqa: E402
from tsxcount_tpu.ops.count import count_unique as j_count_unique  # noqa: E402
from tsxcount_tpu_torch import CountStore, KmerCounter, KmerSpec  # noqa: E402
from tsxcount_tpu_torch.core import checkpoint  # noqa: E402
from tsxcount_tpu_torch.core.lsm import LSMStore  # noqa: E402
from tsxcount_tpu_torch.ops.count import count_unique  # noqa: E402

from tests.test_packer import rand_reads  # noqa: E402

CPU = "cpu"


def _stream_batches(rng, spec, n_batches, p, vocab):
    vocab_keys = rng.integers(0, 2**32, size=(vocab, spec.lanes),
                              dtype=np.uint32)
    vocab_keys[:, -1] &= spec.top_lane_mask
    for _ in range(n_batches):
        idx = rng.integers(0, vocab, size=p)
        valid = rng.random(p) < 0.9
        yield vocab_keys[idx], valid


def _hist(kmers, valid, spec):
    uc = count_unique(torch.from_numpy(kmers.view(np.int32)),
                      torch.from_numpy(valid), spec)
    return uc.keys[None], uc.counts[None], uc.valid[None]


def _expected(expected, kmers, valid):
    for row, ok in zip(kmers.tolist(), valid.tolist()):
        if ok:
            expected[tuple(row)] += 1


def _assert_levels_equal(port_store, port_states, jax_states, tag=""):
    """Every level's JAX store-state fields, rows [0, n) (the JAX XLA merge
    leaves junk past n)."""
    assert len(port_states) == len(jax_states)
    for i, (lvl, st, jst) in enumerate(zip(port_store.levels, port_states,
                                           jax_states)):
        got = lvl.state_to_reference(st)
        n = int(got["n"])
        assert n == int(jst.n), (tag, i)
        assert bool(got["overflowed"]) == bool(jst.overflowed), (tag, i)
        np.testing.assert_array_equal(got["used"], np.asarray(jst.used))
        np.testing.assert_array_equal(got["keys"][:n],
                                      np.asarray(jst.keys)[:n])
        np.testing.assert_array_equal(got["digits"][:n],
                                      np.asarray(jst.digits)[:n])


@pytest.mark.parametrize("growth,n_batches", [(2, 9), (3, 14)])
def test_lsm_matches_flat_store(growth, n_batches):
    spec = KmerSpec(21)
    p = 256
    rng = np.random.default_rng(5)
    flat = CountStore(spec, 4096, CPU)
    lsm = LSMStore(spec, 4096, p, growth=growth, device=CPU)
    assert len(lsm.levels) >= 3  # a real cascade
    fs, ls = flat.init_state(), lsm.init_state()
    expected = collections.Counter()
    for kmers, valid in _stream_batches(rng, spec, n_batches, p, vocab=700):
        _expected(expected, kmers, valid)
        h = _hist(kmers, valid, spec)
        fs = flat.merge_stacked(fs, *h)
        ls = lsm.merge_stacked(ls, *h)
    with pytest.raises(RuntimeError, match="collapse"):
        lsm.to_host(ls)
    ls = lsm.collapse(ls)
    fk, fc, fn = flat.to_host(fs)
    lk, lc, ln = lsm.to_host(ls)
    assert ln == fn == len(expected)
    np.testing.assert_array_equal(lk, fk)
    np.testing.assert_array_equal(lc, fc)
    assert {tuple(k): int(c) for k, c in zip(lk.tolist(), lc)} == dict(expected)


@pytest.mark.parametrize("growth,n_batches", [(2, 9), (3, 14)])
def test_lsm_levels_match_jax_after_every_flush(growth, n_batches):
    """After each merge_stacked (every cascade step included) and after
    the collapse, each level's state equals the JAX LSMStore's."""
    spec = KmerSpec(21)
    p = 256
    rng = np.random.default_rng(9)
    port = LSMStore(spec, 4096, p, growth=growth, device=CPU)
    ref = JLSMStore(JKmerSpec(21), 4096, base_capacity=p * growth,
                    growth=growth)  # the JAX counter's L0: growth flushes
    assert [lv.capacity for lv in port.levels] == [
        lv.capacity for lv in ref.levels]
    ps, rs = port.init_state(), ref.init_state()
    for i, (kmers, valid) in enumerate(
            _stream_batches(rng, spec, n_batches, p, vocab=900)):
        ps = port.merge_stacked(ps, *_hist(kmers, valid, spec))
        uc = j_count_unique(jnp.asarray(kmers), jnp.asarray(valid),
                            spec=JKmerSpec(21))
        rs = ref.merge_stacked(rs, uc.keys[None], uc.counts[None],
                               uc.valid[None])
        _assert_levels_equal(port, ps, rs, f"flush {i + 1}")
    assert port.absorbs >= 2  # cascades ran during the stream
    _assert_levels_equal(port, port.collapse(ps), ref.collapse(rs),
                         "collapse")


def test_lsm_lookup_without_collapse():
    spec = KmerSpec(14)
    p = 128
    rng = np.random.default_rng(11)
    lsm = LSMStore(spec, 2048, p, growth=2, device=CPU)
    ls = lsm.init_state()
    expected = collections.Counter()
    for kmers, valid in _stream_batches(rng, spec, 5, p, vocab=60):
        _expected(expected, kmers, valid)
        ls = lsm.merge_stacked(ls, *_hist(kmers, valid, spec))
    queries = np.array(sorted(expected), dtype=np.uint32)
    counts, found = lsm.lookup(ls, torch.from_numpy(queries.view(np.int32)))
    assert bool(found.all())
    assert counts.tolist() == [expected[tuple(q)] for q in queries.tolist()]


def _reads(seed, n=60, lo=30, hi=90):
    return rand_reads(np.random.default_rng(seed), n, lo, hi)


def test_counter_lsm_end_to_end_matches_flat():
    reads = _reads(3)
    kw = dict(k=11, l=14, batch_words=64, merge_every=1)
    flat = KmerCounter(device=CPU, lsm=False, **kw)
    lsmc = KmerCounter(device=CPU, lsm=True, lsm_growth=2, **kw)
    ref = JKmerCounter(lsm=True, lsm_growth=2, **kw)
    assert lsmc.lsm and ref.lsm
    for c in (flat, lsmc, ref):
        c.add_reads(reads)
        c.finish()
    assert lsmc.distinct == flat.distinct == ref.distinct
    assert lsmc.to_dict() == flat.to_dict() == ref.to_dict()
    assert lsmc.stats()["lsm"] is True and flat.stats()["lsm"] is False


def test_counter_lsm_fallback_when_capacity_small():
    kw = dict(k=11, l=10, batch_words=64, lsm=True, lsm_growth=8)
    c = KmerCounter(device=CPU, **kw)
    assert not c.lsm and not JKmerCounter(**kw).lsm  # capacity <= L0
    assert isinstance(c.store, CountStore)


@pytest.mark.parametrize("kw,engaged", [
    (dict(k=11, l=20, batch_words=64, merge_every=1), True),
    (dict(k=11, l=14, batch_words=64, merge_every=4), False),
    (dict(k=11, l=20, batch_words=64, merge_every=1, lsm_growth=4), True),
    (dict(k=14, l=8), False),
], ids=str)
def test_counter_lsm_auto_rule_matches_jax(kw, engaged):
    """lsm=None applies the JAX package's rule, capacity * (growth-1) >
    growth^2 * flush rows, with the same levels."""
    port = KmerCounter(device=CPU, **kw)
    ref = JKmerCounter(**kw)
    assert port.lsm is ref.lsm is engaged
    assert port.stats()["lsm"] is engaged
    if engaged:
        assert [lv.capacity for lv in port.store.levels] == [
            lv.capacity for lv in ref.store.levels]


def test_counter_lsm_auto_rule_at_default_geometry(monkeypatch):
    """The counter's defaults (k=14, l=26, batch_words 2^16, merge_every 4)
    engage the LSM store with levels 2^25 and 2^26 in both packages;
    constructed only, with the stores' allocations stubbed out."""
    from tsxcount_tpu.core import store as jstore

    monkeypatch.setattr(CountStore, "init_state", lambda self: None)
    monkeypatch.setattr(jstore.CountStore, "init_state", lambda self: None)
    port = KmerCounter(k=14, device=CPU)
    ref = JKmerCounter(k=14)
    assert port.lsm is ref.lsm is True
    caps = [lv.capacity for lv in port.store.levels]
    assert caps == [lv.capacity for lv in ref.store.levels] == [2**25, 2**26]
    flat = KmerCounter(k=14, batch_words=1 << 20, device=CPU)  # CLI default
    assert flat.lsm is JKmerCounter(k=14, batch_words=1 << 20).lsm is False


def test_counter_lsm_auto_engages_end_to_end():
    reads = ["".join(np.random.default_rng(3).choice(list("ACGT"), size=70))
             for _ in range(60)]
    kw = dict(k=11, l=20, batch_words=64, merge_every=1)
    big = KmerCounter(device=CPU, **kw)
    flat = KmerCounter(device=CPU, lsm=False, **kw)
    assert big.lsm and not flat.lsm
    for c in (big, flat):
        c.add_reads(reads)
        c.finish()
    assert big.to_dict() == flat.to_dict()


def test_lsm_growth_below_2_raises():
    with pytest.raises(ValueError, match="lsm_growth"):
        KmerCounter(k=11, l=14, lsm_growth=1, device=CPU)
    with pytest.raises(ValueError, match="growth"):
        LSMStore(KmerSpec(11), 4096, 256, growth=1, device=CPU)


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def test_counter_lsm_partial_first_flush_and_reset(tmp_path):
    """A first file shorter than one flush (merge_every=4 batches), then a
    longer one: the cascade schedule, so every level, stays the JAX
    package's (which pads each flush to merge_every histograms); reset()
    restarts it."""
    rng = np.random.default_rng(21)
    short, long = tmp_path / "short.fastq", tmp_path / "long.fastq"
    _write_fastq(short, rand_reads(rng, 6, 40, 60))
    _write_fastq(long, rand_reads(rng, 90, 40, 90))
    kw = dict(k=12, l=14, batch_words=32, merge_every=4, lsm=True,
              lsm_growth=2, read_len_hint=40)
    port = KmerCounter(device=CPU, **kw)
    ref = JKmerCounter(**kw)
    assert port.lsm and ref.lsm and len(port.store.levels) >= 3
    for path in (short, long):
        port.count_file(path, use_native=True)
        ref.count_file(path, use_native=False)
        _assert_levels_equal(port.store, port.state, ref.state, path.name)
    assert port.store.absorbs >= 2
    assert port.to_dict() == ref.to_dict()
    port.reset()
    ref.reset()
    port.count_file(long, use_native=True)
    ref.count_file(long, use_native=False)
    _assert_levels_equal(port.store, port.state, ref.state, "after reset")


def test_counter_lsm_lane_mix_k127():
    """k=127 engages the lane mix, with the LSM store: the levels hold
    the images, the export maps them back."""
    reads = _reads(13, n=40, lo=130, hi=220)
    kw = dict(k=127, l=13, batch_words=64, merge_every=1, lsm=True,
              lsm_growth=2)
    port = KmerCounter(device=CPU, **kw)
    ref = JKmerCounter(**kw)
    assert port.lsm and ref.lsm and port.hash_first == ref.hash_first == "mix"
    for c in (port, ref):
        c.add_reads(reads)
        c.finish()
    _assert_levels_equal(port.store, port.state, ref.state)
    assert port.store.absorbs >= 2
    assert port.to_dict() == ref.to_dict()


def test_lsm_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(8)
    base = np.array(list("ACGT"))
    reads = ["".join(base[rng.integers(0, 4, size=50)]) for _ in range(30)]
    c = KmerCounter(k=9, l=13, batch_words=64, merge_every=1, lsm=True,
                    lsm_growth=2, device=CPU)
    assert c.lsm
    c.add_reads(reads)
    c.finish()
    want = c.to_dict()
    path = tmp_path / "lsm.npz"
    checkpoint.save_counter(c, path)
    c2 = checkpoint.load_counter(path, batch_words=64, device=CPU)
    assert c2.lsm and c2.to_dict() == want
