"""Wide keys on the port's sort backend: the lane-mix bijection, the
uniform-prefix dedupe with its collision flag, and whole counts at k =
113-256 (and hash_first at k = 31, 63), each against the JAX package on the
same seeded inputs.  Everything here is integers: equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu.ops.count import uniform_prefix_nk as j_prefix_nk  # noqa: E402
from tsxcount_tpu.ops.mix import LaneMixBijection as JLaneMix  # noqa: E402
from tsxcount_tpu_torch import KmerCounter, KmerSpec  # noqa: E402
from tsxcount_tpu_torch.core import counter as counter_mod  # noqa: E402
from tsxcount_tpu_torch.core.counter import PrefixCollision  # noqa: E402
from tsxcount_tpu_torch.ops.count import (  # noqa: E402
    count_unique,
    uniform_prefix_nk,
)
from tsxcount_tpu_torch.ops.mix import (  # noqa: E402
    LaneMixBijection,
    lane_mix,
    lane_mix_plain,
)

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402

MIX_KS = [7, 14, 16, 31, 32, 63, 113, 127, 128, 200, 256]
STORE_FIELDS = ("keys", "digits", "used", "n", "overflowed")


def _keys(rng, n, spec):
    keys = rng.integers(0, 2**32, (n, spec.lanes), dtype=np.uint32)
    keys[:, -1] &= np.uint32(spec.top_lane_mask)
    return keys


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("k", MIX_KS)
def test_lane_mix_matches_jax(k):
    """apply, inverse and their host twins equal the JAX package's bit for
    bit; apply_cols equals apply; the round trip is the identity; images
    stay inside the 2k-bit key space."""
    spec = KmerSpec(k)
    keys = _keys(np.random.default_rng(k), 2000, spec)
    keys[0] = 0
    keys[1] = np.uint32(0xFFFFFFFF)
    keys[1, -1] = np.uint32(spec.top_lane_mask)
    ref = JLaneMix(JKmerSpec(k))
    mix = LaneMixBijection(spec)
    want = np.asarray(ref.apply(jnp.asarray(keys)))
    np.testing.assert_array_equal(ref.apply_host(keys), want)
    np.testing.assert_array_equal(mix.apply_host(keys), want)
    got = mix.apply(_t(keys)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    cols = mix.apply_cols([_t(keys[:, j]) for j in range(spec.lanes)])
    np.testing.assert_array_equal(
        torch.stack(cols, -1).numpy().view(np.uint32), want)
    assert (want[:, -1] & ~np.uint32(spec.top_lane_mask) == 0).all()
    np.testing.assert_array_equal(mix.inv_apply_host(want), keys)
    np.testing.assert_array_equal(
        mix.inv_apply(_t(want)).numpy().view(np.uint32), keys)
    np.testing.assert_array_equal(
        np.asarray(ref.inv_apply(jnp.asarray(want))), keys)
    assert len(np.unique(want, axis=0)) == len(np.unique(keys, axis=0))


def test_lane_mix_wrapper_checks_columns():
    mix = LaneMixBijection(KmerSpec(127))
    cols = [torch.zeros(8, dtype=torch.int32) for _ in range(8)]
    with pytest.raises(ValueError):  # one column per lane
        lane_mix(cols[:7], mix)
    with pytest.raises(TypeError):  # int32 bit patterns
        lane_mix([c.long() for c in cols], mix)
    with pytest.raises(ValueError):  # only CPU (plain) or CUDA (kernel)
        lane_mix([c.to("meta") for c in cols], mix)
    assert all(map(torch.equal, lane_mix(cols, mix),
                   lane_mix_plain(cols, mix)))


@pytest.mark.parametrize("k", [31, 33, 63, 65, 97, 113, 117, 121, 127, 128,
                               200, 224, 256])
def test_uniform_prefix_nk_covers_64_bits(k):
    spec = KmerSpec(k)
    nk = uniform_prefix_nk(spec)
    key_bits_top = spec.top_lane_bits if spec.top_lane_bits < 32 else 0
    assert key_bits_top + 32 * (nk - 1) >= 64
    assert nk == j_prefix_nk(JKmerSpec(k))


def test_narrow_top_lane_prefix_no_false_collision():
    """k=113 (2-bit top lane): two distinct keys whose images agree on the
    top 34 bits and differ just below are sorted apart, with no flag."""
    spec = KmerSpec(113)
    mix = LaneMixBijection(spec)
    img = np.zeros((2, 8), np.uint32)
    img[:, 7] = 1
    img[:, 6] = 0xDEADBEEF
    img[0, 5], img[1, 5] = 1, 2
    img[:, 0] = 7
    raw = mix.inv_apply_host(img)
    assert not np.array_equal(raw[0], raw[1])
    cols = mix.apply_cols([_t(raw[:, j]) for j in range(8)])
    uc = count_unique(cols, torch.ones(2, dtype=torch.bool), spec,
                      uniform_prefix=True)
    assert not bool(uc.collided) and int(uc.n_unique) == 2


def test_k113_uniform_prefix_bulk_exact():
    """2^16 random keys at k=113, each twice, through the image prefix
    sort: no flag, and the histogram equals a host dedupe."""
    spec = KmerSpec(113)
    mix = LaneMixBijection(spec)
    n = 1 << 16
    raw = _keys(np.random.default_rng(11), n, spec)
    raw[n // 2 :] = raw[: n // 2]
    cols = mix.apply_cols([_t(raw[:, j]) for j in range(8)])
    uc = count_unique(cols, torch.ones(n, dtype=torch.bool), spec,
                      uniform_prefix=True)
    assert not bool(uc.collided)
    nu = int(uc.n_unique)
    assert nu == len(np.unique(raw, axis=0))
    counts = uc.counts[:nu].numpy()
    assert counts.sum() == n and (counts == 2).all()
    back = mix.inv_apply(uc.keys[:nu]).numpy().view(np.uint32)
    np.testing.assert_array_equal(np.unique(back, axis=0),
                                  np.unique(raw, axis=0))


@pytest.mark.parametrize("k", [127, 256])
def test_forced_collision_sets_flag(k):
    """Distinct valid keys equal on the whole sorted prefix (impossible for
    real images, made here) set `collided`; invalid rows do not."""
    spec = KmerSpec(k)
    n = 256
    cols = [torch.full((n,), 7, dtype=torch.int32)
            for _ in range(spec.lanes)]
    cols[0] = torch.arange(n, dtype=torch.int32)  # lane 0: after the prefix
    cols[-1] &= spec.top_lane_mask
    uc = count_unique(cols, torch.ones(n, dtype=torch.bool), spec,
                      uniform_prefix=True)
    assert bool(uc.collided)
    uc = count_unique(cols, torch.zeros(n, dtype=torch.bool), spec,
                      uniform_prefix=True)
    assert not bool(uc.collided) and int(uc.n_unique) == 0
    full = count_unique(cols, torch.ones(n, dtype=torch.bool), spec)
    assert full.collided is None and int(full.n_unique) == n


def _wide_reads(rng, k, n=16, dups=10):
    """Reads of k to k + 100 bases, about one N in k + 1 (so most windows
    are valid), and some reads repeated (counts above 1, across
    batches)."""
    reads = rand_reads(rng, n, k, k + 100, alphabet="ACGT" * (k // 4) + "N")
    return reads + [reads[i] for i in rng.integers(0, n, dups)]


@pytest.mark.parametrize("k,kw", [
    (113, {}), (127, {}), (128, {}), (200, {}), (256, {}),
    (31, dict(hash_first=True)), (63, dict(hash_first=True)),
], ids=str)
def test_counter_matches_jax(k, kw):
    """The same auto rule, sorted dumps, queries and store states as the
    JAX package (its rows past n are left unspecified by its XLA merge, so
    the states compare on [0, n) and in every other field whole)."""
    reads = _wide_reads(np.random.default_rng(k), k)
    common = dict(l=11, batch_words=64, merge_every=3, lsm=False, **kw)
    ref = JKmerCounter(k=k, **common)
    ref.add_reads(reads)
    ref.finish()
    port = KmerCounter(k=k, device="cpu", **common)
    port.add_reads(reads)
    port.finish()
    assert port.hash_first == ref.hash_first == "mix"
    want = ref.to_dict()
    assert len(want) > 100
    assert port.to_dict() == want == dict(naive_kmers(reads, k))
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


@pytest.mark.parametrize("k,hash_first,want", [
    (112, None, False), (113, None, "mix"), (256, None, "mix"),
    (14, True, "mix"), (14, "mix", "mix"), (127, False, False),
], ids=str)
def test_auto_rule_matches_jax(k, hash_first, want):
    port = KmerCounter(k=k, l=8, hash_first=hash_first, device="cpu")
    ref = JKmerCounter(k=k, l=8, hash_first=hash_first, lsm=False)
    assert port.hash_first == ref.hash_first == want
    table = KmerCounter(k=k, l=8, backend="table", hash_first=hash_first,
                        device="cpu")
    assert table.hash_first is False


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def test_collision_recounts_in_count_file(tmp_path, monkeypatch, capsys):
    """A collision flag forced on every prefix-sorted batch: count_file
    recounts with the full sort and stays exact; add_reads + finish, which
    cannot replay their input, raise PrefixCollision."""
    real = counter_mod.count_unique_ops
    calls = []

    def colliding(kmers, valid, spec, uniform_prefix=False):
        calls.append(uniform_prefix)
        uo = real(kmers, valid, spec, uniform_prefix=uniform_prefix)
        if uniform_prefix:
            uo = uo._replace(collided=torch.ones((), dtype=torch.bool))
        return uo

    monkeypatch.setattr(counter_mod, "count_unique_ops", colliding)
    k = 127
    reads = _wide_reads(np.random.default_rng(3), k)
    fastq = tmp_path / "r.fastq"
    _write_fastq(fastq, reads)
    c = KmerCounter(k=k, l=12, batch_words=64, device="cpu")
    c.count_file(fastq, use_native=False)
    assert c._mix_full_sort and True in calls and calls[-1] is False
    assert "recounting with the full-comparator sort" in (
        capsys.readouterr().err)
    want = dict(naive_kmers(reads, k))
    assert c.to_dict() == want
    assert c.total_kmers == sum(want.values())
    stream = KmerCounter(k=k, l=12, batch_words=64, device="cpu")
    stream.add_reads(reads)
    with pytest.raises(PrefixCollision):
        stream.finish()
    # a counter that already holds data raises from count_file too
    held = KmerCounter(k=k, l=12, batch_words=64, device="cpu")
    held.add_reads(reads[:3])
    with pytest.raises(PrefixCollision):
        held.count_file(fastq, use_native=False)


def test_real_prefix_collision_recounts(tmp_path, monkeypatch, capsys):
    """A prefix of one operand (2 key bits at k=113): distinct keys really
    collide, the batches leave the dedupe sorted on that prefix only and go
    through the merges so, the flag fires, and count_file's recount with
    the full sort is exact."""
    from tsxcount_tpu_torch.ops import count as count_mod

    k = 113
    assert KmerSpec(k).top_lane_bits == 2
    monkeypatch.setattr(count_mod, "uniform_prefix_nk", lambda spec: 1)
    reads = _wide_reads(np.random.default_rng(5), k, n=40)
    fastq = tmp_path / "r.fastq"
    _write_fastq(fastq, reads)
    c = KmerCounter(k=k, l=13, batch_words=128, merge_every=2, device="cpu")
    c.count_file(fastq, use_native=False)
    assert c._mix_full_sort and c.batches_processed > c.merge_every
    assert "recounting with the full-comparator sort" in (
        capsys.readouterr().err)
    want = dict(naive_kmers(reads, k))
    assert c.to_dict() == want and c.total_kmers == sum(want.values())


@pytest.mark.parametrize("n_keys", [9, 17, 20])
def test_plain_merges_take_any_key_width(n_keys):
    """The plain versions of kernels 2 and 3 have no key-width limit (the
    CUDA kernels stop at 17): a stable merge and a merge-dedupe at 9, 17
    and 20 key words against numpy."""
    from tsxcount_tpu_torch.ops.merge import merge_sorted
    from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted

    rng = np.random.default_rng(n_keys)
    inv_min = 1 << 30

    def run(n, n_inv):
        keys = rng.integers(0, 2, (n, n_keys), dtype=np.uint32)
        keys[:, -1] = rng.integers(0, 4, n)
        keys = keys[np.lexsort(keys.T[::-1])]
        keys[n - n_inv :] = 0
        keys[n - n_inv :, 0] = inv_min
        cnt = rng.integers(1, 2**40, n)
        cnt[n - n_inv :] = 0
        return keys, cnt

    (ka, ca), (kb, cb) = run(3000, 40), run(2000, 7)
    a = tuple(_t(ka[:, j]) for j in range(n_keys)) + (torch.from_numpy(ca),)
    b = tuple(_t(kb[:, j]) for j in range(n_keys)) + (torch.from_numpy(cb),)
    keys = np.concatenate([ka, kb])
    order = np.lexsort(keys.T[::-1])  # stable: A's rows first on ties
    got = merge_sorted(a, b, n_keys)
    want = np.concatenate([ca, cb])[order]
    np.testing.assert_array_equal(
        np.stack([c.numpy().view(np.uint32) for c in got[:n_keys]], 1),
        keys[order])
    np.testing.assert_array_equal(got[n_keys].numpy(), want)
    cols, n_runs, n_valid = merge_dedupe_sorted(a, b, n_keys, inv_min)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inverse.ravel(), np.concatenate([ca, cb]))
    r = int(n_runs)
    assert r == len(uniq) and int(n_valid) == r - 1
    np.testing.assert_array_equal(
        np.stack([c[:r].numpy().view(np.uint32) for c in cols[:n_keys]], 1),
        uniq)
    np.testing.assert_array_equal(cols[n_keys][:r].numpy(), sums)


@pytest.mark.parametrize("k", [127, 256])
def test_mix_store_state_exchange_with_jax(k):
    """A JAX store of lane-mix images (8 and 16 lanes) loads into the port
    (state_from_reference), converts back word for word on [0, n), and a
    count continued there ends equal to the JAX package's whole count."""
    reads = _wide_reads(np.random.default_rng(k + 1), k)
    kw = dict(k=k, l=11, batch_words=64, merge_every=2, lsm=False)
    whole = JKmerCounter(**kw)
    whole.add_reads(reads)
    whole.finish()
    first = JKmerCounter(**kw)
    first.add_reads(reads[:12])
    first.finish()
    ref = {f: np.asarray(v) for f, v in first.state._asdict().items()}
    port = KmerCounter(device="cpu", **kw)
    port.load_store_state(ref)
    back = port.store.state_to_reference(port.state)
    n = int(ref["n"])
    for f in STORE_FIELDS:
        a, b = back[f], ref[f]
        if f in ("keys", "digits"):
            a, b = a[:n], b[:n]
        np.testing.assert_array_equal(a, b, err_msg=f)
    port.add_reads(reads[12:])
    port.finish()
    assert port.to_dict() == whole.to_dict()
    assert list(port.items()) == list(whole.items())
