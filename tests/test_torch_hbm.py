"""The port's device-memory model (utils/hbm.py): the configurations the
card runs fit in one H100's 80 GB, the estimate grows with l, k and the
batch, options add their buffers, and an over-capacity run is predicted.
The card run of chip_smoke.py holds the estimate against the measured
peak; these are the model's own properties."""

import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu_torch import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.core.lsm import LSMStore  # noqa: E402
from tsxcount_tpu_torch.utils.hbm import (  # noqa: E402
    device_hbm_capacity_mb,
    estimate_for,
    estimate_hbm,
    preflight_check,
)

H100_MB = 80 * 1000**3 / 2**20  # 80 GB


@pytest.mark.parametrize("kw", [
    dict(k=14, l=26, batch_words=1 << 20),  # the CLI's defaults
    dict(k=14, l=26, batch_words=1 << 16, lsm=True),  # the counter's
    dict(k=14, l=26, batch_words=1 << 16, lsm=True, lsm_growth=2),
    dict(k=31, l=25, batch_words=1 << 20, canonical=True),
    dict(k=63, l=25, batch_words=1 << 20),
    dict(k=127, l=25, batch_words=1 << 20, hash_first="mix"),
    dict(k=256, l=25, batch_words=1 << 20, hash_first="mix"),
    dict(k=14, l=26, batch_words=1 << 20, backend="table"),
    dict(k=31, l=25, batch_words=1 << 18, backend="table"),
], ids=str)
def test_known_good_configs_fit(kw):
    est = estimate_hbm(**kw)
    assert preflight_check(est, capacity_mb=H100_MB) is None, est.as_dict()
    parts = (est.state_mb + est.dedupe_peak_mb + est.merge_peak_mb
             + est.ingest_mb)
    assert est.total_mb == pytest.approx(parts)


def test_over_capacity_predicted():
    est = estimate_hbm(k=14, l=31, batch_words=1 << 20)
    warn = preflight_check(est, capacity_mb=H100_MB)
    assert warn is not None and "reduce --l" in warn


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_monotonic_in_l_k_and_batch(backend):
    base = estimate_hbm(k=31, l=22, batch_words=1 << 18,
                        backend=backend).total_mb
    for kw in (dict(k=31, l=26, batch_words=1 << 18),
               dict(k=63, l=22, batch_words=1 << 18),
               dict(k=31, l=22, batch_words=1 << 20)):
        assert estimate_hbm(backend=backend, **kw).total_mb > base, kw


def test_options_add_their_buffers():
    kw = dict(k=31, l=26, batch_words=1 << 16)
    flat = estimate_hbm(**kw)
    lsm8 = estimate_hbm(lsm=True, **kw)
    lsm2 = estimate_hbm(lsm=True, lsm_growth=2, **kw)
    assert flat.state_mb < lsm8.state_mb < lsm2.state_mb  # the levels
    assert estimate_hbm(canonical=True, **kw).dedupe_peak_mb > \
        flat.dedupe_peak_mb
    assert estimate_hbm(hash_first="mix", **kw).dedupe_peak_mb > \
        flat.dedupe_peak_mb


@pytest.mark.parametrize("kw", [
    dict(k=31, mix_prefix=True), dict(k=224, mix_prefix=True),
    dict(k=14, hash_first="gf2"), dict(k=63, hash_first="gf2"),
], ids=str)
def test_extended_key_and_gf2_terms(kw):
    """mix_prefix holds lanes + 2 key columns (+ the flag operand) in the
    state, the dedupe and the merges; the GF(2) product adds its planes
    to the dedupe.  estimate_for of such a built counter (and of a
    sharded one routed by GF(2)) is estimate_hbm of its options."""
    geo = dict(l=25, batch_words=1 << 20)
    est = estimate_hbm(**geo, **kw)
    base = estimate_hbm(**geo, k=kw["k"])
    assert preflight_check(est, capacity_mb=H100_MB) is None, est.as_dict()
    assert est.dedupe_peak_mb > base.dedupe_peak_mb
    if kw.get("mix_prefix"):
        assert est.state_mb > base.state_mb
        assert est.merge_peak_mb > base.merge_peak_mb
    else:
        assert (est.state_mb, est.merge_peak_mb) == (base.state_mb,
                                                     base.merge_peak_mb)
    c = KmerCounter(device="cpu", l=12, batch_words=64, lsm=False, **kw)
    assert estimate_for(c) == estimate_hbm(
        l=12, batch_words=64, lsm=False, merge_every=c.merge_every, **kw)
    if kw.get("hash_first") == "gf2":
        from tsxcount_tpu_torch import ShardedKmerCounter

        s = ShardedKmerCounter(k=kw["k"], n_shards=1, l=12, batch_words=64,
                               backend="table", routing_hash="gf2",
                               device="cpu")
        assert estimate_for(s) == estimate_hbm(
            kw["k"], 12, 64, backend="table", hash_first="gf2", n_shards=1,
            merge_every=s.merge_every)


def test_capacity_needs_a_gpu_or_an_argument():
    est = estimate_hbm(k=14, l=20, batch_words=1 << 16)
    assert preflight_check(est, capacity_mb=H100_MB) is None
    if torch.cuda.is_available():
        assert device_hbm_capacity_mb() > 0
        return
    with pytest.raises(RuntimeError, match="capacity_mb"):
        preflight_check(est)


@pytest.mark.parametrize("kw,lsm", [
    (dict(k=11, l=20, batch_words=64, merge_every=1), True),  # auto rule
    (dict(k=11, l=20, batch_words=64, merge_every=1, lsm_growth=2), True),
    (dict(k=11, l=8, batch_words=64), False),  # table not above L0
    (dict(k=11, l=12, batch_words=64, backend="table"), False),
], ids=str)
def test_estimate_for_reads_the_built_counter(kw, lsm):
    """estimate_for models the counter as built: the LSM as its rule chose
    it, with the store's own level sizes."""
    c = KmerCounter(device="cpu", **kw)
    assert c.lsm is lsm
    est = estimate_for(c)
    assert est == estimate_hbm(
        k=11, l=kw["l"], batch_words=64, backend=c.backend,
        merge_every=c.merge_every, lsm=lsm, lsm_growth=c.lsm_growth)
    if lsm:
        row = 4 * c.store.n_ops + 8  # a store row: operands + int64 count
        rows = sum(lv.capacity for lv in c.store.levels)
        assert rows == sum(LSMStore.level_capacities(
            1 << kw["l"], c.merge_every * c.batch.positions, c.lsm_growth))
        assert est.state_mb * 2**20 == row * rows
