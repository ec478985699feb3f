"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes, and the counter on the card against the counter on the
CPU.  Every output is an integer: exact equality.

Marked `cuda`; each test skips where torch.cuda.is_available() is False.
This file imports no JAX, so on a machine with a GPU and without JAX it runs
on its own (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu_torch import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.ops.apply import (  # noqa: E402
    apply_sorted_unique,
    apply_sorted_unique_plain,
    gather_sorted,
    gather_sorted_plain,
)
from tsxcount_tpu_torch.ops.compact import (  # noqa: E402
    compact_flagged,
    compact_flagged_plain,
)
from tsxcount_tpu_torch.ops.merge import merge_sorted, merge_sorted_plain  # noqa: E402
from tsxcount_tpu_torch.ops.merge_dedupe import (  # noqa: E402
    merge_dedupe_sorted,
    merge_dedupe_sorted_plain,
)

pytestmark = pytest.mark.cuda
INV_MIN = 1 << 30


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a: np.ndarray, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a
                            ).to(dev)


@pytest.mark.parametrize("total,density", [(1, 1.0), (5000, 0.5),
                                           (9000, 0.0), (9000, 1.0),
                                           (123457, 0.1)])
def test_compact_kernel(dev, total, density):
    rng = np.random.default_rng(total)
    flag = _t((rng.random(total) < density).astype(np.int32), dev)
    cols = (_t(rng.integers(0, 2**32, total, dtype=np.uint32), dev),
            _t(rng.integers(-2**62, 2**62, total), dev))
    got = compact_flagged(flag, cols)
    want = compact_flagged_plain(flag, cols)
    n = int((flag != 0).sum())
    for g, w in zip(got, want):
        assert torch.equal(g[:n], w[:n])


@pytest.mark.parametrize("flag_dtype", [torch.bool, torch.int32])
def test_compact_repeats_bit_identical(dev, flag_dtype):
    """About 2,000 tiles of 4096 rows finish in a different order on every
    call: five calls must give identical outputs, equal to the plain
    version's."""
    rng = np.random.default_rng(17)
    total = 2000 * 4096 - 3
    flag = _t(rng.random(total) < 0.5, dev).to(flag_dtype)
    cols = (_t(rng.integers(0, 2**32, total, dtype=np.uint32), dev),
            _t(rng.integers(-2**62, 2**62, total), dev))
    want = compact_flagged_plain(flag, cols)
    n = int((flag != 0).sum())
    for _ in range(5):
        for g, w in zip(compact_flagged(flag, cols), want):
            assert torch.equal(g[:n], w[:n])


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_compact_bool_flags_int64_columns_offset_views(dev, offset):
    """Bool flags, int32 and int64 columns, and views that start `offset`
    rows into their storage (unaligned for the vector loads)."""
    rng = np.random.default_rng(offset)
    total = 300_001
    flag = _t(rng.random(total + offset) < 0.3, dev)[offset:]
    cols = (_t(rng.integers(0, 2**32, total + offset, dtype=np.uint32),
               dev)[offset:],
            _t(rng.integers(-2**62, 2**62, total + offset), dev)[offset:])
    n = int(flag.sum())
    for fl in (flag, flag.to(torch.int32)):
        for g, w in zip(compact_flagged(fl, cols),
                        compact_flagged_plain(fl, cols)):
            assert torch.equal(g[:n], w[:n])


def _sorted_run(rng, n, n_keys, hi):
    keys = rng.integers(0, hi, size=(n, n_keys), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    return keys[np.lexsort(keys.T[::-1])]


@pytest.mark.parametrize("m,n,n_keys,hi", [
    (1024, 1024, 1, 2**32), (2000, 48, 1, 50), (0, 2048, 2, 2**32),
    (30000, 15000, 2, 4), (7000, 29000, 3, 3), (5, 0, 1, 9),
    (40000, 40000, 8, 2),
    # many tiles (2048 rows up to 3 key words, 1024 beyond), lengths off
    # the tile: full 32-bit words, one run empty, every key equal
    (300001, 250000, 1, 2**32), (200000, 150001, 3, 2**32),
    (100000, 90001, 8, 2**32), (0, 100003, 3, 7), (100003, 0, 8, 2**32),
    (120000, 100001, 1, 1), (50000, 40001, 8, 1),
])
def test_merge_kernel(dev, m, n, n_keys, hi):
    rng = np.random.default_rng(m + n + n_keys)
    a_keys, b_keys = (_sorted_run(rng, m, n_keys, hi),
                      _sorted_run(rng, n, n_keys, hi))
    a = tuple(_t(a_keys[:, j], dev) for j in range(n_keys)) + (
        torch.arange(m, dtype=torch.int32, device=dev),
        _t(rng.integers(0, 2**40, m), dev))
    b = tuple(_t(b_keys[:, j], dev) for j in range(n_keys)) + (
        torch.arange(n, dtype=torch.int32, device=dev) + 100000,
        _t(rng.integers(0, 2**40, n), dev))
    for g, w in zip(merge_sorted(a, b, n_keys),
                    merge_sorted_plain(a, b, n_keys)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_keys", [1, 3, 8])
def test_merge_kernel_keys_only(dev, n_keys):
    """No payload column: the keys alone, across many tiles."""
    rng = np.random.default_rng(40 + n_keys)
    a = tuple(_t(c, dev) for c in _sorted_run(rng, 70001, n_keys, 2**32).T)
    b = tuple(_t(c, dev) for c in _sorted_run(rng, 60000, n_keys, 2**32).T)
    for g, w in zip(merge_sorted(a, b, n_keys),
                    merge_sorted_plain(a, b, n_keys)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,n,n_keys,hi,n_inv", [
    (40960, 20480, 1, 3000, 37), (60000, 30000, 2, 30, 0),
    (90000, 100, 1, 2, 5), (0, 10, 1, 5, 3), (3, 0, 3, 2, 0),
    (20000, 20000, 8, 2, 11),
])
def test_merge_dedupe_kernel(dev, m, n, n_keys, hi, n_inv):
    rng = np.random.default_rng(m + n)

    def run(k):
        keys = _sorted_run(rng, k, n_keys, hi)
        cnt = rng.integers(2**31, 2**32, k)
        inv = min(n_inv, k)
        keys[k - inv :] = 0
        keys[k - inv :, 0] = INV_MIN
        cnt[k - inv :] = 0
        return tuple(_t(keys[:, j], dev) for j in range(n_keys)) + (
            _t(cnt, dev),)

    a, b = run(m), run(n)
    got, g_runs, g_valid = merge_dedupe_sorted(a, b, n_keys, INV_MIN)
    want, w_runs, w_valid = merge_dedupe_sorted_plain(a, b, n_keys, INV_MIN)
    assert (int(g_runs), int(g_valid)) == (int(w_runs), int(w_valid))
    r = int(w_runs)
    for g, w in zip(got, want):
        assert torch.equal(g[:r], w[:r])


@pytest.mark.parametrize("k", [14, 16, 33])
def test_counter_on_card_matches_cpu(dev, k):
    rng = np.random.default_rng(k)
    reads = ["".join(rng.choice(list("ACGTN"), size=rng.integers(k, 400)))
             for _ in range(300)]
    out = []
    for d in (dev, "cpu"):
        c = KmerCounter(k=k, l=16, batch_words=512, merge_every=3, device=d)
        c.add_reads(reads)
        c.finish()
        out.append((c.to_dict(), c.distinct, c.total_kmers))
    assert out[0] == out[1]


@pytest.mark.parametrize("s,n_live,n_dead,tail", [
    (4096, 1500, 500, 64), (2048, 2048, 0, 0), (2048, 0, 300, 100),
    (100000, 2, 1000, 7), (300000, 90000, 200000, 5000),
])
def test_gather_and_apply_kernels(dev, s, n_live, n_dead, tail):
    rng = np.random.default_rng(s + n_live)
    live = np.sort(rng.choice(s, n_live, replace=False))
    if n_live == 2:  # the first and the last word
        live = np.array([0, s - 1])
    dst2 = np.sort(np.concatenate([2 * live + 1,
                                   2 * rng.integers(0, s + 1, n_dead)]))
    dst2 = _t(np.concatenate([dst2, np.full(tail, 1 << 30)]).astype(np.int32),
              dev)
    col = _t(rng.integers(0, 2**32, s, dtype=np.uint32), dev)
    val = _t(rng.integers(2**31, 2**32, dst2.numel(), dtype=np.uint32), dev)
    for g, w in zip(gather_sorted(col, dst2), gather_sorted_plain(col, dst2)):
        assert torch.equal(g, w)
    got = apply_sorted_unique(col.clone(), dst2, val)
    want = apply_sorted_unique_plain(col.clone(), dst2, val)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_cols", [1, 5, 12])
def test_apply_columns_in_one_launch(dev, n_cols):
    """Column regions of one flat array in one launch, with all-zero, partly
    zero and wrapping value columns, against the plain version."""
    rng = np.random.default_rng(n_cols)
    s, w = 200000, 150000
    live = np.sort(rng.choice(s, 60000, replace=False))
    dst2 = np.sort(np.concatenate([2 * live + 1,
                                   2 * rng.integers(0, s, w - len(live))]))
    dst2 = _t(dst2.astype(np.int32), dev)
    flat = _t(rng.integers(0, 2**32, n_cols * s, dtype=np.uint32), dev)
    vals = [_t(rng.integers(2**31, 2**32, w, dtype=np.uint32), dev)
            * (c % 3 != 1)
            * _t((rng.random(w) < 0.5 + 0.5 * (c % 3 == 0)).astype(np.int32),
                 dev)
            for c in range(n_cols)]
    out = []
    for fn in (apply_sorted_unique, apply_sorted_unique_plain):
        got = flat.clone()
        fn([got[c * s : (c + 1) * s] for c in range(n_cols)], dst2, vals)
        out.append(got)
    assert torch.equal(out[0], out[1])


def _dedupe_run(rng, k, n_keys, hi, n_inv, dev):
    keys = _sorted_run(rng, k, n_keys, hi)
    cnt = rng.integers(2**31, 2**32, k)
    keys[k - n_inv :] = 0
    keys[k - n_inv :, 0] = INV_MIN
    cnt[k - n_inv :] = 0
    return tuple(_t(keys[:, j], dev) for j in range(n_keys)) + (_t(cnt, dev),)


@pytest.mark.parametrize("m,n,n_keys,hi", [
    (3_000_000, 1_000_000, 1, 2**20),  # ~2000 tiles: the look-back spans many
    (400_000, 300_000, 1, 1),          # one key over every tile
    (500_000, 250_000, 8, 2),          # 8 key words, 1024-row tiles
])
def test_merge_dedupe_repeats_bit_identical(dev, m, n, n_keys, hi):
    """Tiles finish in a different order on every call: five calls must
    give identical outputs and stats, equal to the plain version's."""
    rng = np.random.default_rng(m + n_keys)
    a = _dedupe_run(rng, m, n_keys, hi, 17, dev)
    b = _dedupe_run(rng, n, n_keys, hi, 5, dev)
    want, w_runs, w_valid = merge_dedupe_sorted_plain(a, b, n_keys, INV_MIN)
    r = int(w_runs)
    for _ in range(5):
        got, g_runs, g_valid = merge_dedupe_sorted(a, b, n_keys, INV_MIN)
        assert (int(g_runs), int(g_valid)) == (r, int(w_valid))
        for g, w in zip(got, want):
            assert torch.equal(g[:r], w[:r])


@pytest.mark.parametrize("n_cols", [1, 2, 5, 12])
def test_gather_every_row_of_long_runs(dev, n_cols):
    """The table's probe: every row of a run reads the same slot word, over
    column sets of 1-12 regions of one flat array, with a dead tail, and
    over an offset view of dst2; the one-column calls agree."""
    rng = np.random.default_rng(3 + n_cols)
    s = 1 << 20
    flat = _t(rng.integers(0, 2**32, n_cols * s, dtype=np.uint32), dev)
    cols = [flat[c * s : (c + 1) * s] for c in range(n_cols)]
    pos = np.sort(rng.integers(0, 4096, 1 << 18))
    dst2 = _t(np.concatenate([2 * pos + 1, np.full(999, 1 << 30)])
              .astype(np.int32), dev)
    for d in (dst2, dst2[1:]):  # whole, and one row into its storage
        got, zero = gather_sorted(cols, d)
        want, _ = gather_sorted_plain(cols, d)
        assert int(zero) == 0 and len(got) == n_cols
        for col, g, w in zip(cols, got, want):
            assert torch.equal(g, w)
            assert torch.equal(gather_sorted(col, d)[0], g)


@pytest.mark.parametrize("k,l", [(14, 14), (31, 15)])
def test_table_counter_on_card_matches_cpu_state(dev, k, l):
    rng = np.random.default_rng(k)
    reads = ["".join(rng.choice(list("ACGTN"), size=rng.integers(k, 400)))
             for _ in range(300)]
    out = []
    for d in (dev, "cpu"):
        c = KmerCounter(k=k, l=l, backend="table", batch_words=512, device=d)
        c.add_reads(reads)
        c.finish()
        out.append((c.table.state_to_reference(c.state), c.to_dict()))
    for f in out[0][0]:
        assert np.array_equal(out[0][0][f], out[1][0][f]), f
    assert out[0][1] == out[1][1]
