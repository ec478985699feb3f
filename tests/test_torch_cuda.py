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

from tsxcount_tpu_torch import KmerCounter, KmerSpec  # noqa: E402
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
from tsxcount_tpu_torch.ops.mix import (  # noqa: E402
    LaneMixBijection,
    lane_mix,
    lane_mix_plain,
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


@pytest.mark.parametrize("m,n,n_keys,hi", [
    (1000, 700, 9, 2**32), (40000, 30001, 9, 3), (30000, 40000, 17, 2),
    (50001, 0, 17, 2**32), (0, 20000, 9, 2), (30000, 30000, 17, 1),
])
def test_merge_kernel_wide(dev, m, n, n_keys, hi):
    """9 and 17 key words (the run-time width, 512-row tiles) with one
    int32 payload column: 18 columns at most."""
    rng = np.random.default_rng(m + n + n_keys)
    a = tuple(_t(c, dev) for c in _sorted_run(rng, m, n_keys, hi).T) + (
        torch.arange(m, dtype=torch.int32, device=dev),)
    b = tuple(_t(c, dev) for c in _sorted_run(rng, n, n_keys, hi).T) + (
        torch.arange(n, dtype=torch.int32, device=dev) + 100000,)
    for g, w in zip(merge_sorted(a, b, n_keys),
                    merge_sorted_plain(a, b, n_keys)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_keys", [1, 3, 8, 9, 17])
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
    (20000, 20000, 8, 2, 11), (20000, 20000, 9, 2, 11),
    (15000, 12000, 17, 2, 7), (30000, 0, 17, 2**30, 3),
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


@pytest.mark.parametrize("n_cols", [1, 5, 12, 17, 19, 20])
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
    (300_000, 200_000, 17, 2),         # 17 key words, 512-row tiles
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


@pytest.mark.parametrize("n_cols", [1, 2, 5, 12, 17, 19, 20])
def test_gather_every_row_of_long_runs(dev, n_cols):
    """The table's probe: every row of a run reads the same slot word, over
    column sets of 1-20 regions of one flat array, with a dead tail, and
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


def test_compact_18_columns(dev):
    """The k = 256 dedupe's 17 key operands and the position column."""
    rng = np.random.default_rng(18)
    total = 70001
    flag = _t(rng.random(total) < 0.5, dev)
    cols = tuple(_t(rng.integers(0, 2**32, total, dtype=np.uint32), dev)
                 for _ in range(17)) + (
        torch.arange(total, dtype=torch.int32, device=dev),)
    n = int(flag.sum())
    for g, w in zip(compact_flagged(flag, cols),
                    compact_flagged_plain(flag, cols)):
        assert torch.equal(g[:n], w[:n])


@pytest.mark.parametrize("k", [7, 16, 31, 63, 113, 127, 128, 200, 256])
def test_lane_mix_kernel(dev, k):
    """Forward and inverse against the plain version, and the round
    trip, on full 32-bit words (the top lane masked)."""
    spec = KmerSpec(k)
    mix = LaneMixBijection(spec)
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 2**32, (spec.lanes, 100003), dtype=np.uint32)
    keys[-1] &= np.uint32(spec.top_lane_mask)
    cols = [_t(c, dev) for c in keys]
    for inverse in (False, True):
        for g, w in zip(lane_mix(cols, mix, inverse),
                        lane_mix_plain(cols, mix, inverse)):
            assert torch.equal(g, w)
    back = lane_mix(lane_mix(cols, mix), mix, inverse=True)
    assert all(map(torch.equal, back, cols))


@pytest.mark.parametrize("k,hash_first", [(127, None), (256, None),
                                          (63, True), (127, False)])
def test_wide_counter_on_card_matches_cpu(dev, k, hash_first):
    """Wide keys through the lane mix (or not): dumps and store states on
    the card equal the CPU's word for word."""
    rng = np.random.default_rng(k)
    reads = ["".join(rng.choice(list("ACGT" * (k // 4) + "N"),
                                size=rng.integers(k, k + 400)))
             for _ in range(200)]
    reads += reads[:50]
    out = []
    for d in (dev, "cpu"):
        c = KmerCounter(k=k, l=16, batch_words=512, merge_every=3,
                        hash_first=hash_first, device=d)
        c.add_reads(reads)
        c.finish()
        out.append((c.to_dict(), c.distinct, c.total_kmers,
                    c.store.state_to_reference(c.state)))
    assert out[0][:3] == out[1][:3] and out[0][1] > 1000
    for f, v in out[0][3].items():
        np.testing.assert_array_equal(v, out[1][3][f], err_msg=f)


def _out_of_order(rng, k, n_keys, how):
    """k rows of n_keys key words below 2^31 - 1, sorted on the first word
    (0..15) only; "inversion" adds a descending block of the first word,
    "shuffled" breaks every order."""
    keys = rng.integers(0, 2**31 - 1, (k, n_keys)).astype(np.int32)
    keys[:, 0] = np.sort(rng.integers(0, 16, k))
    if how == "inversion":
        lo = k // 3
        keys[lo : lo + 30000, 0] = keys[lo : lo + 30000, 0][::-1]
    elif how == "shuffled":
        rng.shuffle(keys)
    return keys


@pytest.mark.parametrize("n_keys,how", [(2, "prefix"), (3, "inversion"),
                                        (1, "shuffled"), (8, "prefix"),
                                        (9, "inversion"), (17, "shuffled")])
def test_merges_of_runs_out_of_order_stay_in_bounds(dev, n_keys, how):
    """Runs that break the sort order (as a batch sorted only on its
    uniform prefix does after a real collision) give unspecified rows but
    no fault.  Through the C interface, as tools/cuda_emu/emulate.py calls
    it: each column sits between guards of -1 (no key word or row id of
    the data), out is filled with -7 between guards; every row kernel 2
    writes is a copy of an input row, every key kernel 3 writes an input
    key, out's guards stay -7, and the context still works."""
    from tsxcount_tpu_torch import _build

    lib, P, W = _build.kernels(), _build.ptr_array, _build.width_array
    guard = 1 << 16
    rng = np.random.default_rng(n_keys)
    m, n = 300001, 250000
    ka, kb = (_out_of_order(rng, m, n_keys, how),
              _out_of_order(rng, n, n_keys, how))
    every = np.concatenate([ka, kb])
    held = []  # the guarded buffers behind the views

    def guarded(vals, fill):
        buf = torch.full((vals.numel() + 2 * guard,), fill, dtype=vals.dtype,
                         device=dev)
        buf[guard:-guard] = vals
        held.append(buf)
        return buf[guard:-guard]

    def cols(keys, extra):
        return tuple(guarded(_t(c, dev), -1) for c in keys.T) + (
            guarded(extra, -1),)

    def fresh(like):
        bufs = [torch.full((m + n + 2 * guard,), -7, dtype=c.dtype,
                           device=dev) for c in like]
        return bufs, tuple(b[guard:-guard] for b in bufs)

    def guards_kept(bufs):
        return all(bool((b[:guard] == -7).all() and (b[-guard:] == -7).all())
                   for b in bufs)

    # kernel 2, an int32 row id as payload
    a = cols(ka, torch.arange(m, dtype=torch.int32, device=dev))
    b = cols(kb, torch.arange(m, m + n, dtype=torch.int32, device=dev))
    bufs, out = fresh(a)
    scratch = torch.empty(lib.tsx_merge_scratch_elems(n_keys, m, n),
                          dtype=torch.int64, device=dev)
    assert lib.tsx_merge_sorted(P(a), P(b), P(out), W(a), len(a), n_keys, m,
                                n, scratch.data_ptr(), _build.stream()) == 0
    ids = out[n_keys].cpu().numpy()
    assert guards_kept(bufs)
    assert ((ids >= 0) & (ids < m + n)).all()
    got = np.stack([c.cpu().numpy() for c in out[:n_keys]], axis=1)
    assert (got == every[ids]).all()
    # kernel 3, an int64 count
    a = cols(ka, torch.ones(m, dtype=torch.int64, device=dev))
    b = cols(kb, torch.ones(n, dtype=torch.int64, device=dev))
    bufs, out = fresh(a)
    stats = torch.full((2,), -7, dtype=torch.int64, device=dev)
    scratch = torch.empty(lib.tsx_merge_dedupe_scratch_bytes(n_keys, m, n),
                          dtype=torch.uint8, device=dev)
    assert lib.tsx_merge_dedupe_sorted(
        P(a), P(b), P(out), n_keys, m, n, 1 << 31, stats.data_ptr(),
        scratch.data_ptr(), _build.stream()) == 0
    r = int(stats[0])
    assert 0 < r <= m + n and guards_kept(bufs)
    got = np.stack([c[:r].cpu().numpy() for c in out[:n_keys]], axis=1)
    rows = lambda x: np.ascontiguousarray(x).view(
        np.dtype((np.void, 4 * n_keys))).ravel()
    written = (got != -7).any(axis=1)
    assert np.isin(rows(got[written]), rows(every)).all()
    # the context survived: a sorted merge is still exact
    s = tuple(_t(c, dev) for c in _sorted_run(rng, 5000, n_keys, 7).T)
    for g, w in zip(merge_sorted(s, s, n_keys),
                    merge_sorted_plain(s, s, n_keys)):
        assert torch.equal(g, w)


def test_real_prefix_collision_recounts_on_card(dev, tmp_path, monkeypatch):
    """A prefix of one operand (2 key bits at k=113): the batches that reach
    kernels 2 and 3 on the card are sorted on that prefix only, the flag
    fires, and count_file recounts exactly on the same context."""
    from collections import Counter

    from tsxcount_tpu_torch import _build
    from tsxcount_tpu_torch.ops import count as count_mod

    k = 113
    rng = np.random.default_rng(113)
    reads = ["".join(rng.choice(list("ACGT"), size=rng.integers(k, 500)))
             for _ in range(600)]
    reads += reads[:100]
    fastq = tmp_path / "r.fastq"
    fastq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                             for i, r in enumerate(reads)))
    monkeypatch.setattr(count_mod, "uniform_prefix_nk", lambda spec: 1)
    c = KmerCounter(k=k, l=18, batch_words=2048, merge_every=3, device=dev)
    _build.reset_launch_counts()
    c.count_file(fastq, use_native=False)
    assert c._mix_full_sort and c.batches_processed > c.merge_every
    assert _build.launch_counts()["merge_dedupe_sorted"] >= 2
    want = Counter(r[i : i + k] for r in reads
                   for i in range(len(r) - k + 1))
    assert c.to_dict() == dict(want)


@pytest.mark.parametrize("k,big,small", [(14, 1 << 18, 1 << 17),
                                         (127, 1 << 16, 1 << 15)])
def test_absorb_shape_kernel_and_store(dev, k, big, small):
    """Kernel 3 at the LSM absorb's shape (a store run of one level into
    the store run of the next, both with the invalid tail) against its
    plain version, and CountStore.absorb on the card against the CPU."""
    from tsxcount_tpu_torch.core.store import CountStore

    spec = KmerSpec(k)
    states = []
    for d in (dev, "cpu"):
        rng = np.random.default_rng(k)  # the same data on both devices
        pool = rng.integers(0, 2**32, size=(big, spec.lanes),
                            dtype=np.uint64).astype(np.uint32)
        pool[:, -1] &= np.uint32(spec.top_lane_mask)
        # half of the smaller level's keys are in the larger one too: their
        # counts must add
        key_sets = (pool[: big // 2],
                    np.concatenate([pool[: small // 4],
                                    pool[big // 2 : big // 2 + small // 4]]))
        stores = [CountStore(spec, c, d) for c in (big, small)]
        sts = []
        for store, cap, keys in zip(stores, (big, small), key_sets):
            keys = np.unique(keys, axis=0)
            n = len(keys)
            full = np.zeros((cap, spec.lanes), np.uint32)
            full[:n] = keys[np.lexsort(keys.T)]
            digits = np.zeros((cap, 3), np.int32)
            digits[:n, 0] = rng.integers(1, 1 << 20, n)
            digits[:n, 1] = rng.integers(0, 1 << 20, n)
            sts.append(store.state_from_reference(dict(
                keys=full, digits=digits, used=np.arange(cap) < n,
                n=np.int32(n), overflowed=np.bool_(False))))
        if not states:  # the card: the kernel against its plain version
            run_a = tuple(sts[0].keys.unbind(0)) + (sts[0].counts,)
            run_b = tuple(sts[1].keys.unbind(0)) + (sts[1].counts,)
            inv = stores[0].inv_min
            got, g_runs, g_valid = merge_dedupe_sorted(
                run_a, run_b, stores[0].n_ops, inv)
            want, w_runs, w_valid = merge_dedupe_sorted_plain(
                run_a, run_b, stores[0].n_ops, inv)
            assert (int(g_runs), int(g_valid)) == (int(w_runs), int(w_valid))
            for g, w in zip(got, want):
                assert torch.equal(g[: int(w_runs)], w[: int(w_runs)])
        states.append(stores[0].state_to_reference(stores[0].absorb(*sts)))
    n = int(states[0]["n"])
    assert big // 2 < n < big // 2 + small // 2  # the runs overlap in part
    for f, v in states[0].items():
        assert np.array_equal(v, states[1][f]), f


def test_lsm_counter_on_card_matches_cpu_levels(dev):
    """A count whose LSM cascades run during the stream: every level's
    state on the card equals the CPU's word for word, and so do the
    collapsed exports."""
    rng = np.random.default_rng(8)
    reads = ["".join(rng.choice(list("ACGTN"), size=rng.integers(14, 400)))
             for _ in range(600)]
    out = []
    for d in (dev, "cpu"):
        c = KmerCounter(k=14, l=16, batch_words=256, merge_every=1, lsm=True,
                        lsm_growth=2, device=d)
        c.add_reads(reads)
        c.finish()
        assert c.lsm and c.store.absorbs >= 2
        out.append(([lv.state_to_reference(st) for lv, st in
                     zip(c.store.levels, c.state)], c.to_dict()))
    for lv_card, lv_cpu in zip(out[0][0], out[1][0]):
        for f in lv_card:
            assert np.array_equal(lv_card[f], lv_cpu[f]), f
    assert out[0][1] == out[1][1]


@pytest.mark.parametrize("k,backend,l", [(14, "sort", 16), (14, "table", 16),
                                         (127, "sort", 15)])
@pytest.mark.parametrize("nccl", [False, True])
def test_sharded_one_shard_on_card_matches_cpu(dev, k, backend, l, nccl):
    """chip_smoke phases 8a and 8b at a small size: the sharded counter at
    one shard on the card (alone, or on a one-rank NCCL group made first,
    which its collectives then go through; the lane mix at the table and
    at k=127) counts what the plain counter counts on the CPU, through
    the kernels of its path, and answers the same queries."""
    from tsxcount_tpu_torch import _build
    from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

    rng = np.random.default_rng(k + l)
    reads = ["".join(rng.choice(list("ACGTN"), size=rng.integers(k, 400)))
             for _ in range(300)]
    kw = dict(k=k, l=l, backend=backend, batch_words=512, merge_every=2)
    if nccl:
        torch.distributed.init_process_group(
            "nccl", store=torch.distributed.HashStore(), rank=0,
            world_size=1)
    _build.reset_launch_counts()
    try:
        s = ShardedKmerCounter(n_shards=1, capacity_factor=1.5, device=dev,
                               **kw)
        s.add_reads(reads)
        s.finish()
        launches = _build.launch_counts()
        p = KmerCounter(device="cpu", **kw)
        p.add_reads(reads)
        p.finish()
        assert s.group.backend == ("nccl" if nccl else None)
        assert s.device.type == "cuda"
        want = p.to_dict()
        assert s.to_dict() == want
        queries = list(want)[:500] + ["A" * k]
        assert s.get_counts(queries) == p.get_counts(queries)
    finally:
        if nccl:
            torch.distributed.destroy_process_group()
    need = (["gather_sorted", "apply_sorted_unique", "compact_flagged",
             "lane_mix"] if backend == "table" else
            ["compact_flagged", "merge_sorted", "merge_dedupe_sorted"]
            + (["lane_mix"] if k == 127 else []))
    assert all(launches[name] > 0 for name in need), launches


@pytest.mark.parametrize("k,kw", [(63, dict(hash_first="gf2")),
                                  (31, dict(mix_prefix=True)),
                                  (224, dict(mix_prefix=True))], ids=str)
def test_last_options_on_card_match_cpu(dev, k, kw):
    """hash_first="gf2" (the GF(2) image) and mix_prefix (extended keys;
    17 key words at k=224, kernels 1-3's ceiling): dumps and store states
    on the card equal the CPU's word for word, through kernels 1-3."""
    from tsxcount_tpu_torch import _build

    rng = np.random.default_rng(k)
    reads = ["".join(rng.choice(list("ACGT" * max(8, k // 4) + "N"),
                                size=rng.integers(k, k + 400)))
             for _ in range(200)]
    reads += reads[:50]
    out = []
    for d in (dev, "cpu"):
        _build.reset_launch_counts()
        c = KmerCounter(k=k, l=16, batch_words=512, merge_every=3,
                        device=d, **kw)
        c.add_reads(reads)
        c.finish()
        launches = _build.launch_counts()
        out.append((c.to_dict(), c.distinct, c.total_kmers,
                    c.store.state_to_reference(c.state)))
        if d == dev:
            assert all(launches[name] > 0 for name in (
                "compact_flagged", "merge_sorted", "merge_dedupe_sorted"))
            assert c.store.n_ops == (KmerSpec(k).lanes + 3
                                     if c.mix_prefix else KmerSpec(k).lanes)
    assert out[0][:3] == out[1][:3] and out[0][1] > 1000
    for f, v in out[0][3].items():
        np.testing.assert_array_equal(v, out[1][3][f], err_msg=f)


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_gf2_routing_one_shard_on_card_matches_cpu(dev, backend):
    """The sharded counter routed by GF(2) at one shard on the card counts
    what it counts on the CPU and answers the same queries; the table's
    slots are addressed by the GF(2) image."""
    from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

    rng = np.random.default_rng(5)
    reads = ["".join(rng.choice(list("ACGTN"), size=rng.integers(14, 400)))
             for _ in range(300)]
    kw = dict(k=14, n_shards=1, l=16, backend=backend, batch_words=512,
              routing_hash="gf2")
    got = []
    for d in (dev, "cpu"):
        s = ShardedKmerCounter(device=d, **kw)
        s.add_reads(reads)
        s.finish()
        assert s.hashed_store == (backend == "table")
        want = s.to_dict()
        got.append((want, s.get_counts(list(want)[:500] + ["A" * 14])))
    assert got[0] == got[1] and len(got[0][0]) > 1000


@pytest.mark.parametrize("kernel", ["lane_mix", "merge_dedupe_sorted",
                                    "gather_sorted", "apply_sorted_unique"])
def test_a_traced_launch_records_its_shape_and_roofline_share(dev, monkeypatch,
                                                             kernel):
    """One lane-mix launch at 2^24 positions of 8 lanes, one kernel-3
    launch at 8 key words, or one launch of kernel 5 (17 columns) or 4 (19
    columns) at the wide table's round of 2^24 sorted destinations, 68 %
    live, on 2^26-word columns, under a profiler: the launch table holds
    its shape, and the benchmark's reader gives a share in (0, 100] % from
    the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import run
    from portbench.trace import reduce_trace
    from tsxcount_tpu_torch import _build

    monkeypatch.setattr(_build, "_SHAPES", {})
    g = torch.Generator(device=dev).manual_seed(127)
    if kernel == "lane_mix":
        spec = KmerSpec(127)
        mix = LaneMixBijection(spec)
        cols = [torch.randint(-2**31, 2**31, (1 << 24,), dtype=torch.int32,
                              device=dev, generator=g)
                for _ in range(spec.lanes)]
        cols[-1] &= spec.top_lane_mask
        call = lambda: lane_mix(cols, mix)
        shape = dict(positions=1 << 24, lanes=8, input_bytes=8 << 26)
        metric = "kernels.lane_mix.roofline_pct"
    elif kernel == "merge_dedupe_sorted":
        def run_of(rows, step):  # distinct first words: ascending keys
            first = torch.arange(rows, dtype=torch.int32, device=dev) * step
            rest = [torch.randint(-2**31, 2**31, (rows,), dtype=torch.int32,
                                  device=dev, generator=g) for _ in range(7)]
            return (first, *rest, torch.ones(rows, dtype=torch.int64,
                                             device=dev))
        a, b = run_of(1 << 24, 2), run_of(1 << 23, 3)
        call = lambda: merge_dedupe_sorted(a, b, 8, INV_MIN)
        shape = dict(m=1 << 24, n=1 << 23, n_keys=8)
        metric = "kernels.merge_dedupe.roofline_pct"
    else:
        n_cols = 17 if kernel == "gather_sorted" else 19
        slots = [torch.zeros(1 << 26, dtype=torch.int32, device=dev)
                 for _ in range(n_cols)]
        # ascending distinct slots, two thirds of them live (odd)
        addr = torch.arange(1 << 24, dtype=torch.int32, device=dev) * 4
        live = torch.rand(1 << 24, device=dev, generator=g) < 0.68
        dst2 = (addr << 1) | live.to(torch.int32)
        if kernel == "gather_sorted":
            call = lambda: gather_sorted(slots, dst2)
            metric = "kernels.table_gather.roofline_pct"
        else:
            vals = [torch.ones(1 << 24, dtype=torch.int32, device=dev)
                    for _ in range(n_cols)]
            call = lambda: apply_sorted_unique(slots, dst2, vals)
            metric = "kernels.table_apply.roofline_pct"
        shape = dict(elements=1 << 24, cols=n_cols)
    call()  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.window"):
            call()
            torch.cuda.synchronize()
    assert _build.launch_shapes() == [(kernel, shape, 1)]
    rec = reduce_trace(prof.profiler.kineto_results.events(),
                       torch.autograd.DeviceType.CUDA)
    rec["jobs"] = 1
    share = run.load_metric(metric).read(rec)
    assert share is not None and 0 < share <= 100, share


def _cell_table(dev, k=14, l_bits=26):
    """The table of the benchmark's table-k14 (or table-k256) configuration:
    its k, the hash seed and 64 reprobes, here at 2^l_bits slots."""
    from tsxcount_tpu_torch import GF2Hash, QuotientTable

    spec = KmerSpec(k)
    return QuotientTable(spec, l_bits, GF2Hash(spec, seed=31836),
                         max_reprobes=64, device=dev)


def _key_rows(dev, k: int, idx: np.ndarray) -> torch.Tensor:
    """Distinct keys for distinct indices below 12M: at k = 14 the index
    times 22 (a 14-mer); at k = 256 row `idx` of a seeded pool of 12M
    random 16-lane keys (any 512 bits are a 256-mer)."""
    if k == 14:
        return _t(idx.astype(np.int32)[:, None] * 22, dev)
    g = torch.Generator(device=dev).manual_seed(256)
    pool = torch.randint(-2**31, 2**31, (12_000_000, KmerSpec(k).lanes),
                         dtype=torch.int32, device=dev, generator=g)
    return pool[_t(idx, dev)]


@pytest.mark.parametrize("k", [14, 256])
def test_residue_kernel_matches_plain_rounds_at_the_cells_shape(dev,
                                                                monkeypatch,
                                                                k):
    """table-k14's (and table-k256's, 16 key lanes and 20 columns)
    2^26-slot table fed two synth-long-like batch histograms (2^24
    positions, ~9.4M valid windows drawn from 12M keys, a polyA key counted
    past 2^20; the second batch repeats most of the first's keys) through
    insert_histogram's whole schedule, once with the residue phase in the
    kernel and once in the plain rounds (table_residue_plain in the kernel
    wrapper's place): the two states word for word, and the same rounds
    run."""
    from tsxcount_tpu_torch import _build
    from tsxcount_tpu_torch.core import table as table_mod
    from tsxcount_tpu_torch.ops.count import count_unique
    from tsxcount_tpu_torch.ops.table_residue import table_residue_plain

    def plain_rounds(*args):
        *out, k = table_residue_plain(*args[:-1])
        args[-1].add_(k)
        return tuple(out)

    spec = KmerSpec(k)
    rng = np.random.default_rng(21)
    n_pos, n_valid = 1 << 24, 9_400_000
    hists = []
    for _ in range(2):
        idx = rng.integers(0, 12_000_000, n_pos)
        keys = _key_rows(dev, k, idx)
        keys[_t(rng.random(n_pos) < 0.12, dev)] = 0  # the polyA tails
        valid = np.arange(n_pos) < n_valid
        hists.append(count_unique(keys, _t(valid, dev), spec))
        del keys
    out = []
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(table_mod, "table_residue", plain_rounds)
        _build.reset_launch_counts()
        t = _cell_table(dev, k=k)
        st = t.init_state()
        for uc in hists:
            st = t.insert_histogram(st, uc)
        out.append((t, st, _build.launch_counts()["table_residue"]))
        del st
    (tk, sk, lk), (tp, sp, lp) = out
    assert torch.equal(sk.slots, sp.slots)
    for a, b in zip(sk[1:], sp[1:]):
        assert torch.equal(a, b)
    assert int(sk.spilled) == 0 and int(sk.n) > 8_000_000
    assert tk.rounds == tp.rounds > tk.inserts
    assert lk == tk.residue_launches == tp.residue_launches >= 1 and lp == 0


@pytest.mark.parametrize("width", [30_000, 300_000])
def test_residue_phase_makes_one_launch_and_no_host_sync(dev, width):
    """One residue_phase call from round 0 at `width` rows (one chunk of
    the kernel's 2^16 rows, and five), half of whose keys the table holds,
    under torch.cuda.set_sync_debug_mode("error"): it raises on any host
    sync.  One launch of the kernel and of no other port kernel; the state
    equals the plain rounds'."""
    from tsxcount_tpu_torch import _build
    from tsxcount_tpu_torch.core.table import TableState
    from tsxcount_tpu_torch.ops.table_residue import table_residue_plain

    t = _cell_table(dev, l_bits=20)
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 4**14, width + width // 10))[:width]
    keys = _t(rng.permutation(keys).astype(np.int32)[:, None], dev)
    counts = _t(rng.integers(1, 1 << 22, width).astype(np.int32), dev)
    valid = torch.ones(width, dtype=torch.bool, device=dev)
    st = t.insert(t.init_state(), keys[::2], counts[::2], valid[::2])
    pos0, cleared = t._hash_cols(keys)
    carry = (pos0, cleared, counts, valid)
    plain = TableState(st.slots.clone(), st.n, st.spilled, st.probe_hist)
    torch.cuda.synchronize()
    before = _build.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = t.residue_phase(st, carry, 0, width)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = _build.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"table_residue": 1}
    n, spilled, hist, _ = table_residue_plain(
        plain.slots, t.slots, carry, 0, width, t.max_reprobes, plain.n,
        plain.spilled, plain.probe_hist)
    want = t.renorm(TableState(plain.slots, n, spilled, hist))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got.n) == width and int(got.spilled) == 0


def test_table_k256_configuration_counts_on_card_like_the_reference(
        dev, tmp_path):
    """The benchmark's table-k256 configuration as the file gives it (2^26
    slots of 20 columns, 2^20-word batches) counts 2,000 synth-long reads
    on the card exactly as the benchmark's plain reference does: every
    tail in the 16-lane residue kernel, nothing spilled."""
    from portbench import reference, run, traffic
    from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

    cfg = run.load_config("table-k256")
    counter = ShardedKmerCounter(device=dev, **cfg["counter"])
    assert (counter.spec.lanes, counter.table.slot_cols) == (16, 20)
    mix = dict(run.load_traffic("synth-long"), reads=2000)
    path = str(tmp_path / "reads.fastq")
    traffic.write_fastq(mix, 2**31 + 256, path)
    counter.count_file(path)
    want = reference.reference_count(path, 256)
    assert counter.distinct == want[0].shape[0]
    check = reference.compare(want, run.export(counter, 256))
    assert len(check) >= 5 and set(check.values()) == {0}, check
    st = counter.stats()
    assert st["table_residue_launches"] == st["table_inserts"] >= 1
    assert 1 <= st["table_split_rounds"] < st["table_rounds"]
    assert counter.table.state_stats(counter.state)["spilled"] == 0
