"""The plain versions of kernels 4 and 5 (ops/apply.py) against the JAX
package's Pallas kernels in interpret mode, on the cases of
tests/test_pallas_apply.py.  Slot words are integers: exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tsxcount_tpu.ops import pallas_apply as pa  # noqa: E402
from tsxcount_tpu_torch.ops.apply import (  # noqa: E402
    apply_sorted_unique,
    gather_sorted,
)

from tests.test_pallas_apply import _case  # noqa: E402


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


# Every case runs at one shape (a 4096-word column, 4096 destinations
# padded with the 1 << 30 dead tail, tile 1024, window 2048), so each
# interpret-mode kernel is traced once per test process.
S, W, TILE, U_WIN = 4096, 4096, 1024, 2048


def _pad(dst2, val=None):
    n = W - len(dst2)
    dst2 = np.concatenate([dst2, np.full(n, pa.BIG, np.int32)])
    if val is None:
        return dst2
    return dst2, np.concatenate([val, np.zeros(n, np.uint32)])


def _apply_both(slots, dst2, val):
    dst2, val = _pad(dst2, val)
    want, over = pa.apply_sorted_unique(
        jnp.asarray(slots), jnp.asarray(dst2), jnp.asarray(val), tile=TILE,
        u_win=U_WIN, interpret=True)
    assert int(over) == 0
    col = _t(slots).clone()
    got, zero = apply_sorted_unique(col, _t(dst2), _t(val))
    assert got is col and int(zero) == 0  # in place
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


def _jax_gather(slots, dst2):
    want, over = pa.gather_sorted(jnp.asarray(slots), jnp.asarray(_pad(dst2)),
                                  tile=TILE, u_win=U_WIN, interpret=True)
    assert int(over) == 0
    return np.asarray(want)[: len(dst2)]


def _gather_both(slots, dst2):
    got, zero = gather_sorted(_t(slots), _t(_pad(dst2)))
    assert int(zero) == 0
    assert np.array_equal(got.numpy().view(np.uint32)[: len(dst2)],
                          _jax_gather(slots, dst2))


@pytest.mark.parametrize("seed", range(3))
def test_apply_random(seed):
    rng = np.random.default_rng(seed)
    slots, dst2, val = _case(rng, S, 1500, tile=TILE, u_win=U_WIN)
    _apply_both(slots, dst2, val)


def test_apply_dense_and_sparse():
    rng = np.random.default_rng(42)
    slots = rng.integers(0, 1000, size=S, dtype=np.uint32)
    dst2 = np.arange(S, dtype=np.int32) * 2 + 1
    val = rng.integers(0, 1000, size=S, dtype=np.uint32)
    _apply_both(slots, dst2, val)
    _apply_both(slots, np.array([(S - 3) * 2 + 1], np.int32),
                np.array([7], np.uint32))


def test_apply_all_dead_and_empty_tail():
    rng = np.random.default_rng(1)
    slots = rng.integers(0, 2**31, size=S, dtype=np.uint32)
    dst2 = np.full(512, pa.BIG, np.int32)
    val = rng.integers(0, 2**31, size=512, dtype=np.uint32)
    _apply_both(slots, dst2, val)


def test_apply_run_straddles_tiles():
    live = np.array([0, 1, 1023, 1024, 1025, 2047, 2048, 4095], np.int64)
    _apply_both(np.zeros(S, np.uint32), (live * 2 + 1).astype(np.int32),
                np.arange(1, len(live) + 1, dtype=np.uint32))


def test_apply_adds_wrap_past_2_32():
    """uint32 adds modulo 2^32, as the TPU kernel adds."""
    rng = np.random.default_rng(5)
    slots = rng.integers(2**31, 2**32, size=S, dtype=np.uint32)
    live = np.sort(rng.choice(S, 700, replace=False)).astype(np.int64)
    dst2 = np.sort(np.concatenate([live * 2 + 1,
                                   rng.integers(0, S, 300) * 2])
                   ).astype(np.int32)
    val = rng.integers(2**31, 2**32, size=len(dst2), dtype=np.uint32)
    _apply_both(slots, dst2, val)


def test_apply_columns_in_one_call_match_jax_per_column():
    """One call over five column regions of one flat slot array equals the
    JAX kernel applied column by column (the TPU table's loop): non-zero,
    all-zero, partly zero, wrapping and 0/1 value columns."""
    rng = np.random.default_rng(21)
    n_cols = 5
    flat = rng.integers(2**31, 2**32, size=n_cols * S, dtype=np.uint32)
    live = np.sort(rng.choice(S, 1500, replace=False)).astype(np.int64)
    dst2 = np.sort(np.concatenate([live * 2 + 1,
                                   rng.integers(0, S, 400) * 2])
                   ).astype(np.int32)
    w = len(dst2)
    vals = [rng.integers(0, 2**32, size=w, dtype=np.uint32),
            np.zeros(w, np.uint32),
            np.where(rng.random(w) < 0.5, rng.integers(1, 1000, w), 0
                     ).astype(np.uint32),
            rng.integers(2**31, 2**32, size=w, dtype=np.uint32),
            (rng.random(w) < 0.5).astype(np.uint32)]
    want = flat.copy()
    for c, val in enumerate(vals):
        d, v = _pad(dst2, val)
        out, over = pa.apply_sorted_unique(
            jnp.asarray(want[c * S : (c + 1) * S]), jnp.asarray(d),
            jnp.asarray(v), tile=TILE, u_win=U_WIN, interpret=True)
        assert int(over) == 0
        want[c * S : (c + 1) * S] = np.asarray(out)
    got = _t(flat).clone()
    cols = [got[c * S : (c + 1) * S] for c in range(n_cols)]
    res, zero = apply_sorted_unique(cols, _t(_pad(dst2)),
                                    [_t(_pad(dst2, v)[1]) for v in vals])
    assert res is cols and int(zero) == 0  # in place
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("seed", range(2))
def test_gather_random(seed):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, 2**31, size=S, dtype=np.uint32)
    live = np.sort(rng.choice(S, 1200, replace=False)).astype(np.int64)
    dead = np.sort(rng.integers(0, S, size=500, dtype=np.int64))
    dst2 = np.sort(np.concatenate([live * 2 + 1, dead * 2]),
                   kind="stable").astype(np.int32)
    _gather_both(slots, dst2)


def test_gather_dense_edges_and_tail():
    rng = np.random.default_rng(7)
    slots = rng.integers(0, 2**31, size=S, dtype=np.uint32)
    _gather_both(slots, np.arange(S, dtype=np.int32) * 2 + 1)
    live = np.array([0, 1023, 1024, 2047, 2048, 4095], np.int64)
    dst2 = np.concatenate([(live * 2 + 1).astype(np.int32),
                           np.full(100, 1 << 30, np.int32)])
    _gather_both(slots, dst2)


def _runs(rng):
    """Sorted probed slots with long runs, and each row's run-head flag."""
    slots = rng.integers(0, 2**32, size=S, dtype=np.uint32)
    pos = np.sort(rng.integers(0, S // 2, 3000))
    return slots, pos, np.r_[True, pos[1:] != pos[:-1]]


def test_gather_run_heads():
    """The JAX package's probe: heads of long runs read, the rest of each
    run an even value past the head's element."""
    slots, pos, head = _runs(np.random.default_rng(11))
    _gather_both(slots, np.where(head, 2 * pos + 1, 2 * pos + 2
                                 ).astype(np.int32))


def test_gather_every_row_equals_heads_filled_forward():
    """The port's probe: every row of a run reads its slot, which gives
    what the JAX package's head gather gives once filled forward."""
    slots, pos, head = _runs(np.random.default_rng(13))
    heads = _jax_gather(slots, np.where(head, 2 * pos + 1, 2 * pos + 2
                                        ).astype(np.int32))
    filled = heads[np.maximum.accumulate(np.where(head, np.arange(len(pos)),
                                                  0))]
    got, _ = gather_sorted(_t(slots), _t(_pad((2 * pos + 1).astype(np.int32))))
    assert np.array_equal(got.numpy().view(np.uint32)[: len(pos)], filled)


def test_gather_column_set_matches_jax_per_column():
    """One call over three column regions of one flat slot array (the
    table's probe columns) equals the JAX kernel called column by column,
    and each of its outputs the one-column call's."""
    rng = np.random.default_rng(23)
    n_cols = 3
    flat = rng.integers(0, 2**32, size=n_cols * S, dtype=np.uint32)
    live = np.sort(rng.choice(S, 1300, replace=False)).astype(np.int64)
    dead = rng.integers(0, S, size=400, dtype=np.int64)
    dst2 = np.sort(np.concatenate([live * 2 + 1, dead * 2])).astype(np.int32)
    regions = [flat[c * S : (c + 1) * S] for c in range(n_cols)]
    cols = [_t(r) for r in regions]
    outs, zero = gather_sorted(cols, _t(_pad(dst2)))
    assert isinstance(outs, tuple) and len(outs) == n_cols
    assert int(zero) == 0
    for col, region, out in zip(cols, regions, outs):
        assert np.array_equal(out.numpy().view(np.uint32)[: len(dst2)],
                              _jax_gather(region, dst2))
        one, _ = gather_sorted(col, _t(_pad(dst2)))
        assert torch.equal(one, out)


def test_apply_column_sets_checked():
    """One value column per slot column, 1..20 columns of one length: 20
    (a whole slot at k = 256) are taken in one call, 21 refused."""
    col = torch.zeros(S, dtype=torch.int32)
    dst2 = val = torch.ones(8, dtype=torch.int32)
    slot = torch.zeros(20 * S, dtype=torch.int32)
    cols = [slot[c * S : (c + 1) * S] for c in range(20)]
    vals = [torch.full((8,), c + 1, dtype=torch.int32) for c in range(20)]
    words8 = torch.arange(1, 17, 2, dtype=torch.int32)  # words 0..7, live
    apply_sorted_unique(cols, words8, vals)
    assert all(torch.equal(c[:8], v) and not c[8:].any()
               for c, v in zip(cols, vals))
    got, _ = gather_sorted(cols, words8)
    assert all(map(torch.equal, got, vals))
    with pytest.raises(ValueError):
        apply_sorted_unique([col] * 21, dst2, [val] * 21)
    with pytest.raises(ValueError):
        gather_sorted([col] * 21, dst2)
    with pytest.raises(ValueError):
        apply_sorted_unique([col, col.clone()], dst2, [val])
    with pytest.raises(ValueError):
        apply_sorted_unique([col, col[:-1]], dst2, [val, val])
