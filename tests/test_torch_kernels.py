"""The plain PyTorch versions of the port's three CUDA kernels against the
JAX package's Pallas kernels, run in interpret mode (tile 1024, small
sizes), on the same seeded numpy inputs.

On a CPU tensor each port wrapper runs its plain version; the CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.  Every output is an integer, so the tolerance is exact
equality.  The port carries uint32 key words as int32 bit patterns and a
count as one int64 where the JAX kernels carry (lo uint32, hi int32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tsxcount_tpu.ops.pallas_compact import compact_flagged as jax_compact  # noqa: E402
from tsxcount_tpu.ops.pallas_merge import merge_sorted as jax_merge  # noqa: E402
from tsxcount_tpu.ops.pallas_merge_dedupe import (  # noqa: E402
    merge_dedupe_sorted as jax_merge_dedupe,
)
from tsxcount_tpu_torch.ops.compact import compact_flagged  # noqa: E402
from tsxcount_tpu_torch.ops.merge import merge_sorted  # noqa: E402
from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted  # noqa: E402

TILE = 1024
INV_MIN = 1 << 30  # test convention: msb >= 2^30 marks the invalid run


def to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# --- kernel 1: compact_flagged ----------------------------------------------

@pytest.mark.parametrize("density,seed", [(0.0, 3), (0.1, 1), (0.9, 2),
                                          (1.0, 4)])
def test_compact_matches_jax(density, seed):
    rng = np.random.default_rng(seed)
    total = 2 * TILE
    flag = (rng.random(total) < density).astype(np.int32)
    a = rng.integers(0, 2**32, size=total, dtype=np.uint32)  # full 32 bits
    b = rng.integers(-2**31, 2**31, size=total, dtype=np.int32)
    want = jax_compact(jnp.asarray(flag), (jnp.asarray(a), jnp.asarray(b)),
                       tile=TILE, interpret=True)
    got = compact_flagged(torch.from_numpy(flag), (to_torch(a), to_torch(b)))
    n = int(flag.sum())
    np.testing.assert_array_equal(as_u32(got[0])[:n], np.asarray(want[0])[:n])
    np.testing.assert_array_equal(got[1].numpy()[:n], np.asarray(want[1])[:n])
    assert got[0].shape == (total,)


def test_compact_bool_flags_match_jax_int32_flags():
    """The port's callers pass bool flags; the JAX kernel takes the same
    flags as int32."""
    rng = np.random.default_rng(8)
    total = 2 * TILE
    flag = rng.random(total) < 0.4
    a = rng.integers(0, 2**32, size=total, dtype=np.uint32)
    b = rng.integers(-2**31, 2**31, size=total, dtype=np.int32)
    want = jax_compact(jnp.asarray(flag.astype(np.int32)),
                       (jnp.asarray(a), jnp.asarray(b)), tile=TILE,
                       interpret=True)
    got = compact_flagged(torch.from_numpy(flag), (to_torch(a), to_torch(b)))
    n = int(flag.sum())
    np.testing.assert_array_equal(as_u32(got[0])[:n], np.asarray(want[0])[:n])
    np.testing.assert_array_equal(got[1].numpy()[:n], np.asarray(want[1])[:n])


def test_compact_cross_tile_offsets():
    """Irregular flag counts per tile put every tile's output at a
    different offset (the TPU kernel's read-modify-write windows)."""
    rng = np.random.default_rng(9)
    total = 8 * TILE
    flag = np.zeros(total, np.int32)
    for t in range(8):
        c = int(rng.integers(0, TILE))
        flag[rng.choice(TILE, size=c, replace=False) + t * TILE] = 1
    vals = np.arange(total, dtype=np.int32)
    (want,) = jax_compact(jnp.asarray(flag), (jnp.asarray(vals),),
                          tile=TILE, interpret=True)
    (got,) = compact_flagged(torch.from_numpy(flag), (to_torch(vals),))
    n = int(flag.sum())
    np.testing.assert_array_equal(got.numpy()[:n], np.asarray(want)[:n])


def test_compact_carries_int64_columns():
    """The port also carries int64 columns (counts, prefix sums)."""
    rng = np.random.default_rng(5)
    flag = (rng.random(3000) < 0.3).astype(np.int32)
    big = rng.integers(-2**62, 2**62, size=3000)
    (got,) = compact_flagged(torch.from_numpy(flag), (to_torch(big),))
    n = int(flag.sum())
    np.testing.assert_array_equal(got.numpy()[:n], big[flag == 1])


# --- kernel 2: merge_sorted -------------------------------------------------

def _sorted(rng, n, hi):
    return np.sort(rng.integers(0, hi, size=n, dtype=np.uint64)
                   ).astype(np.uint32)


@pytest.mark.parametrize("m,n,hi", [
    (1700, 348, 50),        # heavy duplication: stability across tiles
    (1024, 1024, 2**32 - 1),  # full-width words: an unsigned compare
])
def test_merge_stable_matches_jax(m, n, hi):
    rng = np.random.default_rng(m + n)
    a, b = _sorted(rng, m, hi), _sorted(rng, n, hi)
    pa = np.arange(m, dtype=np.int32)
    pb = np.arange(n, dtype=np.int32) + 10000
    want = jax_merge((jnp.asarray(a), jnp.asarray(pa)),
                     (jnp.asarray(b), jnp.asarray(pb)),
                     tile=TILE, interpret=True)
    got = merge_sorted((to_torch(a), to_torch(pa)),
                       (to_torch(b), to_torch(pb)))
    np.testing.assert_array_equal(as_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_merge_multiset_exact():
    rng = np.random.default_rng(9)
    a, b = _sorted(rng, 2048, 1000), _sorted(rng, 2048, 1000)
    pa = rng.integers(0, 2**31, size=2048, dtype=np.int32)
    pb = rng.integers(0, 2**31, size=2048, dtype=np.int32)
    want = jax_merge((jnp.asarray(a), jnp.asarray(pa)),
                     (jnp.asarray(b), jnp.asarray(pb)),
                     tile=TILE, interpret=True)
    got = merge_sorted((to_torch(a), to_torch(pa)),
                       (to_torch(b), to_torch(pb)))
    np.testing.assert_array_equal(as_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert sorted(zip(as_u32(got[0]).tolist(), got[1].tolist())) == sorted(
        list(zip(a.tolist(), pa.tolist())) + list(zip(b.tolist(), pb.tolist()))
    )


def test_merge_two_key_columns():
    """n_keys=2: (hi, lo) pairs with a full 32-bit lo word."""
    rng = np.random.default_rng(11)

    def run(n):
        v = np.sort(rng.integers(0, 8, n).astype(np.uint64) << np.uint64(32)
                    | rng.integers(0, 2**32, n, dtype=np.uint64))
        return (v >> np.uint64(32)).astype(np.uint32), (
            v & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    ah, al = run(1024)
    bh, bl = run(1024)
    pa = np.arange(1024, dtype=np.int32)
    pb = pa + 100000
    want = jax_merge(
        tuple(map(jnp.asarray, (ah, al, pa))),
        tuple(map(jnp.asarray, (bh, bl, pb))),
        tile=TILE, interpret=True, n_keys=2,
    )
    got = merge_sorted(tuple(map(to_torch, (ah, al, pa))),
                       tuple(map(to_torch, (bh, bl, pb))), n_keys=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).view(g.numpy().dtype))


# --- kernel 3: merge_dedupe_sorted ------------------------------------------

def _make_run(rng, n, n_keys, n_invalid, key_space, max_lo):
    """A sorted run of (keys, lo uint32, hi int32) with n_invalid rows at
    the end masked to the shared invalid constant (as test_fused_merge)."""
    keys = rng.integers(0, key_space, size=(n, n_keys), dtype=np.uint32)
    keys = keys[np.lexsort(tuple(keys[:, j] for j in reversed(range(n_keys))))]
    lo = rng.integers(0, max_lo, size=n, dtype=np.uint32)
    hi = rng.integers(0, 3, size=n).astype(np.int32)
    if n_invalid:
        keys[n - n_invalid :, 0] = INV_MIN
        keys[n - n_invalid :, 1:] = 0
        lo[n - n_invalid :] = 0
        hi[n - n_invalid :] = 0
    return [keys[:, j] for j in range(n_keys)] + [lo, hi]


def _check_merge_dedupe(a, b, n_keys):
    """JAX (lo, hi) columns vs the port's int64 count column."""
    out, n_runs, n_valid = jax_merge_dedupe(
        tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)),
        n_keys=n_keys, inv_min=INV_MIN, tile=TILE, interpret=True,
    )

    def port_run(cols):
        cnt = cols[n_keys].astype(np.int64) + (
            cols[n_keys + 1].astype(np.int64) << 32)
        return tuple(map(to_torch, cols[:n_keys])) + (to_torch(cnt),)

    got, g_runs, g_valid = merge_dedupe_sorted(
        port_run(a), port_run(b), n_keys, INV_MIN
    )
    r = int(n_runs)
    assert (int(g_runs), int(g_valid)) == (r, int(n_valid))
    for j in range(n_keys):
        np.testing.assert_array_equal(as_u32(got[j])[:r],
                                      np.asarray(out[j])[:r])
    want = np.asarray(out[n_keys])[:r].astype(np.int64) + (
        np.asarray(out[n_keys + 1])[:r].astype(np.int64) << 32)
    np.testing.assert_array_equal(got[n_keys].numpy()[:r], want)
    return got[n_keys].numpy()[:r]


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_merge_dedupe_random_runs(n_keys):
    rng = np.random.default_rng(7 + n_keys)
    a = _make_run(rng, 2048, n_keys, 37, 1500, 2**32 - 1)
    b = _make_run(rng, 1024, n_keys, 11, 1500, 2**32 - 1)
    _check_merge_dedupe(a, b, n_keys)


def test_merge_dedupe_heavy_duplication_sums_cross_2_32():
    """One key dominating both runs: a run over many tiles whose sum
    crosses 2^32 many times over."""
    rng = np.random.default_rng(3)
    a_keys = np.zeros(2048, np.uint32)
    a_keys[1500:] = np.sort(rng.integers(1, 50, 548)).astype(np.uint32)
    zero = np.zeros(2048, np.int32)
    a = [a_keys, rng.integers(2**31, 2**32 - 1, 2048, dtype=np.uint32), zero]
    b = [np.zeros(2048, np.uint32),
         rng.integers(2**31, 2**32 - 1, 2048, dtype=np.uint32), zero]
    sums = _check_merge_dedupe(a, b, 1)
    assert sums[0] > 2**40


def test_merge_dedupe_all_invalid_b_side():
    rng = np.random.default_rng(11)
    a = _make_run(rng, 2048, 2, 0, 500, 1000)
    b = _make_run(rng, 1024, 2, 1024, 500, 1000)
    _check_merge_dedupe(a, b, 2)


@pytest.mark.parametrize("m,n", [(0, 2048), (2048, 0)])
def test_merge_dedupe_one_side_empty(m, n):
    rng = np.random.default_rng(m + 3 * n)
    a = _make_run(rng, m, 1, min(m, 13), 500, 2**32 - 1)
    b = _make_run(rng, n, 1, min(n, 13), 500, 2**32 - 1)
    _check_merge_dedupe(a, b, 1)
