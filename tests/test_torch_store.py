"""CountStore: the port's store merge (kernel 2's merge tree, then kernel 3,
as plain versions on the CPU) against the JAX package's store merges — the
Pallas path in interpret mode (tile 1024) and the XLA path — on the same
seeded numpy state and batch histograms; plus the tail invariant, overflow,
lookup and the state exchange with the JAX package.  Everything compared is
an integer or a boolean: exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.core.store import CountStore as JCountStore, StoreState  # noqa: E402
from tsxcount_tpu_torch.config import KmerSpec  # noqa: E402
from tsxcount_tpu_torch.core.store import CountStore  # noqa: E402

FIELDS = ("keys", "digits", "used", "n", "overflowed")


def _sorted_keys(rng, n, spec):
    keys = rng.integers(0, 2**32, size=(n, spec.lanes), dtype=np.uint32)
    keys[:, -1] &= np.uint32(spec.top_lane_mask)
    keys = np.unique(keys, axis=0)
    return keys[np.lexsort(keys.T)]


def _inputs(k, cap, n0, r, p, seed, junk_tail=False):
    """A reference store state (numpy fields) and r batch histograms."""
    rng = np.random.default_rng(seed)
    spec = KmerSpec(k)
    head = _sorted_keys(rng, n0, spec)
    n0 = len(head)
    keys = np.zeros((cap, spec.lanes), np.uint32)
    keys[:n0] = head
    digits = np.zeros((cap, 3), np.int32)
    digits[:n0, 0] = rng.integers(1, 1 << 20, n0)
    digits[:n0, 1] = rng.integers(0, 1 << 14, n0)  # counts past 2^32
    if junk_tail:  # real-looking unsorted keys and counts past n
        keys[n0:] = rng.integers(0, 2**31, size=(cap - n0, spec.lanes))
        digits[n0:, 0] = rng.integers(1, 50, cap - n0)
    ref = dict(keys=keys, digits=digits, used=np.arange(cap) < n0,
               n=np.int32(n0), overflowed=np.bool_(False))
    uk = np.zeros((r, p, spec.lanes), np.uint32)
    uc = np.zeros((r, p), np.int32)
    uv = np.zeros((r, p), bool)
    for i in range(r):
        b = np.concatenate([head[rng.integers(0, n0, p // 3)],
                            _sorted_keys(rng, p // 2, spec)])
        b = np.unique(b, axis=0)
        b = b[np.lexsort(b.T)]
        uk[i, : len(b)] = b
        uk[i, len(b) :] = rng.integers(0, 2**31, (p - len(b), spec.lanes))
        uc[i] = rng.integers(1, 1 << 30, p)
        uv[i, : len(b)] = True
    return ref, uk, uc, uv


def _port_merge(k, cap, ref, uk, uc, uv):
    store = CountStore(KmerSpec(k), cap, "cpu")
    st = store.merge_stacked(
        store.state_from_reference(ref), torch.from_numpy(uk.view(np.int32)),
        torch.from_numpy(uc), torch.from_numpy(uv),
    )
    return store, st


def _jax_state(ref):
    return StoreState(**{f: jnp.asarray(ref[f]) for f in FIELDS})


@pytest.mark.parametrize("k", [14, 31])
def test_merge_stacked_matches_jax_pallas(k):
    """Full state equality with the JAX fused (Pallas) store merge, from a
    state whose unused rows hold junk (the round-2 corruption case)."""
    cap = 4096
    ref, uk, uc, uv = _inputs(k, cap, 900, 2, 1024, seed=k, junk_tail=True)
    jstore = JCountStore(JKmerSpec(k), cap)
    want = jstore._merge_stacked_pallas(
        _jax_state(ref), jnp.asarray(uk), jnp.asarray(uc), jnp.asarray(uv),
        interpret=True, tile=1024, fused=True,
    )
    store, st = _port_merge(k, cap, ref, uk, uc, uv)
    got = store.state_to_reference(st)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    # the tail invariant: past n, the invalid constant and count 0
    n = int(st.n)
    for col, const in zip(st.keys, store.inv_consts):
        assert bool((col[n:] == const).all())
    assert not st.counts[n:].any()


@pytest.mark.parametrize("k,r", [(9, 3), (16, 2), (33, 4), (112, 2)])
def test_merge_stacked_matches_jax_xla(k, r):
    cap = 2048
    ref, uk, uc, uv = _inputs(k, cap, 500, r, 512, seed=100 + k)
    want = JCountStore(JKmerSpec(k), cap).merge_stacked(
        _jax_state(ref), jnp.asarray(uk), jnp.asarray(uc), jnp.asarray(uv))
    store, st = _port_merge(k, cap, ref, uk, uc, uv)
    got = store.state_to_reference(st)
    n = int(want.n)
    assert int(got["n"]) == n and not bool(got["overflowed"])
    np.testing.assert_array_equal(got["keys"][:n], np.asarray(want.keys)[:n])
    np.testing.assert_array_equal(got["digits"][:n],
                                  np.asarray(want.digits)[:n])


def test_overflow_flag_matches_jax():
    cap = 512
    ref, uk, uc, uv = _inputs(14, cap, 400, 2, 512, seed=5)
    want = JCountStore(JKmerSpec(14), cap).merge_stacked(
        _jax_state(ref), jnp.asarray(uk), jnp.asarray(uc), jnp.asarray(uv))
    store, st = _port_merge(14, cap, ref, uk, uc, uv)
    assert bool(want.overflowed) and bool(st.overflowed)
    assert int(st.n) == int(want.n) == cap
    np.testing.assert_array_equal(store.state_to_reference(st)["keys"],
                                  np.asarray(want.keys))


def test_lookup():
    cap = 2048
    ref, uk, uc, uv = _inputs(33, cap, 600, 2, 512, seed=8)
    store, st = _port_merge(33, cap, ref, uk, uc, uv)
    keys, counts, n = store.to_host(st)
    rng = np.random.default_rng(1)
    absent = _sorted_keys(rng, 64, KmerSpec(33))
    q = np.concatenate([keys[rng.integers(0, n, 200)], absent])
    got, found = store.lookup(st, torch.from_numpy(q.view(np.int32)))
    table = {tuple(kk): int(c) for kk, c in zip(keys.tolist(), counts)}
    want = [table.get(tuple(kk), 0) for kk in q.tolist()]
    assert got.tolist() == want
    assert found.tolist() == [w > 0 for w in want]
    # an empty store finds nothing
    empty = store.init_state()
    got, found = store.lookup(empty, torch.from_numpy(q.view(np.int32)))
    assert not found.any() and not got.any()


@pytest.mark.parametrize("k", [14, 16, 47])
def test_state_exchange_round_trips(k):
    cap = 1024
    ref, uk, uc, uv = _inputs(k, cap, 300, 2, 256, seed=k)
    store, st = _port_merge(k, cap, ref, uk, uc, uv)
    # port -> reference -> port is the identity
    back = store.state_from_reference(store.state_to_reference(st))
    for a, b in zip(st, back):
        assert torch.equal(a, b)
    # a canonical reference state (zero tail) survives reference -> port ->
    # reference unchanged
    canon = store.state_to_reference(st)
    again = store.state_to_reference(store.state_from_reference(canon))
    for f in FIELDS:
        np.testing.assert_array_equal(again[f], canon[f], err_msg=f)


def test_state_from_reference_rejects_gaps():
    store = CountStore(KmerSpec(14), 64, "cpu")
    ref = store.state_to_reference(store.init_state())
    ref["used"] = ref["used"].copy()
    ref["used"][3] = True
    with pytest.raises(ValueError):
        store.state_from_reference(ref)
