"""The port's QuotientTable against the JAX package's, on the same seeded
batches: the table states (slots, n, spilled, probe_hist) must be equal
word for word, and queries and exports equal.  Everything is an integer:
exact equality.

The port runs its rounds in the kernel form (kernels 5, 4 and 1, here as
their plain versions).  The JAX package picks its element form on the CPU;
its kernel form runs here in interpret mode once, at a small size."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.core.table import QuotientTable as JQuotientTable  # noqa: E402
from tsxcount_tpu.ops.gf2 import GF2Hash as JGF2Hash  # noqa: E402
from tsxcount_tpu_torch import GF2Hash, QuotientTable  # noqa: E402
from tsxcount_tpu_torch.config import KmerSpec  # noqa: E402

from tests.test_table import _rand_batch, _split_insert  # noqa: E402


def _tables(k, l, seed=1, max_reprobes=64, identity=False):
    jt = JQuotientTable(JKmerSpec(k), l,
                        JGF2Hash(JKmerSpec(k), seed=seed, identity=identity),
                        max_reprobes=max_reprobes)
    pt = QuotientTable(KmerSpec(k), l,
                       GF2Hash(KmerSpec(k), seed=seed, identity=identity),
                       max_reprobes=max_reprobes, device="cpu")
    return jt, pt


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _args(ukeys, ucounts, uvalid):
    return _t(ukeys), _t(ucounts), torch.from_numpy(uvalid)


def _slice(carry, w):
    p0, cl, c, a = carry
    return p0[:w], tuple(x[:w] for x in cl), c[:w], a[:w]


def port_split_insert(table, st, k, c, v):
    """The JAX tests' _split_insert flow (round 0, round 1, residue)."""
    st, carry, _, n_left = table.split_round(
        st, 0, *table.round0_args(k, c, v))
    f = int(n_left)
    if f == 0:
        return table.renorm(st)
    w1 = min(k.shape[0], max(256, 1 << (f - 1).bit_length()))
    st, carry, _, n_left = table.split_round(st, 1, *_slice(carry, w1))
    f = int(n_left)
    if f == 0:
        return table.renorm(st)
    w2 = min(w1, max(256, 1 << (f - 1).bit_length()))
    return table.residue_phase(st, _slice(carry, w2), 2, w2)


def assert_same_state(jstate, table, pstate):
    got = table.state_to_reference(pstate)
    for f in ("slots", "n", "spilled", "probe_hist"):
        want = np.asarray(getattr(jstate, f))
        assert got[f].dtype == want.dtype, f
        assert np.array_equal(got[f], want), f


def _jargs(ukeys, ucounts, uvalid):
    return jnp.asarray(ukeys), jnp.asarray(ucounts), jnp.asarray(uvalid)


@pytest.mark.parametrize("k,l,n,n_u", [(14, 10, 2048, 700),
                                       (33, 11, 2048, 900),
                                       (127, 9, 1024, 300)])
def test_split_flow_matches_jax_element_mode(k, l, n, n_u):
    jt, pt = _tables(k, l)
    batch = _rand_batch(np.random.default_rng(k), n, n_u, KmerSpec(k))
    want = _split_insert(jt, jt.init_state(), *_jargs(*batch), mode="element")
    got = port_split_insert(pt, pt.init_state(), *_args(*batch))
    assert_same_state(want, pt, got)
    assert int(got.n) == n_u and int(got.spilled) == 0


def test_split_flow_matches_jax_kernel_mode():
    """The JAX package's kernel form (Pallas in interpret mode) gives the
    same state as the port's kernel form."""
    jt, pt = _tables(14, 10, seed=3)
    batch = _rand_batch(np.random.default_rng(3), 2048, 700, KmerSpec(14))
    want = _split_insert(jt, jt.init_state(), *_jargs(*batch), mode="kernel")
    got = port_split_insert(pt, pt.init_state(), *_args(*batch))
    assert_same_state(want, pt, got)


@pytest.mark.parametrize("k", [14, 33])
def test_insert_matches_jax(k):
    jt, pt = _tables(k, 9)
    rng = np.random.default_rng(k)
    jst, pst = jt.init_state(), pt.init_state()
    for _ in range(3):
        batch = _rand_batch(rng, 512, int(rng.integers(100, 300)),
                            KmerSpec(k))
        jst = jax.jit(jt.insert)(jst, *_jargs(*batch))
        pst = pt.insert(pst, *_args(*batch))
    assert_same_state(jst, pt, pst)


def test_identity_hash_reprobe_chain():
    """Twelve keys with one home slot walk the triangular reprobe chain."""
    jt, pt = _tables(14, 4, identity=True, max_reprobes=15)
    keys = np.array([[i << 4] for i in range(12)], dtype=np.uint32)
    batch = (keys, np.ones(12, np.int32), np.ones(12, bool))
    jst = jt.insert(jt.init_state(), *_jargs(*batch))
    pst = pt.insert(pt.init_state(), *_args(*batch))
    assert_same_state(jst, pt, pst)
    assert int(pst.spilled) == 0
    digits, found = pt.lookup(pst, _t(keys))
    assert bool(found.all()) and (digits[:, 0] == 1).all()
    kmers, counts, n = pt.to_host(pst)
    assert n == 12 and sorted(int(x[0]) for x in kmers) == [
        i << 4 for i in range(12)]


def test_spill_on_full_table():
    jt, pt = _tables(14, 3, seed=2, max_reprobes=7)
    keys = np.arange(64, dtype=np.uint32)[:, None]  # 64 keys, 8 slots
    batch = (keys, np.ones(64, np.int32), np.ones(64, bool))
    jst = jt.insert(jt.init_state(), *_jargs(*batch))
    pst = pt.insert(pt.init_state(), *_args(*batch))
    assert_same_state(jst, pt, pst)
    assert int(pst.spilled) > 0


def test_residue_overflow_spills_exactly():
    jt, pt = _tables(14, 3, seed=3, max_reprobes=2)
    rng = np.random.default_rng(4)
    p = 512
    keys = np.unique(rng.integers(0, 4**7, size=400, dtype=np.uint32)
                     )[:300][:, None]
    ukeys = np.zeros((p, 1), np.uint32)
    ukeys[: len(keys)] = keys
    batch = (ukeys, np.ones(p, np.int32), np.arange(p) < len(keys))
    jst = jt.insert(jt.init_state(), *_jargs(*batch))
    pst = pt.insert(pt.init_state(), *_args(*batch))
    assert_same_state(jst, pt, pst)
    assert int(pst.n) + int(pst.spilled) == len(keys)
    assert int(pst.spilled) > 0


def test_multi_batch_matches_at_depth():
    """Several batches through the split flow: later batches match keys
    claimed earlier at any reprobe depth."""
    jt, pt = _tables(14, 13)
    rng = np.random.default_rng(17)
    jst, pst = jt.init_state(), pt.init_state()
    truth = collections.Counter()
    for _ in range(4):
        n, n_u = 2048, int(rng.integers(700, 1500))
        uniq = rng.choice(2**13, size=n_u, replace=False).astype(np.uint32)
        ukeys = np.zeros((n, 1), np.uint32)
        ukeys[:n_u, 0] = uniq
        ucounts = rng.integers(1, 5, size=n).astype(np.int32)
        truth.update({int(k): int(c) for k, c in zip(uniq, ucounts)})
        batch = (ukeys, ucounts, np.arange(n) < n_u)
        jst = _split_insert(jt, jst, *_jargs(*batch), mode="element")
        pst = port_split_insert(pt, pst, *_args(*batch))
    assert_same_state(jst, pt, pst)
    assert int(pst.spilled) == 0 and len(pst.probe_hist.nonzero()) > 3
    kk, cc, _ = pt.to_host(pst)
    assert {int(k[0]): int(c) for k, c in zip(kk, cc)} == dict(truth)


@pytest.fixture(scope="module")
def filled():
    """A k=33 table in both packages, 3 batches deep, plus its keys."""
    jt, pt = _tables(33, 11, seed=5)
    rng = np.random.default_rng(33)
    jst, pst = jt.init_state(), pt.init_state()
    keys = []
    for _ in range(3):
        batch = _rand_batch(rng, 1024, 250, KmerSpec(33))
        batch[1][:] = rng.integers(1 << 19, 1 << 30, size=1024)  # carries
        keys.append(batch[0][batch[2]])
        jst = _split_insert(jt, jst, *_jargs(*batch), mode="element")
        pst = port_split_insert(pt, pst, *_args(*batch))
    assert_same_state(jst, pt, pst)
    return jt, jst, pt, pst, np.unique(np.concatenate(keys), axis=0)


def _queries(keys):
    absent = keys[:50].copy()
    absent[:, 0] ^= np.uint32(0x5A5A5A5A)
    return np.concatenate([keys, absent])


def test_lookup_and_get_positions_match_jax(filled):
    jt, jst, pt, pst, keys = filled
    q = _queries(keys)
    jd, jf = jt.lookup(jst, jnp.asarray(q))
    pd, pf = pt.lookup(pst, _t(q))
    assert np.array_equal(pf.numpy(), np.asarray(jf))
    assert np.array_equal(pd.numpy(), np.asarray(jd))
    assert pf[: len(keys)].all()
    for got, want in zip(pt.get_positions(pst, _t(q)),
                         jt.get_positions(jst, jnp.asarray(q))):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_reconstruct_all_and_to_host_match_jax(filled, monkeypatch):
    jt, jst, pt, pst, keys = filled
    jk, ju = jt.reconstruct_all(jst)
    pk, pu = pt.reconstruct_all(pst)
    assert np.array_equal(pu.numpy(), np.asarray(ju))
    assert np.array_equal(pk.numpy().view(np.uint32)[pu.numpy()],
                          np.asarray(jk)[np.asarray(ju)])
    want_k, want_c, want_n = jt.to_host(jst)
    monkeypatch.setattr(QuotientTable, "_EXPORT_CHUNK", 256)  # 8 chunks
    got_k, got_c, got_n = pt.to_host(pst)
    assert got_n == want_n == len(keys)
    assert np.array_equal(got_k, want_k)  # slot order
    assert [int(c) for c in got_c] == [int(c) for c in want_c]
    assert max(int(c) for c in got_c) >= 1 << 20  # digits carried
    assert pt.fill_factor(pst) == jt.fill_factor(jst)
    assert np.array_equal(pt.state_keys(pst).numpy().view(np.uint32),
                          np.asarray(jt.state_keys(jst)))
    assert np.array_equal(pt.state_digits(pst).numpy(),
                          np.asarray(jt.state_digits(jst)))


def test_reference_state_round_trip(filled):
    jt, jst, pt, pst, _ = filled
    ref = {f: np.asarray(v) for f, v in jst._asdict().items()}
    back = pt.state_to_reference(pt.state_from_reference(ref))
    for f in ref:
        assert back[f].dtype == ref[f].dtype and np.array_equal(back[f],
                                                                ref[f])
    with pytest.raises(ValueError):
        pt.state_from_reference(dict(ref, slots=ref["slots"][:-1]))


def test_constructor_checks():
    spec = KmerSpec(14)
    with pytest.raises(ValueError, match="l_bits"):
        QuotientTable(spec, 0, GF2Hash(spec), device="cpu")
    with pytest.raises(ValueError, match="func field"):
        QuotientTable(KmerSpec(4), 8, GF2Hash(KmerSpec(4)), device="cpu")
    # the port's kernels take one region a column and a doubled SLOT
    # address: the JAX package's cap on 2^L x columns is not the port's,
    # so its widest key holds the upstream's 2^26 slots (no slot array is
    # made here)
    with pytest.raises(ValueError, match="doubled slot address"):
        QuotientTable(KmerSpec(31), 30, GF2Hash(KmerSpec(31)),
                      device="cpu")
    for k, l_bits in ((127, 27), (256, 26), (256, 29)):
        wide = QuotientTable(KmerSpec(k), l_bits,
                             GF2Hash(KmerSpec(k), identity=True),
                             device="cpu")
        assert wide.slots == 1 << l_bits
    table = QuotientTable(spec, 3, GF2Hash(spec), device="cpu")
    assert table.max_reprobes == 7 and table.device.type == "cpu"
