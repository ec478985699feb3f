"""The port's sharded counter at one shard (in this process, with no
process group), its routing helpers and the weighted histogram, against the
JAX package on the conftest's CPU mesh: dumps, totals, queries, shard
rows, spill, the count_file modes, a real prefix collision, checkpoints
crossing both ways, the stats keys and the memory model; and the GF(2)
routing (routing_hash="gf2", identity_hash) at one shard and over two
CPU ranks.  Several ranks otherwise: tests/test_torch_distributed.py.
Everything compared is an integer: exact."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tsxcount_tpu.config import KmerSpec as JKmerSpec  # noqa: E402
from tsxcount_tpu.ops.count import count_unique as j_count_unique  # noqa: E402
from tsxcount_tpu.parallel.sharded import (  # noqa: E402
    _owner_starts as j_owner_starts,
)
from tsxcount_tpu.parallel.sharded import (  # noqa: E402
    owner_of_hash as j_owner_of_hash,
)
from tsxcount_tpu_torch.config import KmerSpec  # noqa: E402
from tsxcount_tpu_torch.core.counter import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.ops.count import count_unique  # noqa: E402
from tsxcount_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedKmerCounter,
    _owner_starts,
    owner_of_hash,
)
from tsxcount_tpu_torch.utils.hbm import (  # noqa: E402
    estimate_for,
    estimate_hbm,
)

from tests.test_torch_distributed import (  # noqa: E402
    BW,
    GF2_SCENARIOS,
    GROUPS,
    K,
    L,
    LSM_L,
    SCENARIOS,
    WIDE_K,
    as_dict,
    jax_counter,
    jax_shard_rows,
    jax_table_shard_dump,
    make_inputs,
    naive,
    run_ranks,
    run_scenarios,
    save_jax_checkpoints,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(
        np.int32))


@pytest.mark.parametrize("k", [9, 16, 31, 113])
def test_weighted_count_unique_matches_jax(k):
    """count_unique with row weights (the sharded table's re-dedupe and
    the spill recovery): keys repeated up to max_multiplicity times, some
    rows invalid; keys, sums and n_unique equal the JAX function's."""
    rng = np.random.default_rng(k)
    spec = KmerSpec(k)
    n, mult = 300, 5
    base = rng.integers(0, 2**32, (n // mult, spec.lanes), dtype=np.uint32)
    base[:, -1] &= np.uint32(spec.top_lane_mask)
    keys = np.repeat(base, mult, axis=0)[rng.permutation(n)]
    valid = rng.random(n) < 0.8
    w = rng.integers(0, 1 << 20, n).astype(np.int32)
    ref = j_count_unique(jnp.asarray(keys), jnp.asarray(valid),
                         weights=jnp.asarray(w), spec=JKmerSpec(k),
                         max_multiplicity=mult)
    got = count_unique(_t(keys), torch.from_numpy(valid), spec,
                       weights=torch.from_numpy(w))
    m = int(ref.n_unique)
    assert int(got.n_unique) == m
    np.testing.assert_array_equal(got.keys.numpy().view(np.uint32)[:m],
                                  np.asarray(ref.keys)[:m])
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("k", [9, 16, 113])
def test_owner_of_hash_and_starts_match_jax(n_shards, k):
    """Owners of random top lanes, and the owner starts of sorted owners
    with an invalid tail (owner n_shards) and owners that get no row."""
    rng = np.random.default_rng(n_shards * 1000 + k)
    spec = KmerSpec(k)
    top = rng.integers(0, spec.top_lane_mask + 1, 500, dtype=np.uint64
                       ).astype(np.uint32)
    got = owner_of_hash(_t(top), spec, n_shards)
    want = j_owner_of_hash(jnp.asarray(top), JKmerSpec(k), n_shards)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    owners = np.sort(rng.integers(0, n_shards, 40))
    owners = owners[owners != n_shards // 2]  # an owner with no rows
    eff = np.concatenate([owners, np.full(9, n_shards)]).astype(np.int32)
    np.testing.assert_array_equal(
        _owner_starts(torch.from_numpy(eff).long(), n_shards).numpy(),
        np.asarray(j_owner_starts(jnp.asarray(eff), n_shards)))


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """Every scenario at one shard (the GF(2) routing's too), in this
    process, after the JAX package wrote its checkpoints of the reads at
    n_shards 1 (both routings)."""
    tmp = tmp_path_factory.mktemp("one_shard")
    spec = make_inputs(tmp, 1, seed=11, groups=GROUPS + ("gf2",))
    save_jax_checkpoints(tmp, 1, spec["reads"])
    save_jax_checkpoints(tmp, 1, spec["reads"], routing="gf2")
    run_scenarios(0, 1, tmp / "spec.json", tmp / "rank0.npz")
    return dict(np.load(tmp / "rank0.npz")), spec, tmp


@pytest.fixture(scope="module")
def two_gf2(tmp_path_factory):
    """The GF(2) routing's scenarios over two gloo CPU ranks (rows routed
    between processes by their GF(2) owners), after the JAX package wrote
    its GF(2) checkpoints at n_shards 2."""
    tmp = tmp_path_factory.mktemp("two_gf2")
    spec = make_inputs(tmp, 2, seed=12, groups=("gf2",))
    save_jax_checkpoints(tmp, 2, spec["reads"], routing="gf2")
    return run_ranks(tmp, 2), spec, tmp


def _gf2_case(request, n: int):
    """(n, the ranks' results, the inputs, the temp dir) of n shards."""
    if n == 1:
        out, spec, tmp = request.getfixturevalue("one")
        return 1, [out], spec, tmp
    ranks, spec, tmp = request.getfixturevalue("two_gf2")
    return 2, ranks, spec, tmp


@pytest.mark.parametrize("n", [1, 2], ids=lambda n: f"n{n}")
@pytest.mark.parametrize("name", list(GF2_SCENARIOS))
def test_gf2_routing_equals_jax(request, n, name):
    """routing_hash="gf2" (and identity_hash, which forces it) at one and
    two shards: dumps, totals and queries on every rank equal the JAX
    ShardedKmerCounter's and the naive count; each shard's sorted rows
    (hashed keys and digits) or table k-mers equal the JAX shard's."""
    n, ranks, spec, _ = _gf2_case(request, n)
    kw = GF2_SCENARIOS[name]
    j = jax_counter(n, spec["reads"], **kw)
    want = j.to_dict()
    assert want == naive(spec["reads"])
    jq = j.get_counts(spec["queries"])
    c = ShardedKmerCounter(**(dict(k=K, n_shards=1, l=L, batch_words=BW,
                                   device="cpu") | kw))
    assert c.routing_hash == j.routing_hash == "gf2"
    assert c.hash_fn.identity == j.hash_fn.identity == (name == "identity")
    for shard, out in enumerate(ranks):
        assert as_dict(out, name) == want
        assert int(out[f"{name}/distinct"]) == j.distinct
        assert int(out[f"{name}/total"]) == j.total_kmers
        assert out[f"{name}/queries"].tolist() == jq
        if kw.get("backend") == "table":
            assert out[f"{name}/shard_dump"].tolist() == [
                list(p) for p in jax_table_shard_dump(j, shard)]
            continue
        keys, digits = jax_shard_rows(j, shard)
        np.testing.assert_array_equal(out[f"{name}/shard_keys"], keys)
        np.testing.assert_array_equal(out[f"{name}/shard_digits"], digits)
        assert bool(out[f"{name}/lsm"]) == j.lsm


@pytest.mark.parametrize("n", [1, 2], ids=lambda n: f"n{n}")
@pytest.mark.parametrize("backend", ["sort", "table"])
def test_gf2_checkpoints_cross(request, n, backend):
    """The JAX file of the GF(2) routing resumes in the port; the port's
    file reloads there and loads in the JAX package, which resumes it."""
    from tsxcount_tpu.core.checkpoint import load_counter as j_load

    n, ranks, spec, tmp = _gf2_case(request, n)
    both = spec["reads"] + spec["more_reads"]
    for out in ranks:
        assert as_dict(out, f"ckpt_gf2_{backend}_jax") == naive(both)
        assert as_dict(out, f"ckpt_gf2_{backend}_own") == naive(
            spec["reads"])
    with np.load(tmp / f"port_gf2_{backend}.npz") as data:
        meta = json.loads(str(data["meta"]))
    assert (meta["n_shards"], meta["routing_hash"]) == (n, "gf2")
    j = j_load(tmp / f"port_gf2_{backend}.npz", batch_words=BW)
    assert (j.n_shards, j.backend, j.routing_hash) == (n, backend, "gf2")
    assert j.to_dict() == naive(spec["reads"])
    j.add_reads(spec["more_reads"])
    j.finish()
    assert j.to_dict() == naive(both)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_one_shard_equals_jax(one, name):
    """to_dict, distinct, total_kmers and get_counts equal the JAX
    ShardedKmerCounter's at n_shards 1 and the naive count; the stores
    are hashed (or not) alike."""
    out, spec, _ = one
    kw = SCENARIOS[name]
    j = jax_counter(1, spec["reads"], **kw)
    want = j.to_dict()
    assert want == naive(spec["reads"], canonical=kw.get("canonical", False))
    assert as_dict(out, name) == want
    assert int(out[f"{name}/distinct"]) == j.distinct
    assert int(out[f"{name}/total"]) == j.total_kmers
    assert out[f"{name}/queries"].tolist() == j.get_counts(spec["queries"])
    c = ShardedKmerCounter(**(dict(k=K, n_shards=1, l=L, batch_words=BW,
                                   device="cpu") | kw))
    assert c.hashed_store == j.hashed_store and c.lsm == j.lsm
    assert (c.route_cap, c._carry_enabled) == (j.route_cap,
                                               j._carry_enabled)


@pytest.mark.parametrize("name", ["sort", "canonical", "lsm"])
def test_one_shard_rows_equal_jax(one, name):
    """The shard's sorted rows [0, n) (raw keys: one shard below 8 lanes)
    equal the JAX shard's, converted by state_to_reference."""
    out, spec, _ = one
    keys, digits = jax_shard_rows(jax_counter(1, spec["reads"],
                                              **SCENARIOS[name]), 0)
    np.testing.assert_array_equal(out[f"{name}/shard_keys"], keys)
    np.testing.assert_array_equal(out[f"{name}/shard_digits"], digits)


def test_one_shard_table_dump_equals_jax(one):
    out, spec, _ = one
    j = jax_counter(1, spec["reads"], backend="table")
    assert out["table/shard_dump"].tolist() == [
        list(p) for p in jax_table_shard_dump(j, 0)]


def test_one_shard_stats_carry_the_jax_keys(one):
    out, spec, _ = one
    ref = jax_counter(1, spec["reads"]).stats()
    st = json.loads(str(out["sort/stats"]))
    assert set(ref) <= set(st), set(ref) - set(st)
    for key in ("n_shards", "shard_distinct", "shard_imbalance",
                "spill_recovered", "distinct_kmers", "total_kmers"):
        assert st[key] == ref[key], key


def test_one_shard_spill_recovered_and_past_the_carry(one):
    out, spec, _ = one
    assert int(out["spill/recovered"]) > 0
    assert as_dict(out, "spill") == naive(spec["spill_reads"])
    assert "spill carry" in str(out["spill_hard/error"])


@pytest.mark.parametrize("name,mode", [("range", "range"),
                                       ("gzip", "range"),
                                       ("python", "stripe")])
def test_one_shard_count_file_modes(one, name, mode):
    """One rank reads the whole file: the native parser (gzip too) or
    the Python packer."""
    out, spec, _ = one
    assert str(out[f"{name}/mode"]) == mode
    assert as_dict(out, name) == naive(spec["reads"])


@pytest.mark.parametrize("name", ["sort", "table", "canonical", "lsm",
                                  "gf2_sort", "gf2_table", "gf2_lsm",
                                  "identity", "range", "collision"])
def test_one_shard_steps_take_the_hand_off(one, name):
    """At one shard with no spill carry every step takes the one-shard
    hand-off (the collision scenario's recount with the full sort too):
    stats() route_direct_batches equals batches."""
    out, _, _ = one
    st = json.loads(str(out[f"{name}/stats"]))
    assert st["route_direct_batches"] == st["batches"] > 0


def test_one_shard_spill_carry_takes_the_padded_route(one):
    out, _, _ = one
    st = json.loads(str(out["spill/stats"]))
    assert st["batches"] > 0 and st["route_direct_batches"] == 0


def test_one_shard_real_prefix_collision_recounts(one):
    out, spec, _ = one
    assert bool(out["collision/full_sort"])
    assert as_dict(out, "collision") == naive(spec["wide_reads"], k=WIDE_K)


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_checkpoints_cross_at_one_shard(one, backend):
    """The JAX file loads here and resumes; the port's file (n_shards 1)
    loads in the JAX package and resumes there; both reload in the port."""
    from tsxcount_tpu.core.checkpoint import load_counter as j_load

    out, spec, tmp = one
    both = spec["reads"] + spec["more_reads"]
    assert as_dict(out, f"ckpt_{backend}_jax") == naive(both)
    assert as_dict(out, f"ckpt_{backend}_own") == naive(spec["reads"])
    with np.load(tmp / f"port_{backend}.npz") as data:
        assert json.loads(str(data["meta"]))["n_shards"] == 1
    j = j_load(tmp / f"port_{backend}.npz", batch_words=BW)
    assert j.n_shards == 1 and j.backend == backend
    assert j.to_dict() == naive(spec["reads"])
    j.add_reads(spec["more_reads"])
    j.finish()
    assert j.to_dict() == naive(both)


@pytest.mark.parametrize("backend", ["sort", "table"])
@pytest.mark.parametrize("collapse", [False, True])
def test_one_shard_equals_kmer_counter(one, backend, collapse):
    """The sharded counter at one shard counts what the plain one does
    (add_reads in two calls, then finish), homopolymer collapse included
    (reads with long all-A and all-C runs: the owed counts come back at
    read time)."""
    _, spec, _ = one
    reads = spec["reads"] + ["A" * 40 + "CGT" + "C" * 31, "GATTACA" * 3]
    kw = dict(k=K, l=L, batch_words=BW, backend=backend, device="cpu",
              collapse_homopolymers=collapse)
    s = ShardedKmerCounter(n_shards=1, **kw)
    p = KmerCounter(**kw)
    for c in (s, p):
        c.add_reads(reads[:70])
        c.add_reads(reads[70:])
        c.finish()
    assert s.to_dict() == p.to_dict() == naive(reads)
    assert s.get_counts(spec["queries"] + ["A" * K, "C" * K]) == (
        p.get_counts(spec["queries"] + ["A" * K, "C" * K]))
    assert s.total_kmers == p.total_kmers
    assert (sum(s.packer.stats.hp_bonus) > 0) == collapse


def test_one_shard_lsm_levels_equal_jax_mid_stream():
    """The sharded LSM geometry (L0 one flush rounded up to the routing
    alignment; core/lsm.py with `align`): the level capacities, the
    cascade's absorbs, and every level's rows after a stream of about 20
    flushes, before any collapse, equal the JAX sharded counter's."""
    from tsxcount_tpu.parallel.sharded import ShardedKmerCounter as JSharded

    from tests.test_packer import rand_reads

    reads = rand_reads(np.random.default_rng(21), 400, 60, 140)
    kw = dict(k=K, n_shards=1, l=LSM_L, batch_words=128, lsm=True,
              lsm_growth=2, merge_every=1)
    c = ShardedKmerCounter(device="cpu", **kw)
    j = JSharded(**kw)
    c.add_reads(reads)
    j.add_reads(reads)
    assert c.lsm and j.lsm
    assert [lv.capacity for lv in c.store.levels] == [
        s.capacity for s in j._lsm_stores]
    assert c.store.fill == j._lsm_fill
    assert c.store._flushes == j._lsm_flushes >= 16
    for i, lv in enumerate(c.store.levels):
        ref = lv.state_to_reference(c.state[i])
        n = int(ref["n"])
        assert n == int(j._gather(j.state[i].n)[0]), i
        np.testing.assert_array_equal(ref["keys"][:n],
                                      j._shard_rows(j.state[i].keys, 0, n))
        np.testing.assert_array_equal(
            ref["digits"][:n], j._shard_rows(j.state[i].digits, 0, n))
    # L0 into L1 at every flush, and the higher levels' cascades too
    assert c.store.absorbs > c.store._flushes


def test_estimate_hbm_n_shards():
    """One shard's device: its share of the store (the table's 2^(l -
    log2 n) slots), the routing buffers and the carry; estimate_for of a
    built sharded counter is estimate_hbm of its geometry."""
    one = estimate_hbm(14, 26, 1 << 20, n_shards=1)
    four = estimate_hbm(14, 26, 1 << 20, n_shards=4)
    plain = estimate_hbm(14, 26, 1 << 20)
    assert four.state_mb == pytest.approx(one.state_mb / 4)
    assert one.state_mb == plain.state_mb
    assert one.ingest_mb > plain.ingest_mb  # the route buffers
    t1 = estimate_hbm(14, 26, 1 << 16, backend="table", n_shards=1)
    t4 = estimate_hbm(14, 26, 1 << 16, backend="table", n_shards=4)
    assert t4.state_mb == pytest.approx(t1.state_mb / 4)
    c = ShardedKmerCounter(k=14, n_shards=1, l=12, batch_words=64,
                           device="cpu", lsm=True, lsm_growth=2,
                           merge_every=1)
    assert c.lsm
    assert estimate_for(c) == estimate_hbm(
        14, 12, 64, merge_every=1, lsm=True, lsm_growth=2, hash_first=False,
        n_shards=1)
