"""The port's sharded counter at 4 and 5 ranks (CPU subprocesses on gloo,
tests/test_torch_distributed.py's harness): checkpoints crossing both
ways between the packages at n_shards 4, and at 5 ranks, which the JAX
package's tests never cover, counts equal to the port's own KmerCounter
and a naive count.  Exact."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu_torch.core.counter import KmerCounter  # noqa: E402

from tests.test_torch_distributed import (  # noqa: E402
    BW,
    K,
    L,
    SCENARIOS,
    as_dict,
    make_inputs,
    naive,
    run_ranks,
    save_jax_checkpoints,
)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The JAX package's checkpoints of the reads at n_shards 4 (its CPU
    mesh), then 4 ranks that load them and save their own."""
    tmp = tmp_path_factory.mktemp("ranks4")
    spec = make_inputs(tmp, 4, seed=4, groups=("ckpt",))
    save_jax_checkpoints(tmp, 4, spec["reads"])
    return run_ranks(tmp, 4), spec, tmp


@pytest.fixture(scope="module")
def five(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks5")
    spec = make_inputs(tmp, 5, seed=5, groups=("stores", "unequal", "files"))
    return run_ranks(tmp, 5), spec


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_jax_file_loads_and_resumes_at_four_shards(four, backend):
    ranks, spec, _ = four
    want = naive(spec["reads"] + spec["more_reads"])
    for out in ranks:
        assert as_dict(out, f"ckpt_{backend}_jax") == want
        st = json.loads(str(out[f"ckpt_{backend}_jax/stats"]))
        assert st["n_shards"] == 4 and len(st["shard_distinct"]) == 4


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_port_file_loads_and_resumes_in_jax_at_four_shards(four, backend):
    """The port's file (rank 0 wrote the four shards' stacked states)
    loads in the JAX package at n_shards 4 with the same shard sizes, and
    resumes there."""
    from tsxcount_tpu.core.checkpoint import load_counter as j_load

    ranks, spec, tmp = four
    path = tmp / f"port_{backend}.npz"
    with np.load(path) as data:
        meta = json.loads(str(data["meta"]))
    assert meta["n_shards"] == 4 and meta["routing_hash"] == "mix"
    j = j_load(path, batch_words=BW)
    assert j.n_shards == 4 and j.to_dict() == naive(spec["reads"])
    assert [int(x) for x in j._gather(j._read_state.n)] == json.loads(
        str(ranks[0][f"ckpt_{backend}_own/stats"]))["shard_distinct"]
    j.add_reads(spec["more_reads"])
    j.finish()
    assert j.to_dict() == naive(spec["reads"] + spec["more_reads"])


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_port_file_round_trip_at_four_shards(four, backend):
    ranks, spec, _ = four
    for out in ranks:
        assert as_dict(out, f"ckpt_{backend}_own") == naive(spec["reads"])


@pytest.mark.parametrize("name", list(SCENARIOS) + ["unequal", "range",
                                                     "gzip", "python"])
def test_five_shards_equal_kmer_counter_and_naive(five, name):
    """Five ranks (n_shards 5, not a power of two): every scenario's dump
    and totals equal the port's KmerCounter and the naive count, and the
    five shards' sizes add up."""
    ranks, spec = five
    kw = dict(SCENARIOS.get(name, {}))
    canonical = kw.get("canonical", False)
    want = naive(spec["reads"], canonical=canonical)
    c = KmerCounter(**(dict(k=K, l=L, batch_words=BW, device="cpu") | {
        f: v for f, v in kw.items() if f != "lsm_growth" or kw["lsm"]}))
    c.add_reads(spec["reads"])
    c.finish()
    assert c.to_dict() == want
    for out in ranks:
        assert as_dict(out, name) == want
        assert int(out[f"{name}/total"]) == c.total_kmers
        st = json.loads(str(out[f"{name}/stats"]))
        assert len(st["shard_distinct"]) == 5
        assert sum(st["shard_distinct"]) == len(want)
    if name in SCENARIOS:
        assert [out[f"{name}/queries"].tolist() for out in ranks] == [
            c.get_counts(spec["queries"])] * 5
