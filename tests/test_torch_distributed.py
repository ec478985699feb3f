"""The port's sharded counter over several ranks (parallel/sharded.py,
parallel/distributed.py) against the JAX package's ShardedKmerCounter on
the conftest's 8-device CPU mesh and against a naive count.

Ranks are CPU subprocesses on gloo, joined by a file-based process group
in the test's temporary directory (no ports).  Each world size runs ONCE
a module: one worker a rank does every scenario (`run_scenarios`) and
writes its results to an .npz; the tests then assert on them.  A group
that does not end within RANK_TIMEOUT_S is killed and its tests fail.
`run_scenarios` imports no JAX: the JAX side runs here, in the pytest
process.  Everything compared is an integer: exact."""

import gzip
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 120
K, L, BW = 9, 14, 32          # the scenarios' geometry (small batches)
LSM_L = 16                    # the LSM scenario's l: cascades engage
WIDE_K = 113                  # the real prefix collision's k
SPILL_CF = 0.05               # capacity_factor of the spill scenarios
SPILL_L = 18                  # and their l: the stores never fill
GROUPS = ("stores", "spill", "unequal", "files", "collision", "ckpt")
SCENARIOS = {  # name -> the counter's keywords beyond k, l, batch_words
    "sort": {}, "table": dict(backend="table"),
    "canonical": dict(canonical=True),
    "lsm": dict(lsm=True, lsm_growth=2, merge_every=1, l=LSM_L,
                batch_words=128),
}
# the GF(2) routing (group "gf2", run by tests/test_torch_sharded.py at
# one and two ranks); identity_hash forces it with the identity matrix
GF2_SCENARIOS = {
    "gf2_sort": dict(backend="sort", routing_hash="gf2"),
    "gf2_table": dict(backend="table", routing_hash="gf2"),
    "gf2_lsm": dict(SCENARIOS["lsm"], routing_hash="gf2"),
    "identity": dict(identity_hash=True),
}


# --- the rank worker (no JAX) ---------------------------------------------

def _write_fastq(path, reads):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def _dict_arrays(d: dict) -> tuple[np.ndarray, np.ndarray]:
    keys = sorted(d)
    return (np.array(keys, dtype=str),
            np.array([d[km] for km in keys], dtype=np.int64))


def as_dict(out: dict, name: str) -> dict:
    return dict(zip(out[f"{name}/kmers"].tolist(),
                    out[f"{name}/counts"].tolist()))


def run_scenarios(rank: int, world: int, spec_path, out_path) -> None:
    """Every scenario on this rank of a `world`-rank gloo group (joined
    already; one rank runs with no group); results to `out_path` (.npz)."""
    from tsxcount_tpu_torch.core import checkpoint
    from tsxcount_tpu_torch.core.counter import TableFull
    from tsxcount_tpu_torch.ops import count as count_mod
    from tsxcount_tpu_torch.parallel.distributed import host_input_mode
    from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter
    from tsxcount_tpu_torch.utils.sequence import kmers_to_strings

    spec = json.loads(pathlib.Path(spec_path).read_text())
    tmp = pathlib.Path(spec_path).parent
    reads, queries = spec["reads"], spec["queries"]
    groups = set(spec.get("groups", GROUPS))
    out = {}

    def make(**kw):
        args = dict(k=K, n_shards=world, l=L, batch_words=BW, device="cpu",
                    dist_backend="gloo") | kw
        return ShardedKmerCounter(**args)

    def record(name, c, shard=True):
        d = c.to_dict()
        out[f"{name}/kmers"], out[f"{name}/counts"] = _dict_arrays(d)
        st = c.stats()
        out[f"{name}/stats"] = np.array(json.dumps(st))
        out[f"{name}/distinct"] = np.int64(c.distinct)
        out[f"{name}/total"] = np.int64(c.total_kmers)
        if c.spec.k == K:
            out[f"{name}/queries"] = np.array(c.get_counts(queries),
                                              np.int64)
        if not shard:
            return
        if c.backend == "table":  # this shard's dump: its kmers, mapped back
            keys, counts = c._shard_export()
            keys = c.route_map.inv_apply(keys) if keys.shape[0] else keys
            out[f"{name}/shard_dump"] = np.array(sorted(zip(
                kmers_to_strings(keys.numpy().view(np.uint32), c.spec),
                counts.tolist())), dtype=object).astype(str)
            return
        ref = c._shard_reference()
        n = int(ref["n"])
        out[f"{name}/shard_keys"] = ref["keys"][:n]
        out[f"{name}/shard_digits"] = ref["digits"][:n]
        out[f"{name}/lsm"] = np.bool_(c.lsm)

    for name, kw in SCENARIOS.items() if "stores" in groups else ():
        c = make(**kw)
        c.add_reads(reads[rank::world])
        c.finish()
        record(name, c)

    for name, kw in GF2_SCENARIOS.items() if "gf2" in groups else ():
        c = make(**kw)
        c.add_reads(reads[rank::world])
        c.finish()
        record(name, c)

    # a carry that takes every destination's overflow, recovered exactly;
    # and one that overflows the carry too: TableFull on every rank
    for name in ("spill", "spill_hard") if "spill" in groups else ():
        c = make(batch_words=128 * world, capacity_factor=SPILL_CF,
                 l=SPILL_L)
        try:
            c.add_reads(spec[f"{name}_reads"][rank::world])
            c.finish()
            record(name, c, shard=False)
            out[f"{name}/recovered"] = np.int64(c._spill_recovered)
        except TableFull as e:
            out[f"{name}/error"] = np.array(f"TableFull: {e}")

    # unequal shares: every read on rank 0, none on the others
    if "unequal" in groups:
        c = make()
        c.add_reads(reads if rank == 0 else [])
        c.finish()
        record("unequal", c, shard=False)

    # count_file: byte ranges of a plain file (native parser), record
    # stripes of a gzip file, and the Python packer's stripes
    for name, fname, native in (("range", "in.fastq", None),
                                ("gzip", "in.fastq.gz", None),
                                ("python", "in.fastq", False)
                                ) if "files" in groups else ():
        c = make()
        mode = host_input_mode(tmp / fname, world, native)
        c.count_file(tmp / fname, use_native=native)
        record(name, c, shard=False)
        out[f"{name}/mode"] = np.array(mode)
        out[f"{name}/rounds"] = np.int64(c._stream_rounds)

    # a real prefix collision (a one-operand prefix: 2 key bits at k=113):
    # count_file recounts with the full sort on every rank
    if "collision" in groups:
        real_nk = count_mod.uniform_prefix_nk
        count_mod.uniform_prefix_nk = lambda spec: 1
        try:
            c = make(k=WIDE_K, l=13, batch_words=128, merge_every=2)
            c.count_file(tmp / "wide.fastq", use_native=False)
        finally:
            count_mod.uniform_prefix_nk = real_nk
        record("collision", c, shard=False)
        out["collision/full_sort"] = np.bool_(c._mix_full_sort)

    # checkpoints: the port's file reloads here; the JAX file (written at
    # this n_shards) loads and resumes with the second half of the reads;
    # the lane mix's ("ckpt") and the GF(2) routing's ("gf2") files
    ckpts = [(prefix, backend)
             for prefix, group in (("", "ckpt"), ("gf2_", "gf2"))
             if group in groups for backend in ("sort", "table")]
    for prefix, backend in ckpts:
        c = make(backend=backend, routing_hash="gf2" if prefix else "mix")
        c.add_reads(reads[rank::world])
        own = tmp / f"port_{prefix}{backend}.npz"
        checkpoint.save_counter(c, own)
        c = checkpoint.load_counter(own, batch_words=BW, device="cpu")
        record(f"ckpt_{prefix}{backend}_own", c, shard=False)
        jax_file = tmp / f"jax_{prefix}{backend}.npz"
        if jax_file.exists():
            c = checkpoint.load_counter(jax_file, batch_words=BW,
                                        device="cpu")
            c.add_reads(spec["more_reads"][rank::world])
            c.finish()
            record(f"ckpt_{prefix}{backend}_jax", c, shard=False)
    np.savez(out_path, **out)


def rank_main() -> None:
    """A rank process: argv = rank, world, spec path, output path."""
    import torch.distributed as dist

    from tsxcount_tpu_torch.parallel.mesh import init_shard_group

    rank, world = int(sys.argv[1]), int(sys.argv[2])
    spec_path, out_path = sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)  # ranks and test workers share the cores
    init_shard_group(world, "cpu", "gloo", rank=rank,
                     init_method=f"file://{pathlib.Path(spec_path).parent}/pg")
    try:
        run_scenarios(rank, world, spec_path, out_path)
    finally:
        dist.destroy_process_group()


# --- the pytest side -------------------------------------------------------

def make_inputs(tmp: pathlib.Path, world: int, seed: int,
                groups=GROUPS) -> dict:
    """Reads of the scenarios (made here with numpy from a seed), written
    as spec.json and FASTQ files, with the scenario groups to run;
    returns the spec."""
    from tests.test_packer import rand_reads

    rng = np.random.default_rng(seed)
    reads = rand_reads(rng, 150, 5, 120)
    spec = {
        "reads": reads,
        "more_reads": rand_reads(rng, 40, 5, 120),
        # about 1,560 windows a destination: one batch of 2048 x world
        # positions a rank, past route_cap (1024), inside the carry
        "spill_reads": rand_reads(rng, 17 * world * world, 100, 101),
        "spill_hard_reads": rand_reads(rng, 85 * world * world, 100, 101),
        "wide_reads": rand_reads(rng, 40, WIDE_K, WIDE_K + 100),
        "groups": list(groups),
    }
    spec["queries"] = sorted(
        {r[i : i + K] for r in reads[:20] for i in range(0, len(r) - K + 1,
                                                          7)}) + ["A" * K]
    _write_fastq(tmp / "in.fastq", reads)
    _write_fastq(tmp / "in.fastq.gz", reads)
    _write_fastq(tmp / "wide.fastq", spec["wide_reads"])
    (tmp / "spec.json").write_text(json.dumps(spec))
    return spec


def run_ranks(tmp: pathlib.Path, world: int) -> list[dict]:
    """Start `world` rank processes on tmp/spec.json; kill them all and
    fail if they do not end within RANK_TIMEOUT_S."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    code = "from tests.test_torch_distributed import rank_main; rank_main()"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world),
         str(tmp / "spec.json"), str(tmp / f"rank{r}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{world} ranks did not end within {RANK_TIMEOUT_S} s")
    bad = [f"rank {r}:\n{log[-3000:]}" for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, "\n".join(bad)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


_JAX_COUNTERS: dict = {}


def jax_counter(n_shards: int, reads, **kw):
    """The JAX ShardedKmerCounter of `reads` (one for each arguments: the
    tests of a module share it)."""
    from tsxcount_tpu.parallel.sharded import ShardedKmerCounter

    key = (n_shards, tuple(reads), tuple(sorted(kw.items())))
    if key not in _JAX_COUNTERS:
        c = ShardedKmerCounter(**(dict(k=K, n_shards=n_shards, l=L,
                                       batch_words=BW) | kw))
        c.add_reads(reads)
        c.finish()
        _JAX_COUNTERS[key] = c
    return _JAX_COUNTERS[key]


def jax_shard_rows(c, shard: int) -> tuple[np.ndarray, np.ndarray]:
    """A JAX sort counter's shard: its (hashed keys, digits) rows [0, n)."""
    c._collapse_lsm()
    st = c._read_state
    n = int(c._gather(st.n)[shard])
    return c._shard_rows(st.keys, shard, n), c._shard_rows(st.digits, shard,
                                                           n)


def jax_table_shard_dump(c, shard: int) -> list:
    """A JAX table counter's shard as sorted (kmer, count) pairs."""
    import jax.numpy as jnp

    from tsxcount_tpu.core.table import TableState
    from tsxcount_tpu.utils.sequence import kmers_to_strings

    per = c.table.slots * c.table.slot_cols
    st = TableState(
        slots=jnp.asarray(c._shard_rows(c.state.slots, shard, per)),
        n=jnp.asarray(c._gather(c.state.n)[shard]),
        spilled=jnp.asarray(c._gather(c.state.spilled)[shard]),
        probe_hist=jnp.asarray(c._shard_rows(
            c.state.probe_hist, shard,
            c.state.probe_hist.shape[0] // c.n_shards)))
    hashed, counts, n = c.table.to_host(st)
    kmers = c.route_map.inv_apply_host(hashed) if n else hashed
    return sorted(zip(kmers_to_strings(kmers, c.spec),
                      [str(int(x)) for x in counts]))


def save_jax_checkpoints(tmp: pathlib.Path, n_shards: int, reads,
                         routing: str = "mix") -> dict:
    """JAX counts of each backend over `reads` routed through `routing`,
    saved for the ranks to load (jax_<backend>.npz, with routing "gf2"
    jax_gf2_<backend>.npz); returns the counters."""
    from tsxcount_tpu.core.checkpoint import save_counter

    prefix, kw = ("gf2_", dict(routing_hash="gf2")) if routing == "gf2" \
        else ("", {})
    out = {}
    for backend in ("sort", "table"):
        c = jax_counter(n_shards, reads, backend=backend, **kw)
        save_counter(c, tmp / f"jax_{prefix}{backend}.npz")
        out[backend] = c
    return out


def naive(reads, k=K, canonical=False) -> dict:
    from tests.test_packer import naive_kmers

    want = dict(naive_kmers(reads, k))
    if not canonical:
        return want
    comp = str.maketrans("ACGT", "TGCA")
    out: dict = {}
    for km, c in want.items():
        key = min(km, km.translate(comp)[::-1])
        out[key] = out.get(key, 0) + c
    return out


@pytest.fixture(scope="module", params=[2, 3], ids=lambda n: f"n{n}")
def world(request, tmp_path_factory):
    """(n_shards, the ranks' results, the inputs, the JAX checkpoints'
    counters): the ranks run once a world size."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"ranks{n}")
    spec = make_inputs(tmp, n, seed=n)
    return n, run_ranks(tmp, n), spec


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_dumps_totals_and_queries_equal_jax(world, name):
    """to_dict, distinct, total_kmers and get_counts on every rank equal
    the JAX ShardedKmerCounter's on the same reads (single controller,
    the same n_shards), and the naive count."""
    n, ranks, spec = world
    kw = dict(SCENARIOS[name])
    j = jax_counter(n, spec["reads"], **kw)
    want = j.to_dict()
    assert want == naive(spec["reads"], canonical=kw.get("canonical", False))
    jq = j.get_counts(spec["queries"])
    for out in ranks:
        assert as_dict(out, name) == want
        assert int(out[f"{name}/distinct"]) == j.distinct
        assert int(out[f"{name}/total"]) == j.total_kmers
        assert out[f"{name}/queries"].tolist() == jq
    if name == "lsm":
        assert j.lsm and all(bool(out["lsm/lsm"]) for out in ranks)


@pytest.mark.parametrize("name", ["sort", "canonical", "lsm"])
def test_shard_rows_equal_jax(world, name):
    """Each rank's sorted store (the LSM's top level after the collapse),
    converted by state_to_reference, holds the JAX shard's rows [0, n):
    the same hashed keys and count digits."""
    n, ranks, spec = world
    j = jax_counter(n, spec["reads"], **SCENARIOS[name])
    for shard, out in enumerate(ranks):
        keys, digits = jax_shard_rows(j, shard)
        np.testing.assert_array_equal(out[f"{name}/shard_keys"], keys)
        np.testing.assert_array_equal(out[f"{name}/shard_digits"], digits)


def test_table_shard_dumps_equal_jax(world):
    """Each rank's table shard holds the JAX shard's k-mers and counts
    (slot layouts differ: the port inserts in split rounds)."""
    n, ranks, spec = world
    j = jax_counter(n, spec["reads"], backend="table")
    for shard, out in enumerate(ranks):
        assert out["table/shard_dump"].tolist() == [
            list(p) for p in jax_table_shard_dump(j, shard)]


def test_stats_carry_the_jax_keys(world):
    n, ranks, spec = world
    j = jax_counter(n, spec["reads"])
    ref = j.stats()
    for out in ranks:
        st = json.loads(str(out["sort/stats"]))
        assert set(ref) <= set(st), set(ref) - set(st)
        for key in ("n_shards", "shard_distinct", "distinct_kmers",
                    "total_kmers", "windows", "reads", "spill_recovered"):
            assert st[key] == ref[key], key


def test_spill_recovered_exactly(world):
    n, ranks, spec = world
    want = naive(spec["spill_reads"])
    for out in ranks:
        assert int(out["spill/recovered"]) > 0
        assert as_dict(out, "spill") == want
        assert json.loads(str(out["spill/stats"]))["spill_recovered"] == int(
            out["spill/recovered"])


def test_no_rank_takes_the_one_shard_hand_off(world):
    """At several ranks every step takes the padded route and the
    exchange: stats() route_direct_batches stays 0 on every rank."""
    _, ranks, _ = world
    for out in ranks:
        for name in (*SCENARIOS, "spill", "unequal", "range", "collision"):
            st = json.loads(str(out[f"{name}/stats"]))
            assert st["batches"] > 0 and st["route_direct_batches"] == 0


def test_spill_past_the_carry_raises_on_every_rank(world):
    _, ranks, _ = world
    for out in ranks:
        assert "spill_hard/error" in out, "no TableFull"
        assert "spill carry" in str(out["spill_hard/error"])


def test_unequal_shares_one_rank_with_no_reads(world):
    n, ranks, spec = world
    for out in ranks:
        assert as_dict(out, "unequal") == naive(spec["reads"])


@pytest.mark.parametrize("name,mode", [("range", "range"),
                                       ("gzip", "stripe"),
                                       ("python", "stripe")])
def test_count_file_modes(world, name, mode):
    """count_file in byte-range mode (native parser), and in record
    stripes (gzip, and the Python packer), each rank its share."""
    n, ranks, spec = world
    want = naive(spec["reads"])
    for out in ranks:
        assert str(out[f"{name}/mode"]) == mode
        assert as_dict(out, name) == want
        assert int(out[f"{name}/total"]) == sum(want.values())
        assert int(out[f"{name}/rounds"]) >= 1


def test_real_prefix_collision_recounts_on_every_rank(world):
    n, ranks, spec = world
    want = naive(spec["wide_reads"], k=WIDE_K)
    for out in ranks:
        assert bool(out["collision/full_sort"])
        assert as_dict(out, "collision") == want


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_checkpoint_round_trip(world, backend):
    n, ranks, spec = world
    for out in ranks:
        assert as_dict(out, f"ckpt_{backend}_own") == naive(spec["reads"])
