"""Checkpoints of the port (core/checkpoint.py): round trips on both
backends, flat and LSM, resume after load, files that cross between the
port and the JAX package both ways (the files of the GF(2) store image,
the mix-prefix extended keys and older files too), a count split in two
halves with a save and load between them.  Exact dumps."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.core import checkpoint as jckpt  # noqa: E402
from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu_torch import (  # noqa: E402
    KmerCounter,
    load_counter,
    save_counter,
)

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402

CPU = "cpu"
# (backend, extra kwargs): flat sort store, LSM store, table
KINDS = {
    "sort": dict(backend="sort", lsm=False),
    "lsm": dict(backend="sort", lsm=True, lsm_growth=2, merge_every=1),
    "table": dict(backend="table"),
}


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def _counted(cls, reads, **kw):
    c = cls(**kw)
    c.add_reads(reads)
    c.finish()
    return c


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_save_load_roundtrip(tmp_path, kind):
    rng = np.random.default_rng(3)
    reads = rand_reads(rng, 30, 10, 90)
    kw = dict(k=9, l=13, batch_words=32) | KINDS[kind]
    counter = _counted(KmerCounter, reads, device=CPU, **kw)
    assert counter.lsm == (kind == "lsm")
    ckpt = tmp_path / "state.npz"
    save_counter(counter, ckpt)
    restored = load_counter(ckpt, batch_words=32, device=CPU)
    assert restored.backend == counter.backend and restored.lsm == counter.lsm
    assert restored.to_dict() == counter.to_dict()
    assert restored.total_kmers == counter.total_kmers
    assert restored.batches_processed == counter.batches_processed


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_resume_counting_after_load(tmp_path, kind):
    rng = np.random.default_rng(4)
    reads_a = rand_reads(rng, 20, 10, 60)
    reads_b = rand_reads(rng, 20, 10, 60)
    kw = dict(k=7, l=13, batch_words=32) | KINDS[kind]
    counter = _counted(KmerCounter, reads_a, device=CPU, **kw)
    save_counter(counter, tmp_path / "a.npz")
    restored = load_counter(tmp_path / "a.npz", batch_words=32, device=CPU)
    restored.add_reads(reads_b)
    restored.finish()
    assert restored.to_dict() == dict(naive_kmers(reads_a + reads_b, 7))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_checkpoint_resumes_in_port(tmp_path, kind):
    """A file written by the JAX package's save_counter resumes in the
    port, and the port's own file of the same count loads in the JAX
    package: every dump equal to the whole count."""
    rng = np.random.default_rng(11)
    reads_a = rand_reads(rng, 25, 12, 80, alphabet="ACGTN")
    reads_b = rand_reads(rng, 25, 12, 80, alphabet="ACGTN")
    kw = dict(k=9, l=13, batch_words=32, canonical=kind == "table") | \
        KINDS[kind]
    whole = _counted(JKmerCounter, reads_a + reads_b, **kw).to_dict()
    jax_first = _counted(JKmerCounter, reads_a, **kw)
    jckpt.save_counter(jax_first, tmp_path / "jax.npz")
    port = load_counter(tmp_path / "jax.npz", batch_words=32, device=CPU)
    assert port.lsm == jax_first.lsm and port.canonical == kw["canonical"]
    assert port.to_dict() == jax_first.to_dict()
    port.add_reads(reads_b)
    port.finish()
    assert port.to_dict() == whole
    save_counter(port, tmp_path / "port.npz")
    back = jckpt.load_counter(tmp_path / "port.npz", batch_words=32)
    assert back.lsm == port.lsm and back.backend == port.backend
    assert back.to_dict() == whole
    assert back.total_kmers == port.total_kmers
    back.add_reads(reads_a)
    back.finish()
    port.add_reads(reads_a)
    port.finish()
    assert back.to_dict() == port.to_dict()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_save_mid_stream_keeps_buffered_reads(tmp_path, kind):
    """A save after add_reads with no finish() counts the reads the packer
    still holds first: the file's state, stats and batches equal those of
    a finished count of the same reads; it resumes to the naive count in
    the port and in the JAX package; and the counter that saved goes on
    to the same count."""
    import dataclasses

    rng = np.random.default_rng(8)
    reads = rand_reads(rng, 20, 20, 90)
    first, rest = reads[:10], reads[10:]
    kw = dict(k=17, l=13, batch_words=32) | KINDS[kind]
    want = dict(naive_kmers(reads, 17))
    c = KmerCounter(device=CPU, **kw)
    c.add_reads(first)
    assert c.packer._cur_word > 0  # a partial batch is buffered
    save_counter(c, tmp_path / "mid.npz")
    done = _counted(KmerCounter, first, device=CPU, **kw)
    with np.load(tmp_path / "mid.npz") as data:
        meta = json.loads(str(data["meta"]))
    assert meta["stats"] == json.loads(json.dumps(
        dataclasses.asdict(done.packer.stats)))
    assert meta["batches_processed"] == done.batches_processed
    loaded = load_counter(tmp_path / "mid.npz", batch_words=32, device=CPU)
    assert loaded.to_dict() == dict(naive_kmers(first, 17))
    assert sum(loaded.to_dict().values()) == loaded.total_kmers
    loaded.add_reads(rest)
    loaded.finish()
    assert loaded.to_dict() == want
    assert loaded.total_kmers == sum(want.values())
    back = jckpt.load_counter(tmp_path / "mid.npz", batch_words=32)
    back.add_reads(rest)
    back.finish()
    assert back.to_dict() == want
    c.add_reads(rest)
    c.finish()
    assert c.to_dict() == want and c.total_kmers == sum(want.values())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_split_run_is_exact(tmp_path, kind):
    """Counting a file whole, or its two halves with a save and a load
    between them, gives identical dumps and totals."""
    rng = np.random.default_rng(17)
    reads = rand_reads(rng, 80, 20, 120, alphabet="ACGTNACGT")
    whole_f, a_f, b_f = (tmp_path / n for n in ("w.fq", "a.fq", "b.fq"))
    _write_fastq(whole_f, reads)
    _write_fastq(a_f, reads[:40])
    _write_fastq(b_f, reads[40:])
    kw = dict(k=13, l=14, batch_words=64, read_len_hint=20) | KINDS[kind]
    whole = KmerCounter(device=CPU, **kw)
    whole.count_file(whole_f, use_native=True)
    first = KmerCounter(device=CPU, **kw)
    first.count_file(a_f, use_native=True)
    save_counter(first, tmp_path / "half.npz")
    second = load_counter(tmp_path / "half.npz", batch_words=64, device=CPU)
    second.count_file(b_f, use_native=True)
    assert sorted(second.items()) == sorted(whole.items())
    assert second.total_kmers == whole.total_kmers
    assert second.stats()["reads"] == whole.stats()["reads"] == len(reads)


def test_meta_carries_options(tmp_path):
    """canonical, hp-collapse, the LSM, its growth and merge_every survive
    a round trip, under the JAX package's meta keys and array dtypes."""
    reads = rand_reads(np.random.default_rng(5), 20, 10, 60)
    c = _counted(KmerCounter, reads, k=9, l=14, batch_words=32,
                 canonical=True, collapse_homopolymers=True, lsm=True,
                 lsm_growth=3, merge_every=2, device=CPU)
    save_counter(c, tmp_path / "c.npz")
    j = _counted(JKmerCounter, reads, k=9, l=14, batch_words=32,
                 canonical=True, collapse_homopolymers=True, lsm=True,
                 lsm_growth=3, merge_every=2)
    jckpt.save_counter(j, tmp_path / "j.npz")
    with np.load(tmp_path / "c.npz") as ours, np.load(tmp_path / "j.npz") as ref:
        assert set(ours.files) == set(ref.files)
        meta, jmeta = (json.loads(str(d["meta"])) for d in (ours, ref))
        for f in ours.files:
            if f != "meta":
                assert ours[f].dtype == ref[f].dtype, f
    assert set(meta) == set(jmeta)
    for key in ("canonical", "collapse_hp", "lsm", "merge_every", "stats",
                "n_shards", "hash_first"):
        assert meta[key] == jmeta[key], key
    # the JAX counter keeps no lsm_growth attribute, so its files always
    # say 8 (ROADMAP Queue 3); the port writes the growth it counted with
    assert meta["lsm_growth"] == 3
    r = load_counter(tmp_path / "c.npz", batch_words=32, device=CPU)
    assert (r.canonical, r.collapse_hp, r.lsm, r.lsm_growth,
            r.merge_every) == (True, True, True, 3, 2)
    assert r.to_dict() == c.to_dict() == j.to_dict()


def _edited(tmp_path, src, **meta_changes):
    """A copy of checkpoint `src` with meta fields changed."""
    with np.load(src) as data:
        arrays = {f: data[f] for f in data.files}
    meta = json.loads(str(arrays.pop("meta")))
    meta.update(meta_changes)
    out = tmp_path / "edited.npz"
    np.savez(out, meta=json.dumps(meta), **arrays)
    return out


# the case ids of the time these files were refused ("Do not port")
@pytest.mark.parametrize("change", [
    dict(n_shards=1), dict(n_shards=4), dict(mix_prefix=True),
    dict(hash_first="gf2"), dict(hash_first=True),
], ids=["{'n_shards': 1}-None", "{'n_shards': 4}-None",
        "{'mix_prefix': True}-Do not port",
        "{'hash_first': 'gf2'}-Do not port",
        "{'hash_first': True}-Do not port"])
def test_refusals_are_loud(tmp_path, change, capsys):
    """Files the port once refused now load, both ways.  Sharded: a JAX
    ShardedKmerCounter's file at n_shards 1 and 4 resumes in the port's
    command line (at 4, as four CPU ranks) and counts the input again,
    every count doubled.  mix_prefix and hash_first="gf2": a JAX file
    resumes in the port and the port's file in the JAX package, each
    ending at the whole count.  Older files: hash_first True (the GF(2)
    image before "mix" existed) and a sharded GF(2) file without
    `routing_hash` load as the GF(2) image and resume exactly."""
    reads = rand_reads(np.random.default_rng(6), 10, 10, 40)
    more = rand_reads(np.random.default_rng(7), 10, 10, 40)
    if "n_shards" in change:
        from tsxcount_tpu.parallel.sharded import (
            ShardedKmerCounter as JSharded,
        )
        from tsxcount_tpu_torch.cli import main

        n = change["n_shards"]
        _write_fastq(tmp_path / "r.fastq", reads)
        j = _counted(JSharded, reads, k=9, n_shards=n, l=12, batch_words=32)
        jckpt.save_counter(j, tmp_path / "j.npz")
        dump = tmp_path / "dump.count"
        assert main(["count", "--input", str(tmp_path / "r.fastq"),
                     "--load-state", str(tmp_path / "j.npz"), "--dump",
                     str(dump), "--batch-words", "32", "--platform",
                     "cpu"]) == 0
        with open(dump) as f:
            got = dict(line.split("\t") for line in f.read().splitlines())
        assert {km: int(c) for km, c in got.items()} == {
            km: 2 * c for km, c in naive_kmers(reads, 9).items()}
        return
    whole = dict(naive_kmers(reads + more, 9))
    if change.get("hash_first") is True:
        from tsxcount_tpu.parallel.sharded import (
            ShardedKmerCounter as JSharded,
        )

        # a single-device file of the GF(2) image, as older files say it
        j = _counted(JKmerCounter, reads, k=9, l=12, batch_words=32,
                     hash_first="gf2", hash_seed=3)
        jckpt.save_counter(j, tmp_path / "j.npz")
        port = load_counter(_edited(tmp_path, tmp_path / "j.npz",
                                    hash_first=True), device=CPU)
        assert port.hash_first == "gf2"
        # a sharded GF(2) file from before routing_hash was written
        js = _counted(JSharded, reads, k=9, n_shards=1, l=12,
                      batch_words=32, routing_hash="gf2", hash_seed=3)
        jckpt.save_counter(js, tmp_path / "js.npz")
        with np.load(tmp_path / "js.npz") as data:
            arrays = {f: data[f] for f in data.files}
        meta = json.loads(str(arrays.pop("meta")))
        del meta["routing_hash"]
        np.savez(tmp_path / "old_sharded.npz", meta=json.dumps(meta),
                 **arrays)
        sharded = load_counter(tmp_path / "old_sharded.npz", device=CPU)
        assert sharded.routing_hash == "gf2"
        for c in (port, sharded):
            assert c.to_dict() == dict(naive_kmers(reads, 9))
            c.add_reads(more)
            c.finish()
            assert c.to_dict() == whole
        return
    kw = dict(k=9, l=12, batch_words=32) | change
    j = _counted(JKmerCounter, reads, **kw)
    jckpt.save_counter(j, tmp_path / "j.npz")
    port = load_counter(tmp_path / "j.npz", batch_words=32, device=CPU)
    assert (port.hash_first, port.mix_prefix) == (j.hash_first,
                                                  j.mix_prefix)
    assert port.to_dict() == j.to_dict()
    port.add_reads(more)
    port.finish()
    assert port.to_dict() == whole
    save_counter(port, tmp_path / "c.npz")
    back = jckpt.load_counter(tmp_path / "c.npz", batch_words=32)
    assert (back.hash_first, back.mix_prefix) == (j.hash_first,
                                                  j.mix_prefix)
    assert back.to_dict() == whole


def test_newer_format_refused(tmp_path):
    c = _counted(KmerCounter, ["ACGTACGTACGT"], k=9, l=12, batch_words=32,
                 device=CPU)
    save_counter(c, tmp_path / "c.npz")
    with pytest.raises(ValueError, match="format"):
        load_counter(_edited(tmp_path, tmp_path / "c.npz", format=4),
                     device=CPU)


def test_old_table_layouts_migrate(tmp_path):
    """Table files that stored the slot rows as [slots, C], or as separate
    keys / digits / used arrays, load as the flat column-major layout."""
    reads = rand_reads(np.random.default_rng(9), 20, 10, 60)
    c = _counted(KmerCounter, reads, k=9, l=12, backend="table",
                 batch_words=32, device=CPU)
    save_counter(c, tmp_path / "t.npz")
    want = c.to_dict()
    with np.load(tmp_path / "t.npz") as data:
        arrays = {f: data[f] for f in data.files}
    cols = c.table.slot_cols
    rows = arrays.pop("state_slots").reshape(cols, -1).T  # [slots, C]
    lanes = c.spec.lanes
    for name, extra in (
            ("rows", dict(state_slots=rows)),
            ("split", dict(state_keys=rows[:, :lanes],
                           state_digits=rows[:, lanes : lanes + 3]
                           .view(np.int32),
                           state_used=rows[:, -1] != 0))):
        path = tmp_path / f"{name}.npz"
        np.savez(path, **arrays, **extra)
        assert load_counter(path, batch_words=32, device=CPU).to_dict() == want
