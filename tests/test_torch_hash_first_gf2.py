"""hash_first="gf2" on the port's sort backend: the batch keys mapped
through the seeded GF(2) matrix before the dedupe (ops/gf2.py, on the
stacked keys), the store holding the images.  Sorted dumps, queries and
store states against the JAX package's KmerCounter(hash_first="gf2") at
k = 9 and 63 and in canonical mode, identity_hash turning it off, and a
detected collision recounted.  Exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu_torch import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.core import counter as counter_mod  # noqa: E402
from tsxcount_tpu_torch.core.counter import PrefixCollision  # noqa: E402

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402

STORE_FIELDS = ("keys", "digits", "used", "n", "overflowed")


def _reads(rng, k, n=30, dups=8):
    reads = rand_reads(rng, n, k, k + 80,
                       alphabet="ACGT" * max(8, k // 4) + "N")
    return reads + [reads[i] for i in rng.integers(0, n, dups)]


@pytest.mark.parametrize("k,kw", [
    (9, {}), (63, {}), (31, dict(canonical=True)),
    (14, dict(hash_seed=5, l=13, lsm=True, lsm_growth=2, merge_every=1)),
], ids=str)
def test_counter_matches_jax(k, kw):
    """The GF(2) images in the store (rows [0, n); the LSM's top level
    after its collapse), the sorted dump and queries equal the JAX
    package's at the same seed."""
    reads = _reads(np.random.default_rng(k), k)
    common = dict(l=11, batch_words=64, merge_every=3, lsm=False,
                  hash_first="gf2") | kw
    ref = JKmerCounter(k=k, **common)
    ref.add_reads(reads)
    ref.finish()
    port = KmerCounter(k=k, device="cpu", **common)
    port.add_reads(reads)
    port.finish()
    assert port.hash_first == ref.hash_first == "gf2"
    assert port.key_map is port.hash_fn
    assert port.lsm == ref.lsm == ("lsm_growth" in kw)
    np.testing.assert_array_equal(port.hash_fn.matrix, ref.hash_fn.matrix)
    want = ref.to_dict()
    assert len(want) > 100
    assert port.to_dict() == want
    if not kw.get("canonical"):
        assert want == dict(naive_kmers(reads, k))
    assert list(port.items()) == list(ref.items())
    queries = list(want)[:30] + ["A" * k, "C" * (k - 1) + "G"]
    assert port.get_counts(queries) == ref.get_counts(queries)
    port.distinct  # the LSM's collapse, as the JAX reads do
    state = port.state[-1] if port.lsm else port.state
    ref_state = ref.state[-1] if ref.lsm else ref.state
    store = port.store.levels[-1] if port.lsm else port.store
    got = store.state_to_reference(state)
    n = int(ref_state.n)
    for f in STORE_FIELDS:
        a, b = np.asarray(got[f]), np.asarray(getattr(ref_state, f))
        if f in ("keys", "digits"):
            a, b = a[:n], b[:n]
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_identity_hash_turns_it_off(backend):
    """The identity image is not uniform: identity_hash turns "gf2" into
    False, as in the JAX package, and the count stays exact."""
    reads = _reads(np.random.default_rng(2), 9)
    kw = dict(k=9, l=11, batch_words=64, hash_first="gf2",
              identity_hash=True, backend=backend)
    port = KmerCounter(device="cpu", **kw)
    ref = JKmerCounter(**kw)
    assert port.hash_first is ref.hash_first is False
    assert port.key_map is None and port.hash_fn.identity
    port.add_reads(reads)
    port.finish()
    assert port.to_dict() == dict(naive_kmers(reads, 9))


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def test_collision_recounts_in_count_file(tmp_path, monkeypatch, capsys):
    """A collision flag forced on every prefix-sorted batch of GF(2)
    images: count_file recounts with the full sort, exact; add_reads +
    finish raise PrefixCollision."""
    real = counter_mod.count_unique_ops
    calls = []

    def colliding(kmers, valid, spec, uniform_prefix=False):
        calls.append(uniform_prefix)
        uo = real(kmers, valid, spec, uniform_prefix=uniform_prefix)
        if uniform_prefix:
            uo = uo._replace(collided=torch.ones((), dtype=torch.bool))
        return uo

    monkeypatch.setattr(counter_mod, "count_unique_ops", colliding)
    k = 63
    reads = _reads(np.random.default_rng(3), k)
    fastq = tmp_path / "r.fastq"
    _write_fastq(fastq, reads)
    c = KmerCounter(k=k, l=12, batch_words=64, hash_first="gf2",
                    device="cpu")
    c.count_file(fastq, use_native=False)
    assert c._mix_full_sort and True in calls and calls[-1] is False
    assert "recounting with the full-comparator sort" in (
        capsys.readouterr().err)
    want = dict(naive_kmers(reads, k))
    assert c.to_dict() == want
    stream = KmerCounter(k=k, l=12, batch_words=64, hash_first="gf2",
                         device="cpu")
    stream.add_reads(reads)
    with pytest.raises(PrefixCollision):
        stream.finish()
