"""The table backend at the widest keys, k = 208-256: a split round probes
lanes + 1 slot columns in one launch of kernel 5 and applies lanes + 3 in
one launch of kernel 4, 17 and 19 at k = 256 (16 lanes, 20 slot columns).
The port's KmerCounter(backend="table", device="cpu") against the JAX
package's on the same seeded reads: table states word for word, dumps,
items order and queries equal, and equal to a naive count; the sharded
table at one shard, the command line, and a JAX checkpoint resumed in the
port at k = 256.  Exact."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.cli import main as jax_main  # noqa: E402
from tsxcount_tpu.core import checkpoint as jckpt  # noqa: E402
from tsxcount_tpu.core.counter import KmerCounter as JKmerCounter  # noqa: E402
from tsxcount_tpu_torch import (  # noqa: E402
    KmerCounter,
    ShardedKmerCounter,
    load_counter,
)
from tsxcount_tpu_torch.cli import main  # noqa: E402

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402
from tests.test_torch_counter import _write_fastq  # noqa: E402
from tests.test_torch_table_counter import assert_same_table  # noqa: E402

CPU = "cpu"
L, BW = 14, 256  # several batches of a few reads each at these k


def _reads(k: int, seed: int, n: int = 30) -> list[str]:
    rng = np.random.default_rng(seed)
    return rand_reads(rng, n, k, k + 60)


def _counted(cls, reads, **kw):
    c = cls(**kw)
    c.add_reads(reads)
    c.finish()
    return c


# 208: 13 lanes, the widest k below either old cap; 209: 14 lanes, 17
# applied columns; 240: the last k with 16 probed columns; 241: 17 probed,
# 19 applied; 256: a whole slot of 20 columns
@pytest.mark.parametrize("k", [208, 209, 240, 241, 256])
def test_wide_table_matches_jax(k):
    reads = _reads(k, k)
    kw = dict(k=k, l=L, backend="table", batch_words=BW)
    ref = _counted(JKmerCounter, reads, **kw)
    port = _counted(KmerCounter, reads, device=CPU, **kw)
    assert port.batches_processed > 1
    assert port.table.slot_cols == port.spec.lanes + 4
    assert_same_table(ref, port)
    want = ref.to_dict()
    assert port.to_dict() == want == dict(naive_kmers(reads, k))
    assert list(port.items()) == list(ref.items())  # slot order
    assert (port.distinct, port.total_kmers) == (ref.distinct,
                                                 ref.total_kmers)
    queries = list(want)[:20] + ["A" * k, "C" * (k - 1) + "G"]
    assert port.get_counts(queries) == ref.get_counts(queries)
    assert port.stats()["spilled"] == 0


def test_sharded_wide_table_at_one_shard():
    k = 256
    reads = _reads(k, 7)
    c = ShardedKmerCounter(k=k, n_shards=1, l=L, backend="table",
                           batch_words=BW, device=CPU)
    c.add_reads(reads)
    c.finish()
    assert c.to_dict() == dict(naive_kmers(reads, k))
    assert c.total_kmers == sum(naive_kmers(reads, k).values())


def test_cli_counts_the_wide_table(tmp_path, capsys):
    """--mode TSX --k 224 exits 0 with the JAX CLI's totals, at --shards 0
    (the plain counter) and at the default --shards (the sharded one)."""
    k = 224
    reads = _reads(k, 3, n=20)
    path = tmp_path / "wide.fastq"
    _write_fastq(path, reads)
    args = ["count", "--input", str(path), "--k", str(k), "--l", str(L),
            "--batch-words", str(BW), "--mode", "TSX", "--stats-json",
            "--platform", CPU]
    assert jax_main(args + ["--shards", "0"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    naive = naive_kmers(reads, k)
    assert (ref["total_kmers"], ref["distinct_kmers"]) == (
        sum(naive.values()), len(naive))
    for shards in ([], ["--shards", "0"]):
        assert main(args + shards) == 0, shards
        ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        for key in ("total_kmers", "distinct_kmers", "windows", "reads"):
            assert ours[key] == ref[key], (shards, key)


def test_jax_checkpoint_at_k256_resumes_in_port(tmp_path):
    k = 256
    reads = _reads(k, 11)
    half = len(reads) // 2
    kw = dict(k=k, l=L, backend="table", batch_words=BW)
    jax_first = _counted(JKmerCounter, reads[:half], **kw)
    jckpt.save_counter(jax_first, tmp_path / "jax.npz")
    port = load_counter(tmp_path / "jax.npz", batch_words=BW, device=CPU)
    assert_same_table(jax_first, port)
    port.add_reads(reads[half:])
    port.finish()
    assert port.to_dict() == dict(naive_kmers(reads, k))
    assert port.total_kmers == sum(naive_kmers(reads, k).values())
