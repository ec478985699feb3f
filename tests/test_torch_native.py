"""The port's parser (`tsxcount_tpu_torch/csrc/fastxpack.cpp`) against the
JAX package's (`tsxcount_tpu/_native/fastxpack.cpp`): every batch buffer
(words and intervals), `n_valid`, `n_bases`, the final PackStats and the
parse errors byte-identical, over read contents, k, the N policy, the
homopolymer collapse, input formats, long reads, tiny interval budgets,
byte ranges and threads; and `fast_reads`, the count of reads that took
the one-pass path."""

import dataclasses
import gzip

import numpy as np
import pytest

from tsxcount_tpu.config import BatchSpec as JBatchSpec
from tsxcount_tpu.config import KmerSpec as JKmerSpec
from tsxcount_tpu.io import native as jnative
from tsxcount_tpu_torch.config import BatchSpec, KmerSpec
from tsxcount_tpu_torch.io import native

CONTENTS = ("clean", "n_first", "n_mid", "n_last", "all_n", "short",
            "mixed")
FORMATS = ("fastq", "gzip", "fasta", "crlf_lower")
POLICIES = [("drop", False), ("random", False), ("drop", True),
            ("random", True)]


def make_reads(content: str, k: int, seed: int, n: int = 40) -> list[str]:
    """Reads of one kind: N-free, N at the first, middle or last base, all
    N, shorter than k, or a mix (1 % N, other invalid bytes, homopolymer
    runs longer than 2k - 2, short reads)."""
    rng = np.random.default_rng(seed)
    acgt = np.array(list("ACGT"))

    def rand(m):
        return "".join(rng.choice(acgt, size=m))

    lens = rng.integers(k, 4 * k + 40, size=n)
    if content == "clean":
        return [rand(m) for m in lens]
    if content in ("n_first", "n_mid", "n_last"):
        out = []
        for m in lens:
            s = list(rand(m))
            s[{"n_first": 0, "n_mid": m // 2, "n_last": m - 1}[content]] = "N"
            out.append("".join(s))
        return out
    if content == "all_n":
        return ["N" * int(m) for m in lens[:8]] + [rand(m) for m in lens[8:]]
    if content == "short":
        return [rand(int(m)) for m in rng.integers(0, k, size=n)]
    out = []
    for m in lens:
        s = rng.choice(acgt, size=m)
        if rng.random() < 0.5:  # a homopolymer run past the collapse's keep
            i = rng.integers(0, m)
            s[i:i + 3 * k] = rng.choice(acgt)
        s[rng.random(m) < 0.01] = "N"
        s[rng.random(m) < 0.003] = rng.choice(list("RY.-n"))
        out.append("".join(s))
    return out + [rand(int(m)) for m in rng.integers(0, k, size=4)]


def write_reads(path, reads, fmt: str):
    """Reads as FASTQ, gzip FASTQ, multi-line FASTA (lines of 60), or FASTQ
    with CRLF line ends and lowercase bases."""
    if fmt == "fasta":
        text = "".join(
            f">r{i}\n" + "".join(s[j:j + 60] + "\n"
                                 for j in range(0, len(s), 60))
            for i, s in enumerate(reads))
    else:
        nl = "\r\n" if fmt == "crlf_lower" else "\n"
        text = "".join(f"@r{i}{nl}{s}{nl}+{nl}{'I' * len(s)}{nl}"
                       for i, s in enumerate(reads))
        if fmt == "crlf_lower":
            text = text.lower().replace("@r", "@R")
    data = text.encode()
    if fmt == "gzip":
        data = gzip.compress(data, compresslevel=1)
    path.write_bytes(data)
    return path


def specs(k: int, capacity_words: int, read_len_hint: int = 384):
    return (BatchSpec(KmerSpec(k), capacity_words=capacity_words,
                      read_len_hint=read_len_hint),
            JBatchSpec(JKmerSpec(k), capacity_words=capacity_words,
                       read_len_hint=read_len_hint))


def drain(reader):
    """(batches as (buf, n_valid, n_bases), stats, error text or None)."""
    out, err = [], None
    try:
        for pb in reader:
            out.append((pb.buf.copy(), pb.n_valid, pb.n_bases))
    except ValueError as e:
        err = str(e)
    return out, dataclasses.asdict(reader.stats), err


def assert_parity(path, k, capacity_words=64, read_len_hint=384,
                  ordered=True, **kw):
    """Both readers over one file; returns the port's reader and its
    batches."""
    ours_spec, ref_spec = specs(k, capacity_words, read_len_hint)
    ours = native.NativeFileReader(path, ours_spec, **kw)
    got = drain(ours)
    want = drain(jnative.NativeFileReader(path, ref_spec, **kw))
    assert got[2] == want[2]
    if got[2] is None:  # after an error the stats are the reader's own
        assert got[1] == want[1]
    batches = [got[0], want[0]]
    if not ordered:  # threads: batches arrive in any order
        batches = [sorted(b, key=lambda t: t[0].tobytes()) for b in batches]
    assert len(batches[0]) == len(batches[1])
    for (gb, gv, gn), (wb, wv, wn) in zip(*batches):
        assert gb.dtype == wb.dtype and gb.shape == wb.shape
        np.testing.assert_array_equal(gb, wb)
        assert (gv, gn) == (wv, wn)
    return ours, got[0]


def fast_eligible(reads, k) -> int:
    valid = set("ACGTacgt")
    return sum(len(s) >= k and set(s) <= valid for s in reads)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n_policy,collapse", POLICIES)
@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("k", [14, 31, 127])
def test_batches_and_stats_match_the_reference(tmp_path, k, content,
                                               n_policy, collapse, fmt):
    reads = make_reads(content, k, seed=k * 100 + CONTENTS.index(content))
    path = write_reads(tmp_path / f"r.{fmt}", reads, fmt)
    ours, _ = assert_parity(path, k, n_policy=n_policy, seed=7,
                            collapse=collapse)
    want = 0 if collapse else fast_eligible(reads, k)
    assert ours.fast_reads == want


@pytest.mark.parametrize("n_policy", ["drop", "random"])
@pytest.mark.parametrize("k", [14, 31, 127])
def test_read_longer_than_a_batch(tmp_path, k, n_policy):
    rng = np.random.default_rng(k)
    long = "".join(rng.choice(list("ACGT"), size=20_000))
    with_n = long[:7000] + "N" + long[7001:15000] + "NN" + long[15002:]
    reads = [long, "ACGT" * 40, with_n, long[:k + 3]]
    for fmt in ("fastq", "fasta"):
        path = write_reads(tmp_path / f"long.{fmt}", reads, fmt)
        ours, _ = assert_parity(path, k, capacity_words=64,
                                n_policy=n_policy)
        assert ours.fast_reads == 3


@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("k", [14, 31])
def test_tiny_interval_budget_flushes_early(tmp_path, k, with_n):
    """Reads of at most two words fill the 1024 interval slots of a
    4096-word batch before its words, so batches flush on the budget; a
    read with an N every k + 10 bases makes them flush mid-read."""
    rng = np.random.default_rng(k)
    acgt = list("ACGT")
    reads = ["".join(rng.choice(acgt, size=m))
             for m in rng.integers(k, 33, size=3000)]
    if with_n:
        reads.insert(1500, "".join(
            "".join(rng.choice(acgt, size=k + 9)) + "N" for _ in range(3000)))
    path = write_reads(tmp_path / "t.fastq", reads, "fastq")
    ours_spec, _ = specs(k, 4096)
    _, batches = assert_parity(path, k, capacity_words=4096,
                               n_policy="drop")
    full = [int((b[ours_spec.total_words:][:ours_spec.max_intervals]
                 != 0xFFFFFFFF).sum()) == ours_spec.max_intervals
            for b, _, _ in batches]
    assert ours_spec.max_intervals == 1024 and sum(full) >= 2


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
@pytest.mark.parametrize("threads", [1, 2, 3, 4])
def test_byte_ranges_and_threads(tmp_path, threads, fmt):
    reads = make_reads("mixed", 14, seed=11, n=300)
    path = write_reads(tmp_path / f"t.{fmt}", reads, fmt)
    data = path.read_bytes()
    size = len(data)
    heads = [i for i in range(size)
             if data[i] in b"@>" and (i == 0 or data[i - 1] == ord("\n"))]
    ours, _ = assert_parity(path, 14, ordered=threads == 1,
                            threads=threads)
    assert ours.fast_reads == fast_eligible(reads, 14)
    # one rank's share, cut anywhere and at record starts, threads on it
    for lo, hi in [(0, size // 3), (size // 3, 2 * size // 3),
                   (2 * size // 3, -1), (1, size - 1), (7, 8),
                   (heads[10], heads[50]), (heads[50], -1),
                   (heads[20] - 1, heads[21] + 1)]:
        assert_parity(path, 14, ordered=threads == 1, threads=threads,
                      byte_start=lo, byte_end=hi, n_policy="random")


def big_reads(seed: int, n_bases: int) -> list[str]:
    """Reads of 100-1999 bases, 0.1 % N, about n_bases in all."""
    rng = np.random.default_rng(seed)
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_bases)]
    codes[rng.random(n_bases) < 0.001] = ord("N")
    text = codes.tobytes().decode()
    cuts = np.cumsum(rng.integers(100, 2000, n_bases // 100))
    cuts = [0] + [int(c) for c in cuts[cuts < n_bases]] + [n_bases]
    return [text[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.mark.parametrize("fmt", ["fastq", "gzip", "fasta", "fasta_one_line"])
def test_files_larger_than_the_input_buffer(tmp_path, fmt):
    """The parser reads plain files in 8 MiB blocks and gzip in 1 MiB
    pieces, keeping a partial record across each refill; a FASTA record
    longer than the buffer grows it."""
    reads = big_reads(1, 10_000_000 if fmt.startswith("fasta") else 8_000_000)
    if fmt == "fasta_one_line":
        path = tmp_path / "one.fasta"
        whole = "".join(reads)
        path.write_text(f">a\n{whole.replace('N', 'A')}\n>b\n{whole}\n"
                        f">c\n{reads[0]}\n")
    else:
        path = write_reads(tmp_path / f"big.{fmt}", reads, fmt)
    ours, _ = assert_parity(path, 31, capacity_words=1 << 16,
                            read_len_hint=1000)
    assert ours.stats.reads > 2 and ours.fast_reads > 0
    if fmt == "fastq":  # a rank's share, on three threads
        size = path.stat().st_size
        assert_parity(path, 31, capacity_words=1 << 16, ordered=False,
                      threads=3, byte_start=size // 5, byte_end=size - 99)


@pytest.mark.parametrize("at", [0.3, 0.6])
def test_corrupt_gzip_stops_where_the_reference_does(tmp_path, at):
    """A damaged gzip stream gives the reference's batches, then its error:
    the parser asks zlib for the same 1 MiB pieces, so the bytes that come
    before zlib's error are the same."""
    data = bytearray(write_reads(tmp_path / "ok.gz", big_reads(2, 8_000_000),
                                 "gzip").read_bytes())
    i = int(len(data) * at)
    data[i] ^= 0xFF
    data[i + 1] ^= 0x5A
    path = tmp_path / "bad.fastq.gz"
    path.write_bytes(bytes(data))
    ours_spec, _ = specs(31, 4096)
    assert drain(native.NativeFileReader(path, ours_spec))[2] is not None
    assert_parity(path, 31, capacity_words=4096)


@pytest.mark.parametrize("text", [
    "not a fastq\nACGT\n",
    "@r0\nACGTACGTACGTACGT\n",
    "@r0\nACGTACGTACGTACGT\n+\n",
    "@r0\nACGTACGTACGTACGT\nX\nIIII\n",
    "@r0\nACGTACGTACGTACGT\n+\nIIII\n@r1\nACGTACGTACGTACGT\n",
    "@r0\nACGTACGTACGTACGT\n+\nIIII\nr1\nACGT\n+\nIIII\n",
    "@r0\nACGTACGTACGTACGT\n+\nIIII\n\n@r1\nACGTACGTACGTACGT\n+\nII\n",
    "@r0\nACGTACGTACGTACGT\n+\nIIII\n@r1\nACGTACGTACGTACGT\r\n+\nII",
    "@r0\nACGTACGTACGTACGT\r",
    ">r0\nACGTACGTACGT\n\nACGTACGT\r\n>r1\n>r2\nACGTACGTACGTACGTAC",
], ids=["missing_at", "truncated_seq", "truncated_qual", "bad_plus",
        "truncated_second", "missing_second_at", "blank_line_stops",
        "no_final_newline", "cr_at_eof", "fasta_blank_and_empty"])
def test_malformed_and_truncated_records(tmp_path, text):
    path = tmp_path / "bad.fastq"
    path.write_bytes(text.encode())
    assert_parity(path, 4, capacity_words=8)


def test_counters_report_fast_reads(tmp_path):
    """stats()["parse_fast_reads"] sits beside "reads", counts the job since
    reset(), and stays out of PackStats (and so of checkpoints)."""
    from tsxcount_tpu_torch import KmerCounter
    from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

    reads = make_reads("n_mid", 14, seed=5)[:10] + make_reads("clean", 14,
                                                              seed=6)
    path = write_reads(tmp_path / "t.fastq", reads, "fastq")
    for counter in (KmerCounter(k=14, l=16, device="cpu"),
                    ShardedKmerCounter(k=14, n_shards=1, l=16, device="cpu")):
        for _ in range(2):
            counter.reset()
            counter.count_file(path)
            st = counter.stats()
            keys = list(st)
            assert keys[keys.index("reads") + 1] == "parse_fast_reads"
            assert st["reads"] == len(reads)
            assert st["parse_fast_reads"] == len(reads) - 10
        assert "parse_fast_reads" not in dataclasses.asdict(
            counter.packer.stats)
