"""The plain reference against a brute-force count, and the comparison and
its control at small sizes."""

from collections import Counter

import numpy as np
import pytest

from portbench import reference


def brute_force(reads: list[str], k: int) -> Counter:
    out: Counter = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            if all(b in "ACGTacgt" for b in w):
                out[w.upper()] += 1
    return out


def write(path, reads):
    path.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                            for i, r in enumerate(reads)))


def as_rows(counts: Counter, k: int):
    kmers = sorted(counts)
    rows = reference.encode_kmers("".join(kmers).encode(), k)
    return rows, np.array([counts[s] for s in kmers], dtype=np.int64)


def random_reads(rng, n, lo, hi, alphabet="ACGTacgtN"):
    p = np.array([0.22, 0.22, 0.22, 0.22, 0.02, 0.02, 0.02, 0.02, 0.04])
    return ["".join(rng.choice(list(alphabet), size=int(rng.integers(lo, hi)),
                               p=p)) for _ in range(n)]


@pytest.mark.parametrize("k", [1, 5, 14, 31, 32, 33, 64, 70])
def test_reference_matches_brute_force(tmp_path, k):
    rng = np.random.default_rng(k)
    reads = random_reads(rng, 60, 0, 150) + ["A" * 200, "ACGT" * 30, ""]
    path = tmp_path / "r.fastq"
    write(path, reads)
    want = as_rows(brute_force(reads, k), k)
    got = reference.reference_count(path, k)
    assert reference.compare(want, got) == dict.fromkeys(
        ["missing", "extra", "wrong_count", "duplicate", "windows_off"], 0)
    order = np.argsort(want[0])
    assert np.array_equal(got[0], want[0][order])
    assert np.array_equal(got[1], want[1][order])


def revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.mark.parametrize("k", [1, 4, 14, 31, 32, 33, 65])
def test_canonical_reference_matches_brute_force(tmp_path, k):
    """min(k-mer, reverse complement) in string order, as the counter's
    --canonical counts."""
    rng = np.random.default_rng(100 + k)
    reads = random_reads(rng, 50, 0, 160) + ["ACGT" * 40, "T" * 90]
    path = tmp_path / "r.fastq"
    write(path, reads)
    plain = brute_force(reads, k)
    folded: Counter = Counter()
    for s, n in plain.items():
        folded[min(s, revcomp(s))] += n
    want = as_rows(folded, k)
    got = reference.reference_count(path, k, canonical=True)
    assert reference.compare(want, got) == dict.fromkeys(
        ["missing", "extra", "wrong_count", "duplicate", "windows_off"], 0)


@pytest.mark.parametrize("k", [20, 40])
def test_key_words_sort_as_their_strings(k):
    kmers = sorted({"".join(w) for w in np.random.default_rng(k).choice(
        list("ACGT"), size=(200, k))})
    rows = reference.encode_kmers("".join(kmers).encode(), k)
    words = rows.view(np.uint64).reshape(len(kmers), -1)
    order = np.lexsort(words.T[::-1])  # word 0 first
    assert list(order) == list(range(len(kmers)))


def test_a_file_without_a_final_newline(tmp_path):
    path = tmp_path / "r.fastq"
    path.write_text("@a\nACGTACGTAC\n+\nIIIIIIIIII")
    keys, counts = reference.reference_count(path, 4)
    assert counts.sum() == 7


def test_a_file_that_is_not_fastq_is_refused(tmp_path):
    path = tmp_path / "r.fa"
    path.write_text(">a\nACGT\n")
    with pytest.raises(ValueError):
        reference.reference_count(path, 2)


def test_compare_sees_each_fault(tmp_path):
    rng = np.random.default_rng(7)
    reads = random_reads(rng, 40, 20, 90, alphabet="ACGNacgtT")
    path = tmp_path / "r.fastq"
    write(path, reads)
    want = reference.reference_count(path, 9)
    rows, counts = want[0].copy(), want[1].copy()
    assert not any(reference.compare(want, (rows, counts)).values())
    c = counts.copy()
    c[3] += 1
    assert reference.compare(want, (rows, c)) == {
        "missing": 0, "extra": 0, "wrong_count": 1, "duplicate": 0,
        "windows_off": 1}
    cut = reference.compare(want, (rows[1:], counts[1:]))
    assert cut["missing"] == 1 and cut["windows_off"] == counts[0]
    dup = reference.compare(want, (np.concatenate([rows, rows[:2]]),
                                   np.concatenate([counts, counts[:2]])))
    assert dup["duplicate"] == 2
    other = reference.encode_kmers(b"TTTTTTTTT", 9)
    assert other[0] not in rows  # no read has nine Ts in a row
    ext = reference.compare(want, (np.concatenate([rows, other]),
                                   np.concatenate([counts, [1]])))
    assert ext["extra"] == 1 and ext["windows_off"] == 1


def test_control_drops_only_the_windows_across_seams(tmp_path):
    reads = ["ACGTTGCA" * 10, "GATTACA" * 9, "CCCGGGTTTAAA" * 7]
    path = tmp_path / "r.fastq"
    write(path, reads)
    k = 6
    want = reference.reference_count(path, k)
    whole = reference.control_count(path, k, 10 ** 9)
    assert not any(reference.compare(want, whole).values())
    total = sum(map(len, reads))
    chunk = 37
    seams = [s for s in range(chunk, total, chunk)]
    got = reference.control_count(path, k, chunk)
    nums = reference.compare(want, got)
    # every seam falls inside a read here and loses k - 1 windows
    assert nums["windows_off"] == (k - 1) * len(seams)
    assert nums["wrong_count"] + nums["missing"] > 0
