"""The traffic: each mix finds its generator by name, repeats by seed, and
is as its file says."""

import numpy as np
import pytest

from portbench import reference, run, traffic

SMALL = {
    "synth-long": {"reads": 30},
    "genome-30x": {"genome_len": 3000},
}


def small_mix(name: str) -> dict:
    return dict(run.load_traffic(name), **SMALL[name])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_same_seed_gives_the_same_bytes(tmp_path, name):
    mix = small_mix(name)
    big = 2 ** 31 + 977  # seeds go past 32 signed bits
    paths = [tmp_path / f"{i}.fastq" for i in range(3)]
    for p, seed in zip(paths, (big, big, big + 1)):
        traffic.write_fastq(mix, seed, p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert paths[0].read_bytes() != paths[2].read_bytes()


def test_synth_long_at_seed_42_is_the_bench_file(tmp_path):
    """The upstream generator as bench.py draws it: 18,750,197 windows
    and 14,479,762 distinct k = 14 keys."""
    path = tmp_path / "synth.fastq"
    traffic.write_fastq(run.load_traffic("synth-long"), 42, path)
    keys, counts = reference.reference_count(path, 14)
    assert int(counts.sum()) == 18_750_197
    assert keys.size == 14_479_762
    head = path.read_text()[:12]
    assert head.startswith("@read0\n")


def test_synth_long_reads_and_tails(tmp_path):
    mix = small_mix("synth-long")
    reads = traffic.make_reads(mix, 5)
    assert len(reads) == 30
    for r in reads:
        s = r.tobytes()
        body = s.rstrip(b"A")
        assert 600 <= len(s) <= 999 + 299
        assert len(s) - len(body) >= 100  # the polyA tail
        assert set(s) <= set(b"ACGT")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_each_mix_names_a_generator_module(name):
    mix = run.load_traffic(name)
    gen = traffic.generator(mix["generator"])
    assert gen.__name__ == f"portbench.generators.{mix['generator']}"
    assert callable(gen.make_reads)


def test_a_mix_with_an_unknown_generator_is_refused(tmp_path):
    mix = dict(small_mix("synth-long"), generator="no_such_generator")
    with pytest.raises(ModuleNotFoundError):
        traffic.write_fastq(mix, 1, tmp_path / "r.fastq")


def test_genome_reads_come_from_either_strand_of_the_genome():
    mix = dict(small_mix("genome-30x"), error_rate=0.0)
    seed = 11
    reads = traffic.make_reads(mix, seed)
    g = mix["genome_len"]
    assert len(reads) == round(mix["coverage"] * g / 150)
    genome_codes = np.random.default_rng(seed).integers(0, 4, size=g,
                                                        dtype=np.uint8)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[genome_codes].tobytes()
    rc = genome[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    strands = [0, 0]
    for r in reads:
        s = r.tobytes()
        assert len(s) == 150
        fwd = s in genome
        strands[fwd] += 1
        assert fwd or s in rc
    assert min(strands) > 0.3 * len(reads)


def test_genome_reads_carry_the_stated_substitutions():
    mix = dict(small_mix("genome-30x"), genome_len=20000)
    rate = mix["error_rate"]
    clean = traffic.make_reads(dict(mix, error_rate=0.0), 3)
    noisy = traffic.make_reads(mix, 3)
    diff = sum(int((a != b).sum()) for a, b in zip(clean, noisy))
    bases = sum(a.size for a in clean)
    assert 0.8 * rate * bases < diff < 1.2 * rate * bases
