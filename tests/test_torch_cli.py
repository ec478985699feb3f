"""The port's command line (`python -m tsxcount_tpu_torch count`), run in
process with --platform cpu, against the JAX package's CLI and a naive
count: dumps, exit codes, flags and the --stats-json keys.  Exact."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu.cli import main as jax_main  # noqa: E402
from tsxcount_tpu.utils.goldenfile import read_golden  # noqa: E402
from tsxcount_tpu_torch.cli import main  # noqa: E402

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402

CPU = ["--platform", "cpu"]


@pytest.fixture()
def fastq(tmp_path):
    rng = np.random.default_rng(0)
    reads = rand_reads(rng, 30, 10, 80)
    path = tmp_path / "in.fastq"
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return path, reads


def _golden(tmp_path, reads, k=9):
    want = naive_kmers(reads, k)
    golden = tmp_path / "golden.count"
    with open(golden, "w") as f:
        for km, c in want.items():
            f.write(f"{km}\t{c}\n")
    return golden, dict(want)


def _count(path, *flags):
    return ["count", "--input", str(path), "--k", "9", "--l", "12",
            "--batch-words", "64", *flags]


def test_cli_count_dump_check_roundtrip(fastq, tmp_path, capsys):
    path, reads = fastq
    golden, want = _golden(tmp_path, reads)
    dump = tmp_path / "dump.count"
    rc = main(_count(path, "--dump", str(dump), "--check", "--golden",
                     str(golden), *CPU))
    assert rc == 0
    assert read_golden(dump) == want
    err = capsys.readouterr().err
    assert f"check: {len(want)}/{len(want)} matched, 0 mismatched" in err
    assert "backend=sort shards=1" in err


def test_cli_check_mismatch_exit_1(fastq, tmp_path):
    path, reads = fastq
    golden, want = _golden(tmp_path, reads)
    km = next(iter(want))
    golden.write_text(f"{km}\t{want[km] + 1}\n")
    assert main(_count(path, "--check", "--golden", str(golden), *CPU)) == 1


def test_cli_checkabort_exit_200(fastq, tmp_path):
    path, reads = fastq
    golden = tmp_path / "golden.count"
    km = next(iter(naive_kmers(reads, 9)))
    golden.write_text(f"{km}\t99999\n")
    rc = main(_count(path, "--checkabort", "--golden", str(golden), *CPU))
    assert rc == 200


def test_cli_table_full_exit_42(fastq):
    path, _ = fastq
    rc = main(["count", "--input", str(path), "--k", "9", "--l", "3",
               "--batch-words", "64", *CPU])
    assert rc == 42


@pytest.mark.parametrize("flags", [
    ["--input", "/nonexistent/reads.fastq"],
    ["--mode", "NOPE"],
    ["--lsm-growth", "1"],
], ids=str)
def test_cli_bad_input_exit_2(fastq, flags, capsys):
    """A missing file, an unknown mode and a ValueError of the counter."""
    path, _ = fastq
    assert main(_count(path, *flags, *CPU)) == 2  # the last --input wins
    assert "ERROR:" in capsys.readouterr().err


def test_cli_mode_alias_table(fastq, tmp_path):
    path, reads = fastq
    golden, _ = _golden(tmp_path, reads)
    rc = main(["count", "--input", str(path), "--k", "9", "--l", "14",
               "--batch-words", "64", "--mode", "TSX", "--check",
               "--golden", str(golden), *CPU])
    assert rc == 0


def test_cli_help_runs():
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        main(["count", "--help"])
    assert e.value.code == 0


@pytest.mark.parametrize("shards", ["0", "1"])
def test_cli_shards_0_and_1_match_jax_cli(fastq, tmp_path, shards, capsys):
    """--shards 0 runs the plain counter and --shards 1 the sharded one on
    one device, as the JAX CLI does: the dump equals the JAX CLI's at the
    same --shards and the naive count, the --stats-json line carries every
    key of the JAX line (at --shards 1 the sharded ones: n_shards,
    shard_distinct, shard_imbalance, spill_recovered) and --save-state
    writes the JAX file's n_shards."""
    path, reads = fastq
    out = {}
    for tag, run, platform in (("ours", main, CPU),
                               ("ref", jax_main, ["--platform", "cpu"])):
        assert run(_count(path, "--shards", shards, "--dump",
                          str(tmp_path / f"{tag}.count"), "--stats-json",
                          "--save-state", str(tmp_path / f"{tag}.npz"),
                          *platform)) == 0
        cap = capsys.readouterr()
        out[tag] = json.loads(cap.out.strip().splitlines()[-1])
        assert "item 12" not in cap.err
        with np.load(tmp_path / f"{tag}.npz") as data:
            out[tag]["saved_n_shards"] = json.loads(str(data["meta"]))[
                "n_shards"]
    assert read_golden(tmp_path / "ours.count") == read_golden(
        tmp_path / "ref.count") == dict(naive_kmers(reads, 9))
    ours, ref = out["ours"], out["ref"]
    assert set(ref) <= set(ours), set(ref) - set(ours)
    sharded = {"n_shards", "shard_distinct", "shard_imbalance",
               "spill_recovered"}
    assert (sharded <= set(ours)) == (shards == "1")
    for key in ("total_kmers", "distinct_kmers", "saved_n_shards",
                *(sharded & set(ref))):
        assert ours[key] == ref[key], key
    assert ours["saved_n_shards"] == int(shards)


@pytest.mark.parametrize("shards", ["2", "3"])
def test_cli_shards_2_refused(fastq, tmp_path, shards):
    """--shards 2 and 3 (once refused) start that many CPU rank processes
    on gloo: the dump equals the JAX CLI's at the same --shards (its
    8-device CPU mesh) and the naive count."""
    path, reads = fastq
    ours, ref = tmp_path / "ours.count", tmp_path / "ref.count"
    assert main(_count(path, "--shards", shards, "--dump", str(ours),
                       *CPU)) == 0
    assert jax_main(_count(path, "--shards", shards, "--dump", str(ref),
                           "--platform", "cpu")) == 0
    assert read_golden(ours) == read_golden(ref) == dict(
        naive_kmers(reads, 9))


@pytest.mark.parametrize("hash_first", ["off", "mix", "auto"])
def test_cli_hash_first(fastq, tmp_path, hash_first):
    path, reads = fastq
    dump = tmp_path / "dump.count"
    rc = main(_count(path, "--shards", "0", "--hash-first", hash_first,
                     "--dump", str(dump), *CPU))
    assert rc == 0
    assert read_golden(dump) == dict(naive_kmers(reads, 9))


@pytest.mark.parametrize("flags", [["--hash-first", "gf2"], ["--mix-prefix"]],
                         ids=str)
def test_cli_unported_options_refused(fastq, tmp_path, flags, capsys):
    """Once refused, now ported: at --shards 0 the option counts (exit 0,
    the dump equal to the JAX CLI's and the naive count); at the default
    --shards 1 it is ignored with the JAX CLI's warning."""
    path, reads = fastq
    ours, ref = tmp_path / "ours.count", tmp_path / "ref.count"
    assert main(_count(path, "--shards", "0", *flags, "--dump", str(ours),
                       *CPU)) == 0
    assert jax_main(_count(path, "--shards", "0", *flags, "--dump",
                           str(ref), "--platform", "cpu")) == 0
    assert read_golden(ours) == read_golden(ref) == dict(
        naive_kmers(reads, 9))
    capsys.readouterr()
    assert main(_count(path, *flags, *CPU)) == 0
    assert f"warning: {flags[0]} is ignored with --shards >= 1" in (
        capsys.readouterr().err)


def test_cli_routing_hash_ignored_with_warning(fastq, capsys):
    """The plain counter (--shards 0) routes nothing: the flag is ignored
    with a warning there."""
    path, _ = fastq
    assert main(_count(path, "--shards", "0", "--routing-hash", "gf2",
                       *CPU)) == 0
    assert "warning: --routing-hash is ignored" in capsys.readouterr().err


# the case ids of the time the GF(2) routing was refused (exit 2)
@pytest.mark.parametrize("routing", ["mix", "gf2"], ids=["mix-0", "gf2-2"])
def test_cli_routing_hash_of_the_sharded_counter(fastq, tmp_path, routing):
    """At the default --shards 1 the sharded counter reads the flag: both
    routings count (the table too, whose slots the image addresses), and
    --identity-hash (which forces the GF(2) routing) as well; every dump
    equals the JAX CLI's and the naive count."""
    path, reads = fastq
    want = dict(naive_kmers(reads, 9))
    runs = [["--routing-hash", routing],
            ["--routing-hash", routing, "--mode", "table"]]
    if routing == "gf2":
        runs.append(["--identity-hash"])
    for flags in runs:
        ours, ref = tmp_path / "ours.count", tmp_path / "ref.count"
        assert main(_count(path, *flags, "--dump", str(ours), *CPU)) == 0
        assert jax_main(_count(path, *flags, "--dump", str(ref),
                               "--platform", "cpu")) == 0
        assert read_golden(ours) == read_golden(ref) == want, flags


@pytest.mark.parametrize("mode", ["SERIAL", "TSX"])
def test_cli_stats_json_superset_of_jax(fastq, mode, capsys):
    """--stats-json prints stats() + wall_seconds + kmers_per_second: every
    key of the JAX CLI's line (its plain counter, --shards 0), equal
    totals."""
    path, _ = fastq
    flags = ("--shards", "0", "--mode", mode, "--stats-json")
    assert main(_count(path, *flags, *CPU)) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_main(_count(path, *flags, "--platform", "cpu")) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ref) <= set(ours), set(ref) - set(ours)
    for key in ("total_kmers", "distinct_kmers", "windows", "reads",
                "backend"):
        assert ours[key] == ref[key], key
    assert ours["wall_seconds"] > 0 and ours["device"] == "cpu"
    assert ours["memory_estimate_mb"] > 0  # the built counter's estimate


@pytest.mark.parametrize("flags", [
    ["--canonical"], ["--hp-collapse"], ["--lsm", "--lsm-growth", "2"],
    ["--canonical", "--mode", "CAS"],
], ids=str)
def test_cli_options_match_jax_cli(fastq, tmp_path, flags):
    path, _ = fastq
    ours, ref = tmp_path / "ours.count", tmp_path / "ref.count"
    common = ("--shards", "0", "--merge-every", "1", *flags)
    assert main(_count(path, *common, "--dump", str(ours), *CPU)) == 0
    assert jax_main(_count(path, *common, "--dump", str(ref),
                           "--platform", "cpu")) == 0
    assert read_golden(ours) == read_golden(ref)


def test_cli_save_load_state_and_progress(fastq, tmp_path, capsys):
    """--save-state writes a checkpoint that --load-state resumes (here:
    the same file twice, so every count doubles); --progress 1 prints a
    line a batch; --profile writes a trace."""
    path, reads = fastq
    state = tmp_path / "s.npz"
    assert main(_count(path, "--save-state", str(state), "--progress", "1",
                       "--profile", str(tmp_path / "prof"), *CPU)) == 0
    err = capsys.readouterr().err
    assert "progress: batches=1 " in err and f"saved state to {state}" in err
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    dump = tmp_path / "dump.count"
    assert main(_count(path, "--load-state", str(state), "--dump",
                       str(dump), *CPU)) == 0
    assert read_golden(dump) == {km: 2 * c for km, c in
                                 naive_kmers(reads, 9).items()}
