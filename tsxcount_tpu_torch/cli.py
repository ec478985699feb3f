"""Command line of the port, `python -m tsxcount_tpu_torch count ...`.

The flags, defaults, `--mode` aliases, stderr lines and exit codes are the
JAX package's (`tsxcount_tpu/cli.py`): 0 on success, 1 on a `--check`
mismatch, 2 on a missing file or a ValueError, 42 when the table is full,
200 on a `--checkabort` mismatch.  What differs:

  * `--platform cuda` (the default; `gpu` is an alias) or `cpu`.  Where no
    GPU is present the run stops with an ERROR line unless `--platform cpu`
    is given: it never falls back to the CPU by itself.
  * `--shards N` (default 1) runs the sharded counter
    (parallel/sharded.py) over N ranks, one shard and one device each;
    `--shards 0` runs the plain KmerCounter.  From N = 2 the command
    starts the N rank processes itself (cuda:0 .. cuda:N-1, NCCL; with
    `--platform cpu`, CPU ranks on gloo), unless it already runs as one
    of N ranks under torchrun.  Every rank counts its share of the input
    and takes part in every read; rank 0 alone prints, dumps, checks and
    writes the state, and every rank exits with the same code.
  * `--routing-hash` is ignored with a warning at `--shards 0`, and
    `--hash-first` and `--mix-prefix` at `--shards` >= 1, as the JAX
    command line ignores them there.
  * `--profile DIR` writes a torch.profiler trace of the count and prints
    the device's busy time over it.
  * the memory preflight models the port's buffers (utils/hbm.py) against
    the card's memory; `--stats-json` adds that estimate of the counter
    as built, `memory_estimate_mb`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tsxcount-tpu-torch",
        description="exact k-mer counter on one NVIDIA GPU (PyTorch + CUDA "
        "port of tsxcount_tpu)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("count", help="count k-mers in a FASTQ/FASTA(.gz) file")
    c.add_argument("--input", required=True, help="FASTQ/FASTA file, .gz ok")
    c.add_argument("--k", type=int, default=14, help="k-mer length (default 14)")
    c.add_argument("--l", type=int, default=26,
                   help="log2 table capacity (default 26, as the reference)")
    c.add_argument("--s", type=int, default=4,
                   help="accepted for reference parity; counts here are "
                        "unbounded")
    c.add_argument("--threads", type=int, default=0,
                   help="host parse/pack threads (0 = auto -> 1); >1 "
                        "byte-range-splits uncompressed input across "
                        "threads (gzip degrades to 1)")
    c.add_argument("--mode", default="SERIAL",
                   help="reference mode string or backend name "
                        "(SERIAL/PTHREAD/OMP/CAS/TSX/EXPERIMENTAL/OMP_COUNT "
                        "or sort/table)")
    c.add_argument("--check", action="store_true",
                   help="verify against <input>.<k>.count golden file")
    c.add_argument("--checkabort", action="store_true",
                   help="abort on first mismatch (exit 200)")
    c.add_argument("--golden", default=None,
                   help="override golden file path for --check")
    c.add_argument("--dump", default=None,
                   help="write full counts as kmer\\tcount TSV")
    c.add_argument("--shards", type=int, default=1,
                   help="table shards, one a rank and device (default 1: "
                        "the sharded counter on one device); 0 = the "
                        "plain KmerCounter.  N >= 2 starts N ranks (or "
                        "joins torchrun's N)")
    c.add_argument("--batch-words", type=int, default=1 << 20,
                   help="uint32 words per device batch (16 bases/word)")
    c.add_argument("--read-len", type=int, default=0,
                   help="expected read length in bases; sizes the "
                        "interval-coded validity budget per batch "
                        "(0 = auto-detect from the first reads)")
    c.add_argument("--merge-every", type=int, default=4,
                   help="batches folded per store merge (sort backend)")
    c.add_argument("--hp-collapse", dest="hp_collapse",
                   action="store_true", default=None,
                   help="homopolymer run-length collapse at ingest (exact "
                        "either way: runs longer than 2k-2 are spliced and "
                        "the elided counts added at read time).  Default "
                        "off; on --load-state the checkpoint's setting "
                        "wins unless a flag overrides it")
    c.add_argument("--no-hp-collapse", dest="hp_collapse",
                   action="store_false",
                   help="disable homopolymer collapse (overrides a loaded "
                        "checkpoint's setting)")
    c.add_argument("--lsm", action="store_true", default=None,
                   help="force the log-structured multi-level store (sort "
                        "backend; exact).  Default: engaged when "
                        "capacity*(growth-1) > growth^2*flush rows")
    c.add_argument("--no-lsm", dest="lsm", action="store_false",
                   help="force the flat store")
    c.add_argument("--lsm-growth", type=int, default=8,
                   help="LSM level size ratio (default 8)")
    c.add_argument("--n-policy", choices=("drop", "random"), default="drop",
                   help="N handling: drop windows (default) or random "
                        "substitution (reference bug-compat)")
    c.add_argument("--hash-seed", type=int, default=None,
                   help="GF(2) hash matrix seed (default: fixed)")
    c.add_argument("--identity-hash", action="store_true",
                   help="debug: identity hash instead of random GF(2)")
    c.add_argument("--routing-hash", choices=("mix", "gf2"), default=None,
                   help="sharded routing bijection: 'mix' (the lane mix, "
                        "default) or 'gf2' (the seeded GF(2) matrix, what "
                        "sharded files written before the mix hold)")
    c.add_argument("--hash-first", choices=("auto", "mix", "gf2", "off"),
                   default="auto",
                   help="plain counter (--shards 0), sort backend: map keys "
                        "through a bijection before the dedupe and sort "
                        "its >= 64-bit uniform prefix.  'auto' (default) "
                        "engages the lane mix from k >= 113, 'mix' at any "
                        "k, 'gf2' the GF(2) matrix, 'off' never")
    c.add_argument("--mix-prefix", action="store_true", default=None,
                   help="plain counter (--shards 0), sort backend: store "
                        "keys extended by a 64-bit mixing hash and sort "
                        "the dedupe on it (exact; k <= 224)")
    c.add_argument("--stats-json", action="store_true",
                   help="emit stats as one JSON line")
    c.add_argument("--progress", type=int, default=0, metavar="N",
                   help="print an ingest progress line to stderr every N "
                        "batches (0 = off)")
    c.add_argument("--canonical", action="store_true",
                   help="count canonical kmers min(kmer, revcomp)")
    c.add_argument("--save-state", default=None,
                   help="write a resumable .npz checkpoint after counting "
                        "(loads in either package)")
    c.add_argument("--load-state", default=None,
                   help="resume from a .npz checkpoint before counting")
    c.add_argument("--platform", choices=sorted(PLATFORMS), default="cuda",
                   help="cuda (default; gpu is an alias) or cpu.  Without a "
                        "GPU the run stops unless --platform cpu is given")
    c.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the count to DIR")
    # set on the rank processes that --shards N starts: rank/N/init method
    c.add_argument("--rank-of", default=None, help=argparse.SUPPRESS)
    return p


def _profiled(out_dir: str, device):
    """torch.profiler over the count, every thread recorded where the
    installed torch can (the producer's parse and copy spans on their own
    thread); on exit the Chrome trace goes to out_dir/trace.json, and the
    device's busy time and the port's spans (utils/profiling.py) to
    stderr."""
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsxcount_tpu_torch.utils.profiling import (
        device_busy_us,
        reset_spans,
        span_totals,
    )

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:  # a torch without the option: the main thread only
        config = None

    @contextlib.contextmanager
    def ctx():
        reset_spans()
        with profile(activities=acts, experimental_config=config) as prof:
            t0 = time.perf_counter()
            yield
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        busy = device_busy_us(prof) / 1e6 if device.type == "cuda" else 0.0
        print(f"profile: {out / 'trace.json'}, wall {wall:.4f} s, device "
              f"busy {busy:.4f} s", file=sys.stderr)
        for name, (n, total, own) in sorted(span_totals().items()):
            print(f"profile: span {name} count {n} total {total:.4f} s "
                  f"self {own:.4f} s", file=sys.stderr)

    return ctx()


RANK_GRACE_S = 60  # after one rank fails, the others' time to end


def _checkpoint_shards(path: str) -> int:
    """n_shards of a checkpoint (0: the plain counter's)."""
    import numpy as np

    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["meta"])).get("n_shards", 0)


def _launch_ranks(argv: list[str], n: int) -> int:
    """Run this command as n rank processes, joined by a file-based
    process group in a fresh temporary directory.  Returns rank 0's exit
    code, or another rank's where rank 0's is 0; once a rank fails, the
    others get RANK_GRACE_S to end before they are killed (a rank that
    died leaves the rest waiting in a collective)."""
    with tempfile.TemporaryDirectory(prefix="tsxcount-ranks-") as tmp:
        init = f"file://{tmp}/pg"
        env = dict(os.environ)
        root = str(Path(__file__).resolve().parent.parent)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tsxcount_tpu_torch", *argv,
             "--rank-of", f"{r}/{n}/{init}"], env=env) for r in range(n)]
        failed_at = None
        while any(p.poll() is None for p in procs):
            if failed_at is None and any(p.poll() for p in procs):
                failed_at = time.monotonic()
            if (failed_at is not None
                    and time.monotonic() - failed_at > RANK_GRACE_S):
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.05)
        codes = [p.wait() for p in procs]
    return codes[0] or next((c for c in codes if c), 0)


def _join_rank(rank_of: str, device):
    """Join the rank processes' group (--rank-of r/N/init).  Returns
    (this rank, its device: cuda:r, or the CPU)."""
    import torch

    from tsxcount_tpu_torch.parallel.mesh import init_shard_group

    rank, world, init = rank_of.split("/", 2)
    rank, world = int(rank), int(world)
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = init_shard_group(world, device.type, init_method=init, rank=rank)
    return rank, group.device


def cmd_count(args: argparse.Namespace, argv: list[str] | None = None
              ) -> int:
    import torch

    device = torch.device(PLATFORMS[args.platform])
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device (torch.cuda.is_available() is False); "
              "pass --platform cpu to count on the CPU", file=sys.stderr)
        return 2
    if args.load_state:
        # the checkpoint's own shape (shards, backend, k, l) wins
        args.shards = _checkpoint_shards(args.load_state)
    rank = 0
    if args.rank_of is not None:
        rank, device = _join_rank(args.rank_of, device)
    elif args.shards >= 2:
        world = os.environ.get("WORLD_SIZE")
        if world is not None and int(world) != args.shards:
            print(f"ERROR: --shards {args.shards} under a launcher of "
                  f"{world} ranks", file=sys.stderr)
            return 2
        if (device.type == "cuda"
                and torch.cuda.device_count() < args.shards):
            print(f"ERROR: --shards {args.shards} needs {args.shards} "
                  f"CUDA devices, {torch.cuda.device_count()} present; "
                  f"pass --platform cpu to run the ranks on the CPU",
                  file=sys.stderr)
            return 2
        if world is None:
            return _launch_ranks(
                sys.argv[1:] if argv is None else argv, args.shards)
        # one of torchrun's ranks
        rank = int(os.environ.get("RANK", 0))
        device = torch.device(f"cuda:{os.environ.get('LOCAL_RANK', 0)}"
                              if device.type == "cuda" else "cpu")
    if rank:  # rank 0 alone prints
        sys.stdout = sys.stderr = open(os.devnull, "w")
    return _count(args, device, rank == 0)


def _count(args: argparse.Namespace, device, rank0: bool) -> int:
    # deferred imports keep --help quick
    from tsxcount_tpu_torch.core.counter import (
        CheckAbort,
        KmerCounter,
        TableFull,
    )
    from tsxcount_tpu_torch.ops.gf2 import DEFAULT_SEED
    from tsxcount_tpu_torch.utils.goldenfile import write_golden

    if args.shards == 0 and args.routing_hash is not None:
        print("warning: --routing-hash is ignored with --shards 0 (the "
              "plain counter routes nothing)", file=sys.stderr)
    if args.shards >= 1 and args.hash_first != "auto":
        print("warning: --hash-first is ignored with --shards >= 1 (the "
              "sharded stream hashes for routing; use --shards 0 for the "
              "plain counter)", file=sys.stderr)
    if args.shards >= 1 and args.mix_prefix is not None:
        print("warning: --mix-prefix is ignored with --shards >= 1 (use "
              "--shards 0 for the plain counter)", file=sys.stderr)
    kwargs = dict(
        k=args.k, l=args.l, s=args.s, backend=args.mode,
        batch_words=args.batch_words, n_policy=args.n_policy,
        hash_seed=(DEFAULT_SEED if args.hash_seed is None
                   else args.hash_seed),
        canonical=args.canonical, merge_every=args.merge_every,
        lsm=args.lsm, lsm_growth=args.lsm_growth, threads=args.threads,
        read_len_hint=args.read_len, progress_every=args.progress,
        collapse_homopolymers=bool(args.hp_collapse), device=device,
    )
    t0 = time.perf_counter()
    if args.load_state:
        from tsxcount_tpu_torch.core.checkpoint import load_counter

        counter = load_counter(args.load_state,
                               batch_words=args.batch_words, device=device)
        if args.hp_collapse is not None:
            # an explicit flag overrides the checkpoint's collapse setting
            counter.collapse_hp = args.hp_collapse
            counter.packer.collapse = args.hp_collapse and counter.spec.k >= 2
    elif args.shards >= 1:
        from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

        counter = ShardedKmerCounter(
            n_shards=args.shards, identity_hash=args.identity_hash,
            routing_hash=args.routing_hash or "mix", **kwargs)
    else:
        counter = KmerCounter(
            identity_hash=args.identity_hash, mix_prefix=args.mix_prefix,
            hash_first={"auto": None, "off": False}.get(args.hash_first,
                                                          args.hash_first),
            **kwargs)

    # config echo, like the reference's startup lines
    print(f"k={args.k} l={args.l} s={args.s} mode={args.mode} "
          f"backend={counter.backend} shards={args.shards} "
          f"input={args.input}", file=sys.stderr)
    from tsxcount_tpu_torch.utils.hbm import estimate_for, preflight_check

    estimate = estimate_for(counter)
    if device.type == "cuda":
        # a predicted out-of-memory as a warning before the count
        warn = preflight_check(estimate)
        if warn:
            print(f"warning: {warn}", file=sys.stderr)
    if counter.backend == "table":
        print("note: the table backend is the reference-semantics parity "
              "path (slot encoding, reconstruction, probe histograms); the "
              "sort backend (--mode SERIAL) is the speed path",
              file=sys.stderr)

    profile_ctx = (_profiled(args.profile, device) if args.profile
                   else contextlib.nullcontext())
    try:
        with profile_ctx:
            counter.count_file(args.input)
    except TableFull as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 42  # the reference's exit code for a full table

    wall = time.perf_counter() - t0
    stats = counter.stats()
    stats["wall_seconds"] = round(wall, 4)
    stats["kmers_per_second"] = (
        round(stats["windows"] / wall) if wall > 0 else 0
    )
    stats["memory_estimate_mb"] = round(estimate.total_mb, 1)
    if args.stats_json:
        print(json.dumps(stats))
    else:
        for key, val in stats.items():
            print(f"{key}: {val}", file=sys.stderr)

    if args.save_state:
        from tsxcount_tpu_torch.core.checkpoint import save_counter

        save_counter(counter, args.save_state)  # sharded: rank 0 writes
        print(f"saved state to {args.save_state}", file=sys.stderr)

    if args.dump:
        counts = counter.to_dict()  # a collective on every rank
        distinct = counter.distinct
        if rank0:
            write_golden(args.dump, counts, sort=True)
        print(f"dumped {distinct} kmers to {args.dump}", file=sys.stderr)

    if args.check or args.checkabort:
        golden = args.golden or f"{args.input}.{args.k}.count"
        try:
            res = counter.check(golden, abort=args.checkabort)
        except CheckAbort as e:
            print(f"CHECK ABORT: {e}", file=sys.stderr)
            return 200  # the reference's exit code for a check abort
        print(
            f"check: {res.n_matched}/{res.n_checked} matched, "
            f"{len(res.mismatches)} mismatched, {len(res.missing)} missing, "
            f"{res.extra_distinct} extra",
            file=sys.stderr,
        )
        if not res.ok:
            for kmer_str, want, got in (res.mismatches + res.missing)[:20]:
                print(f"  {kmer_str}: expected {want}, got {got}",
                      file=sys.stderr)
            return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return cmd_count(args, argv)
    except FileNotFoundError as e:
        print(f"ERROR: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
