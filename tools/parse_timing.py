#!/usr/bin/env python3
"""Host timing of the port's parser against the JAX package's parser source.

    python3 tools/parse_timing.py [--reps 5]

Builds `tsxcount_tpu_torch/csrc/fastxpack.cpp` (through io/native.py) and
`tsxcount_tpu/_native/fastxpack.cpp` (by path, with the same g++ command,
into `tsxcount_tpu_torch/build/`; nothing of the JAX package is imported),
writes four files from seed 42 into a temporary directory, and times one
whole parse of each file with each library (calls in the order reference,
port, port, reference, `--reps` times), with the benchmark's batch
geometry: k = 14, 2^20-word batches, one thread.  The files: the two
benchmark mixes (`portbench/traffic`), the genome-30x reads with 1 % of
their bases and one more base of each read set to N (so every read takes
the general path), and those reads as a multi-line FASTA (60 bases a
line).  Prints one JSON line a file:
median seconds of each parser, their ratio, and the reads that took the
port's one-pass path.  No device is used.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from portbench import traffic  # noqa: E402
from tsxcount_tpu_torch.config import BatchSpec, KmerSpec  # noqa: E402
from tsxcount_tpu_torch.io import native  # noqa: E402

REFERENCE = REPO / "tsxcount_tpu" / "_native" / "fastxpack.cpp"


def build_reference() -> ctypes.CDLL:
    out = native.BUILD_DIR / "libfastxpack-reference.so"
    cmd = native.compile_command(out)
    cmd[cmd.index(str(native.SOURCE))] = str(REFERENCE)
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(cmd, check=True)
    return ctypes.CDLL(str(out))


def declare(lib) -> ctypes.CDLL:
    lib.fxp_open_range.restype = ctypes.c_void_p
    lib.fxp_open_range.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.fxp_next_batch.restype = ctypes.c_int
    lib.fxp_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.fxp_close.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "fxp_fast_reads"):  # not in the reference
        lib.fxp_fast_reads.restype = ctypes.c_int64
        lib.fxp_fast_reads.argtypes = [ctypes.c_void_p]
    return lib


def parse_s(lib, path: Path, batch: BatchSpec) -> tuple[float, int]:
    """Seconds of one whole parse, as NativeFileReader runs it (a fresh
    buffer a batch), and the one-pass reads (-1 where not counted)."""
    t0 = time.perf_counter()
    h = lib.fxp_open_range(str(path).encode(), batch.spec.k, 0, 0, 0, -1, 0)
    n_valid, n_bases = ctypes.c_int64(), ctypes.c_int64()
    while True:
        buf = np.empty(batch.buf_words, np.uint32)
        rc = lib.fxp_next_batch(h, buf.ctypes.data, batch.total_words,
                                batch.capacity_words, batch.max_intervals,
                                ctypes.byref(n_valid), ctypes.byref(n_bases))
        if rc <= 0:
            break
    dt = time.perf_counter() - t0
    fast = lib.fxp_fast_reads(h) if hasattr(lib, "fxp_fast_reads") else -1
    lib.fxp_close(h)
    if rc < 0:
        raise RuntimeError(f"parse error in {path}")
    return dt, fast


def write_files(tmp: Path) -> dict[str, Path]:
    files = {}
    for mix in ("synth-long", "genome-30x"):
        files[mix] = tmp / f"{mix}.fastq"
        mix_params = json.loads(
            (REPO / "portbench" / "traffic" / f"{mix}.json").read_text())
        traffic.write_fastq(mix_params, 42, files[mix])
    lines = files["genome-30x"].read_bytes().split(b"\n")
    rng = np.random.default_rng(42)
    for i in range(1, len(lines), 4):
        s = np.frombuffer(lines[i], np.uint8).copy()
        s[rng.random(s.size) < 0.01] = ord("N")
        s[rng.integers(s.size)] = ord("N")  # every read on the general path
        lines[i] = s.tobytes()
    files["genome-30x-n1pct"] = tmp / "genome-30x-n1pct.fastq"
    files["genome-30x-n1pct"].write_bytes(b"\n".join(lines))
    files["genome-30x-fasta60"] = tmp / "genome-30x.fasta"
    with open(files["genome-30x-fasta60"], "wb") as f:
        for i, s in enumerate(lines[1::4]):
            f.write(b">r%d\n" % i)
            f.write(b"".join(s[j:j + 60] + b"\n"
                             for j in range(0, len(s), 60)))
    return files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    libs = {"reference": declare(build_reference()),
            "port": declare(native.load_native())}
    batch = BatchSpec(KmerSpec(14), capacity_words=1 << 20)
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in write_files(Path(tmp)).items():
            times = {"reference": [], "port": []}
            fast = -1
            for _ in range(args.reps):
                for which in ("reference", "port", "port", "reference"):
                    dt, f = parse_s(libs[which], path, batch)
                    times[which].append(dt)
                    fast = max(fast, f)
            med = {w: statistics.median(t) for w, t in times.items()}
            print(json.dumps({
                "file": name, "mb": round(path.stat().st_size / 1e6, 2),
                "reference_s": med["reference"], "port_s": med["port"],
                "speedup": med["reference"] / med["port"],
                "port_fast_reads": fast}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
