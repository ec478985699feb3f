"""ctypes bindings for the native C++ FASTQ parser/packer.

The parser's source is the JAX package's `tsxcount_tpu/_native/fastxpack.cpp`,
read by path: this module never imports that package, never loads the
library shipped beside the source, and never writes into its directory.  It
compiles the source with g++ into this package's build directory
(`tsxcount_tpu_torch/build/`, listed in .gitignore), under a file name keyed
by a hash of the source and the compile command, so an edited source or
flag set builds anew and concurrent processes never load a half-written
library (each build goes to a temporary name and is renamed into place).

Byte-range chunking: `fxp_open_range` parses only the records owned by a
byte range of the file (FASTQ 4-line / FASTA resync in C++), so
NativeFileReader can fan the parse out over N host threads (ctypes calls
release the GIL).  Ranges need uncompressed input; .gz falls back to one
sequential stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from tsxcount_tpu_torch.config import BatchSpec
from tsxcount_tpu_torch.io.packer import PackedBatch, PackStats, add_stats

_REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "tsxcount_tpu" / "_native" / "fastxpack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

_lock = threading.Lock()
_lib = None
_build_error: str | None = None

N_POLICY_CODES = {"drop": 0, "random": 1}


def compile_command(out: Path) -> list[str]:
    """The g++ command that builds the parser into `out`.  No -march=native:
    the library must run on whichever host loads the build directory."""
    return [
        os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-shared",
        "-fPIC", str(SOURCE), "-o", str(out), "-lz",
    ]


def library_path() -> Path:
    """Build output for the current source, command and host platform
    (hash-keyed)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(compile_command(Path("out"))).encode())
    h.update(platform.platform().encode())
    return BUILD_DIR / f"libfastxpack-{h.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> None:
    """Compile the parser; raises RuntimeError with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            compile_command(tmp), capture_output=True, text=True, timeout=300
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native parser build failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native parser build failed:\n{proc.stderr[-2000:]}"
        )
    os.replace(tmp, lib_path)


def _declare(lib) -> None:
    lib.fxp_open_range.restype = ctypes.c_void_p
    lib.fxp_open_range.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ]
    lib.fxp_next_batch.restype = ctypes.c_int
    lib.fxp_next_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fxp_stats.restype = None
    lib.fxp_stats.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int64)
    ] * 5
    lib.fxp_hp_bonus.restype = None
    lib.fxp_hp_bonus.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.fxp_packed_words.restype = ctypes.c_int64
    lib.fxp_packed_words.argtypes = [ctypes.c_void_p]
    lib.fxp_error.restype = ctypes.c_char_p
    lib.fxp_error.argtypes = [ctypes.c_void_p]
    lib.fxp_close.restype = None
    lib.fxp_close.argtypes = [ctypes.c_void_p]


def load_native():
    """The parser library, built on first use.  Raises RuntimeError when it
    cannot be built or loaded (the message holds the compiler's output)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(_build_error)
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _build_error = f"native parser unavailable: {e}"
            raise RuntimeError(_build_error) from e
        _declare(lib)
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_native()
    except RuntimeError:
        return False
    return True


def is_gzip(path: str | Path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def split_ranges(path: str | Path, n: int) -> list[tuple[int, int]]:
    """Split a file into n contiguous byte ranges.  Record-boundary
    alignment is the native parser's job (resync), so plain equal byte
    splits are correct."""
    size = os.path.getsize(path)
    cuts = [size * i // n for i in range(n + 1)]
    return [(cuts[i], cuts[i + 1]) for i in range(n)
            if cuts[i + 1] > cuts[i]] or [(0, size)]


class _Handle:
    """One native parse stream over one byte range (end -1 = to EOF)."""

    def __init__(self, lib, path: str | Path, batch: BatchSpec,
                 n_policy: str, seed: int, byte_start: int, byte_end: int):
        self._lib = lib
        self.batch = batch
        self._h = lib.fxp_open_range(
            str(path).encode(), batch.spec.k, N_POLICY_CODES[n_policy],
            seed, byte_start, byte_end, 0,
        )
        if not self._h:
            raise FileNotFoundError(path)

    def batches(self):
        lib = self._lib
        b = self.batch
        n_valid = ctypes.c_int64()
        n_bases = ctypes.c_int64()
        while True:
            buf = np.empty(b.buf_words, dtype=np.uint32)
            rc = lib.fxp_next_batch(
                self._h,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                b.total_words,
                b.capacity_words,
                b.max_intervals,
                ctypes.byref(n_valid),
                ctypes.byref(n_bases),
            )
            if rc < 0:
                raise ValueError(
                    f"parse error: {lib.fxp_error(self._h).decode()}"
                )
            if n_valid.value or n_bases.value:
                yield PackedBatch(
                    buf=buf,
                    n_valid=int(n_valid.value),
                    n_bases=int(n_bases.value),
                    batch=b,
                )
            if rc == 0:
                return

    def stats(self) -> PackStats:
        vals = [ctypes.c_int64() for _ in range(5)]
        self._lib.fxp_stats(self._h, *[ctypes.byref(v) for v in vals])
        bonus = (ctypes.c_int64 * 4)()
        self._lib.fxp_hp_bonus(self._h, bonus)
        return PackStats(
            reads=int(vals[0].value),
            reads_skipped=int(vals[1].value),
            bases=int(vals[2].value),
            n_bases=int(vals[3].value),
            windows=int(vals[4].value),
            hp_bonus=tuple(int(b) for b in bonus),
            hp_collapsed_bases=int(sum(bonus)),
            packed_words=int(self._lib.fxp_packed_words(self._h)),
        )

    def close(self):
        if self._h:
            self._lib.fxp_close(self._h)
            self._h = None


class NativeFileReader:
    """Streams PackedBatch objects straight from a FASTQ/FASTA(.gz) file.

    threads > 1 splits an uncompressed file into byte ranges parsed
    concurrently (each ctypes call releases the GIL); batch order across
    ranges is arrival order — counting is order-invariant.  gzip input
    degrades to one stream.  Raises RuntimeError if the parser cannot be
    built.
    """

    def __init__(self, path: str | Path, batch: BatchSpec,
                 n_policy: str = "drop", seed: int = 0, threads: int = 1):
        lib = load_native()
        if not Path(path).exists():
            raise FileNotFoundError(path)
        self.batch = batch
        self.stats = PackStats()
        if threads > 1 and not is_gzip(path):
            ranges = split_ranges(path, threads)
        else:
            ranges = [(0, -1)]
        self._handles = [
            _Handle(lib, path, batch, n_policy, seed + i, s, e)
            for i, (s, e) in enumerate(ranges)
        ]

    def __iter__(self):
        try:
            if len(self._handles) == 1:
                source = self._handles[0].batches()
            else:
                from tsxcount_tpu_torch.io.pipeline import merged_iter

                source = merged_iter(
                    [h.batches() for h in self._handles],
                    depth=2 * len(self._handles),
                )
            for pb in source:
                self.stats.batches += 1
                yield pb
        finally:
            self._finalize_stats()

    def _finalize_stats(self):
        if not self._handles:
            return
        total = PackStats()
        for h in self._handles:
            total = add_stats(total, h.stats())
            h.close()
        total.batches = self.stats.batches
        self.stats = total
        self._handles = []
