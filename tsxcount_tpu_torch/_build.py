"""Build, load and launch-count the port's CUDA kernels.

The kernels live in `csrc/*.cu` (device code shared between files in
`csrc/*.cuh`).  They are compiled at first use with nvcc for Hopper
(`sm_90a`) into ONE shared library with a plain C interface, loaded through
ctypes — no PyTorch headers, so the build takes seconds, not minutes.  The
library goes to `tsxcount_tpu_torch/build/` (listed in .gitignore) under a
name keyed by a hash of every source and of the command, so an edited kernel
builds anew; each build writes a temporary file and renames it into place,
so concurrent processes never load a half-written library.

Every C entry point returns `cudaGetLastError()` after its launches;
`check` raises on anything but 0.  Pointers and the stream travel as
`c_void_p` (a 64-bit value — ctypes would otherwise cut them to 32-bit
ints), sizes as `c_int64`.

Launch counts: each kernel wrapper adds one to its entry in `LAUNCHES` where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.  The counts are per process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

LAUNCHES = {"compact_flagged": 0, "merge_sorted": 0, "merge_dedupe_sorted": 0}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# entry point -> (restype, argtypes); see the extern "C" blocks in csrc/
_SIGNATURES = {
    "tsx_compact_scratch_elems": (_I64, [_I64]),
    "tsx_compact_flagged": (_INT, [_P, _P, _P, _P, _INT, _I64, _P, _P]),
    "tsx_merge_scratch_elems": (_I64, [_I64, _I64]),
    "tsx_merge_sorted": (_INT, [_P, _P, _P, _P, _INT, _INT, _I64, _I64,
                                _P, _P]),
    "tsx_merge_dedupe_scratch_bytes": (_I64, [_INT, _I64, _I64]),
    "tsx_merge_dedupe_sorted": (_INT, [_P, _P, _P, _INT, _I64, _I64,
                                       ctypes.c_uint32, _P, _P, _P]),
    "tsx_error_string": (ctypes.c_char_p, [_INT]),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    return shutil.which("nvcc") or str(cand)


def nvcc_command(out: Path) -> list[str]:
    """The nvcc command line that builds every kernel into `out`."""
    return [
        nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-o", str(out), *map(str, sources()),
    ]


def library_path() -> Path:
    """Build output for the current sources and command (hash-keyed)."""
    h = hashlib.sha256()
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(nvcc_command(Path("out"))[1:]).encode())
    return BUILD_DIR / f"libtsxkernels-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, path)


def kernels():
    """The kernel library, built on first use (raises if nvcc fails)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = kernels().tsx_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr_array(tensors) -> ctypes.Array:
    """Host array of device pointers (the C side copies it into a struct
    passed to the kernel by value)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def width_array(tensors) -> ctypes.Array:
    return (ctypes.c_int * len(tensors))(*[t.element_size() for t in tensors])


def check_columns(name: str, cols, dtypes: tuple, length: int | None = None,
                  device: torch.device | None = None) -> torch.device:
    """Raise unless every column is a contiguous 1-D tensor of one of
    `dtypes`, of `length` (if given), all on one device; return it."""
    if not cols:
        raise ValueError(f"{name}: no columns")
    dev = device if device is not None else cols[0].device
    for c in cols:
        if not isinstance(c, torch.Tensor) or c.dim() != 1:
            raise ValueError(f"{name}: columns must be 1-D tensors")
        if c.dtype not in dtypes:
            raise TypeError(f"{name}: column dtype {c.dtype} not in {dtypes}")
        if c.device != dev:
            raise ValueError(f"{name}: columns on {c.device} and {dev}")
        if not c.is_contiguous():
            raise ValueError(f"{name}: columns must be contiguous")
        if length is not None and c.shape[0] != length:
            raise ValueError(
                f"{name}: column length {c.shape[0]} != {length}"
            )
    return dev


def require_cuda(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; expected cpu or cuda")
