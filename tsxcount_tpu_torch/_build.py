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
path went through the kernels.  The counts are per process.  While a torch
profiler runs (the process-wide flag that `utils/profiling.span` reads),
the wrapper's launch is also kept by its shape, the sizes the host holds
at the launch (rows, columns, key words), in a second per-process table,
`launch_shapes()`: the bytes a traced kernel moved, for its roofline share.
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
import torch.autograd.profiler as _autograd_profiler

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
MAX_COLS = 18  # kMaxCols of csrc/common.cuh: columns of one kernel call

LAUNCHES = {"compact_flagged": 0, "merge_sorted": 0, "merge_dedupe_sorted": 0,
            "apply_sorted_unique": 0, "gather_sorted": 0, "lane_mix": 0,
            "table_residue": 0}

# (kernel, sorted shape items) -> launches while a profiler ran
_SHAPES: dict[tuple[str, tuple], int] = {}
_shapes_lock = threading.Lock()

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_U32 = ctypes.c_uint32
# entry point -> (restype, argtypes); see the extern "C" blocks in csrc/
_SIGNATURES = {
    "tsx_compact_scratch_bytes": (_I64, [_I64]),
    "tsx_compact_flagged": (_INT, [_P, _INT, _P, _P, _P, _INT, _I64, _P,
                                   _P]),
    "tsx_merge_scratch_elems": (_I64, [_INT, _I64, _I64]),
    "tsx_merge_sorted": (_INT, [_P, _P, _P, _P, _INT, _INT, _I64, _I64,
                                _P, _P]),
    "tsx_merge_partition": (_INT, [_P, _P, _INT, _I64, _I64, _P, _P]),
    "tsx_merge_dedupe_scratch_bytes": (_I64, [_INT, _I64, _I64]),
    "tsx_merge_dedupe_sorted": (_INT, [_P, _P, _P, _INT, _I64, _I64,
                                       _U32, _P, _P, _P]),
    "tsx_gather_sorted": (_INT, [_P, _P, _INT, _I64, _P, _I64, _P]),
    "tsx_apply_sorted_unique": (_INT, [_P, _P, _INT, _I64, _P, _I64, _P]),
    "tsx_lane_mix": (_INT, [_P, _P, _INT, _I64, _INT, _U32, _U32, _U32, _U32,
                            _U32, _INT, _INT, _P]),
    "tsx_table_residue_scratch_words": (_I64, [_I64]),
    "tsx_table_residue": (_INT, [_P, _I64, _INT, _P, _P, _P, _P, _I64, _I64,
                                 _I64, _I64, _P, _P, _P, _I64, _P, _P, _P, _P,
                                 _P, _I64, _P]),
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


def count_launch(name: str, **shape) -> None:
    """Count one launch of kernel `name`; while a torch profiler runs,
    also keep it under its `shape` (see the module docstring), whose
    values are ints or zero-argument callables that give one, called only
    then."""
    LAUNCHES[name] += 1
    if _autograd_profiler._is_profiler_enabled:
        key = (name, tuple(sorted((k, v() if callable(v) else v)
                                  for k, v in shape.items())))
        with _shapes_lock:
            _SHAPES[key] = _SHAPES.get(key, 0) + 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def launch_shapes() -> list[tuple[str, dict[str, int], int]]:
    """[(kernel, shape, launches)] of the launches counted while a torch
    profiler ran, since the last `reset_launch_shapes()`."""
    with _shapes_lock:
        return [(name, dict(shape), n)
                for (name, shape), n in _SHAPES.items()]


def reset_launch_shapes() -> None:
    with _shapes_lock:
        _SHAPES.clear()


def distinct_bytes(tensors) -> int:
    """Bytes of the union of contiguous tensors' memory: columns that are
    overlapping views of one buffer count each byte once."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in tensors)
    total = end = 0
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


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


def resolve_device(device: str | torch.device) -> torch.device:
    """The device of a counter, store or table: "cuda" raises where no GPU
    is present, and the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to count on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
