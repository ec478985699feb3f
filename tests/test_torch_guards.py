"""Guards of the port: no JAX anywhere in it, an explicit device with no
silent CPU fallback, loud refusals for what it does not cover yet, and the
kernel build's command line.  Pure checks, no tolerances involved."""

import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu_torch import KmerCounter, _build  # noqa: E402
from tsxcount_tpu_torch.io import native  # noqa: E402
from tsxcount_tpu_torch.ops.compact import compact_flagged  # noqa: E402
from tsxcount_tpu_torch.ops.merge import merge_sorted  # noqa: E402
from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "tsxcount_tpu_torch"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", [*sorted(PORT.rglob("*.py")),
                                  REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tsxcount_tpu"), (path, mod)


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        KmerCounter(k=14)
    with pytest.raises(RuntimeError):
        KmerCounter(k=14, device="cuda:0")


@pytest.mark.parametrize("kw", [
    dict(backend="table"), dict(backend="CAS"), dict(backend="TSX"),
    dict(backend="EXPERIMENTAL"), dict(canonical=True), dict(lsm=True),
    dict(hash_first=True), dict(hash_first="mix"), dict(hash_first="gf2"),
    dict(mix_prefix=True), dict(collapse_homopolymers=True), dict(k=113),
    dict(k=127),
], ids=str)
def test_out_of_slice_options_raise(kw):
    args = dict(k=14, device="cpu") | kw
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KmerCounter(**args)


def test_in_slice_options_accepted():
    for kw in (dict(lsm=None), dict(lsm=False), dict(hash_first=False),
               dict(mix_prefix=False), dict(backend="SERIAL"), dict(k=112)):
        c = KmerCounter(**(dict(k=14, l=8, device="cpu") | kw))
        assert c.backend == "sort" and c.lsm is False


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions: anything else launches a
    kernel or raises, never falls back."""
    meta = lambda dt: torch.empty(8, dtype=dt, device="meta")
    with pytest.raises(ValueError):
        compact_flagged(meta(torch.int32), (meta(torch.int32),))
    with pytest.raises(ValueError):
        merge_sorted((meta(torch.int32),), (meta(torch.int32),))
    with pytest.raises(ValueError):
        merge_dedupe_sorted((meta(torch.int32), meta(torch.int64)),
                            (meta(torch.int32), meta(torch.int64)), 1, 1)


def test_wrappers_check_dtype_shape_contiguity():
    i32 = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        compact_flagged(i32, (torch.zeros(16, dtype=torch.float32),))
    with pytest.raises(ValueError):
        compact_flagged(i32, (torch.zeros(15, dtype=torch.int32),))
    with pytest.raises(ValueError):
        compact_flagged(i32, (torch.zeros(32, dtype=torch.int32)[::2],))
    with pytest.raises(TypeError):  # key columns must be int32 words
        merge_sorted((i32.long(),), (i32.long(),))
    with pytest.raises(TypeError):  # the count column must be int64
        merge_dedupe_sorted((i32, i32), (i32, i32), 1, 1)


def test_cpu_path_launches_no_kernel():
    _build.reset_launch_counts()
    c = KmerCounter(k=14, l=10, batch_words=32, device="cpu")
    c.add_reads(["ACGTACGTACGTACGTTTGACA"] * 5)
    c.finish()
    assert c.distinct == 9
    assert set(_build.launch_counts().values()) == {0}


def _gitignored(path: pathlib.Path) -> bool:
    rel = path.relative_to(REPO).as_posix()
    lines = (REPO / ".gitignore").read_text().splitlines()
    return any(rel.startswith(ln.strip().rstrip("/") + "/")
               for ln in lines if ln.strip() and not ln.startswith("#"))


def test_nvcc_command_targets_sm90a_in_ignored_build_dir():
    out = _build.library_path()
    cmd = _build.nvcc_command(out)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-std=c++17", "-O3", "-shared"):
        assert flag in cmd
    assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert out.parent == _build.BUILD_DIR and _gitignored(out)
    srcs = {pathlib.Path(a).name for a in cmd if a.endswith(".cu")}
    assert srcs == {"compact.cu", "merge.cu", "merge_dedupe.cu"}


def test_native_parser_built_from_source_into_ignored_dir():
    assert native.SOURCE == REPO / "tsxcount_tpu" / "_native" / "fastxpack.cpp"
    out = native.library_path()
    assert out.parent == native.BUILD_DIR and _gitignored(out)
    cmd = native.compile_command(out)
    assert "libfastxpack.so" not in " ".join(cmd)
    assert "-march=native" not in cmd  # the build dir may reach other hosts
