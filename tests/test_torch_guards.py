"""Guards of the port: no JAX anywhere in it, an explicit device with no
silent CPU fallback (counter and command line), the options it once
refused now counting, and the kernel build's command line.  Pure checks,
no tolerances involved."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu_torch import (  # noqa: E402
    CountStore,
    GF2Hash,
    KmerCounter,
    KmerSpec,
    QuotientTable,
    _build,
)
from tsxcount_tpu_torch.io import native  # noqa: E402
from tsxcount_tpu_torch.ops.apply import (  # noqa: E402
    MAX_APPLY_COLS,
    apply_sorted_unique,
    gather_sorted,
)
from tsxcount_tpu_torch.ops.compact import compact_flagged  # noqa: E402
from tsxcount_tpu_torch.ops.merge import merge_sorted  # noqa: E402
from tsxcount_tpu_torch.ops.merge_dedupe import merge_dedupe_sorted  # noqa: E402

from tests.test_packer import naive_kmers, rand_reads  # noqa: E402

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


def test_no_jax_walk_covers_the_sharded_modules():
    """The walk above reaches parallel/ (the sharded counter), whose
    modules exist."""
    walked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"parallel/mesh.py", "parallel/sharded.py",
            "parallel/distributed.py"} <= walked


def test_sharded_counter_and_group_need_the_card_or_an_explicit_cpu(
        tmp_path, capsys):
    """ShardedKmerCounter and init_shard_group default to the rank's own
    card and NCCL: without a GPU they raise, and the CPU (with gloo) is
    used only when asked for; the command line stops with an ERROR line
    at any --shards unless --platform cpu is given."""
    from tsxcount_tpu_torch.cli import main
    from tsxcount_tpu_torch.parallel.mesh import init_shard_group
    from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card is the valid default here")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedKmerCounter(k=14, n_shards=1)
    with pytest.raises(RuntimeError, match="cuda"):
        init_shard_group(1)
    with pytest.raises(RuntimeError, match="cuda"):
        init_shard_group(1, device="cuda:0", backend="gloo")
    c = ShardedKmerCounter(k=14, n_shards=1, l=8, device="cpu")
    # one shard runs alone: no process group, no collective
    assert c.device.type == "cpu" and c.group.backend is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        init_shard_group(1, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="ranks"):
        init_shard_group(2, device="cpu")
    path = tmp_path / "r.fastq"
    path.write_text("@r\nACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIII\n")
    for shards in ("1", "2"):
        assert main(["count", "--input", str(path), "--l", "8",
                     "--shards", shards]) == 2
        err = capsys.readouterr().err
        assert "ERROR:" in err and "--platform cpu" in err


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        KmerCounter(k=14)
    with pytest.raises(RuntimeError):
        KmerCounter(k=14, device="cuda:0")


@pytest.mark.parametrize("make", [
    lambda spec, **kw: CountStore(spec, 64, **kw),
    lambda spec, **kw: QuotientTable(spec, 8, GF2Hash(spec), **kw),
], ids=["CountStore", "QuotientTable"])
def test_store_and_table_default_to_the_card(make):
    """The public store and table classes default to "cuda" like the
    counter: without a GPU they raise, and take the CPU only when asked."""
    spec = KmerSpec(14)
    assert make(spec, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported"):
        make(spec, device="meta")
    if torch.cuda.is_available():
        assert make(spec).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        make(spec)


@pytest.mark.parametrize("kw", [
    dict(hash_first="gf2"), dict(mix_prefix=True),
], ids=str)
def test_out_of_slice_options_raise(kw):
    """The two options the port once refused (the "Do not port" list)
    now build on the sort backend, store their images (GF(2)) or
    extended keys (mix_prefix), and count what a naive count does."""
    reads = rand_reads(np.random.default_rng(1), 20, 10, 80)
    c = KmerCounter(**(dict(k=14, l=10, batch_words=64, device="cpu") | kw))
    assert (c.hash_first, c.mix_prefix) == (kw.get("hash_first", False),
                                            kw.get("mix_prefix", False))
    assert c.store.n_ops == (4 if c.mix_prefix else 1)
    c.add_reads(reads)
    c.finish()
    assert c.to_dict() == dict(naive_kmers(reads, 14))


@pytest.mark.parametrize("kw,n_ops", [
    (dict(hash_first=True), 1), (dict(hash_first="mix"), 1),
    (dict(k=113), 8), (dict(k=127), 8),
], ids=str)
def test_wide_keys_and_lane_mix_accepted(kw, n_ops):
    """hash_first=True/"mix" at any k, and k >= 113 (the lane mix
    engaged by itself) on the sort backend; other hash_first values
    raise."""
    c = KmerCounter(**(dict(k=14, l=8, device="cpu") | kw))
    assert c.backend == "sort" and c.hash_first == "mix"
    assert c.key_map is not None and c.store.n_ops == n_ops
    with pytest.raises(ValueError):
        KmerCounter(k=14, l=8, hash_first="other", device="cpu")


@pytest.mark.parametrize("kw", [
    dict(backend="table"), dict(backend="CAS"), dict(backend="TSX"),
    dict(backend="EXPERIMENTAL"), dict(backend="table", k=127),
], ids=str)
def test_table_backend_accepted(kw):
    c = KmerCounter(**(dict(k=14, l=8, device="cpu") | kw))
    assert c.backend == "table" and c.merge_every == 1
    assert c.table.slot_cols == c.spec.lanes + 4


def test_in_slice_options_accepted():
    for kw in (dict(lsm=None), dict(lsm=False), dict(hash_first=False),
               dict(mix_prefix=False), dict(backend="SERIAL"), dict(k=112),
               dict(k=256, hash_first=False)):
        c = KmerCounter(**(dict(k=14, l=8, device="cpu") | kw))
        assert c.backend == "sort" and c.lsm is False


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_reference_keywords_accepted_at_defaults(backend):
    """lsm_growth and progress_every, keywords of the JAX package's
    counter, are taken by name and in the JAX package's positions (after
    lsm, and after collapse_homopolymers)."""
    for progress_every in (0, -1):  # the JAX package takes <= 0 as off
        c = KmerCounter(k=14, l=8, backend=backend, lsm_growth=8,
                        progress_every=progress_every, device="cpu")
        assert c.backend == backend and c.lsm is False
    args = (14, 8, 4, backend, 1 << 16, "drop", 7, False, 64, 0, 4, False,
            None, 8, 0, 3, 0, False)
    pos = KmerCounter(*args, 0, device="cpu")
    assert pos.threads == 1 and pos.prefetch_depth == 3
    assert pos.progress_every == 0 and pos.lsm_growth == 8
    assert KmerCounter(*args, 1, device="cpu").progress_every == 1


def test_cli_refuses_to_fall_back_to_the_cpu(tmp_path, capsys):
    """Without a GPU the command line stops with an ERROR line unless
    --platform cpu is given; it never counts on the CPU by itself."""
    from tsxcount_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default platform is valid here")
    path = tmp_path / "r.fastq"
    path.write_text("@r\nACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIII\n")
    for platform in ([], ["--platform", "cuda"], ["--platform", "gpu"]):
        assert main(["count", "--input", str(path), "--l", "8",
                     *platform]) != 0
        err = capsys.readouterr().err
        assert "ERROR:" in err and "--platform cpu" in err
    assert main(["count", "--input", str(path), "--l", "8",
                 "--platform", "cpu"]) == 0


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
    with pytest.raises(ValueError):
        gather_sorted(meta(torch.int32), meta(torch.int32))
    with pytest.raises(ValueError):
        apply_sorted_unique(meta(torch.int32), meta(torch.int32),
                            meta(torch.int32))


def test_wrappers_check_dtype_shape_contiguity():
    i32 = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        compact_flagged(i32, (torch.zeros(16, dtype=torch.float32),))
    with pytest.raises(ValueError):
        compact_flagged(i32, (torch.zeros(15, dtype=torch.int32),))
    with pytest.raises(ValueError):
        compact_flagged(i32, (torch.zeros(32, dtype=torch.int32)[::2],))
    for flag_dtype in (torch.float32, torch.int64):  # int32 or bool flags
        with pytest.raises(TypeError):
            compact_flagged(i32.to(flag_dtype), (i32,))
    with pytest.raises(TypeError):  # key columns must be int32 words
        merge_sorted((i32.long(),), (i32.long(),))
    with pytest.raises(TypeError):  # the count column must be int64
        merge_dedupe_sorted((i32, i32), (i32, i32), 1, 1)
    with pytest.raises(TypeError):  # slot words are int32 bit patterns
        gather_sorted(i32.long(), i32)
    # 1..MAX_APPLY_COLS of one length
    for cols in ([], [i32] * (MAX_APPLY_COLS + 1), [i32, i32[:8]]):
        with pytest.raises(ValueError):
            gather_sorted(cols, i32)
    with pytest.raises(ValueError):  # one value per destination
        apply_sorted_unique(i32, i32, i32[:8])
    with pytest.raises(ValueError):
        apply_sorted_unique(i32, i32[::2], i32[:8])


def test_cpu_path_launches_no_kernel():
    _build.reset_launch_counts()
    c = KmerCounter(k=14, l=10, batch_words=32, device="cpu")
    c.add_reads(["ACGTACGTACGTACGTTTGACA"] * 5)
    c.finish()
    assert c.distinct == 9
    t = KmerCounter(k=14, l=10, backend="table", batch_words=32, device="cpu")
    t.add_reads(["ACGTACGTACGTACGTTTGACA"] * 5)
    t.finish()
    assert t.to_dict() == c.to_dict()
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
    assert srcs == {"apply.cu", "compact.cu", "lane_mix.cu", "merge.cu",
                    "merge_dedupe.cu", "table_residue.cu"}


def test_native_parser_built_from_source_into_ignored_dir():
    # the port's own parser source (the JAX package's is the tests'
    # reference for it, never built by the port)
    assert native.SOURCE == (REPO / "tsxcount_tpu_torch" / "csrc"
                             / "fastxpack.cpp")
    assert native.SOURCE.is_file()
    out = native.library_path()
    assert out.parent == native.BUILD_DIR and _gitignored(out)
    cmd = native.compile_command(out)
    assert "libfastxpack.so" not in " ".join(cmd)
    assert "-march=native" not in cmd  # the build dir may reach other hosts


def test_merge_stamps_patch_current_kernel_source():
    """tools/merge_stamps.py patches a copy of csrc/merge.cu by anchored
    edits: every anchor is still there once, and each stamp lands in the
    tile kernel (the package's own source stays as it is)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "merge_stamps", REPO / "tools" / "merge_stamps.py")
    stamps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stamps)
    src = (PORT / "csrc" / "merge.cu").read_text()
    out = stamps.stamped_source(src)
    assert "g_stamps" not in src
    kernel = out[out.index("merge_tile_kernel(ColSet a"):
                 out.index("int64_t merge_scratch_elems")]
    for stamp in ("c0 = clock64()", "c1 = clock64()", "c2 = clock64()",
                  "g[3] = clock64()"):
        assert kernel.count(stamp) == 1, stamp
    assert out.count('extern "C" int tsx_merge_stamps') == 1
