"""The benchmark of tsxcount_tpu_torch, the PyTorch and CUDA counter.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of the repository, on a machine with the cards the cell asks
for.  Everything is found by name: the cell in `BENCHMARK.json`, its
configuration in `portbench/configs/<config>.json`, its traffic mix in
`portbench/traffic/<traffic>.json` (which names its generator,
`portbench/generators/<generator>.py`), and each per-layer metric in
`portbench/metrics/<metric>.py`.

A run writes the mix's FASTQ file from the seed under `TMPDIR`, builds the
configuration's counter once, and counts the file once to warm up: that is
the set-up.  Then, for `--seconds`, it runs jobs back to back.  A job is one
exact count of the file, as the command line runs it: `reset()`, then
`count_file(path)`, then `distinct`, which folds what is pending and waits
for the card.  After the window it exports the last job's counts
(`items()`), frees the counter and compares the export, and every job's
`distinct`, with the plain reference (`portbench/reference.py`).

The last line of standard output is one JSON object: `correct`,
`attempted` and `failed` jobs, `metrics` (the end-to-end metrics; with
`--trace 1` the per-layer ones, from a torch.profiler trace of the
window), `device`, with `--trace 1` a `breakdown`, and last `check`: each
number compared beside its limit, which also end standard error.
"""

import time

T_START = time.perf_counter()  # the set-up is timed from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from portbench import reference, traffic  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "tsxcount_tpu")
GIB = float(1 << 30)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def load_traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def load_metric(name: str):
    """The reader module of a per-layer metric: `read(records)` returns
    its value, or None where the records hold nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (tsxcount_tpu_torch is not tsxcount_tpu)."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def make_counter(cfg: dict, device: str):
    from tsxcount_tpu_torch.parallel.sharded import ShardedKmerCounter

    return ShardedKmerCounter(device=device, **cfg["counter"])


def job(counter, path: str) -> int:
    """One count of the file, from a cleared counter to a store that can
    answer; returns its distinct k-mers."""
    counter.reset()
    counter.count_file(path)
    return counter.distinct


def export(counter, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The counter's public export, as the reference's key rows and
    counts."""
    flat = list(itertools.chain.from_iterable(counter.items()))
    rows = reference.encode_kmers("".join(flat[0::2]).encode("ascii"), k)
    return rows, np.array(flat[1::2], dtype=np.int64)


def parse_pass_s(counter, path: str) -> float:
    """Seconds of one pass of the port's native reader over the file with
    the counter's batch geometry, and no device work."""
    from tsxcount_tpu_torch.io.native import NativeFileReader

    t0 = time.perf_counter()
    reader = NativeFileReader(path, counter.batch, n_policy=counter.n_policy,
                              seed=counter.seed, threads=counter.threads,
                              collapse=counter.collapse_hp)
    for _ in reader:
        pass
    return time.perf_counter() - t0


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START) -> dict:
    """One run of a cell.  Returns {"jobs", "walls", "failed",
    "setup_s", "window_s", "peak_bytes", "records", "stats", "check"}."""
    import torch

    c = cfg["counter"]
    if c.get("n_policy", "drop") != "drop" or c.get("collapse_homopolymers"):
        raise ValueError("the reference counts windows with N dropped and "
                         "no homopolymer collapse")
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    k = c["k"]
    phases = {"imports": time.perf_counter() - t_start}
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        path = os.path.join(tmp, "reads.fastq")
        t = time.perf_counter()
        traffic.write_fastq(mix, seed, path)
        phases["data"] = time.perf_counter() - t
        t = time.perf_counter()
        counter = make_counter(cfg, device)
        phases["counter"] = time.perf_counter() - t
        t = time.perf_counter()
        job(counter, path)  # warm-up: builds and loads every kernel
        phases["warm_up_job"] = time.perf_counter() - t
        out = {"setup_s": time.perf_counter() - t_start,
               "setup_phases": phases}
        walls, distincts, failed = [], [], 0
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        with torch.profiler.record_function("portbench.window"):
            t0 = time.perf_counter()
            t_end = t0 + seconds
            t_last = t0
            while time.perf_counter() < t_end:
                t = time.perf_counter()
                try:
                    with torch.profiler.record_function("portbench.job"):
                        distincts.append(job(counter, path))
                except Exception:  # a failed job is counted, not fatal
                    failed += 1
                    if failed == 1:
                        traceback.print_exc()
                    continue
                t_last = time.perf_counter()
                walls.append(t_last - t)
        out["window_s"] = t_last - t0
        out["peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda
                             else 0)
        if prof is not None:
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            prof.stop()
            from portbench.trace import reduce_trace

            events = prof.profiler.kineto_results.events()
            t_stop = time.perf_counter() - t
            out["records"] = reduce_trace(events,
                                          torch.autograd.DeviceType.CUDA)
            out["records"]["reduce_s"] = [t_stop, time.perf_counter() - t,
                                          len(events)]
            del prof, events
            out["records"]["jobs"] = len(walls)
            out["records"]["parse_s"] = parse_pass_s(counter, path)
        out["stats"] = counter.stats()
        got = export(counter, k) if distincts else None
        del counter
        if cuda:
            torch.cuda.empty_cache()
        want = reference.reference_count(path, k, bool(c.get("canonical")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["jobs"], out["walls"], out["failed"] = len(walls), walls, failed
    out["windows"] = int(want[1].sum())
    check = {"jobs_failed": failed,
             "jobs_distinct_off": sum(d != want[0].size for d in distincts)}
    if got is None:
        check["no_job_completed"] = 1
    else:
        check.update(reference.compare(want, got))
    out["check"] = check
    return out


def end_to_end(out: dict) -> dict[str, float]:
    walls = out["walls"]
    if not walls:
        return {"setup_s": out["setup_s"]}
    return {
        "kmers_per_s": out["windows"] * len(walls) / out["window_s"],
        "job_s_p90": float(np.percentile(walls, 90)),
        "peak_mem_gib": out["peak_bytes"] / GIB,
        "setup_s": out["setup_s"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    cfg, mix = load_config(cell["config"]), load_traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    out = run_cell(cfg, mix, args.seed, args.seconds, bool(args.trace))

    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if args.trace:
        from portbench.trace import top

        rec = out["records"]
        print(f"portbench: host time in the window by operation (s) "
              f"{json.dumps(top(rec['host_ops']))}; trace (stop s, stop "
              f"and reduce s, events) {rec['reduce_s']}", file=sys.stderr)
    walls = out["walls"] or [0.0]
    print(f"portbench: set-up phases (s) {json.dumps(out['setup_phases'])}; "
          f"job walls (s) min {min(walls)} median {np.median(walls)} max "
          f"{max(walls)}; counter stats {json.dumps(out['stats'])}",
          file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"]}
    result = report(bench, out, bool(args.trace), device)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def report(bench: dict, out: dict, trace: bool, device: dict) -> dict:
    """The result line of a run (`run_cell`'s output) of a cell."""
    device = dict(device, memory_peak_bytes=out["peak_bytes"])
    result = {"correct": False, "attempted": out["jobs"] + out["failed"],
              "failed": out["failed"], "metrics": {}, "device": device}
    if trace:
        from portbench.trace import top

        rec = out["records"]
        device["busy_s"], device["window_s"] = rec["busy_s"], rec["window_s"]
        values = {m["name"]: load_metric(m["name"]).read(rec)
                  for m in bench["per_layer"]}
        result["breakdown"] = {"device_ops": top(rec["device_ops"]),
                               "idle_gaps": top(rec["idle_gaps"])}
        entries = bench["per_layer"]
    else:
        values = end_to_end(out)
        entries = bench["end_to_end"]
    for m in entries:
        if values.get(m["name"]) is not None:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    check = {name: {"value": v, "limit": 0}
             for name, v in out["check"].items()}
    result["correct"] = bool(out["jobs"]) and all(
        c["value"] <= c["limit"] for c in check.values())
    result["check"] = check
    return result


if __name__ == "__main__":
    sys.exit(main())
