"""The control of the comparison that decides `correct`, at a cell's own
size: the plain reference put in the program's place with one guarantee
broken (`reference.control_count`: the windows across each seam between
two batches of the configuration's `batch_words` x 16 bases left out).
Each number of the comparison has to read above its limit for one seed or
more, or the comparison could not see a dropped window.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed: the numbers that the control gives.  It runs
on the host alone; the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from portbench import reference, run, traffic


def control_numbers(cfg: dict, mix: dict, seed: int) -> dict[str, int]:
    """The comparison's numbers for the control on the mix's file."""
    c = cfg["counter"]
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        path = os.path.join(tmp, "reads.fastq")
        traffic.write_fastq(mix, seed, path)
        canonical = bool(c.get("canonical"))
        want = reference.reference_count(path, c["k"], canonical)
        got = reference.control_count(path, c["k"], 16 * c["batch_words"],
                                      canonical)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return reference.compare(want, got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = run.find_cell(run.load_json(run.ROOT / "BENCHMARK.json"),
                         args.workload)
    cfg, mix = run.load_config(cell["config"]), run.load_traffic(
        cell["traffic"])
    for seed in args.seeds:
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control": control_numbers(cfg, mix, seed)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
