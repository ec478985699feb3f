"""The roofline shares of the port's kernels: the bytes a launch moves, from
the shape the program recorded for it, over the card's peak bandwidth and
the kernel's device time in the traced window.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again.  The peak is NVIDIA's data sheet for the
H100 SXM (80 GB of HBM3 at 3.35 TB/s), which assumes the card's full power
limit of 700 W: a card set below it reads lower, so a share is reported
beside the card's name and power limit.

The shapes come from `tsxcount_tpu_torch/_build.py` `launch_shapes()`:
each kernel wrapper's launches by shape, recorded only while a torch
profiler runs, so in a run of the benchmark exactly the traced window's.
A tree of the program without that table gives nothing to read.
"""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
INT32, INT64 = 4, 8


def lane_mix_bytes(positions: int, lanes: int, input_bytes: int) -> int:
    """The lane mix (`csrc/lane_mix.cu`): its input columns' distinct bytes
    read once (the routing step's lanes are views of one stream of
    windows, 16 positions apart, so they share nearly every byte) and
    every lane of every position's image written once."""
    return input_bytes + positions * lanes * INT32


def merge_dedupe_bytes(m: int, n: int, n_keys: int) -> int:
    """Kernel 3 (`csrc/merge_dedupe.cu`): both runs' rows of `n_keys`
    int32 key words and one int64 count read once.  The output's length,
    the distinct keys, lives only on the card, so its bytes are left out:
    the share is a floor of the kernel's true share."""
    return (m + n) * (n_keys * INT32 + INT64)


def launch_shapes():
    """The program's launch-shape table, or None where the program has
    none."""
    try:
        from tsxcount_tpu_torch._build import launch_shapes as table
    except ImportError:
        return None
    return table()


def share_pct(rec: dict, kernel: str, bytes_of, device_kernels) -> float | None:
    """100 x the bytes of the window's launches of wrapper `kernel`
    (`bytes_of(**shape)` each) / HBM_BYTES_PER_S / the device seconds of
    the trace's operations named by any of `device_kernels` (whole words).
    None where the window ran no such launch or no such kernel, or ran
    nothing on a card."""
    if not rec.get("busy_s") or not rec.get("device_ops"):
        return None
    shapes = launch_shapes()
    if not shapes:
        return None
    moved = sum(count * bytes_of(**shape)
                for name, shape, count in shapes if name == kernel)
    names = re.compile(r"\b(%s)\b" % "|".join(map(re.escape, device_kernels)))
    seconds = sum(s for op, s in rec["device_ops"].items()
                  if names.search(op))
    if not moved or not seconds:
        return None
    return 100.0 * moved / HBM_BYTES_PER_S / seconds
