"""Reduction of a torch.profiler trace of the measured window to the
records that the per-layer metrics (`metrics/<name>.py`) read, and to the
result line's `breakdown`.

Events are read from the profiler's kineto results, one object an event,
without building its tree of function events (which takes seconds for a
window of jobs).  The device's busy time is the union of the intervals of
its kernels, copies and sets, the arithmetic of the port's
`utils/profiling.py` `device_busy_us`, frozen here.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict
from pathlib import Path

WINDOW_SPAN = "portbench.window"
JOB_SPAN = "portbench.job"
_SPANS = (WINDOW_SPAN, JOB_SPAN)
_NO_OP = "no torch op (host parse, pack or Python)"
_TOP = 10
_KERNELS = [line.strip() for line in
            (Path(__file__).resolve().parent / "kernels.txt")
            .read_text().splitlines()
            if line.strip() and not line.startswith("#")]
_PORT_KERNEL = re.compile(r"\b(%s)\b" % "|".join(map(re.escape, _KERNELS)))


def is_port_kernel(name: str) -> bool:
    """Whether a device operation is one of the port's own kernels
    (`kernels.txt`)."""
    return _PORT_KERNEL.search(name) is not None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _merged(spans) -> list[tuple[int, int]]:
    """The disjoint intervals that (start, end) intervals cover."""
    out: list[list[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_union_ns(spans) -> int:
    """The length of the union of (start, end) intervals, as
    `device_busy_us` takes it over a trace's device intervals."""
    return sum(e - s for s, e in _merged(spans))


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def reduce_trace(events, device_type) -> dict:
    """Records of one traced window: `window_s`, `busy_s`, `device_ops`
    ({name: seconds} over every device operation), `idle_gaps` ({what
    the host was doing: seconds} over the gaps between device operations)
    and `host_ops` ({name: seconds} of host operations), all inside the
    window.  `events`: the kineto events; `device_type`:
    torch.autograd.DeviceType.CUDA."""
    window = None
    dev, host = [], []
    for e in events:  # millions of events: few calls into each
        name, s = e.name(), e.start_ns()
        on_device = e.device_type() == device_type
        if name in _SPANS:
            # the benchmark's own spans, and their copies on the card
            if name == WINDOW_SPAN and not on_device:
                window = (s, s + e.duration_ns())
            continue
        (dev if on_device else host).append((s, s + e.duration_ns(), name))
    if window is None:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    ops: dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        ops[_short(n)] += (e - s) / 1e9
    busy = _merged((s, e) for s, e, _ in dev)
    edges = [w0] + [t for span in busy for t in span] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host_ops: dict[str, float] = defaultdict(float)
    for s, e, n in host:
        if e > w0 and s < w1:
            host_ops[_short(n)] += (min(e, w1) - max(s, w0)) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_ops": dict(ops),
        "idle_gaps": _name_gaps(gaps, host),
        "host_ops": dict(host_ops),
    }


def _name_gaps(gaps, host) -> dict[str, float]:
    """The gaps' seconds by what the host was doing: the part of a gap
    that host operations cover goes to the one that overlaps it most (the
    innermost of those that overlap it alike; the trace does not tell the
    host's threads apart reliably, so they are taken together), the rest
    to the host's own work outside torch (the parse and pack in C++,
    Python)."""
    host = sorted(host)
    out: dict[str, float] = defaultdict(float)
    active: list[tuple[int, int]] = []  # (end, index) of started events
    i = 0
    for g0, g1 in gaps:
        while i < len(host) and host[i][0] < g1:
            heapq.heappush(active, (host[i][1], i))
            i += 1
        while active and active[0][0] <= g0:
            heapq.heappop(active)
        best, label, spans = None, None, []
        for end, j in active:
            s = max(host[j][0], g0)
            e = min(end, g1)
            spans.append((s, e))
            key = (e - s, s)
            if best is None or key > best:
                best, label = key, host[j][2]
        covered = busy_union_ns(spans)
        if covered:
            out[_short(label)] += covered / 1e9
        if g1 - g0 > covered:
            out[_NO_OP] += (g1 - g0 - covered) / 1e9
    return dict(out)


def top(d: dict[str, float]) -> list[list]:
    """The largest entries of {name: seconds}, as [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:_TOP]]
