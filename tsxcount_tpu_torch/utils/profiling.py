"""Spans of the port's ingest path, and reading torch.profiler traces.

`span(name)` marks one leaf step of the work: a pull from the producer
queue, a parse call, a copy to the card, a batch's device step, a fold, a
host read of a device value.  It costs one attribute read while no torch
profiler runs.  While one runs, a span is a `tsx.<name>` host operation in
the trace (a plain RecordFunction, not a user annotation, so the card's
timeline gets no copy of it) and adds its count, total time and self time
(its time less that of the spans nested in it on the same thread) to a
process-wide table, `span_totals()`.  The table is what carries spans of
threads that the profiler does not record (by default it records only the
thread that started it).  Its times are `time.time_ns()` stamps, the Unix
epoch nanoseconds that kineto stamps host events with.  One span nests in
another leaf: the lane mix (`mix`) inside a batch's step.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_totals: dict[str, list[int]] = {}  # name: [count, total ns, self ns]
_local = threading.local()  # .stack: the open spans' child ns, innermost last


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._rf = torch._C._profiler._RecordFunctionFast("tsx." + name)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(0)
        self._rf.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        dt = time.time_ns() - self._t0
        self._rf.__exit__(*exc)
        stack = _local.stack
        own = dt - stack.pop()
        if stack:
            stack[-1] += dt
        with _lock:
            t = _totals.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += dt
            t[2] += own
        return False


def span(name: str):
    """A context manager over one step of the work (see the module
    docstring); the shared null context while no torch profiler runs.
    The check is the process-wide flag, which reads alike on every
    thread (torch's own `_profiler_enabled()` is per thread)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def span_totals() -> dict[str, tuple[int, float, float]]:
    """{name: (count, total s, self s)} of the spans closed since the
    last `reset_spans()`, over every thread."""
    with _lock:
        return {n: (c, t / 1e9, s / 1e9) for n, (c, t, s) in _totals.items()}


def reset_spans() -> None:
    with _lock:
        _totals.clear()


def device_busy_us(prof) -> float:
    """The union of the CUDA kernel, copy and set intervals of a finished
    torch.profiler trace (us): the card's busy time, whatever the host did
    meanwhile.  Read from the kineto events (building `prof.events()`
    takes seconds on a long trace); an annotation's copy on the card is
    no work."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation())
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3
