"""The port's span table, as the per-layer metrics of its spans read it.

`tsxcount_tpu_torch/utils/profiling.py` `span_totals()` gives {name:
(count, total s, self s)} over every thread, the producer's included,
which the benchmark's trace does not record.  Spans record only while a
torch profiler runs, and a run traces one window in one process, so the
table holds exactly the traced window.  A tree of the program without the
table gives nothing to read.
"""

TOTAL, SELF = 1, 2


def per_job(rec: dict, name: str, field: int):
    """A span's total (TOTAL) or self (SELF) seconds over the window's
    jobs, or None where there are no jobs, no such span, or no work on a
    card (a run on the CPU: no device path whose wait the spans split)."""
    jobs = rec.get("jobs")
    if not jobs or not rec.get("busy_s"):
        return None
    try:
        from tsxcount_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    entry = span_totals().get(name)
    return entry[field] / jobs if entry else None
