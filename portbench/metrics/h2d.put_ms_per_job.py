"""h2d.put_ms_per_job: milliseconds a job that the producer thread spends
in the pageable host-to-device copy (`tsx.put`, the counters' `_put`):
the time it is blocked, not the copy's time on the card."""

from portbench.spans import TOTAL, per_job


def read(rec: dict):
    s = per_job(rec, "put", TOTAL)
    return None if s is None else 1e3 * s
