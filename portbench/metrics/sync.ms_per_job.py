"""sync.ms_per_job: milliseconds a job of the launching thread in explicit
host reads of device values (`tsx.sync`: the table insert's distinct and
rows-left counts, the residue rounds' checks, the sharded `_sum`)."""

from portbench.spans import TOTAL, per_job


def read(rec: dict):
    s = per_job(rec, "sync", TOTAL)
    return None if s is None else 1e3 * s
