"""fold.ms_per_job: milliseconds a job of the launching thread folding
runs into the store or the table (`tsx.fold`: the sharded `_flush_merges`
and `_recover_spill`, the plain `_flush_pending` and table insert), net of
the host syncs nested in it."""

from portbench.spans import SELF, per_job


def read(rec: dict):
    s = per_job(rec, "fold", SELF)
    return None if s is None else 1e3 * s
