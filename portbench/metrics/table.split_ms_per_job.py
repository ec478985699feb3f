"""table.split_ms_per_job: milliseconds a job of the launching thread in
the quotient table's split rounds (`tsx.table_split`: each `split_round`
of `QuotientTable.insert_histogram`, round 0 with its keys' hash; nested
in `tsx.fold`, so `fold.ms_per_job`, a self time, leaves it out).  The
host reads between rounds stay in `tsx.sync`.  Nothing to read on the
sort backend, or in a tree without the span."""

from portbench.spans import TOTAL, per_job


def read(rec: dict):
    s = per_job(rec, "table_split", TOTAL)
    return None if s is None else 1e3 * s
