"""step.ms_per_job: milliseconds a job of the launching thread in one
batch's device step (`tsx.step`: the sharded `_route`, the plain
`_dedupe`), net of the spans nested in it."""

from portbench.spans import SELF, per_job


def read(rec: dict):
    s = per_job(rec, "step", SELF)
    return None if s is None else 1e3 * s
