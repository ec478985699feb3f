"""mix.ms_per_job: milliseconds a job of the launching thread in the lane
mix (`tsx.mix`, `ops/mix.py` `lane_mix`: the routing step's forward mix of
a batch's keys, nested in `tsx.step`).  The tree opens it wherever the
lane mix runs: the sort backend from 8 lanes, the table at every k."""

from portbench.spans import TOTAL, per_job


def read(rec: dict):
    s = per_job(rec, "mix", TOTAL)
    return None if s is None else 1e3 * s
