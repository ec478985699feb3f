"""parse.span_s_per_job: seconds a job of the C++ parse and pack inside
the window (`tsx.parse`, each `fxp_next_batch` call of `io/native.py`),
summed over the parse threads."""

from portbench.spans import TOTAL, per_job


def read(rec: dict):
    return per_job(rec, "parse", TOTAL)
