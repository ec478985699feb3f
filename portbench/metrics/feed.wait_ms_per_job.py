"""feed.wait_ms_per_job: milliseconds a job that the launching thread
waits for the producer's next batch (`tsx.feed_wait`, each pull at the
consumer's side of `io/pipeline.py` `prefetch`)."""

from portbench.spans import TOTAL, per_job


def read(rec: dict):
    s = per_job(rec, "feed_wait", TOTAL)
    return None if s is None else 1e3 * s
