"""parse.s_per_job: seconds of one pass of the port's native reader
(`io/native.py` NativeFileReader) over the cell's file, with the counter's
batch geometry and no device work: what the host parse and pack alone
cost a job.  Timed by the benchmark after the traced window."""


def read(rec: dict):
    return rec.get("parse_s") or None
