"""h2d.ms_per_job: milliseconds a job of host-to-device copies on the card
(the trace's Memcpy HtoD operations: `ShardedKmerCounter._put`)."""


def read(rec: dict):
    s = sum(v for name, v in rec["device_ops"].items()
            if name.startswith("Memcpy HtoD"))
    return 1e3 * s / rec["jobs"] if s and rec["jobs"] else None
