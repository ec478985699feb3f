"""glue.ms_per_job: milliseconds a job of device operations that are
neither the port's own kernels (`portbench/kernels.txt`) nor copies or
sets: the torch operations of window extraction, routing, the dedupe sort
and the table's glue."""

from portbench.trace import is_copy, is_port_kernel


def read(rec: dict):
    s = sum(v for name, v in rec["device_ops"].items()
            if not is_copy(name) and not is_port_kernel(name))
    return 1e3 * s / rec["jobs"] if s and rec["jobs"] else None
