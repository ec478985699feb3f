"""kernels.ms_per_job: milliseconds a job of the port's own CUDA kernels
(`tsxcount_tpu_torch/csrc/*.cu`, named in `portbench/kernels.txt`) on the
card."""

from portbench.trace import is_port_kernel


def read(rec: dict):
    s = sum(v for name, v in rec["device_ops"].items() if is_port_kernel(name))
    return 1e3 * s / rec["jobs"] if s and rec["jobs"] else None
