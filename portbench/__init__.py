"""portbench: the benchmark of tsxcount_tpu_torch (see run.py)."""
