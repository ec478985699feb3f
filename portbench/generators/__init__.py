"""Traffic generators, one module each, named by a mix (traffic.py)."""
