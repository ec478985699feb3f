"""The bytes of the quotient table's round kernels (`csrc/apply.cu`), for
their roofline shares: kernel 5 (`gather_sorted`, a round's probe of every
active row's slot) and kernel 4 (`apply_sorted_unique`, a round's update
of every resolved row's slot), from the shape that each launch records in
`tsxcount_tpu_torch/_build.py` `launch_shapes()`: `elements`, the round's
rows, and `cols`, the slot columns of the one launch.

As in `portbench/roofline.py`, each input byte is counted read once and
each output byte written once.  Both kernels stream an int32 destination
a row and one int32 column a slot column: kernel 5 writes its probe out,
kernel 4 reads its values in.  The slot words themselves are read, and
by kernel 4 written, only at live destinations, whose number lives on the
card: they are left out, so each share is a floor of the kernel's true
share.  The peak and `share_pct` are `portbench/roofline.py`'s.
"""

from __future__ import annotations

from portbench.roofline import INT32


def round_bytes(elements: int, cols: int) -> int:
    """Kernel 5 or 4: the destinations read, and each column's probe
    written (5) or values read (4)."""
    return elements * (1 + cols) * INT32
