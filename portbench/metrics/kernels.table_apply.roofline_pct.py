"""kernels.table_apply.roofline_pct: kernel 4's share of its roofline over
the traced window: the bytes of every `apply_sorted_unique` launch
(destinations and value columns read; the slot words read and written at
live rows left out, `portbench/table_roofline.py`: a floor) at the card's
peak bandwidth, over the device time of `apply_sorted_unique_kernel`."""

from portbench.roofline import share_pct
from portbench.table_roofline import round_bytes


def read(rec: dict):
    return share_pct(rec, "apply_sorted_unique", round_bytes,
                     ("apply_sorted_unique_kernel",))
