"""kernels.table_gather.roofline_pct: kernel 5's share of its roofline over
the traced window: the bytes of every `gather_sorted` launch (destinations
read, the probe's columns written; the slot words read at live rows left
out, `portbench/table_roofline.py`: a floor) at the card's peak bandwidth,
over the device time of `gather_sorted_kernel`."""

from portbench.roofline import share_pct
from portbench.table_roofline import round_bytes


def read(rec: dict):
    return share_pct(rec, "gather_sorted", round_bytes,
                     ("gather_sorted_kernel",))
