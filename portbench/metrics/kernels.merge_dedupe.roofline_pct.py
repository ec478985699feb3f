"""kernels.merge_dedupe.roofline_pct: kernel 3's share of its roofline over
the traced window: the bytes of every `merge_dedupe_sorted` launch (both
runs' rows read once; the output, whose length lives on the card, left
out, `portbench/roofline.py`) at the card's peak bandwidth, over the device
time of the kernels its entry point launches.  The partition kernel's name
is kernel 2's too, whose time is then counted here as well: the share is a
floor."""

from portbench.roofline import merge_dedupe_bytes, share_pct

KERNELS = ("merge_partition_kernel", "merge_dedupe_kernel",
           "fix_reduce_kernel", "fix_apply_kernel")


def read(rec: dict):
    return share_pct(rec, "merge_dedupe_sorted", merge_dedupe_bytes, KERNELS)
