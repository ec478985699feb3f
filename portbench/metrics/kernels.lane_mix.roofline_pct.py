"""kernels.lane_mix.roofline_pct: the lane-mix kernel's share of its
roofline over the traced window: the bytes of every `lane_mix` launch
(its input columns' distinct bytes read, positions x lanes x 4 B written,
`portbench/roofline.py`) at the card's peak bandwidth, over the device
time of `lane_mix_kernel`."""

from portbench.roofline import lane_mix_bytes, share_pct


def read(rec: dict):
    return share_pct(rec, "lane_mix", lane_mix_bytes, ("lane_mix_kernel",))
