"""Reading torch.profiler traces of the port."""

from __future__ import annotations

import torch


def device_busy_us(prof) -> float:
    """The union of the CUDA kernel and copy intervals of a finished
    torch.profiler trace (us): the card's busy time, whatever the host
    did meanwhile."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy
