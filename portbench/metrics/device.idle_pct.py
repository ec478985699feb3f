"""device.idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card (100 minus the busy union over the window)."""


def read(rec: dict):
    if not rec["window_s"] or not rec["busy_s"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
