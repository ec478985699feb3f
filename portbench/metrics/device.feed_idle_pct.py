"""device.feed_idle_pct: the share of the traced window in which the card
idled while the launching thread waited for the feed (the idle gaps that
`tsx.feed_wait` names)."""


def read(rec: dict):
    s = rec.get("idle_gaps", {}).get("tsx.feed_wait")
    if not s or not rec.get("busy_s"):  # no card: no idle card either
        return None
    return 100.0 * s / rec["window_s"]
