"""device_idle_pct: 100 · (1 − the union of each card's kernels, copies and
sets ÷ the profiled window), both from one timeline, the mean over the
cards.  Traced runs only."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
