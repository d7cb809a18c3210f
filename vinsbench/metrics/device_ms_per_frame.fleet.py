"""device_ms_per_frame: summed kernel milliseconds per frame in the
profiled frames.  Traced runs only."""


def read(rec):
    t = rec.get("trace")
    return 1e3 * t["kernel_s"] / t["frames"] if t and t["frames"] else None
