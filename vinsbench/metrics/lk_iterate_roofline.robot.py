"""lk_iterate_roofline: the share of its roofline that kernel lk_iterate reaches in
the profiled frames: the least time the card could take for the work
these frames' own inputs need (``vinsbench/bounds.py``), over the
kernel's measured time on each card's frame stream, in %.  Traced runs only;
nothing where the kernel did not run."""

from vinsbench import trace


def read(rec):
    t, b = rec.get("trace"), rec.get("bounds_ms", {})
    if not t or "lk_iterate" not in b:
        return None
    measured = trace.kernel_seconds(t, "lk_iterate_kernel", rec.get("frame_streams"))
    return 100.0 * 1e-3 * b["lk_iterate"] / measured if measured > 0 else None
