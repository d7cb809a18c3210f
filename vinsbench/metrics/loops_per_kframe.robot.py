"""loops_per_kframe.robot: loops the pose graph closed in the window per
1,000 frames handed in, from the graph's own list of loops.  Only where
the cell runs the pose graph.  Moves ``frame_ms_p95``."""


def read(rec):
    if rec.get("loops") is None or not rec.get("frames"):
        return None
    return 1e3 * rec["loops"] / rec["frames"]
