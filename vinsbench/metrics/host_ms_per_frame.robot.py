"""host_ms_per_frame.robot: milliseconds from handing a frame in to
``VinsPipeline.spin_once``'s return, the mean over the window's poses, from
the benchmark's spans.  Moves ``frame_ms_p95``."""


def read(rec):
    s = rec["spans"].get("host")
    return 1e3 * sum(s) / len(s) if s else None
