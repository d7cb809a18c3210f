"""readback_ms.robot: milliseconds from ``spin_once``'s return to the
frame's pose (P, Q) on the host, the mean over the window's poses: the
device's work that the host's shell leaves exposed.  Moves
``frame_ms_p95``."""


def read(rec):
    s = rec["spans"].get("readback")
    return 1e3 * sum(s) / len(s) if s else None
