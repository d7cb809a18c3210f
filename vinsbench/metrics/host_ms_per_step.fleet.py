"""host_ms_per_step.fleet: host milliseconds inside ``BatchedVioRunner.run``
per lock-step frame, from the benchmark's span around each call before the
synchronisation that ends its pass.  Moves ``seq_frames_per_s``."""


def read(rec):
    s = rec["spans"].get("run_call")
    if not s or not rec.get("steps"):
        return None
    return 1e3 * sum(s) / rec["steps"]
