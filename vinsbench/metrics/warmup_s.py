"""warmup_s: the seconds of warm-up and capture in set-up (the runner's
``warm`` and first ``run``, or the pipeline's initialization frames and
first steady frame), from the benchmark's span around them.  Moves
``setup_s``."""


def read(rec):
    s = rec["spans"].get("warmup")
    return sum(s) if s else None
