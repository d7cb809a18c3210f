"""kernels_per_frame: device kernels per frame in the profiled frames
(every kernel of the window on every stream).  Traced runs only."""


def read(rec):
    t = rec.get("trace")
    return t["n_kernels"] / t["frames"] if t and t["frames"] else None
