#!/usr/bin/env python3
"""Reproducibility probe of the batched loop cell on one GPU.

    python3 batched_loop_repro.py [MODE ...]

Runs ``chip_smoke.run_batched_loop_path`` (phase 10's cell: B = 8 at
640×480, four revisit sequences, ten timed segments of 18 frames) once per
MODE, in one process and in the order given (default: none none inline
inline threaded threaded), and compares the runs' VIO costs (frames × B)
bit for bit, every run against every other.  Modes: "none" runs the
batched runner with no closer, "inline" the closer's serial ``consume`` on
the frame thread, "pipelined" its five-stage pipeline on the frame thread,
"threaded" the ``ThreadedLoopCloser``.  ``chip_smoke.py``'s phase 23 runs
the inline, pipelined and threaded modes from one staging on every run
of the script and holds their closers to each other.  A suffix turns on
``torch.use_deterministic_algorithms(True, warn_only=True)`` and lists the
operations that warned: "+det" for the whole run (uninitialized memory
filled with NaN), "+det-nofill" the same without the fill, "+det-<scope>"
only inside the functions of ``SCOPES[scope]`` (the tracker, the backend's
steps, or one part of them).  Two runs of one mode
that differ show that the path is not reproducible by itself; "none" pairs
that agree while "threaded" pairs differ would point at the worker's
stream.  Prints one line per run and per comparison; writes
``chiprun_out/batched_loop_repro.json``.  Without CUDA it exits non-zero.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

import chip_smoke
from vins_rgbd_fast_torch.backend import estimator as est
from vins_rgbd_fast_torch.backend import feature_table as ftab
from vins_rgbd_fast_torch.frontend import feature_tracker as ft
from vins_rgbd_fast_torch.ops import imu_preintegration as imupre
from vins_rgbd_fast_torch.ops import marginalization as marg
from vins_rgbd_fast_torch.ops import solver as slv

DEFAULT_MODES = ("none", "none", "inline", "inline", "threaded", "threaded")
# the functions "+det-<scope>" runs under deterministic algorithms (looked up
# through these modules by the runner at each call)
SCOPES = {"tracker": ((ft, "track_frame"),),
          "backend": ((est, "fill_step"), (est, "init_full"), (est, "vio_step")),
          "solve": ((slv, "solve"),),
          "marg": ((marg, "marginalize_old"), (marg, "marginalize_new")),
          "ingest": ((ftab, "ingest_frame"), (ftab, "triangulate_with_depth")),
          "preint": ((imupre, "preintegrate"), (imupre, "sqrt_information")),
          "slide": ((est, "_slide"),)}


@contextlib.contextmanager
def deterministic(scope):
    """Deterministic algorithms for the whole block ("det", "det-nofill")
    or only inside the functions of ``SCOPES[scope]``; nothing for None."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    saved = []
    try:
        if scope in ("det", "det-nofill"):
            torch.utils.deterministic.fill_uninitialized_memory = scope == "det"
            torch.use_deterministic_algorithms(True, warn_only=True)
        elif scope is not None:
            for mod, name in SCOPES[scope.split("-")[1]]:
                fn = getattr(mod, name)

                def wrapped(*args, _fn=fn, **kwargs):
                    torch.use_deterministic_algorithms(True, warn_only=True)
                    try:
                        return _fn(*args, **kwargs)
                    finally:
                        torch.use_deterministic_algorithms(False)

                saved.append((mod, name, fn))
                setattr(mod, name, wrapped)
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run(mode: str, device, **kwargs) -> dict:
    base, _, scope = mode.partition("+")
    warned: dict = {}
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with deterministic(scope or None):
            res = chip_smoke.run_batched_loop_path(device, mode=base, **kwargs)
    for w in caught:
        msg = str(w.message).splitlines()[0][:200]
        warned[msg] = warned.get(msg, 0) + 1
    res["wall_s"] = time.perf_counter() - t0
    res["warnings"] = warned
    return res


def first_difference(a: np.ndarray, b: np.ndarray):
    """(segment, frame, sequence) of the first cost that differs, in
    frame order."""
    diff = np.argwhere(~((a == b) | (np.isnan(a) & np.isnan(b))))
    return None if diff.size == 0 else [int(x) for x in diff[0]]


def main() -> int:
    if not torch.cuda.is_available():
        print("batched_loop_repro: CUDA is not available", file=sys.stderr)
        return 2
    modes = sys.argv[1:] or list(DEFAULT_MODES)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    smi = chip_smoke.nvidia_smi_line()
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    runs = []
    for i, mode in enumerate(modes):
        r = run(mode, dev)
        runs.append(r)
        print(f"[run {i} {mode}] {r['wall_s']:.1f} s; {r['ms_per_frame']:.3f} ms per lock-step "
              f"frame; costs finite {bool(np.all(np.isfinite(r['cost'])))}; loop_kf "
              f"{r['loop_kf']}, loops_found {r['loops_found']}; clean ate_m {r['ate_m']:.6f}; "
              f"warnings {r['warnings']}", flush=True)
    pairs = []
    for i, j in itertools.combinations(range(len(runs)), 2):
        a, b = runs[i]["cost"], runs[j]["cost"]
        first = first_difference(a, b)
        pairs.append(dict(runs=[i, j], modes=[modes[i], modes[j]], bit_equal=first is None,
                          first_difference=first,
                          max_abs_diff=float(np.nanmax(np.abs(a - b))) if first else 0.0,
                          loops=[runs[i]["loops_found"], runs[j]["loops_found"]]))
        print(f"[pair {i} {modes[i]} / {j} {modes[j]}] bit-equal {first is None}; first "
              f"differing (segment, frame, sequence) {first}; largest difference "
              f"{pairs[-1]['max_abs_diff']:.6g}; loops {pairs[-1]['loops']}", flush=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "batched_loop_repro.json"), "w") as f:
        json.dump(dict(card=smi, modes=modes, pairs=pairs,
                       runs=[{k: v for k, v in r.items() if k not in ("cost", "profile")}
                             for r in runs]), f, indent=1, default=float)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
