"""What every cell shares: finding a cell's files by name, the set-up clock,
the host spans, the profiled frames and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, whose ``driver`` names
``drivers/<driver>.py``).  Each per-layer metric is a reader of its own,
``metrics/<metric>.py``, with a ``read(rec)`` that returns a number or None
when its cell gives it nothing to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")
UNIT_CHARS = NAME_CHARS | set("/%")
# top-level module names that may not be loaded in a run (compared whole:
# the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "vins_rgbd_fast_tpu")
FRAME_SPAN = "vinsbench::frame"


def checkout_root() -> str:
    """The directory a run starts from: it holds ``BENCHMARK.json``."""
    return os.getcwd()


def set_cache_dirs(root: str) -> Dict[str, str]:
    """Fixed build and kernel-cache directories inside the checkout, so only
    a checkout's first run builds (the port's own nvcc build directory is
    ``vins_rgbd_fast_torch/build/`` in the checkout already)."""
    base = os.path.join(root, ".vinsbench_cache")
    dirs = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
            "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}
    out = {}
    for var, sub in dirs.items():
        out[var] = os.path.join(base, sub)
        os.environ[var] = out[var]
    return out


def process_start_epoch() -> float:
    """When this process started (wall clock), from /proc; the time of this
    call where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic_file(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def driver(name: str):
    return importlib.import_module(f"vinsbench.drivers.{name}")


def reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read``, loaded by its path (a metric's
    name may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "vinsbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that cell reports: those
    listing it under ``workloads``; a per-layer metric without the key is
    reported wherever its ``moves`` is."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every module
    loaded in this process), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def nvidia_smi(devices: List[int]) -> List[dict]:
    """Each card's clocks, power, power limit and temperature, or [] where
    ``nvidia-smi`` cannot be run."""
    q = "index,name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    rows = []
    for line in out.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 7 and parts[0].isdigit() and int(parts[0]) in devices:
            rows.append(dict(zip(q.split(","), parts)))
    return rows


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` by linear interpolation (numpy's
    default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell, its configuration and traffic, the run's
    arguments and the devices."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    devices: list
    t_process: float  # process start, wall clock
    out_dir: str
    log: Callable = print
    control: bool = False  # also read the control (the reference in bfloat16)


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the end-to-end values, the record the
    per-layer readers read, the comparisons (name -> (value, limit)), the
    answers attempted and failed, and the device's numbers."""
    e2e: Dict[str, float]
    rec: dict
    checks: Dict[str, tuple]
    attempted: int
    failed: int
    memory_peak_bytes: int
    breakdown: Optional[dict] = None


def vins_config(cfg: dict, **overrides):
    """The program's ``VinsConfig`` from a configuration file's ``vins`` keys."""
    from vins_rgbd_fast_torch.config import VinsConfig

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["vins"].items()}
    kw.update(overrides)
    return VinsConfig(**kw)


def rig(cfg: dict):
    """The synthetic rig that renders a configuration's camera: its size,
    pinhole intrinsics, radtan distortion and camera and IMU rates."""
    from .traffic.synthetic import SyntheticRig

    v = cfg["vins"]
    fx, fy, cx, cy = v["intrinsics"]
    k1, k2, p1, p2 = v.get("distortion", (0.0, 0.0, 0.0, 0.0))
    return SyntheticRig(width=v["image_width"], height=v["image_height"], fx=fx, fy=fy, cx=cx,
                        cy=cy, imu_rate=cfg["rig"]["imu_rate"],
                        frame_rate=cfg["rig"]["frame_rate"],
                        k1=k1, k2=k2, p1=p1, p2=p2)


def lane_seeds(seed: int, n: int) -> List[int]:
    """n stream seeds drawn from the run's seed (any size of integer)."""
    import numpy as np

    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint32)]


class Spans:
    """Host spans the benchmark takes around its calls into each layer:
    name -> list of seconds."""

    def __init__(self):
        self.s: Dict[str, List[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.s.setdefault(name, []).append(seconds)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return float(sum(self.s.get(name, [])))


def synchronize(devices) -> None:
    import torch

    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def profile_frames(run_frame: Callable[[int], None], n: int, devices, path: str,
                   frames: Optional[int] = None) -> dict:
    """Run ``n`` calls (``run_frame(i)``) under ``torch.profiler`` inside
    one ``trace.WINDOW_SPAN``, each inside a ``FRAME_SPAN``, ended by a
    synchronisation of every card; the chrome trace goes to ``path``.
    ``frames`` is the frames the calls run together (default: one each).
    Returns its reduction (``trace.reduce``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace

    synchronize(devices)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for i in range(n):
                with record_function(FRAME_SPAN):
                    run_frame(i)
            synchronize(devices)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    del prof
    return trace.reduce(load_json(path), n if frames is None else frames,
                        [torch.device(d).index for d in devices])


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple],
                device: dict, checks: Dict[str, tuple], breakdown: Optional[dict] = None) -> str:
    """The contract's last line: ``metrics`` name -> (value, unit); the
    comparisons come last, each number beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": _num(v), "limit": _num(lim)} for k, (v, lim) in checks.items()}
    return json.dumps(out)


def _num(x):
    x = float(x)
    return x if math.isfinite(x) else str(x)


def passes(checks: Dict[str, tuple]) -> bool:
    """Every number compared is finite and within its limit (a limit is the
    most a number may read)."""
    return all(math.isfinite(float(v)) and float(v) <= float(lim) for v, lim in checks.values())
