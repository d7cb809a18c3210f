"""Build-on-first-use loader for the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into ONE shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The library lands in ``vins_rgbd_fast_torch/build/`` under
a name carrying the hash of the sources, so an edited source triggers a
rebuild; ptxas's report of each kernel's registers, shared memory and
spills goes beside it (``<library>.log``).  Nothing here runs at import
time: the CPU tests import every module of the package.

Each kernel's wrapper counts its launches in a ``LaunchCount``.  A launch
made while the calling thread captures a CUDA graph (``capture``) runs only
when the graph is replayed, so it is noted for the graph instead, and each
``Captured.replay`` adds it to its counter then.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD = os.path.join(_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()  # launches come from the frame thread and from workers
_tls = threading.local()  # ``recording``'s launches of the thread that captures


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))) + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for the current sources, or its
    log, is missing; returns its path.  The compilers' messages (ptxas's
    registers, shared memory and spills per kernel among them) are written
    to the library's path + ".log" and, with ``verbose``, printed."""
    h = hashlib.sha256()
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    out = os.path.join(BUILD, f"libvins_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out) and os.path.exists(out + ".log"):
        return out
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        srcs = [p for p in _sources() if p.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p],
                                  stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                 for p, o in zip(srcs, objs)]
        logs = [proc.communicate()[1] for proc in procs]  # waits for all, drains each pipe
        for p, proc, err in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(p)} "
                                   f"({proc.returncode}):\n{err}")
        lib_tmp = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                              "-o", lib_tmp, *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        with open(out + ".log", "w") as f:
            f.write("".join(logs))
        os.replace(lib_tmp, out)
    if verbose:
        print("".join(logs))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            L.fast_nms_launch.restype = i
            # each launcher takes its tensors' device index before the stream
            # and refuses a calling thread whose current device is another
            L.fast_nms_launch.argtypes = [p, p, i, i, i, f, i, p]
            L.lk_level_launch.restype = i
            L.lk_level_launch.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                          i, i, i, i, i, i, i, f, f, i, p]
            L.lk_iterate_launch.restype = i
            L.lk_iterate_launch.argtypes = [p] * 14 + [i, i, i, i, i, f, i, p]
            L.stage_mark_launch.restype = i
            L.stage_mark_launch.argtypes = [p, i, i, p]
            L.proj_schur_launch.restype = i
            L.proj_schur_launch.argtypes = [p] * 25 + [i, i, i, i, f, f, i, p]
            L.proj_schur_scratch_floats.restype = i
            L.proj_schur_scratch_floats.argtypes = []
            _lib = L
    return _lib


def check_args(name: str, ref: torch.Tensor, specs) -> None:
    """Refuse a launcher's argument that is not a contiguous tensor of the
    dtype and shape the kernel reads, on ``ref``'s device: ``specs`` holds
    (argument name, tensor, dtype, shape) for each."""
    for arg, t, dt, shape in specs:
        if t.device != ref.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {ref.device}")


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def launch(name: str, device: torch.device, *args) -> None:
    """Call the launcher ``name`` of the library for tensors on ``device``:
    under a guard that makes ``device`` the calling thread's current one
    (the runtime launches there, whatever the stream), on its current
    stream, with the device index and the stream appended to ``args``.
    A caller on any thread, whatever its current device, gets a launch on
    the tensors' card."""
    fn = getattr(lib(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(fn(*args, device.index, stream), name)


class LaunchCount:
    """One kernel's launches: ``total``, and ``by_device`` (CUDA device
    index -> launches).  While the calling thread records (``recording``),
    a launch is noted for the graph being captured and counted by its
    replays (``Captured.replay``), not here."""

    def __init__(self):
        self.total = 0
        self.by_device = {}

    def add(self, device: int, n: int = 1) -> None:
        noted = getattr(_tls, "launches", None)
        if noted is not None:
            noted[(self, device)] = noted.get((self, device), 0) + n
            return
        with _count_lock:
            self.total += n
            self.by_device[device] = self.by_device.get(device, 0) + n

    def reset(self) -> None:
        with _count_lock:
            self.total = 0
            self.by_device.clear()


@contextlib.contextmanager
def recording():
    """Within: this thread's launches are noted, not counted; yields the
    notes, {(LaunchCount, device index): launches}."""
    prev = getattr(_tls, "launches", None)
    _tls.launches = noted = {}
    try:
        yield noted
    finally:
        _tls.launches = prev


class Captured:
    """A captured CUDA graph and the launches its capture noted."""

    def __init__(self, graph, launches: dict):
        self.graph = graph
        self.launches = dict(launches)

    def replay(self) -> None:
        """The graph's work on the current stream; each noted launch is
        counted, on its device."""
        self.graph.replay()
        for (count, device), n in self.launches.items():
            count.add(device, n)

    def reset(self) -> None:
        """Release the graph and its memory pool."""
        self.graph.reset()


def capture(fn, stream) -> Captured:
    """``fn``'s work recorded on ``stream`` as a CUDA graph, the kernels'
    launches noted for its replays (``recording``).  Capture errors are
    confined to the calling thread, so a worker thread launching on a
    stream of its own goes on.  A call that capture refuses raises, with a
    note naming the last PyTorch op dispatched before it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class LastOp(TorchDispatchMode):
        op = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.op = func
            return func(*args, **(kwargs or {}))

    graph = torch.cuda.CUDAGraph()
    last = LastOp()
    with recording() as launches:
        try:
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                with last:
                    fn()
        except Exception as e:
            e.add_note(f"while capturing a CUDA graph on {stream.device}; the last op "
                       f"dispatched: {last.op}")
            raise
    return Captured(graph, launches)
