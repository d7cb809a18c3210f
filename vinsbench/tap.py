"""Read-only taps on the program's timed path: each keeps references to the
tensors that one function of the program takes and returns, as the call
makes them, so the benchmark can copy them out after a frame and hand them
to the reference.

A CUDA graph records its calls once; a tap that ran during the capture
keeps the graph's own tensors, which every replay refills.  So a tap keeps
two slots, ``graph`` (set while a stream is capturing) and ``eager`` (every
other call), and ``take`` copies the one the last frame wrote.  A tap adds
no kernel to the replayed frame: it only keeps the graph's pool from
reusing the tensors it holds, except where it has to copy a tensor that
the frame overwrites (``_keep_solve``).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional

import torch


def _copy(tree):
    """A copy of every tensor in a tree of dicts, lists and (named) tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_copy(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree


class Tap:
    """``module.name`` wrapped while the tap is open: ``keep(args, kwargs,
    result)`` picks what to hold."""

    def __init__(self, module: str, name: str, keep: Callable):
        self.module, self.name, self.keep = module, name, keep
        self.slots: Dict[str, Optional[dict]] = {"graph": None, "eager": None}
        self._orig = None

    def open(self) -> None:
        mod = importlib.import_module(self.module)
        self._orig = orig = getattr(mod, self.name)

        def tapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
            self.slots["graph" if capturing else "eager"] = self.keep(args, kwargs, out)
            return out

        setattr(mod, self.name, tapped)

    def close(self) -> None:
        if self._orig is not None:
            setattr(importlib.import_module(self.module), self.name, self._orig)
            self._orig = None

    def take(self, replayed: bool) -> Optional[dict]:
        """A copy of what the last frame's call left: the graph's slot after
        a replayed frame, the eager one otherwise."""
        return _copy(self.slots["graph" if replayed else "eager"])


class Taps:
    """Several taps opened and closed together (a context manager)."""

    def __init__(self, taps: Dict[str, Tap]):
        self.taps = taps

    def __enter__(self):
        for t in self.taps.values():
            t.open()
        return self

    def __exit__(self, *exc):
        for t in self.taps.values():
            t.close()

    def take(self, replayed: bool, names: Optional[List[str]] = None) -> dict:
        return {k: t.take(replayed) for k, t in self.taps.items()
                if names is None or k in names}


def _keep_solve(args, kwargs, res) -> dict:
    """The window before the solve and the prior are copied as the solve
    gets them: some of their tensors are the frame's input state, which
    the frame overwrites with its new state when it ends (in a graph, 20
    device copies per frame)."""
    _, x0, vis, imu, prior, gravity = args[:6]
    relo = kwargs.get("relo")
    out = dict(x0=_copy(x0), vis=vis, prior=_copy(prior), x=res.x, inv_depth=res.inv_depth,
               cost0=res.cost0, cost=res.cost)
    if relo is not None:
        out.update(relo=relo, relo_P=res.relo_P, relo_Q=res.relo_Q)
    return out


def _keep_imu(args, kwargs, out) -> dict:
    st = args[1]
    return dict(dts=st.imu_dts, acc=st.imu_acc, gyr=st.imu_gyr)


def _keep_lk(args, kwargs, out) -> dict:
    """Where LK starts each point, and which points it tracks (the points
    themselves are the tracker's state before the frame)."""
    return dict(init=args[3], active=args[4])


def program_taps(solve: bool = True, imu: bool = False, lk: bool = False) -> Taps:
    """The window solve (``ops.solver.solve``: the window before it, the
    feature table, the prior, the relocalization and the solved window),
    the IMU samples it is given (``backend.estimator._make_preints``) and
    the tracker's LK start (``ops.lk.pyramidal_lk``: where LK starts each
    point)."""
    taps = {}
    if solve:
        taps["solve"] = Tap("vins_rgbd_fast_torch.ops.solver", "solve", _keep_solve)
    if imu:
        taps["imu"] = Tap("vins_rgbd_fast_torch.backend.estimator", "_make_preints", _keep_imu)
    if lk:
        taps["lk"] = Tap("vins_rgbd_fast_torch.ops.lk", "pyramidal_lk", _keep_lk)
    return Taps(taps)
