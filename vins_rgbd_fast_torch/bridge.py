"""State bridge between the JAX package and the port.

The JAX states are NamedTuples of arrays; ``jax.device_get(state)`` turns
them into NamedTuples of numpy arrays, which is what this module takes.
``to_torch`` rebuilds the port's NamedTuple of the same name, field by
field and recursively (``TrackerState``, ``EstimatorState`` with its
``WindowState``, ``FeatureTable`` and ``PriorFactor``, ``FrameFeatures``,
``ImuInterval``, ``StepOutput``, ``ReloData``, the solver's ``VisualData``
and ``ImuData`` with its ``Preintegrated``, and the batched runner's
``FrameBatch`` and ``ScanOutputs``); ``to_numpy`` goes back to
plain numpy NamedTuples of the port's classes, with the same field names as
JAX's.  Leading batch axes are kept as they are: stack per-sequence JAX
states first to get the port's (B, ...) layout.  dtypes are preserved.
``KeyFrameData`` is host data in both packages: it maps field by field,
its arrays copied and its scalars kept.  ``copy_pose_graph`` copies a JAX
``PoseGraph``'s host state and retrieval DB into the port's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .backend.estimator import EstimatorState, ImuInterval, StepOutput
from .backend.feature_table import FeatureTable, FrameFeatures
from .backend.state import WindowState
from .frontend.feature_tracker import TrackerState
from .loop.pose_graph import KeyFrameData, PoseGraph
from .ops.imu_preintegration import Preintegrated
from .ops.solver import ImuData, PriorFactor, ReloData, VisualData
from .parallel.batched_pipeline import FrameBatch, ScanOutputs

PORT_TYPES = {cls.__name__: cls for cls in (
    TrackerState, EstimatorState, WindowState, FeatureTable, PriorFactor,
    FrameFeatures, ImuInterval, StepOutput, ReloData, KeyFrameData, FrameBatch, ScanOutputs,
    VisualData, ImuData, Preintegrated)}


def _port_type(obj):
    cls = PORT_TYPES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port type for {type(obj).__name__}")
    if tuple(cls._fields) != tuple(obj._fields):
        raise TypeError(f"{cls.__name__}: fields {obj._fields} != {cls._fields}")
    return cls


def to_torch(obj: Any, device="cpu"):
    """numpy NamedTuple tree (JAX field names) -> the port's NamedTuples."""
    if hasattr(obj, "_fields"):
        cls = _port_type(obj)
        if cls is KeyFrameData:
            return cls(*[np.array(v, copy=True) if np.ndim(v) else v for v in obj])
        return cls(*[to_torch(v, device) for v in obj])
    if isinstance(obj, (tuple, list)):
        return tuple(to_torch(v, device) for v in obj)
    return torch.from_numpy(np.array(obj, copy=True)).to(device)


def to_numpy(obj: Any):
    """The port's NamedTuple tree -> the same NamedTuples holding numpy
    (scalars stay scalars)."""
    if hasattr(obj, "_fields"):
        return type(obj)(*[to_numpy(v) for v in obj])
    if isinstance(obj, (tuple, list)):
        return tuple(to_numpy(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.array(obj, copy=True) if isinstance(obj, np.ndarray) else obj


def copy_pose_graph(src, dst: PoseGraph) -> PoseGraph:
    """Copy a JAX ``PoseGraph``'s host state (keyframes with host
    descriptors, loops, drift, alignment, corrected poses) and its retrieval
    DB rows into the (empty) port graph ``dst``; returns ``dst``."""
    dst.keyframes = [to_torch(KeyFrameData(*[np.asarray(v) if np.ndim(v) else v
                                             for v in kf])) for kf in src.keyframes]
    dst.loops = [{k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
                  for k, v in lp.items()} for lp in src.loops]
    dst.earliest_loop_index = src.earliest_loop_index
    dst.sequence = src.sequence
    dst.yaw_drift = float(src.yaw_drift)
    dst.t_drift = np.array(src.t_drift, np.float64)
    dst.corrected = {k: (np.array(P), np.array(Q)) for k, (P, Q) in src.corrected.items()}
    dst.w_r_vio = np.array(src.w_r_vio)
    dst.w_t_vio = np.array(src.w_t_vio)
    dst.sequence_aligned = dict(src.sequence_aligned)
    dst.db_evicted = src.db_evicted
    n = src._db_size
    if n:
        dst._db_append_block(np.asarray(src._dev_db[:n]), np.asarray(src._dev_valid[:n]),
                             norms=np.asarray(src._dev_norm[:n]),
                             kf_indices=np.asarray(src._db_index[:n]))
    return dst


def stack(trees):
    """Stack per-sequence numpy NamedTuple trees along a new leading axis."""
    first = trees[0]
    if hasattr(first, "_fields"):
        return type(first)(*[stack([t[i] for t in trees]) for i in range(len(first))])
    if isinstance(first, (tuple, list)):
        return tuple(stack([t[i] for t in trees]) for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees])
