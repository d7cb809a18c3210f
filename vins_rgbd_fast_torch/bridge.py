"""State bridge between the JAX package and the port.

The JAX states are NamedTuples of arrays; ``jax.device_get(state)`` turns
them into NamedTuples of numpy arrays, which is what this module takes.
``to_torch`` rebuilds the port's NamedTuple of the same name, field by
field and recursively (``TrackerState``, ``EstimatorState`` with its
``WindowState``, ``FeatureTable`` and ``PriorFactor``, ``FrameFeatures``,
``ImuInterval``); ``to_numpy`` goes back to plain numpy NamedTuples of
the port's classes, with the same field names as JAX's.  Leading batch
axes are kept as they are: stack per-sequence JAX states first to get the
port's (B, ...) layout.  dtypes are preserved.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .backend.estimator import EstimatorState, ImuInterval
from .backend.feature_table import FeatureTable, FrameFeatures
from .backend.state import WindowState
from .frontend.feature_tracker import TrackerState
from .ops.solver import PriorFactor

PORT_TYPES = {cls.__name__: cls for cls in (
    TrackerState, EstimatorState, WindowState, FeatureTable, PriorFactor,
    FrameFeatures, ImuInterval)}


def to_torch(obj: Any, device="cpu"):
    """numpy NamedTuple tree (JAX field names) -> the port's NamedTuples."""
    if hasattr(obj, "_fields"):
        cls = PORT_TYPES.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"no port type for {type(obj).__name__}")
        if tuple(cls._fields) != tuple(obj._fields):
            raise TypeError(f"{cls.__name__}: fields {obj._fields} != {cls._fields}")
        return cls(*[to_torch(v, device) for v in obj])
    if isinstance(obj, (tuple, list)):
        return tuple(to_torch(v, device) for v in obj)
    return torch.from_numpy(np.array(obj, copy=True)).to(device)


def to_numpy(obj: Any):
    """The port's NamedTuple tree -> the same NamedTuples holding numpy."""
    if hasattr(obj, "_fields"):
        return type(obj)(*[to_numpy(v) for v in obj])
    if isinstance(obj, (tuple, list)):
        return tuple(to_numpy(v) for v in obj)
    return obj.detach().cpu().numpy()


def stack(trees):
    """Stack per-sequence numpy NamedTuple trees along a new leading axis."""
    first = trees[0]
    if hasattr(first, "_fields"):
        return type(first)(*[stack([t[i] for t in trees]) for i in range(len(first))])
    if isinstance(first, (tuple, list)):
        return tuple(stack([t[i] for t in trees]) for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees])
