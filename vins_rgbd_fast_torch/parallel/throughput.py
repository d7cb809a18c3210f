"""Batched-sequence throughput over a "mesh" of devices (twin of
``vins_rgbd_fast_tpu/parallel/throughput.py``).

JAX shards N independent sensor streams (robots, bag replays, evaluation
sweeps) over a device mesh with ``vmap(vio_step)``.  The port's backend is
batched already, over the leading axis of every state, so the batched step
is ``vio_step`` itself, and the port runs a batch on one card: a mesh here
is a list of devices, and a mesh of more than one device is refused rather
than silently reduced to one.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..backend import estimator as est
from ..config import EstimatorConfig
from .batched_pipeline import map_tree


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> List[torch.device]:
    """The CUDA devices (the first ``n_devices``; all by default), or
    ``[torch.device("cpu")]`` with ``device="cpu"``."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_mesh: CUDA is not available (device='cpu' for the CPU)")
    if n_devices is not None:
        if n_devices > n:
            raise ValueError(f"make_mesh: {n_devices} devices asked for, {n} present")
        n = n_devices
    return [torch.device("cuda", i) for i in range(n)]


def _device(mesh: List[torch.device]) -> torch.device:
    if len(mesh) != 1:
        raise ValueError(f"a mesh of {len(mesh)} devices: the port runs a batch on one "
                         "device (make_mesh(1))")
    return mesh[0]


def batch_shard(mesh: List[torch.device], tree):
    """A batched tree (leading axis B) placed on the mesh's device."""
    dev = _device(mesh)
    return map_tree(lambda a: a.to(dev), tree)


def make_batched_step(cfg: EstimatorConfig, mesh: List[torch.device]):
    """The batched VIO step over (states, feats, imus, draws): one
    ``vio_step`` per sequence on the mesh's device, no cross-sequence
    work.  ``draws`` takes the place of JAX's per-sequence keys: the VO
    pose init's PnP uniforms (B, 32, MAXF), None with an IMU (where JAX's
    step does not read its key)."""
    _device(mesh)

    def step(states, feats, imus, draws=None):
        return est.vio_step(cfg, states, feats, imus, None, draws)

    return step


def replicate_state(state, batch: int):
    """Tile a B = 1 state (every leaf (1, ...)) into a batch of ``batch``."""
    return map_tree(lambda a: a.repeat((batch,) + (1,) * (a.dim() - 1)), state)
