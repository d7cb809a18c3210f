"""Batched-sequence throughput over a mesh of devices (twin of
``vins_rgbd_fast_tpu/parallel/throughput.py``).

JAX shards N independent sensor streams (robots, bag replays, evaluation
sweeps) over a device mesh with ``vmap(vio_step)`` and sharding
annotations.  The port's backend is batched already, over the leading
axis of every state, so each shard's step is ``vio_step`` itself: a mesh
is a list of devices (a device may appear more than once, each entry its
own shard), ``batch_shard`` splits the lane axis over it in lane order
(``Sharded``), and ``make_batched_step`` runs one ``vio_step`` per shard,
each on its device, in turn from the calling thread (``on_shards``; JAX's
jitted step has no host threads either), with no cross-sequence work.  A
mesh is never reduced to fewer devices than asked for.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..backend import estimator as est
from ..config import EstimatorConfig
from .batched_pipeline import Sharded, ShardSpec, map_tree, mesh_of, on_shards


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> List[torch.device]:
    """The first ``n_devices`` CUDA devices (all by default; fewer present
    raises), or with ``device="cpu"`` ``n_devices`` entries of the CPU (1
    by default), the twin of the virtual host devices JAX's tests run on."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_mesh: CUDA is not available (device='cpu' for the CPU)")
    if n_devices is not None:
        if n_devices > n:
            raise ValueError(f"make_mesh: {n_devices} devices asked for, {n} present")
        n = n_devices
    return [torch.device("cuda", i) for i in range(n)]


def batch_shard(mesh: List[torch.device], tree) -> Sharded:
    """A batched tree (leading axis B) split in lane order over the mesh,
    each shard copied to its device; B must divide by the mesh's size."""
    return ShardSpec(mesh_of(mesh), 0).place(tree)


def make_batched_step(cfg: EstimatorConfig, mesh: List[torch.device]):
    """The batched VIO step over (states, feats, imus, draws): one eager
    ``vio_step`` per shard of the mesh, shard after shard from the caller's
    thread, each on its own device, no cross-sequence work; inputs
    ``Sharded`` over the mesh (a plain batched tree is placed by
    ``batch_shard`` first), outputs (states, StepOutput)
    ``Sharded`` alike.  ``draws`` takes the place of JAX's per-sequence
    keys: the VO pose init's PnP uniforms (B, 32, MAXF), None with an IMU
    (where JAX's step does not read its key)."""
    spec = ShardSpec(mesh_of(mesh), 0)
    if not spec.mesh:
        raise ValueError("make_batched_step: an empty mesh")

    def placed(tree):
        if tree is None:
            return None
        tree = tree if isinstance(tree, Sharded) else spec.place(tree)
        spec.check(tree, "make_batched_step: the inputs")
        return tree

    def step(states, feats, imus, draws=None):
        ins = [placed(t) for t in (states, feats, imus, draws)]
        res = on_shards(spec.mesh, lambda i: est.vio_step(
            cfg, *[None if t is None else t.parts[i] for t in ins[:3]], None,
            None if ins[3] is None else ins[3].parts[i]))
        return (Sharded(spec.mesh, [r[0] for r in res], 0),
                Sharded(spec.mesh, [r[1] for r in res], 0))

    return step


def replicate_state(state, batch: int):
    """Tile a B = 1 state (every leaf (1, ...)) into a batch of ``batch``."""
    return map_tree(lambda a: a.repeat((batch,) + (1,) * (a.dim() - 1)), state)
