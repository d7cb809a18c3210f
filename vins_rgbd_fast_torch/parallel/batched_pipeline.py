"""Batched VIO runner: the whole per-frame pipeline (gyro prediction →
tracker → depth lookup → backend step) over B sequences in lock step
(twin of ``gyro_relative_R``, ``fused_frame_step`` and ``BatchedVioRunner``
in ``vins_rgbd_fast_tpu/parallel/batched_pipeline.py``).

Like the JAX runner, it takes states warmed by the host pipeline under
any initialization program: warm one ``VinsPipeline`` per sequence until
NON_LINEAR (static init, dynamic init with its monocular fallback, td and
the extrinsic free or not), ``stack_states``, ``stage_frames_arrays``,
``run``.  It can also warm itself (``warm``: 11 window-filling frames and
the static initialization; static init only).  ``run`` processes T staged
frames with no host synchronisation per frame; outputs stay on the device
and are stacked at the end.  Loop closure rides on the outputs between
segments (``parallel/loop_closer.BatchedLoopCloser``,
``ThreadedLoopCloser``).

``run`` is JAX's compiled scan: on a CUDA device each shard's steady
frame is captured once as a CUDA graph (``_FrameProgram``: static input
slots, states and output slots; the first frame of a shape runs eagerly on
the capture stream, the warm-up PyTorch asks for, then the capture) and
replayed for every later frame, with each lane's draws made outside the
graph from its generators, as before.  The graph is kept across calls of
one shape and captured again when B, the image size or a dtype changes;
``close`` releases it.  On the CPU the same static-buffer program runs
eagerly.  ``run_chained`` is ``run`` (JAX's per-frame twin replays the same
step); ``run_eager`` is the per-op dispatch, the plain version the tests
and ``chip_smoke.py`` hold the replay to.  Code on the step keeps the
capture's rules: no constant built on the host after the warm-up (see
``utils.quaternion.const``), no host wait, no draw inside the step.  The
latency pipeline (``pipeline.VinsPipeline``) runs its steady frame through
the same ``_FrameProgram``.

The multi-device program (JAX's ``run_sharded`` under ``shard_map``): a
runner built with a ``mesh`` (a list of devices, one shard each; a device
may appear more than once) splits its B lanes over the mesh in lane order.
``shard_spec``, ``put_states`` and ``put_batch`` place each shard's lanes on
its device as a ``Sharded`` tree, and ``run_sharded`` replays every shard's
frame in turn from the calling thread, frame by frame, each under its
device, on that device's current stream (``on_shards``); no shard talks
to another.  Lane b's generators live on lane b's device whatever the
split, so a lane's draws do not depend on it (JAX builds the per-lane keys
outside the shard).  States and outputs come back sharded;
``Sharded.gather`` brings a tree onto one device.
``run`` and ``warm`` are the one-device path.  ``stack_states`` turns
per-sequence ``VinsPipeline``s (warmed by their own initialization
programs) into the runner's batched states; ``stage_frames_arrays`` stages
pre-rendered device stacks with each lane's IMU intervals.

Without an IMU (VO, the TUM RGB-D rig: ``EstimatorConfig.use_imu`` and
``TrackerConfig.use_imu_prediction`` off) the staged intervals are empty,
the tracker runs cold LK on ``pyr_levels_cold`` levels (K2 per level) and
``vio_step`` initialises each new pose by PnP; each sequence then draws its
PnP uniforms (B, 32, MAXF) from a generator of its own, after its RANSAC
uniforms, in every step (JAX draws both from one key per sequence and step).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..backend import estimator as est
from ..backend.state import WINDOW_SIZE
from ..config import EstimatorConfig, TrackerConfig
from ..frontend import feature_tracker as ft
from ..models.camera import CameraModel
from ..ops import ransac as ransac_ops
from ..utils import quaternion as quat
from ..utils.timing import TRACER


class FrameBatch(NamedTuple):
    """Per-frame staged inputs with leading axes (T, B, ...)."""
    imgs: torch.Tensor     # (T, B, H, W)
    depths: torch.Tensor   # (T, B, H, W)
    ts: torch.Tensor       # (T, B)
    imu_dts: torch.Tensor  # (T, B, MAXI)
    imu_acc: torch.Tensor  # (T, B, MAXI+1, 3)
    imu_gyr: torch.Tensor  # (T, B, MAXI+1, 3)


class ScanOutputs(NamedTuple):
    """Per-frame per-sequence outputs, stacked (T, B, ...).  The ``wp_*``
    fields are the newest frame's depth-anchored landmarks (pre-slide):
    what the pose graph needs to build a keyframe (``BatchedLoopCloser``)."""
    P: torch.Tensor
    Q: torch.Tensor
    V: torch.Tensor
    cost: torch.Tensor
    is_keyframe: torch.Tensor
    n_features: torch.Tensor
    wp_world: torch.Tensor  # (T, B, MAXF, 3)
    wp_uv: torch.Tensor     # (T, B, MAXF, 2)
    wp_norm: torch.Tensor   # (T, B, MAXF, 2)
    wp_valid: torch.Tensor  # (T, B, MAXF)
    wp_ids: torch.Tensor    # (T, B, MAXF) feature ids


def gyro_relative_R(dts, gyr, bg, qic) -> torch.Tensor:
    """Camera-frame relative rotation R_{c1<-c0} from one interval of raw
    gyro samples: dts (B, MAXI), gyr (B, MAXI+1, 3), bg (B, 3), qic (B, 4).
    The quaternion chain is a pairwise tree product; padded steps are
    identities."""
    dq = quat.so3_exp((gyr[:, 1:] - bg[:, None]) * dts[..., None])  # (B, N, 4)
    n = dq.shape[1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        ident = quat.q_identity(dq.dtype, dq.device).expand(dq.shape[0], m - n, 4)
        dq = torch.cat([dq, ident], dim=1)
    while dq.shape[1] > 1:
        dq = quat.qmul(dq[:, 0::2], dq[:, 1::2])
    R_imu = quat.q2R(quat.qnormalize(dq[:, 0]))
    R_ic = quat.q2R(qic)
    return R_ic.transpose(1, 2) @ R_imu.transpose(1, 2) @ R_ic


def fused_frame_step(tcfg: TrackerConfig, cam: CameraModel, ecfg: EstimatorConfig,
                     trk: ft.TrackerState, st: est.EstimatorState, img, depth, t,
                     imu: est.ImuInterval, ransac_u, relo=None, pnp_u=None):
    """One steady-state frame of B sequences: gyro prediction → tracker →
    depth lookup → ``vio_step`` (with the relocalization constraint
    ``relo`` when ``ecfg.fast_relo``, and in VO mode the PnP uniforms
    ``pnp_u`` (B, 32, MAXF); JAX draws both RANSACs from one key)."""
    relR = gyro_relative_R(imu.dts, imu.gyr, st.x.Bg[:, WINDOW_SIZE], st.x.qic)
    trk, tout = ft.track_frame(tcfg, cam, trk, img, t, relR, ransac_u)
    feats = tout.features
    feats = feats._replace(depth=ft.lookup_depth(depth, feats.uv, feats.ids >= 0))
    TRACER.mark("track")
    st, sout = est.vio_step(ecfg, st, feats, imu, relo, pnp_u)
    return trk, st, sout


def _scan_outputs(sout: est.StepOutput) -> ScanOutputs:
    return ScanOutputs(P=sout.P, Q=sout.Q, V=sout.V, cost=sout.cost,
                       is_keyframe=sout.is_keyframe, n_features=sout.n_features,
                       wp_world=sout.wp_world, wp_uv=sout.wp_uv, wp_norm=sout.wp_norm,
                       wp_valid=sout.wp_valid, wp_ids=sout.wp_ids)


def _layout(tree) -> tuple:
    """Shape, dtype and device of every leaf: what a captured frame fixes."""
    return tuple((tuple(a.shape), a.dtype, a.device) for a in leaves(tree))


def _assign(dst, src) -> None:
    """Copy tree ``src`` into the buffers of tree ``dst`` (same layout).  A
    leaf that is its own buffer stays; one that shares memory with another
    buffer is cloned first, so no copy reads a buffer already written."""
    bufs, new = leaves(dst), leaves(src)
    if _layout(dst) != _layout(src):
        raise ValueError("the frame's states and outputs keep their layout from frame to "
                         "frame")
    held = {b.untyped_storage().data_ptr() for b in bufs}
    srcs = [None if n is b else n.clone() if n.untyped_storage().data_ptr() in held else n
            for b, n in zip(bufs, new)]
    for b, n in zip(bufs, srcs):
        if n is not None:
            b.copy_(n)


def _batch_args(inp):
    """``fused_frame_step``'s frame arguments from a runner program's slots:
    (the frame of a ``FrameBatch``, the RANSAC uniforms, the PnP uniforms or
    None)."""
    f, ransac_u, pnp_u = inp
    return (f.imgs, f.depths, f.ts, est.ImuInterval(f.imu_dts, f.imu_acc, f.imu_gyr),
            ransac_u, None, pnp_u)


class _FrameProgram:
    """One steady frame over static buffers, the port's twin of one of JAX's
    compiled frames: a step of the batched runner's scanned ``run`` (one
    shard) or the latency pipeline's jitted ``fused`` frame
    (``VinsPipeline``).  Input slots (shaped by the first frame's inputs),
    the tracker and estimator states and the output slots, allocated once;
    the step is ``fused_frame_step`` on them (``args(slots)`` gives its frame
    arguments: image, depth, t, IMU interval, RANSAC uniforms, relo,
    PnP uniforms), then in-place copies of the outputs (``outputs`` of its
    ``StepOutput``: ``ScanOutputs`` for the runner, the whole ``StepOutput``
    for the pipeline) and of the new states into their buffers.  On a CUDA
    device the first frame runs the step eagerly on a side stream (the
    warm-up a capture needs: the kernels' build and opt-ins, the solver
    libraries' handles and workspaces, the cached constants), then the step
    is captured on that stream (``native.capture``) and every later frame
    replays it on the current stream; a failed capture or replay raises.
    On the CPU every frame runs the step eagerly.  ``args`` and
    ``outputs`` are module-level functions (or partials of them): the
    program holds no reference to its owner, so releasing the owner
    releases the graph and its memory pool."""

    def __init__(self, tcfg: TrackerConfig, cam: CameraModel, ecfg: EstimatorConfig,
                 layout: tuple, trk, st, args: Callable = _batch_args,
                 outputs: Callable = _scan_outputs):
        self.cfg = (tcfg, cam, ecfg)
        self.layout = layout
        self.device = leaves(trk)[0].device
        self.trk = map_tree(torch.empty_like, trk)
        self.st = map_tree(torch.empty_like, st)
        self.args, self.outputs = args, outputs
        self.inp = None  # the input slots, shaped by the first frame's inputs
        self.out = None  # the output slots, shaped by the first step
        self.graph: Optional[native.Captured] = None
        self.outs = None  # a runner call's (T, B, ...) ScanOutputs (``frame``)
        self.handed = None  # the states the owner last took (``states``), if it keeps them

    def load(self, trk, st, T: int = 0) -> None:
        """Start from the caller's states (a runner call of T frames)."""
        TRACER.count("program::loads")
        _assign((self.trk, self.st), (trk, st))
        self.T, self.outs = T, None

    def step(self) -> None:
        """The frame on the buffers: what the graph records (with tracing
        on, the stage marks too: ``track`` ends after the depth lookup,
        ``init`` after the ingest and pose init, ``solve`` after the failure
        flags, ``marg`` after the prior, ``tail`` after the copies)."""
        with TRACER.marking(self.device):
            trk, st, sout = fused_frame_step(*self.cfg, self.trk, self.st,
                                             *self.args(self.inp))
            out = self.outputs(sout)
            if self.out is None:
                self.out = map_tree(torch.empty_like, out)
            _assign(self.out, out)  # first: an output may be a view of an old state buffer
            _assign((self.trk, self.st), (trk, st))

    def put(self, inputs) -> None:
        """``inputs`` (the tree ``args`` reads) into the slots."""
        if self.inp is None:
            self.inp = map_tree(torch.empty_like, inputs)
        for slot, a in zip(leaves(self.inp), leaves(inputs)):
            slot.copy_(a)

    def replay(self) -> None:
        """The step on the slots (replayed, or its warm-up and capture, or
        on the CPU eager); its outputs are left in ``out``."""
        if self.device.type != "cuda":
            self.step()
        elif self.graph is not None:
            self.graph.replay()
        else:
            self._warm_and_capture()

    def frame(self, batch: FrameBatch, k: int, ransac_u, pnp_u) -> None:
        """A runner's frame k of ``batch`` with these draws (``put``, then
        ``replay``), its outputs into the call's (T, B, ...) ``ScanOutputs``."""
        with TRACER.span("runner::inputs"):
            self.put((FrameBatch(*(a[k] for a in batch)), ransac_u, pnp_u))
        with TRACER.span("runner::replay"):
            self.replay()
        with TRACER.span("runner::outputs"):
            if self.outs is None:
                self.outs = map_tree(lambda a: a.new_empty((self.T,) + tuple(a.shape)),
                                     self.out)
            for o, a in zip(leaves(self.outs), leaves(self.out)):
                o[k].copy_(a)

    def _warm_and_capture(self) -> None:
        TRACER.count("program::captures")
        with TRACER.span("program::capture"):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with TRACER.span("program::warm"), torch.cuda.stream(side):
                self.step()
            for a in leaves(self.out):  # made on the side stream, read on the current one
                a.record_stream(current)
            with TRACER.span("program::record"):
                self.graph = native.capture(self.step, side)
            current.wait_stream(side)

    def states(self):
        """(trk, st) copied out of the buffers, so no later frame changes
        them."""
        return map_tree(torch.clone, self.trk), map_tree(torch.clone, self.st)

    def result(self):
        """(trk, st, ScanOutputs) of a runner call, the states ``states``."""
        return (*self.states(), self.outs)

    def close(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.trk = self.st = self.inp = self.out = self.outs = None
        self.handed = None


def stage_frames(imgs: Sequence[torch.Tensor], depths: Sequence[torch.Tensor],
                 seq_ts: Sequence[np.ndarray],
                 buffers: Optional[Sequence[est.ImuIntervalBuffer]],
                 k0: int, k1: int, device, dtype=torch.float32,
                 max_imu: int = 32) -> FrameBatch:
    """Stage frames [k0, k1) of B sequences: rendered images/depths
    (per-sequence (N, H, W) device stacks) and the IMU interval of each
    frame, paired on the host and uploaded once.  Frame 0's interval is
    (t0 − 1 ms, t0], as the host estimator pairs it.  With ``buffers``
    None (VO) every interval is empty: ``max_imu`` zero samples."""
    B = len(imgs)
    T = k1 - k0
    maxi = buffers[0].max_imu if buffers is not None else max_imu
    dts = np.zeros((T, B, maxi))
    acc = np.zeros((T, B, maxi + 1, 3))
    gyr = np.zeros((T, B, maxi + 1, 3))
    for b in range(B if buffers is not None else 0):
        for i, k in enumerate(range(k0, k1)):
            t_prev = float(seq_ts[b][k - 1]) if k > 0 else float(seq_ts[b][0]) - 1e-3
            dts[i, b], acc[i, b], gyr[i, b] = buffers[b].collect(t_prev, float(seq_ts[b][k]))
    ts = np.stack([np.asarray(seq_ts[b][k0:k1]) for b in range(B)], axis=1)

    def put(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return FrameBatch(
        imgs=torch.stack([im[k0:k1] for im in imgs], dim=1).to(device=device, dtype=dtype),
        depths=torch.stack([d[k0:k1] for d in depths], dim=1).to(device=device, dtype=dtype),
        ts=put(ts), imu_dts=put(dts), imu_acc=put(acc), imu_gyr=put(gyr))


class BatchedVioRunner:
    """Batched multi-sequence VIO (or VO), on one device or sharded by lane
    over a mesh of devices.

    Any ``EstimatorConfig`` (one for all sequences): lanes warmed by
    ``VinsPipeline`` and stacked (``stack_states``), or, with static init,
    by ``warm``, which runs the window-filling frames and the static
    initialization in lock step; ``run`` then processes T steady frames on
    ``device``, replaying the frame it captured (``_FrameProgram``; each
    shard keeps one until its layout changes or ``close``).  With ``mesh``
    (devices, one shard each, B divisible by their number; ``device``
    defaults to its first), ``run_sharded`` runs shard i's lanes on
    ``mesh[i]``.  RANSAC draws come from one
    ``torch.Generator`` per sequence, seeded ``seed + b``, on lane b's
    device; in VO mode the PnP draws from another, seeded
    ``seed + PNP_SEED + b``."""

    PNP_SEED = 1000

    def __init__(self, tcfg: TrackerConfig, cam: CameraModel, ecfg: EstimatorConfig,
                 device, B: int, seed: int = 17, mesh: Optional[Sequence] = None):
        # the batched envelope: LK capped at 12 fine / 6 coarse iterations;
        # "auto" is the whole-level kernel K2, as JAX picks on TPU
        eng = "pallas3" if tcfg.lk_engine == "auto" else tcfg.lk_engine
        self.tcfg = dataclasses.replace(tcfg, lk_engine=eng,
                                        lk_max_iters=min(tcfg.lk_max_iters, 12),
                                        lk_coarse_iters=min(tcfg.lk_coarse_iters, 6))
        self.cam = cam
        self.ecfg = ecfg
        if device is None and not mesh:
            raise ValueError("BatchedVioRunner: a device or a mesh")
        self.device = _indexed(device if device is not None else mesh[0])
        self.mesh = mesh_of(mesh) if mesh else (self.device,)
        if B % len(self.mesh):
            raise ValueError(f"BatchedVioRunner: {B} lanes do not split over a mesh of "
                             f"{len(self.mesh)} devices")
        self.B = B
        self.generators = self._generators(seed)
        self.pnp_generators = None if ecfg.use_imu else self._generators(seed + self.PNP_SEED)
        self._prog: Optional[_FrameProgram] = None
        self._shards = [self._shard(i) for i in range(len(self.mesh))]

    def _generators(self, seed: int) -> List[torch.Generator]:
        """One per lane, on the device of the lane's shard."""
        gens = []
        for b in range(self.B):
            g = torch.Generator(device=self.mesh[b // (self.B // len(self.mesh))])
            g.manual_seed(seed + b)
            gens.append(g)
        return gens

    def _shard(self, i: int) -> "BatchedVioRunner":
        """Shard i as a one-device runner over its lanes, sharing their
        generators with this runner."""
        n = self.B // len(self.mesh)
        view = copy.copy(self)
        view.device, view.mesh, view.B = self.mesh[i], (self.mesh[i],), n
        view.generators = self.generators[i * n:(i + 1) * n]
        if self.pnp_generators is not None:
            view.pnp_generators = self.pnp_generators[i * n:(i + 1) * n]
        view._prog, view._shards = None, []  # no reference back: no cycle keeps a graph alive
        return view

    def _one_device(self, name: str) -> None:
        if any(d != self.device for d in self.mesh):
            raise ValueError(f"{name} runs every lane on {self.device}, but this runner's "
                             f"lanes lie on {[str(d) for d in self.mesh]}: run_sharded")

    def ransac_uniforms(self):
        return ransac_ops.draw_uniforms(self.generators, self.tcfg.ransac_trials,
                                        self.tcfg.maxc, self.device)

    def pnp_uniforms(self):
        """(B, 32, MAXF) uniforms of the VO pose init (None with an IMU)."""
        if self.pnp_generators is None:
            return None
        return ransac_ops.draw_uniforms(self.pnp_generators, ransac_ops.PNP_TRIALS,
                                        self.ecfg.maxf, self.device)

    def init_states(self, ric, tic, td: float = 0.0):
        trk = ft.init_state(self.tcfg, self.B, self.device)
        st = est.init_estimator_state(self.ecfg, ric, tic, td, self.B, self.device)
        return trk, st

    def warm(self, trk, st, batch: FrameBatch):
        """Frames 0..WINDOW_SIZE of ``batch`` fill the window (tracker,
        depth lookup, ``fill_step``), then the static initialization runs;
        returns (trk, st, StepOutput).  Static initialization only: a rig
        with ``static_init`` 0 warms its lanes through ``VinsPipeline``."""
        if self.ecfg.use_imu and not self.ecfg.static_init:
            raise NotImplementedError(
                "BatchedVioRunner.warm runs the static initialization only; for static_init 0 "
                "warm one VinsPipeline per sequence until NON_LINEAR (init_dynamic or "
                "init_mono), then stack_states(pipes), stage_frames_arrays(pipes, ...) and run")
        self._one_device("warm")
        if batch.ts.shape[0] != WINDOW_SIZE + 1:
            raise ValueError(f"warm needs {WINDOW_SIZE + 1} frames")
        for k in range(WINDOW_SIZE + 1):
            imu = est.ImuInterval(batch.imu_dts[k], batch.imu_acc[k], batch.imu_gyr[k])
            relR = gyro_relative_R(imu.dts, imu.gyr, st.x.Bg[:, WINDOW_SIZE], st.x.qic)
            trk, tout = ft.track_frame(self.tcfg, self.cam, trk, batch.imgs[k], batch.ts[k],
                                       relR, self.ransac_uniforms())
            feats = tout.features
            feats = feats._replace(depth=ft.lookup_depth(batch.depths[k], feats.uv,
                                                         feats.ids >= 0))
            st, _ = est.fill_step(self.ecfg, st, k, feats, imu)
        st, out = est.init_full(self.ecfg, st)
        return trk, st, out

    def run(self, trk, st, batch: FrameBatch):
        """T steady frames on ``device``: per frame, each lane's draws from
        its generators, then the captured frame replayed (``_FrameProgram``;
        the first frame of a new shape warms up and captures it; on the CPU
        the same program runs eagerly); returns (trk, st, ScanOutputs
        (T, B, ...)), states of the caller's own."""
        self._one_device("run")
        with TRACER.frame("runner::run"):
            with TRACER.span("runner::inputs"):
                prog = self._program(trk, st, batch)
            for k in range(batch.ts.shape[0]):
                with TRACER.span("runner::draws"):
                    u, pnp_u = self.ransac_uniforms(), self.pnp_uniforms()
                prog.frame(batch, k, u, pnp_u)
            with TRACER.span("runner::states"):
                return prog.result()

    def run_chained(self, trk, st, batch: FrameBatch):
        """JAX's host-dispatched twin of its scanned ``run`` (one compiled
        step per frame): here ``run`` itself replays one captured step per
        frame, so this is ``run``."""
        return self.run(trk, st, batch)

    def run_eager(self, trk, st, batch: FrameBatch):
        """``run`` dispatched op by op (``fused_frame_step`` per frame, no
        static buffers, no graph): the plain version ``run``'s replay is
        held to."""
        self._one_device("run_eager")
        outs = []
        for k in range(batch.ts.shape[0]):
            imu = est.ImuInterval(batch.imu_dts[k], batch.imu_acc[k], batch.imu_gyr[k])
            ransac_u = self.ransac_uniforms()
            trk, st, sout = fused_frame_step(self.tcfg, self.cam, self.ecfg, trk, st,
                                             batch.imgs[k], batch.depths[k], batch.ts[k],
                                             imu, ransac_u, pnp_u=self.pnp_uniforms())
            outs.append(_scan_outputs(sout))
        return trk, st, ScanOutputs(*[torch.stack(f) for f in zip(*outs)])

    def _program(self, trk, st, batch: FrameBatch) -> _FrameProgram:
        """This shard's frame program for these layouts (kept while they
        stay, made anew when they change), loaded with the states."""
        frame = FrameBatch(*(a[0] for a in batch))
        layout = _layout((trk, st, frame))
        if self._prog is None or self._prog.layout != layout:
            self.close()
            self._prog = _FrameProgram(self.tcfg, self.cam, self.ecfg, layout, trk, st)
        self._prog.load(trk, st, batch.ts.shape[0])
        return self._prog

    def close(self) -> None:
        """Release every shard's frame program: its buffers, its graph and
        the graph's memory pool (a later ``run`` captures again)."""
        for r in [self] + [v for v in self._shards if v is not self]:
            if r._prog is not None:
                r._prog.close()
                r._prog = None

    # -- the mesh ----------------------------------------------------------
    def shard_spec(self, ndim_batch_axis: int = 0) -> "ShardSpec":
        """How a tree with its lane axis at ``ndim_batch_axis`` is split:
        lanes in order over the runner's mesh."""
        return ShardSpec(self.mesh, ndim_batch_axis)

    def put_batch(self, tree) -> "Sharded":
        """A (T, B, ...) tree (a ``FrameBatch``) split by lane, each
        shard's lanes copied to its device."""
        return self.shard_spec(1).place(tree)

    def put_states(self, tree) -> "Sharded":
        """A (B, ...) tree (tracker or estimator states) split by lane, each
        shard's lanes copied to its device."""
        return self.shard_spec(0).place(tree)

    def run_sharded(self, trk: "Sharded", st: "Sharded", batch: "Sharded"):
        """T frames of every shard, each on its own device, from states
        placed by ``put_states`` and a batch placed by ``put_batch`` (or
        ``Sharded`` trees of the same layout, such as this method's own
        results): frame by frame, shard 0, 1, ... replays its captured frame
        in turn from the calling thread (``on_shards``), as ``run`` does;
        returns (trk, st, ScanOutputs), all ``Sharded`` (the outputs on lane
        axis 1).  A shard's exception is raised once every shard has run
        that frame."""
        for name, tree, axis in (("tracker states", trk, 0), ("estimator states", st, 0),
                                 ("batch", batch, 1)):
            self.shard_spec(axis).check(tree, f"run_sharded: the {name}")
        shards = self._shards

        def draws(i):
            with TRACER.span("runner::draws"):
                return shards[i].ransac_uniforms(), shards[i].pnp_uniforms()

        with TRACER.frame("runner::run"):
            with TRACER.span("runner::inputs"):
                progs = on_shards(self.mesh, lambda i: shards[i]._program(
                    trk.parts[i], st.parts[i], batch.parts[i]))
            for k in range(batch.parts[0].ts.shape[0]):
                on_shards(self.mesh, lambda i: progs[i].frame(batch.parts[i], k, *draws(i)))
            with TRACER.span("runner::states"):
                res = [p.result() for p in progs]
        return (Sharded(self.mesh, [r[0] for r in res], 0),
                Sharded(self.mesh, [r[1] for r in res], 0),
                Sharded(self.mesh, [r[2] for r in res], 1))


def _indexed(device) -> torch.device:
    """``device`` with its index (a bare "cuda" is the current device)."""
    d = torch.device(device)
    return torch.device("cuda", torch.cuda.current_device()) \
        if d.type == "cuda" and d.index is None else d


def mesh_of(devices: Sequence) -> tuple:
    """A mesh: the devices, each with its index, one shard each."""
    return tuple(_indexed(d) for d in devices)


class Sharded:
    """A tree split by lane over a mesh (the port's twin of a JAX array
    sharded on its lane axis): ``parts[i]`` holds shard i's lanes, in lane
    order, on ``mesh[i]``; ``axis`` is every leaf's lane axis (0 for
    states, 1 for a (T, B, ...) ``FrameBatch`` or ``ScanOutputs``)."""

    def __init__(self, mesh: Sequence, parts: Sequence, axis: int = 0):
        if len(parts) != len(mesh):
            raise ValueError(f"Sharded: {len(parts)} parts for a mesh of {len(mesh)}")
        self.mesh = mesh_of(mesh)
        self.parts = tuple(parts)
        self.axis = axis

    def devices(self) -> set:
        """The devices the leaves live on."""
        return {a.device for p in self.parts for a in leaves(p)}

    def gather(self, device):
        """The whole tree on ``device``: the shards' lanes concatenated in
        order."""
        return _cat_trees([map_tree(lambda a: a.to(device), p) for p in self.parts],
                          self.axis)


class ShardSpec(NamedTuple):
    """Lanes split in order over ``mesh``, along each leaf's ``axis``."""
    mesh: tuple
    axis: int

    def place(self, tree) -> Sharded:
        """``tree`` (lane axis ``axis``) split into equal shards, each copied
        to its device (a B the mesh does not divide raises ``ValueError``,
        as JAX's ``shard_map`` does)."""
        B = leaves(tree)[0].shape[self.axis]
        n = len(self.mesh)
        if B % n:
            raise ValueError(f"{B} lanes do not split over a mesh of {n} devices")
        per = B // n
        return Sharded(self.mesh, [
            map_tree(lambda a: a.narrow(self.axis, i * per, per).to(d, copy=True).contiguous(),
                     tree)
            for i, d in enumerate(self.mesh)], self.axis)

    def check(self, tree, what: str) -> None:
        """Raise ``ValueError`` unless ``tree`` is ``Sharded`` as this spec
        places it: this mesh, this axis, every leaf of shard i on
        ``mesh[i]`` with the same number of lanes."""
        if not isinstance(tree, Sharded) or tree.mesh != tuple(self.mesh) \
                or tree.axis != self.axis:
            raise ValueError(f"{what} are not split over the mesh "
                             f"{[str(d) for d in self.mesh]} on axis {self.axis} "
                             "(put_states/put_batch)")
        lanes = set()
        for d, part in zip(self.mesh, tree.parts):
            for a in leaves(part):
                if a.device != d:
                    raise ValueError(f"{what}: a leaf of the shard of {d} lies on {a.device}")
                lanes.add(a.shape[self.axis])
        if len(lanes) > 1:
            raise ValueError(f"{what}: shards of unequal lanes {sorted(lanes)}")


def on_shards(mesh: Sequence[torch.device], fn: Callable[[int], object]) -> list:
    """``fn(i)`` for every shard i of ``mesh`` in turn, from the calling
    thread, each under its device (so on that device's current stream);
    the results in shard order.  Every shard runs; then the exception of
    the first shard that raised, if any, is raised here, with a note
    naming the shard and its device."""
    results: list = []
    first = None
    for i, d in enumerate(mesh):
        try:
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                results.append(fn(i))
        except Exception as e:  # raised below, once every shard has run
            results.append(None)
            if first is None:
                e.add_note(f"in shard {i} of {len(mesh)}, on {d}")
                first = e
    if first is not None:
        raise first
    return results


def leaves(tree) -> list:
    """The tensors of a NamedTuple tree, in field order (None skipped)."""
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def map_tree(fn, tree):
    """``fn`` over every tensor of a NamedTuple tree (None kept)."""
    if isinstance(tree, tuple):
        return type(tree)(*[map_tree(fn, v) for v in tree]) if hasattr(tree, "_fields") \
            else tuple(map_tree(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _cat_trees(trees, dim: int = 0):
    first = trees[0]
    if isinstance(first, tuple):
        parts = [_cat_trees([t[i] for t in trees], dim) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    return None if first is None else torch.cat(list(trees), dim)


def stack_states(pipes) -> Tuple[ft.TrackerState, est.EstimatorState]:
    """Per-sequence ``VinsPipeline``s (each B = 1, after any initialization
    program) -> the runner's batched (tracker states, estimator states),
    sequence b from ``pipes[b]``: lanes warmed by the latency pipeline
    continue on ``BatchedVioRunner``."""
    return (_cat_trees([p.tracker_state for p in pipes]),
            _cat_trees([p.estimator.state for p in pipes]))


def stage_frames_arrays(pipes, seq_ts, seq_imgs, seq_depths, t_start: int, t_end: int,
                        dtype=torch.float32) -> FrameBatch:
    """A ``FrameBatch`` of frames [t_start, t_end) from per-sequence
    pre-rendered device stacks (``seq_imgs[b]``/``seq_depths[b]`` (N, H, W),
    ``seq_ts[b]`` (N,)): one stack per field on the images' device, and the
    IMU intervals paired by each lane's ``estimator._collect_interval_np``
    at that lane's host td (``estimator._td_cache``: frame k's interval is
    (t[k-1] + td, t[k] + td], where the lane's pipeline left off; frame 0's
    starts 1 ms before, as ``stage_frames`` pairs it), uploaded once."""
    B = len(pipes)
    T = t_end - t_start
    device = seq_imgs[0].device
    maxi = pipes[0].estimator.cfg.max_imu
    dts = np.zeros((T, B, maxi))
    acc = np.zeros((T, B, maxi + 1, 3))
    gyr = np.zeros((T, B, maxi + 1, 3))
    for b in range(B):
        td = pipes[b].estimator._td_cache
        for i, k in enumerate(range(t_start, t_end)):
            t_prev = float(seq_ts[b][k - 1]) if k > 0 else float(seq_ts[b][0]) - 1e-3
            dts[i, b], acc[i, b], gyr[i, b] = pipes[b].estimator._collect_interval_np(
                t_prev + td, float(seq_ts[b][k]) + td)
    ts = np.stack([np.asarray(seq_ts[b][t_start:t_end]) for b in range(B)], axis=1)

    def put(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return FrameBatch(
        imgs=torch.stack([im[t_start:t_end] for im in seq_imgs], dim=1).to(dtype),
        depths=torch.stack([d[t_start:t_end] for d in seq_depths], dim=1).to(dtype),
        ts=put(ts), imu_dts=put(dts), imu_acc=put(acc), imu_gyr=put(gyr))
