"""Single-sequence VIO pipeline: stream pairing → frontend tracking →
backend solve (twin of ``VinsPipeline`` in ``vins_rgbd_fast_tpu/
pipeline.py``), the system's low-latency entry point for one robot.

Until the estimator is NON_LINEAR a frame runs unfused: ``track_frame``
(its LK levels through kernel K3, ``TrackerConfig.lk_engine="auto"``),
the depth lookup and ``VinsEstimator.process_features``.  With
``fused_steady_state`` a steady frame then runs ``fused_frame_step`` at
B = 1 (on-device gyro prediction → tracker → depth lookup → ``vio_step``)
with one small upload: the timestamp and IMU interval packed into one
buffer, staged through a ring of pinned host buffers so the copy does not
wait on the host; with fast relocalization the buffer also carries the
pending relocalization constraint (inactive when none is pending: the
constraint is data, so one program serves both).  Frames pushed as numpy
arrays (decoded bag or TUM frames) go to the card the same way, through a
ring of their own for the images and one for the depths.

That steady frame is JAX's one-dispatch ``fused`` frame: with ``replay``
(the default) it runs as a ``_FrameProgram`` (``parallel/
batched_pipeline.py``), which on CUDA captures the first steady frame of
a layout as a CUDA graph and replays it for every later frame (on the CPU
the same static-buffer step runs eagerly); ``replay=False`` dispatches it
op by op, the plain version the program is held to.  The host keeps, on
either path, the td refresh and copy, the IMU pairing, the relo queue, the
draws, the failure check and the bookkeeping.  Each frame's outputs and
new states are copied out of the program's buffers, so an output or state
the caller keeps does not change under it; a state the program did not
hand out (after the unfused frames, a failure reset, a stream
discontinuity, a resumed checkpoint or a caller's own) is loaded into the
buffers at the next steady frame, and a tracker or estimator config
replaced after construction makes a new program (JAX retraces ``fused``).

With ``loop_closure`` the pipeline owns a ``PoseGraph``.  With
``eager_outputs`` every keyframe goes to it inline, in the frame's
``spin_once``; without, steady frames go to an ``AsyncLoopStager``, whose
worker thread runs the pose graph on a stream of its own (``run`` and
``drain`` wait for it).  A loop's relocalization constraint comes back
through ``VinsEstimator.set_relo_frame`` and the solve's refined relo pose
goes back to the graph (``PoseGraph.update_keyframe_loop``).

Without an IMU (``vcfg.imu`` off, VO mode: the TUM RGB-D rig) no frame
waits for IMU samples, the tracker runs cold LK from the previous positions
on 4 pyramid levels, the estimator initialises each new pose by PnP and the
pose graph is the 6-DoF one.

With ``equalize`` the tracker runs CLAHE before its pyramid and with
``fisheye`` it masks detections and tracks (``frontend/feature_tracker``);
the pose graph's keyframe images stay the raw frames, as in JAX.

The estimator runs the rig's initialization (static, or dynamic with the
monocular fallback), its online td estimation (the td the host pairs IMU
intervals with is refreshed from the state every ``max(failure_check_
interval, 4)`` frames, on both paths) and its extrinsic calibration
(``estimate_extrinsic`` 2: on the unfused path only, as in JAX).

RANSAC draws come from one ``torch.Generator`` per pipeline, or from a
``ransac_uniforms(fused, index)`` callable (tests inject the JAX draws:
``index`` is the frame counter on the unfused path and the fused-step
counter on the fused one, as JAX keys them); the VO pose init's PnP draws
from the estimator's generator or ``vo_pnp_uniforms(fused, index)``
(``index``: the estimator's step unfused, the fused-step counter fused); a
loop check's PnP draws from the pose graph's generator or
``pnp_uniforms(keyframe index, n)``; the initializations' and the hand-eye
calibration's from the estimator's generator or ``init_uniforms(step)``
and ``ex_uniforms(step, n)`` (``VinsEstimator``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from .backend import estimator as est
from .config import TrackerConfig, VinsConfig
from .frontend import feature_tracker as ft
from .io import stream as io_stream
from .loop.pose_graph import KeyframeGate, PoseGraph, PoseGraphConfig, relo_relative_pose
from .ops import solver as slv
from .parallel.batched_pipeline import _FrameProgram, _layout, fused_frame_step, map_tree
from .parallel.loop_closer import AsyncLoopStager
from .utils.timing import TRACER

_RING = 4  # pinned upload buffers in flight


def _unpack_relo(dev: torch.Tensor, maxf: int) -> slv.ReloData:
    """The relo block of the packed upload (``VinsPipeline._pack_relo``) as
    views of it."""
    return slv.ReloData(active=dev[0:1] > 0.5, P=dev[None, 1:4], Q=dev[None, 4:8],
                        match_pts=dev[8:8 + 2 * maxf].reshape(1, maxf, 2),
                        match_valid=dev[None, 8 + 2 * maxf:8 + 3 * maxf] > 0.5,
                        match_ids=dev[8 + 3 * maxf:].view(torch.int32)[None])


def _unpack_packed(ecfg, dev: torch.Tensor):
    """The packed upload of a steady frame as views: (t (1,), its
    ``ImuInterval``, its ``ReloData`` with ``fast_relo``, else None)."""
    maxi = ecfg.max_imu
    n_imu = 1 + maxi + 6 * (maxi + 1)
    imu = est.ImuInterval(dts=dev[None, 1:1 + maxi],
                          acc=dev[1 + maxi:1 + maxi + 3 * (maxi + 1)].reshape(1, maxi + 1, 3),
                          gyr=dev[1 + maxi + 3 * (maxi + 1):n_imu].reshape(1, maxi + 1, 3))
    relo = _unpack_relo(dev[n_imu:], ecfg.maxf) if ecfg.fast_relo else None
    return dev[0:1], imu, relo


def _frame_args(ecfg, inp):
    """``fused_frame_step``'s frame arguments from the latency program's
    slots: (image, depth, packed upload, RANSAC uniforms, PnP uniforms or
    None)."""
    img, depth, packed, u, pnp_u = inp
    t, imu, relo = _unpack_packed(ecfg, packed)
    return img, depth, t, imu, u, relo, pnp_u


def _whole_output(sout: est.StepOutput) -> est.StepOutput:
    """The latency program keeps the whole ``StepOutput``."""
    return sout


class VinsPipeline:
    """End-to-end RGB-D inertial odometry over one sensor stream."""

    def __init__(self, vcfg: VinsConfig, device, dtype=torch.float32,
                 eager_outputs: bool = True, failure_check_interval: int = 1,
                 fused_steady_state: bool = False,
                 ransac_uniforms: Optional[Callable] = None,
                 pose_graph_config: Optional[PoseGraphConfig] = None,
                 pnp_uniforms: Optional[Callable] = None,
                 vo_pnp_uniforms: Optional[Callable] = None,
                 init_uniforms: Optional[Callable] = None,
                 ex_uniforms: Optional[Callable] = None, replay: bool = True):
        self.vcfg = vcfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.cam = vcfg.camera()
        self.tcfg = TrackerConfig(
            width=vcfg.image_width, height=vcfg.image_height, max_cnt=vcfg.max_cnt,
            capacity=vcfg.feature_capacity, min_dist=vcfg.min_dist,
            grid_rows=vcfg.num_grid_rows, grid_cols=vcfg.num_grid_cols,
            f_threshold=vcfg.f_threshold, fast_threshold=float(vcfg.fast_threshold),
            equalize=bool(vcfg.equalize), fisheye=bool(vcfg.fisheye),
            fisheye_mask_path=vcfg.fisheye_mask, use_imu_prediction=bool(vcfg.imu))
        self._vo_pnp_uniforms = vo_pnp_uniforms
        self.estimator = est.VinsEstimator(
            vcfg, self.device, dtype, eager_outputs=eager_outputs,
            failure_check_interval=failure_check_interval,
            pnp_uniforms=(None if vo_pnp_uniforms is None
                          else (lambda step: vo_pnp_uniforms(False, step))),
            init_uniforms=init_uniforms, ex_uniforms=ex_uniforms)
        self.tracker_state = ft.init_state(self.tcfg, 1, self.device, dtype)
        self.pairer = io_stream.StreamPairer(frontend_freq=vcfg.frontend_freq,
                                             publish_freq=vcfg.freq)
        self._frame_idx = 0
        self._fused_step = 0
        self._held_frame = None  # paired frame waiting on IMU coverage
        self._last_frame_time: Optional[float] = None
        self._imu_for_predict: list = []  # (t, gyr)
        self._bg_cache = np.zeros(3)
        self._fused_enabled = fused_steady_state
        self.replay = replay
        self._prog: Optional[_FrameProgram] = None  # the steady frame's program (``replay``)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        self._ransac_uniforms = ransac_uniforms
        self._rings: dict = {}  # name -> [(pinned buffer, copy-done event)], next slot

        # loop closure (the reference's pose-graph nodelet)
        self.pose_graph: Optional[PoseGraph] = None
        self._loop_stager: Optional[AsyncLoopStager] = None
        if vcfg.loop_closure:
            pg_cfg = pose_graph_config or PoseGraphConfig(max_wp=vcfg.feature_capacity,
                                                          use_6dof=not vcfg.imu)
            self.pose_graph = PoseGraph(pg_cfg, self.cam, vcfg.ric_matrix(), vcfg.tic_vector(),
                                        self.device, dtype, pnp_uniforms=pnp_uniforms)
            self._kf_gate = KeyframeGate(vcfg.skip_cnt, vcfg.skip_dis)
            self._relo_sent_kf: Optional[int] = None  # keyframe awaiting its relo result
            if not eager_outputs:
                self._loop_stager = AsyncLoopStager(
                    self.pose_graph, self.estimator, skip_cnt=vcfg.skip_cnt,
                    skip_dis=vcfg.skip_dis, fast_relocalization=vcfg.fast_relocalization)

    # ------------------------------------------------------------------
    def push_imu(self, t: float, acc, gyr):
        self.estimator.push_imu(t, acc, gyr)
        self._imu_for_predict.append((float(t), np.asarray(gyr, np.float64)))
        if len(self._imu_for_predict) > 4000:
            del self._imu_for_predict[:2000]

    def push_image(self, t: float, image):
        """``image`` (H, W) gray levels: numpy, or a tensor already on the device."""
        self.pairer.push_image(io_stream.ImageMsg(t=float(t), image=image))

    def push_depth(self, t: float, depth):
        """``depth`` (H, W) metres: numpy, or a tensor already on the device."""
        self.pairer.push_depth(io_stream.DepthMsg(t=float(t), depth=depth))

    # ------------------------------------------------------------------
    def _predict_relative_R(self, t0: float, t1: float) -> np.ndarray:
        """Gyro-only camera-frame relative rotation R_c1<-c0 for the tracker
        prediction (numpy; the gyro bias is a host cache, kept at zero)."""
        samples = [s for s in self._imu_for_predict if t0 < s[0] <= t1]
        if len(samples) < 1:
            return np.eye(3)
        bg = self._bg_cache
        R = np.eye(3)
        t_prev = t0
        for (ts, w) in samples:
            th = (w - bg) * (ts - t_prev)
            a = np.linalg.norm(th)
            if a > 1e-12:
                k = th / a
                K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
                R = R @ (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K))
            t_prev = ts
        ric = self.vcfg.ric_matrix()
        return ric.T @ R.T @ ric

    def _uniforms(self, fused: bool, index: int) -> torch.Tensor:
        """(1, ransac_trials, MAXC) RANSAC uniforms."""
        shape = (self.tcfg.ransac_trials, self.tcfg.maxc)
        if self._ransac_uniforms is not None:
            u = torch.tensor(np.asarray(self._ransac_uniforms(fused, index)))
            return u.reshape(shape)[None].to(self.device)
        return torch.rand((1,) + shape, generator=self._generator, device=self.device,
                          dtype=self.dtype)

    def _vo_uniforms(self, fused_step: int) -> torch.Tensor:
        """(1, 32, MAXF) PnP uniforms of a fused VO frame."""
        if self._vo_pnp_uniforms is None:
            return self.estimator.draw_pnp_uniforms(self.estimator._step)
        u = torch.tensor(np.asarray(self._vo_pnp_uniforms(True, fused_step)), dtype=self.dtype)
        return u.reshape(-1, self.estimator.cfg.maxf)[None].to(self.device)

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)[None]

    def _reset_tracker(self):
        self.tracker_state = ft.init_state(self.tcfg, 1, self.device, self.dtype)

    # ------------------------------------------------------------------
    def spin_once(self):
        """Process at most one paired frame; returns odometry or None.
        Traced as the root span ``vins::frame`` (``utils/timing``)."""
        with TRACER.frame("vins::frame"):
            return self._spin()

    def _spin(self):
        with TRACER.span("vins::pair"):
            frame = self._held_frame
            self._held_frame = None
            if frame is None:
                frame = self.pairer.next_frame()
            if frame is None:
                return None
            if self.pairer.consume_reset():
                self._reset_tracker()
                self.estimator.reset()
                self.estimator.prev_time = None
                if self.pose_graph is not None:
                    self._relo_sent_kf = None  # the reset dropped its constraint
                    self.pose_graph.new_sequence()  # a discontinuity starts a new sequence

            t = frame.t
            # the backend needs IMU coverage up to t + td: hold the frame (it is
            # already popped from the pairer) and retry on the next spin
            if self.vcfg.imu and not self.estimator.imu_available(t + self.vcfg.td):
                TRACER.count("vins::held")
                self._held_frame = frame
                return None
        t_last = self._last_frame_time
        self._last_frame_time = t

        if (self._fused_enabled and frame.publish
                and self.estimator.solver_flag == est.VinsEstimator.NON_LINEAR):
            TRACER.count("vins::fused")
            with TRACER.span("vins::upload"):
                img = self._frame_on_device(frame.image, "image")
                depth = self._frame_on_device(frame.depth, "depth")
            out = self._spin_fused(img, depth, t)  # gyro prediction on the device
            if self.pose_graph is not None and out is not None:
                if isinstance(out, dict):
                    with TRACER.span("vins::keyframe"):
                        self._consume_relo_result(out)
                        self._maybe_add_keyframe(out, img[0], depth[0], t)
                elif self._loop_stager is not None:
                    with TRACER.span("vins::loop_handoff"):
                        self._loop_stager.on_frame(out, img[0], t, depth=depth[0],
                                                   frame=TRACER.current_frame())
            return out

        with TRACER.span("vins::tracker_only"):
            rel_R = (self._predict_relative_R(t_last if t_last else t - 1e-3, t)
                     if self.vcfg.imu else np.eye(3))
            img = self._frame_on_device(frame.image, "image")
            self.tracker_state, tout = ft.track_frame(
                self.tcfg, self.cam, self.tracker_state, img,
                self._on_device(t), self._on_device(rel_R),
                self._uniforms(False, self._frame_idx))
            self._frame_idx += 1
            if not frame.publish:
                return None
            TRACER.count("vins::unfused")
            depth = self._frame_on_device(frame.depth, "depth")
            feats = tout.features
            feats = feats._replace(depth=ft.lookup_depth(depth, feats.uv, feats.ids >= 0))
            out = self.estimator.process_features(feats, t)
        if self.pose_graph is not None and isinstance(out, dict):
            with TRACER.span("vins::keyframe"):
                self._consume_relo_result(out)
                self._maybe_add_keyframe(out, img[0], depth[0], t)
        return out

    # ------------------------------------------------------------------
    def _pinned_upload(self, arr: np.ndarray, ring: str) -> torch.Tensor:
        """Copy a host array to the device without a host wait: through the
        named ring of pinned buffers, each reused only once its last copy
        has completed."""
        if self.device.type != "cuda":
            return torch.from_numpy(arr.copy()).to(self.device)
        bufs, pos = self._rings.get(ring, (None, 0))
        if bufs is None or bufs[0][0].shape != arr.shape or bufs[0][0].numpy().dtype != arr.dtype:
            bufs, pos = [(torch.from_numpy(np.empty(arr.shape, arr.dtype)).pin_memory(),
                          torch.cuda.Event()) for _ in range(_RING)], 0
        buf, done = bufs[pos]
        self._rings[ring] = (bufs, (pos + 1) % _RING)
        if not done.query():
            with TRACER.wait("wait::ring"):
                done.synchronize()
        buf.numpy()[:] = arr
        dev = buf.to(self.device, non_blocking=True)
        done.record()
        return dev

    def _frame_on_device(self, a, ring: str) -> torch.Tensor:
        """A (H, W) frame as a (1, H, W) device tensor of the pipeline's
        dtype: a numpy frame (a decoded bag or TUM frame) goes to the card
        through its own pinned ring."""
        if isinstance(a, torch.Tensor) or self.device.type != "cuda":
            return self._on_device(a)
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        return self._pinned_upload(np.asarray(a, np_dtype), ring)[None]

    @staticmethod
    def _pack_relo(relo: Optional[dict], maxf: int) -> np.ndarray:
        """The relo block of the packed upload: active, P (3), Q (4), the
        matched points (2·maxf), their mask (maxf) and the feature ids
        (maxf int32, bit-cast); an inactive constraint when ``relo`` is None."""
        out = np.zeros(8 + 4 * maxf, np.float32)
        out[4] = 1.0
        ids = np.full(maxf, -1, np.int32)
        if relo is not None:
            out[0] = 1.0
            out[1:4], out[4:8] = relo["P"], relo["Q"]
            out[8:8 + 2 * maxf] = relo["match_pts"].ravel()
            out[8 + 2 * maxf:8 + 3 * maxf] = relo["match_valid"]
            ids = relo["match_ids"]
        out[8 + 3 * maxf:] = ids.view(np.float32)
        return out

    def _spin_fused(self, img: torch.Tensor, depth: torch.Tensor, t: float):
        """A steady frame as ``fused_frame_step`` at B = 1, replayed from its
        program (``replay``) or dispatched op by op; the bookkeeping of
        ``VinsEstimator.process_features`` (NON_LINEAR arm)."""
        est_ = self.estimator
        maxi = est_.cfg.max_imu
        with TRACER.span("vins::interval"):
            est_.refresh_td_cache()
            cur_time = t + est_._td_cache
            if est_.cfg.use_imu:
                dts, acc, gyr = est_._collect_interval_np(
                    est_.prev_time if est_.prev_time is not None else cur_time - 1e-3, cur_time)
            else:  # VO: an empty interval
                dts, acc, gyr = np.zeros(maxi), np.zeros((maxi + 1, 3)), np.zeros((maxi + 1, 3))
            est_.prev_time = cur_time
        with TRACER.span("vins::upload"):
            parts = [[t], dts, acc.ravel(), gyr.ravel()]
            if est_.cfg.fast_relo:
                parts.append(self._pack_relo(est_.take_relo(), est_.cfg.maxf))
            dev = self._pinned_upload(np.concatenate(parts).astype(np.float32), "packed")
        with TRACER.span("vins::draws"):
            u = self._uniforms(True, self._fused_step)
            pnp_u = None if est_.cfg.use_imu else self._vo_uniforms(self._fused_step)
        self._fused_step += 1
        if self.replay:
            with TRACER.span("vins::replay"):
                inputs = (img, depth, dev, u, pnp_u)
                prog = self._program(inputs)
                prog.put(inputs)
                prog.replay()
            with TRACER.span("vins::handout"):
                step_out = map_tree(torch.clone, prog.out)
                self.tracker_state, est_.state = prog.handed = prog.states()
        else:
            with TRACER.span("vins::replay"):
                t_dev, imu, relo = _unpack_packed(est_.cfg, dev)
                self.tracker_state, est_.state, step_out = fused_frame_step(
                    self.tcfg, self.cam, est_.cfg, self.tracker_state, est_.state,
                    img, depth, t_dev, imu, u, relo, pnp_u)
        self._frame_idx += 1
        est_.headers = est_.headers[1:] + [t]
        if est_.failed(step_out):
            est_.reset()  # drops a queued relocalization: its ids and world are gone
            est_.prev_time = None
            self._reset_tracker()
            if self.pose_graph is not None:
                self._relo_sent_kf = None
            est_._step += 1
            return None
        with TRACER.span("vins::emit"):
            out = est_._emit(step_out, t)
            est_._step += 1
            est_.stage_td_copy()
        return out

    def _program(self, inputs) -> _FrameProgram:
        """The steady frame's program for the current configs and layouts
        (kept while they stay; made anew when a config object or a layout
        changes), loaded with the pipeline's states unless they are the
        ones it handed out last."""
        est_ = self.estimator
        cfg = (self.tcfg, self.cam, est_.cfg)
        states = (self.tracker_state, est_.state)
        layout = _layout((states, inputs))
        prog = self._prog
        if prog is None or prog.layout != layout or any(a is not b for a, b in zip(prog.cfg, cfg)):
            self._release_program()
            prog = self._prog = _FrameProgram(*cfg, layout, *states,
                                              functools.partial(_frame_args, est_.cfg),
                                              _whole_output)
        if prog.handed is None or any(a is not b for a, b in zip(prog.handed, states)):
            prog.load(*states)
        return prog

    def _release_program(self) -> None:
        """Release the steady frame's program: its buffers, its graph and
        the graph's memory pool (the next steady frame makes a new one)."""
        if self._prog is not None:
            self._prog.close()
            self._prog = None

    # ------------------------------------------------------------------
    def _consume_relo_result(self, out: dict):
        """The solve optimized the relo pose alongside the window: the
        refined loop-relative pose goes back to the pose graph's drift."""
        if not out.get("relo_used") or self._relo_sent_kf is None:
            return
        kf_index, self._relo_sent_kf = self._relo_sent_kf, None
        self.pose_graph.update_keyframe_loop(kf_index, *relo_relative_pose(
            out["relo_P"], out["relo_Q"], out["relo_cur_P"], out["relo_cur_Q"]))

    def _maybe_add_keyframe(self, out: dict, img: torch.Tensor, depth: torch.Tensor, t: float):
        """Feed a keyframe to the pose graph, gated by ``skip_cnt`` and
        ``skip_dis``; a loop sends its relocalization constraint."""
        P = np.asarray(out["P"])
        if not self._kf_gate.admit(bool(out.get("is_keyframe")), P):
            return
        info = self.pose_graph.add_keyframe(img, t, P, np.asarray(out["Q"]), out["wp_world"],
                                            out["wp_uv"], out["wp_norm"], out["wp_valid"],
                                            depth=depth)
        if info is not None and self.vcfg.fast_relocalization:
            old = self.pose_graph.keyframes[info["old"]]
            self.estimator.set_relo_frame(info["matched_old_norm"], info["inlier_mask"],
                                          np.asarray(out["wp_ids"]), old.P_vio, old.Q_vio)
            self._relo_sent_kf = info["cur"]

    def corrected_trajectory(self) -> list:
        """Loop-corrected keyframe path (empty without loop closure)."""
        if self.pose_graph is None:
            return []
        return [dict(t=t, P=P, Q=Q, V=np.zeros(3)) for (t, P, Q) in self.pose_graph.path()]

    def drain(self):
        """Wait for the pose graph's worker (if any); raises its exception."""
        if self._loop_stager is not None:
            self._loop_stager.drain()

    def close(self):
        """Drain and stop the pose graph's worker thread; release the steady
        frame's program."""
        try:
            if self._loop_stager is not None:
                self._loop_stager.close()
        finally:
            self._release_program()

    def run(self, max_frames: int = 10 ** 9) -> list:
        """Drain the stream; returns the trajectory list."""
        n = 0
        while n < max_frames:
            out = self.spin_once()
            if out is None and self.pairer._img_buf == []:
                break
            if out is not None:
                n += 1
        self.drain()
        return self.estimator.trajectory
