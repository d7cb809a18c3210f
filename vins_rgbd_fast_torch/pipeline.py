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
wait on the host.  Loop closure is not ported: ``loop_closure=True``
raises ``NotImplementedError``.

RANSAC draws come from one ``torch.Generator`` per pipeline, or from a
``ransac_uniforms(fused, index)`` callable (tests inject the JAX draws:
``index`` is the frame counter on the unfused path and the fused-step
counter on the fused one, as JAX keys them).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .backend import estimator as est
from .config import TrackerConfig, VinsConfig
from .frontend import feature_tracker as ft
from .io import stream as io_stream
from .parallel.batched_pipeline import fused_frame_step
from .utils.timing import StageTimer

_RING = 4  # pinned upload buffers in flight


class VinsPipeline:
    """End-to-end RGB-D inertial odometry over one sensor stream."""

    def __init__(self, vcfg: VinsConfig, device, dtype=torch.float32,
                 eager_outputs: bool = True, failure_check_interval: int = 1,
                 fused_steady_state: bool = False,
                 ransac_uniforms: Optional[Callable] = None):
        if vcfg.loop_closure:
            raise NotImplementedError("loop closure is not ported yet")
        if vcfg.equalize or vcfg.fisheye:
            raise NotImplementedError("the port's tracker has no CLAHE and no fisheye mask")
        self.vcfg = vcfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.cam = vcfg.camera()
        self.tcfg = TrackerConfig(
            width=vcfg.image_width, height=vcfg.image_height, max_cnt=vcfg.max_cnt,
            capacity=vcfg.feature_capacity, min_dist=vcfg.min_dist,
            grid_rows=vcfg.num_grid_rows, grid_cols=vcfg.num_grid_cols,
            f_threshold=vcfg.f_threshold, fast_threshold=float(vcfg.fast_threshold))
        self.estimator = est.VinsEstimator(vcfg, self.device, dtype,
                                           eager_outputs=eager_outputs,
                                           failure_check_interval=failure_check_interval)
        self.tracker_state = ft.init_state(self.tcfg, 1, self.device, dtype)
        self.pairer = io_stream.StreamPairer(frontend_freq=vcfg.frontend_freq,
                                             publish_freq=vcfg.freq)
        self.timer = StageTimer()
        self._frame_idx = 0
        self._fused_step = 0
        self._held_frame = None  # paired frame waiting on IMU coverage
        self._last_frame_time: Optional[float] = None
        self._imu_for_predict: list = []  # (t, gyr)
        self._bg_cache = np.zeros(3)
        self._fused_enabled = fused_steady_state
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        self._ransac_uniforms = ransac_uniforms
        self._ring: list = []  # (pinned packed buffer, copy-done event)
        self._ring_pos = 0

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

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)[None]

    def _reset_tracker(self):
        self.tracker_state = ft.init_state(self.tcfg, 1, self.device, self.dtype)

    # ------------------------------------------------------------------
    def spin_once(self):
        """Process at most one paired frame; returns odometry or None."""
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

        t = frame.t
        # the backend needs IMU coverage up to t + td: hold the frame (it is
        # already popped from the pairer) and retry on the next spin
        if not self.estimator.imu_available(t + self.vcfg.td):
            self._held_frame = frame
            return None
        t_last = self._last_frame_time
        self._last_frame_time = t

        if (self._fused_enabled and frame.publish
                and self.estimator.solver_flag == est.VinsEstimator.NON_LINEAR):
            return self._spin_fused(frame)  # gyro prediction on the device

        rel_R = self._predict_relative_R(t_last if t_last else t - 1e-3, t)
        with self.timer.stage("frontend"):
            self.tracker_state, tout = ft.track_frame(
                self.tcfg, self.cam, self.tracker_state, self._on_device(frame.image),
                self._on_device(t), self._on_device(rel_R),
                self._uniforms(False, self._frame_idx))
        self._frame_idx += 1
        if not frame.publish:
            return None

        with self.timer.stage("depth_lookup"):
            feats = tout.features
            feats = feats._replace(depth=ft.lookup_depth(
                self._on_device(frame.depth), feats.uv, feats.ids >= 0))

        with self.timer.stage("backend"):
            return self.estimator.process_features(feats, t)

    # ------------------------------------------------------------------
    def _packed_upload(self, packed: np.ndarray) -> torch.Tensor:
        """Copy the packed frame inputs to the device without a host wait:
        a ring of pinned buffers, each reused only once its last copy has
        completed."""
        if self.device.type != "cuda":
            return torch.from_numpy(packed.copy()).to(self.device)
        if not self._ring:
            self._ring = [(torch.empty(packed.shape, dtype=torch.float32).pin_memory(),
                           torch.cuda.Event()) for _ in range(_RING)]
        buf, done = self._ring[self._ring_pos]
        self._ring_pos = (self._ring_pos + 1) % _RING
        if not done.query():
            done.synchronize()
        buf.numpy()[:] = packed
        dev = buf.to(self.device, non_blocking=True)
        done.record()
        return dev

    def _spin_fused(self, frame):
        """A steady frame as ``fused_frame_step`` at B = 1; the bookkeeping
        of ``VinsEstimator.process_features`` (NON_LINEAR arm)."""
        est_ = self.estimator
        maxi = est_.cfg.max_imu
        t = frame.t
        cur_time = t + est_._td_cache
        dts, acc, gyr = est_._collect_interval_np(
            est_.prev_time if est_.prev_time is not None else cur_time - 1e-3, cur_time)
        est_.prev_time = cur_time
        packed = np.concatenate([[t], dts, acc.ravel(), gyr.ravel()]).astype(np.float32)
        dev = self._packed_upload(packed)
        imu = est.ImuInterval(dts=dev[None, 1:1 + maxi],
                              acc=dev[1 + maxi:1 + maxi + 3 * (maxi + 1)].reshape(1, maxi + 1, 3),
                              gyr=dev[1 + maxi + 3 * (maxi + 1):].reshape(1, maxi + 1, 3))
        u = self._uniforms(True, self._fused_step)
        self._fused_step += 1
        with self.timer.stage("fused"):
            self.tracker_state, est_.state, step_out = fused_frame_step(
                self.tcfg, self.cam, est_.cfg, self.tracker_state, est_.state,
                self._on_device(frame.image), self._on_device(frame.depth), dev[0:1], imu, u)
        self._frame_idx += 1
        est_.headers = est_.headers[1:] + [t]
        if est_._step % est_.failure_check_interval == 0 and bool(step_out.failure[0]):
            est_.reset()
            est_.prev_time = None
            self._reset_tracker()
            est_._step += 1
            return None
        out = est_._emit(step_out, t)
        est_._step += 1
        return out

    # ------------------------------------------------------------------
    def corrected_trajectory(self) -> list:
        """Loop-corrected keyframe path; empty (loop closure is not ported)."""
        return []

    def run(self, max_frames: int = 10 ** 9) -> list:
        """Drain the stream; returns the trajectory list."""
        n = 0
        while n < max_frames:
            out = self.spin_once()
            if out is None and self.pairer._img_buf == []:
                break
            if out is not None:
                n += 1
        return self.estimator.trajectory
