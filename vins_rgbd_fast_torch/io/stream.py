"""The sensor-stream runtime of the host shell, trajectory files and
trajectory evaluation (twins of ``ImuMsg``, ``ImageMsg``, ``DepthMsg``,
``RgbdFrame``, ``decode_depth``, ``StreamPairer``, ``write_trajectory_csv``,
``write_tum_trajectory`` and ``ate_rmse`` in
``vins_rgbd_fast_tpu/io/stream.py``).

The JAX module is numpy only, but the port's entry points import nothing
of the JAX package (the machine with the card has no JAX, and
``chip_smoke.py`` must run there without it), so the port keeps its own
copy; ``tests/test_torch_pipeline.py`` holds the pairer to JAX's.  The
pairer pairs RGB and depth by stamp within ±3 ms, applies the frontend
and publish rate gates and flags stream discontinuities (>1 s gap or
backwards time) for a tracker + estimator reset.  It counts (``utils/
timing``) the pairs it takes in (``pairer::pairs``), those the frontend
gate skips (``pairer::skipped``) or the publish gate withholds from the
estimator (``pairer::unpublished``), and the discontinuities
(``pairer::resets``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np

from ..utils.timing import TRACER


class ImuMsg(NamedTuple):
    t: float
    acc: np.ndarray
    gyr: np.ndarray


class ImageMsg(NamedTuple):
    t: float
    image: np.ndarray  # (H, W) grayscale float32 [0,255]


class DepthMsg(NamedTuple):
    t: float
    depth: np.ndarray  # (H, W) float32 meters


class RgbdFrame(NamedTuple):
    t: float
    image: np.ndarray
    depth: np.ndarray
    publish: bool  # PUB_THIS_FRAME


def decode_depth(raw: np.ndarray, encoding: str) -> np.ndarray:
    """Depth image to metres (estimator_nodelet.cpp:511-533): mono16/16UC1
    millimetres or 32FC1 metres."""
    if encoding in ("mono16", "16UC1"):
        return raw.astype(np.float32) / 1000.0
    if encoding == "32FC1":
        return raw.astype(np.float32)
    raise ValueError(f"unsupported depth encoding {encoding}")


@dataclasses.dataclass
class StreamPairer:
    """Pairs RGB and depth by stamp, applies rate gates, flags resets."""

    frontend_freq: float = 20.0
    publish_freq: float = 10.0
    pair_tol: float = 0.003  # ±3 ms (estimator_nodelet.cpp:216)
    gap_reset: float = 1.0  # >1 s gap -> reset (estimator_nodelet.cpp:245)

    def __post_init__(self):
        self._img_buf: list = []
        self._depth_buf: list = []
        self.last_image_time: Optional[float] = None
        self.first_image_time: Optional[float] = None
        self.last_pub_time: Optional[float] = None
        self.pub_count = 0
        self.reset_flag = False

    def push_image(self, msg: ImageMsg):
        self._img_buf.append(msg)

    def push_depth(self, msg: DepthMsg):
        self._depth_buf.append(msg)

    def _pop_pair(self) -> Optional[Tuple[ImageMsg, DepthMsg]]:
        while self._img_buf and self._depth_buf:
            img = self._img_buf[0]
            dep = self._depth_buf[0]
            if img.t < dep.t - self.pair_tol:
                self._img_buf.pop(0)  # drop unmatched old image
            elif dep.t < img.t - self.pair_tol:
                self._depth_buf.pop(0)
            else:
                self._img_buf.pop(0)
                self._depth_buf.pop(0)
                return img, dep
        return None

    def next_frame(self) -> Optional[RgbdFrame]:
        """Returns the next paired + rate-gated frame, or None."""
        while True:
            pair = self._pop_pair()
            if pair is None:
                return None
            img, dep = pair
            t = img.t
            TRACER.count("pairer::pairs")

            # discontinuity detection (estimator_nodelet.cpp:243-262)
            if self.last_image_time is not None and (
                t < self.last_image_time or t - self.last_image_time > self.gap_reset
            ):
                self.reset_flag = True
                TRACER.count("pairer::resets")
                self.first_image_time = None
                self.last_pub_time = None
                self.pub_count = 0
            self.last_image_time = t

            if self.first_image_time is None:
                self.first_image_time = t
                self.last_pub_time = t

            # frontend input gate (estimator_nodelet.cpp:265-271): at most
            # frontend_freq Hz
            if self.frontend_freq > 0:
                elapsed = t - self.first_image_time
                if elapsed > 0 and (self.pub_count + 1) / elapsed > self.frontend_freq * 1.15:
                    TRACER.count("pairer::skipped")
                    continue  # skip frame entirely

            # publish gate (estimator_nodelet.cpp:274-286): PUB_THIS_FRAME at publish_freq
            publish = True
            if self.publish_freq > 0:
                elapsed = max(t - self.first_image_time, 1e-9)
                rate = self.pub_count / elapsed
                publish = rate <= self.publish_freq
                if publish and abs(rate - self.publish_freq) < 0.01 * self.publish_freq:
                    self.first_image_time = t
                    self.pub_count = 0
            if publish:
                self.pub_count += 1
            else:
                TRACER.count("pairer::unpublished")
            return RgbdFrame(t=t, image=img.image, depth=dep.depth, publish=publish)

    def consume_reset(self) -> bool:
        r = self.reset_flag
        self.reset_flag = False
        return r


def write_trajectory_csv(path: str, trajectory: Iterable[dict]):
    """The reference's ``vins_result_no_loop.csv`` (visualization.cpp:215-225):
    stamp_ns,x,y,z,qw,qx,qy,qz,vx,vy,vz,"""
    with open(path, "w") as f:
        for rec in trajectory:
            Q, P, V = rec["Q"], rec["P"], rec["V"]
            f.write(
                f"{rec['t'] * 1e9:.0f},{P[0]:.5f},{P[1]:.5f},{P[2]:.5f},"
                f"{Q[0]:.5f},{Q[1]:.5f},{Q[2]:.5f},{Q[3]:.5f},"
                f"{V[0]:.5f},{V[1]:.5f},{V[2]:.5f},\n")


def write_tum_trajectory(path: str, trajectory: Iterable[dict]):
    """The TUM / rpg_trajectory_evaluation format, t x y z qx qy qz qw (the
    reference's ``stamped_traj_estimate``, pose_graph.cpp:855-864)."""
    with open(path, "w") as f:
        for rec in trajectory:
            Q, P = rec["Q"], rec["P"]
            f.write(f"{rec['t']:.6f} {P[0]:.6f} {P[1]:.6f} {P[2]:.6f} "
                    f"{Q[1]:.6f} {Q[2]:.6f} {Q[3]:.6f} {Q[0]:.6f}\n")


def ate_rmse(est_t, est_P, gt_t, gt_P, align: bool = True) -> float:
    """Absolute trajectory error RMSE after stamp association (±10 ms) and
    optional SE(3) Umeyama alignment (no scale)."""
    est_t = np.asarray(est_t)
    gt_t = np.asarray(gt_t)
    pairs = []
    for i, t in enumerate(est_t):
        j = int(np.argmin(np.abs(gt_t - t)))
        if abs(gt_t[j] - t) < 0.01:
            pairs.append((i, j))
    if len(pairs) < 3:
        return float("nan")
    E = np.asarray([est_P[i] for i, _ in pairs])
    Gt = np.asarray([gt_P[j] for _, j in pairs])
    if align:
        mu_e, mu_g = E.mean(0), Gt.mean(0)
        U, _, Vt = np.linalg.svd((E - mu_e).T @ (Gt - mu_g))
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        E = (E - mu_e) @ (Vt.T @ S @ U.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((E - Gt) ** 2, axis=1))))
