"""The port's own static configuration dataclasses and rig-file loader.

Field names and derived properties follow the JAX package (``config.
VinsConfig``/``load_config``, ``frontend/feature_tracker.TrackerConfig``,
``backend/estimator.EstimatorConfig``, ``ops/solver.SolverConfig``), so a
config built from a ``VinsConfig`` drives both packages identically.  Only
the options the ported slices run are kept: pinhole camera, IMU on (VIO)
or off (VO), static or dynamic initialization (with its monocular
fallback), online td and extrinsic estimation, rolling shutter, CLAHE
(``equalize``) and the fisheye mask, and the bag topics replay reads.
The JAX ``config.py`` imports jax, so the port cannot import it on a
machine without JAX.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Tuple

import numpy as np

from .models.camera import PinholeCamera

FOCAL_LENGTH = 460.0  # virtual focal length (reference parameters.h:13)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    width: int
    height: int
    max_cnt: int = 150
    capacity: int = 0  # feature slots; 0 -> derived
    min_dist: int = 30
    grid_rows: int = 5
    grid_cols: int = 6
    f_threshold: float = 1.0
    fast_threshold: float = 10.0
    equalize: bool = False  # CLAHE before the pyramid (ops/image.clahe)
    fisheye: bool = False  # field-of-view mask on detection and tracks
    fisheye_radius_frac: float = 0.5  # the analytic circle's radius (no mask file)
    fisheye_mask_path: str = ""  # mask image; "" -> the analytic circle
    pyr_levels_predicted: int = 2
    pyr_levels_cold: int = 4
    ransac_trials: int = 64
    admission_rounds: int = 16
    lk_max_iters: int = 20
    lk_coarse_iters: int = 10
    lk_engine: str = "auto"  # "pallas" (K3) | "pallas3" (K2) | "xla" (CPU only)
    use_imu_prediction: bool = True  # False: LK starts at the previous positions, cold pyramid

    @property
    def maxc(self) -> int:
        if self.capacity:
            return self.capacity
        return max(((int(self.max_cnt * 1.5) + 7) // 8) * 8, 32)

    @property
    def num_grids(self) -> int:
        return self.grid_rows * self.grid_cols

    @property
    def grid_quota(self) -> int:
        return max(self.max_cnt // self.num_grids, 1)

    @property
    def cand_per_grid(self) -> int:
        return self.grid_quota + 2

    @property
    def pyr_levels(self) -> int:
        return max(self.pyr_levels_predicted, self.pyr_levels_cold)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    maxf: int
    max_iters: int = 8
    use_imu: bool = True  # False (VO): the speed-bias dims are frozen
    fix_pose0: bool = False  # VO: the first pose anchors the gauge
    yaw_gauge: bool = True  # IMU: the post-solve yaw/position re-anchoring
    with_relo: bool = False  # append the relocalization pose block
    estimate_td: bool = False  # td free (gated per sequence by ``td_free``)
    estimate_extrinsic: bool = False  # the imu<-cam extrinsic free


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    maxf: int
    max_imu: int = 32
    use_imu: bool = True
    static_init: bool = True  # False: dynamic init, monocular init as its fallback
    estimate_td: bool = False
    estimate_extrinsic: bool = False  # the rig's estimate_extrinsic > 0
    fix_depth: bool = True
    depth_min_dist: float = 0.3
    depth_max_dist: float = 6.0
    min_parallax: float = 10.0 / FOCAL_LENGTH
    g_norm: float = 9.805
    acc_n: float = 1.0
    gyr_n: float = 0.01
    acc_w: float = 0.001
    gyr_w: float = 0.0001
    tr_over_row: float = 0.0
    max_iters: int = 8
    fast_relo: bool = False  # relocalization factors in the window solve

    @classmethod
    def from_vins(cls, vcfg) -> "EstimatorConfig":
        """Mirror of the JAX ``EstimatorConfig.from_vins``.  With
        ``estimate_extrinsic`` 2 the solver frees the extrinsic while the
        hand-eye calibration runs, as in JAX."""
        return cls(
            maxf=vcfg.feature_capacity, max_imu=vcfg.max_imu_per_frame, use_imu=bool(vcfg.imu),
            static_init=bool(vcfg.static_init), estimate_td=bool(vcfg.estimate_td),
            estimate_extrinsic=vcfg.estimate_extrinsic > 0,
            fix_depth=vcfg.fix_depth, depth_min_dist=vcfg.depth_min_dist,
            depth_max_dist=vcfg.depth_max_dist,
            min_parallax=vcfg.keyframe_parallax / vcfg.focal_length,
            g_norm=vcfg.g_norm, acc_n=vcfg.acc_n, gyr_n=vcfg.gyr_n,
            acc_w=vcfg.acc_w, gyr_w=vcfg.gyr_w,
            tr_over_row=(vcfg.rolling_shutter_tr / vcfg.image_height
                         if vcfg.rolling_shutter else 0.0),
            max_iters=vcfg.max_num_iterations,
            fast_relo=vcfg.fast_relocalization,
        )

    @property
    def solver(self) -> SolverConfig:
        return SolverConfig(maxf=self.maxf, max_iters=self.max_iters, use_imu=self.use_imu,
                            fix_pose0=not self.use_imu, yaw_gauge=self.use_imu,
                            with_relo=self.fast_relo, estimate_td=self.estimate_td,
                            estimate_extrinsic=self.estimate_extrinsic)


@dataclasses.dataclass(frozen=True)
class VinsConfig:
    """The knobs of the system that the ported pipeline, tracker and
    estimator read; names and defaults of ``vins_rgbd_fast_tpu/config.py``
    (which follow the reference YAML keys)."""

    imu: bool = True
    static_init: bool = True
    image_topic: str = "/camera/color/image_raw"
    depth_topic: str = "/camera/aligned_depth_to_color/image_raw"
    imu_topic: str = "/imu"
    depth_min_dist: float = 0.3
    depth_max_dist: float = 6.0
    fix_depth: bool = True
    frontend_freq: float = 20.0
    freq: float = 10.0
    num_grid_rows: int = 5
    num_grid_cols: int = 6
    max_cnt: int = 30
    min_dist: int = 30
    f_threshold: float = 1.0
    equalize: bool = False
    fisheye: bool = False
    fast_threshold: int = 20
    model_type: str = "PINHOLE"
    image_width: int = 640
    image_height: int = 480
    intrinsics: Tuple[float, ...] = (604.58, 604.25, 321.26, 239.71)  # fx fy cx cy
    distortion: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)  # k1 k2 p1 p2
    estimate_extrinsic: int = 0
    ric: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)  # row-major 3x3 imu<-cam
    tic: Tuple[float, ...] = (0.0, 0.0, 0.0)
    max_num_iterations: int = 8
    keyframe_parallax: float = 10.0  # pixels, / focal_length at use site
    acc_n: float = 1.0
    gyr_n: float = 0.01
    acc_w: float = 0.001
    gyr_w: float = 0.0001
    g_norm: float = 9.805
    estimate_td: bool = False
    td: float = 0.0
    rolling_shutter: bool = False
    rolling_shutter_tr: float = 0.0
    loop_closure: bool = False
    fast_relocalization: bool = False
    skip_dis: float = 0.0  # pose graph: min travel between admitted keyframes
    skip_cnt: int = 0      # pose graph: admit every skip_cnt-th keyframe
    focal_length: float = 460.0
    fisheye_mask: str = ""  # mask image path; "" + fisheye -> the analytic circle
    max_features: int = 0  # 0 -> derived from max_cnt
    max_imu_per_frame: int = 32

    @property
    def feature_capacity(self) -> int:
        if self.max_features:
            return self.max_features
        return max(((int(self.max_cnt * 1.5) + 7) // 8) * 8, 32)

    def camera(self) -> PinholeCamera:
        if self.model_type.upper() != "PINHOLE":
            raise NotImplementedError(
                f"the port has the pinhole camera only, not {self.model_type!r}")
        fx, fy, cx, cy = self.intrinsics
        k1, k2, p1, p2 = self.distortion
        return PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, k1=k1, k2=k2, p1=p1, p2=p2,
                             width=self.image_width, height=self.image_height)

    def ric_matrix(self) -> np.ndarray:
        return np.asarray(self.ric, dtype=np.float64).reshape(3, 3)

    def tic_vector(self) -> np.ndarray:
        return np.asarray(self.tic, dtype=np.float64)


# ---------------------------------------------------------------------------
# OpenCV FileStorage YAML (the reference's rig files), regex only
# ---------------------------------------------------------------------------

_KEY = re.compile(r"^(\s*)([A-Za-z_][\w]*)\s*:\s*(.*?)\s*$")


def _scalar(text: str):
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text


def _parse_opencv_yaml(text: str) -> dict:
    """Flat keys, one level of indented maps and ``!!opencv-matrix`` nodes
    whose ``data: [...]`` list may span lines — the subset of YAML that
    OpenCV's ``FileStorage`` writes."""
    out: dict = {}
    node = None  # the map that indented keys go to
    lines = iter(text.splitlines())
    for line in lines:
        line = re.sub(r"(^|\s)#.*$", "", line).rstrip()
        if not line.strip() or line.startswith("%") or line.strip() == "---":
            continue
        m = _KEY.match(line)
        if m is None:
            continue
        indent, key, val = m.groups()
        if val.startswith("["):
            while "]" not in val:
                val += " " + re.sub(r"(^|\s)#.*$", "", next(lines)).strip()
            items = [v.strip() for v in val.strip("[] ").split(",") if v.strip()]
            val = [_scalar(v) for v in items]
        elif val in ("", "!!opencv-matrix"):
            node = out[key] = {}
            continue
        else:
            val = _scalar(val)
        if indent and node is not None:
            node[key] = val
        else:
            node = None
            out[key] = val
    return out


def _as_matrix(node) -> np.ndarray:
    arr = np.asarray(node["data"], dtype=np.float64)
    return arr.reshape(int(node["rows"]), int(node["cols"]))


def load_config(path: str) -> VinsConfig:
    """Load a reference-format YAML rig file (JAX ``config.load_config``)."""
    with open(path) as f:
        raw = _parse_opencv_yaml(f.read())
    get = raw.get
    proj = raw.get("projection_parameters", {})
    dist = raw.get("distortion_parameters", {})
    kwargs = dict(
        imu=bool(get("imu", 1)),
        static_init=bool(get("static_init", 0)),
        image_topic=str(get("image_topic", "/camera/color/image_raw")),
        depth_topic=str(get("depth_topic", "/camera/depth/image_raw")),
        imu_topic=str(get("imu_topic", "/imu")),
        depth_min_dist=float(get("depth_min_dist", 0.3)),
        depth_max_dist=float(get("depth_max_dist", 6.0)),
        fix_depth=bool(get("fix_depth", 1)),
        frontend_freq=float(get("frontend_freq", 20)),
        freq=float(get("freq", 10)),
        num_grid_rows=int(get("num_grid_rows", 5)),
        num_grid_cols=int(get("num_grid_cols", 6)),
        max_cnt=int(get("max_cnt", 150)),
        min_dist=int(get("min_dist", 30)),
        f_threshold=float(get("F_threshold", 1.0)),
        equalize=bool(get("equalize", 0)),
        fisheye=bool(get("fisheye", 0)),
        fisheye_mask=str(get("fisheye_mask", "")),
        model_type=str(get("model_type", "PINHOLE")),
        image_width=int(get("image_width", 640)),
        image_height=int(get("image_height", 480)),
        max_num_iterations=int(get("max_num_iterations", 8)),
        keyframe_parallax=float(get("keyframe_parallax", 10.0)),
        acc_n=float(get("acc_n", 1.0)),
        gyr_n=float(get("gyr_n", 0.01)),
        acc_w=float(get("acc_w", 0.001)),
        gyr_w=float(get("gyr_w", 0.0001)),
        g_norm=float(get("g_norm", 9.805)),
        estimate_extrinsic=int(get("estimate_extrinsic", 0)),
        estimate_td=bool(get("estimate_td", 0)),
        td=float(get("td", 0.0)),
        rolling_shutter=bool(get("rolling_shutter", 0)),
        rolling_shutter_tr=float(get("rolling_shutter_tr", 0.0)),
        fast_threshold=int(get("fast_threshold", 20)),
        loop_closure=bool(get("loop_closure", 0)),
        fast_relocalization=bool(get("fast_relocalization", 0)),
        skip_dis=float(get("skip_dis", 0.0)),
        skip_cnt=int(get("skip_cnt", 0)),
    )
    for keys in (("fx", "fy", "cx", "cy"), ("mu", "mv", "u0", "v0"),
                 ("gamma1", "gamma2", "u0", "v0")):
        if keys[0] in proj:
            kwargs["intrinsics"] = tuple(float(proj[k]) for k in keys)
            break
    if dist:
        kwargs["distortion"] = tuple(float(dist.get(k, 0)) for k in ("k1", "k2", "p1", "p2"))
    if kwargs["fisheye"] and not kwargs["fisheye_mask"]:
        # the reference's fisheye_mask.jpg beside the rig file or one directory up
        d = os.path.dirname(os.path.abspath(path))
        for cand in (os.path.join(d, "fisheye_mask.jpg"),
                     os.path.join(os.path.dirname(d), "fisheye_mask.jpg")):
            if os.path.exists(cand):
                kwargs["fisheye_mask"] = cand
                break
    if raw.get("estimate_extrinsic", 0) != 2:
        if "extrinsicRotation" in raw:
            kwargs["ric"] = tuple(_as_matrix(raw["extrinsicRotation"]).ravel().tolist())
        if "extrinsicTranslation" in raw:
            kwargs["tic"] = tuple(_as_matrix(raw["extrinsicTranslation"]).ravel().tolist())
    return VinsConfig(**kwargs)
