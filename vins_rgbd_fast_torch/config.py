"""The port's own static configuration dataclasses.

Field names and derived properties follow the JAX package
(``frontend/feature_tracker.TrackerConfig``, ``backend/estimator.
EstimatorConfig``, ``ops/solver.SolverConfig``), so a config built from a
``VinsConfig`` drives both packages identically.  Only the options the
ported slice runs are kept: IMU on, static initialization, no fisheye
mask, no CLAHE, no relocalization factors.
"""

from __future__ import annotations

import dataclasses

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
    pyr_levels_predicted: int = 2
    pyr_levels_cold: int = 4
    ransac_trials: int = 64
    admission_rounds: int = 16
    lk_max_iters: int = 20
    lk_coarse_iters: int = 10

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


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    maxf: int
    max_imu: int = 32
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

    @classmethod
    def from_vins(cls, vcfg) -> "EstimatorConfig":
        """Mirror of the JAX ``EstimatorConfig.from_vins`` for the ported
        slice (IMU on, static init, no td/extrinsic estimation, no relo)."""
        if not (vcfg.imu and vcfg.static_init) or vcfg.estimate_td \
                or vcfg.estimate_extrinsic or vcfg.fast_relocalization:
            raise NotImplementedError(
                "the port runs IMU + static init without td/extrinsic "
                "estimation or relocalization")
        return cls(
            maxf=vcfg.feature_capacity, max_imu=vcfg.max_imu_per_frame,
            fix_depth=vcfg.fix_depth, depth_min_dist=vcfg.depth_min_dist,
            depth_max_dist=vcfg.depth_max_dist,
            min_parallax=vcfg.keyframe_parallax / vcfg.focal_length,
            g_norm=vcfg.g_norm, acc_n=vcfg.acc_n, gyr_n=vcfg.gyr_n,
            acc_w=vcfg.acc_w, gyr_w=vcfg.gyr_w,
            tr_over_row=(vcfg.rolling_shutter_tr / vcfg.image_height
                         if vcfg.rolling_shutter else 0.0),
            max_iters=vcfg.max_num_iterations,
        )

    @property
    def solver(self) -> SolverConfig:
        return SolverConfig(maxf=self.maxf, max_iters=self.max_iters)
