"""Intrinsic calibration suite (twin of ``vins_rgbd_fast_tpu/calib``):
chessboard detection on the image's device, Zhang's closed form and an LM
bundle refinement in float64 on the caller's device, the camodocal YAML
writer, and the reference's ``intrinsic_calib`` CLI.

Run as ``python3 -m vins_rgbd_fast_torch.calib -w 8 --bh 12 -s 7 -i dir/``.
"""

from .chessboard import detect_corners, find_chessboard, order_grid
from .calibrate import (CalibrationResult, board_points, calibrate, homography, refine,
                        write_camera_yaml, zhang_intrinsics)

__all__ = [
    "CalibrationResult", "board_points", "calibrate", "detect_corners",
    "find_chessboard", "homography", "order_grid", "refine",
    "write_camera_yaml", "zhang_intrinsics",
]
