"""Static-initialization pieces (twin of ``init_first_imu_pose`` and
``solve_gyroscope_bias`` in ``vins_rgbd_fast_tpu/backend/initialization.py``).
The dynamic (SFM alignment) and monocular initializations are not ported."""

from __future__ import annotations

import torch

from ..utils import quaternion as quat


def init_first_imu_pose(accs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Gravity-aligned, yaw-zeroed world-from-body quaternion from the mean
    accelerometer sample; accs (..., K, 3), valid (..., K)."""
    n = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1).to(accs.dtype)
    aver = torch.sum(accs * valid[..., None].to(accs.dtype), dim=-2) / n
    return quat.R2q(quat.g2R(aver))


def solve_gyroscope_bias(dq_pre, J_q_bg, Q, valid) -> torch.Tensor:
    """Least-squares gyro-bias increment matching Δq(bg+Δbg) to the frame
    rotations.  dq_pre (B, W, 4), J_q_bg (B, W, 3, 3), Q (B, W+1, 4),
    valid (B, W).  A singular system gives NaN."""
    q_ij = quat.qmul(quat.qconj(Q[:, :-1]), Q[:, 1:])
    resid = 2.0 * quat.qmul(quat.qconj(dq_pre), q_ij)[..., 1:4]
    w = valid.to(dq_pre.dtype)
    A = torch.sum(w[..., None, None] * (J_q_bg.transpose(-1, -2) @ J_q_bg), dim=1)
    b = torch.sum(w[..., None] * (J_q_bg.transpose(-1, -2) @ resid[..., None])[..., 0], dim=1)
    A = A + 1e-10 * torch.eye(3, dtype=A.dtype, device=A.device)
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where((info == 0)[:, None], x, torch.nan)
