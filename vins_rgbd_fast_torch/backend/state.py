"""Sliding-window state, tangent layout and retraction (twin of
``vins_rgbd_fast_tpu/backend/state.py``), batched over B sequences.

Tangent layout (per sequence), as in the JAX package:
    [pose 0..10 (6 each) | sb 0..10 (9 each) | extrinsic (6) | td (1)] = 172
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import quaternion as quat

WINDOW_SIZE = 10
FRAMES = WINDOW_SIZE + 1
POSE_DIM = 6
SB_DIM = 9
NP = FRAMES * POSE_DIM  # 66
NSB = FRAMES * SB_DIM  # 99
EX_OFF = NP + NSB  # 165
TD_OFF = EX_OFF + 6  # 171
NX = TD_OFF + 1  # 172


class WindowState(NamedTuple):
    P: torch.Tensor   # (B, FRAMES, 3)
    Q: torch.Tensor   # (B, FRAMES, 4) world-from-imu, wxyz
    V: torch.Tensor   # (B, FRAMES, 3)
    Ba: torch.Tensor  # (B, FRAMES, 3)
    Bg: torch.Tensor  # (B, FRAMES, 3)
    tic: torch.Tensor  # (B, 3)
    qic: torch.Tensor  # (B, 4)
    td: torch.Tensor   # (B,)


def identity_state(B: int, device, dtype=torch.float32) -> WindowState:
    z3 = torch.zeros((B, FRAMES, 3), dtype=dtype, device=device)
    q = quat.q_identity(dtype, device)
    return WindowState(
        P=z3.clone(), Q=q.expand(B, FRAMES, 4).clone(), V=z3.clone(),
        Ba=z3.clone(), Bg=z3.clone(),
        tic=torch.zeros((B, 3), dtype=dtype, device=device),
        qic=q.expand(B, 4).clone(),
        td=torch.zeros((B,), dtype=dtype, device=device))


def where_state(cond: torch.Tensor, a, b):
    """Per-sequence select between two NamedTuples of (B, ...) tensors."""
    def sel(x, y):
        if isinstance(x, tuple):
            return type(x)(*[sel(u, v) for u, v in zip(x, y)])
        return torch.where(cond.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return sel(a, b)


def boxplus(x: WindowState, dx: torch.Tensor) -> WindowState:
    """Retract a (B, 172) tangent step onto the window state."""
    B = dx.shape[0]
    dpose = dx[:, :NP].reshape(B, FRAMES, POSE_DIM)
    dsb = dx[:, NP:EX_OFF].reshape(B, FRAMES, SB_DIM)
    return WindowState(
        P=x.P + dpose[..., 0:3],
        Q=quat.qboxplus(x.Q, dpose[..., 3:6]),
        V=x.V + dsb[..., 0:3],
        Ba=x.Ba + dsb[..., 3:6],
        Bg=x.Bg + dsb[..., 6:9],
        tic=x.tic + dx[:, EX_OFF:EX_OFF + 3],
        qic=quat.qboxplus(x.qic, dx[:, EX_OFF + 3:EX_OFF + 6]),
        td=x.td + dx[:, TD_OFF],
    )


def boxminus(x: WindowState, x0: WindowState) -> torch.Tensor:
    """(B, 172) tangent difference x ⊟ x0 (2·vec(q0⁻¹ ⊗ q), sign-fixed)."""
    def qdiff(q, q0):
        return 2.0 * quat.qpositify(quat.qmul(quat.qconj(q0), q))[..., 1:4]

    B = x.P.shape[0]
    dpose = torch.cat([x.P - x0.P, qdiff(x.Q, x0.Q)], dim=-1)
    dsb = torch.cat([x.V - x0.V, x.Ba - x0.Ba, x.Bg - x0.Bg], dim=-1)
    dex = torch.cat([x.tic - x0.tic, qdiff(x.qic, x0.qic)], dim=-1)
    return torch.cat([dpose.reshape(B, -1), dsb.reshape(B, -1), dex,
                      (x.td - x0.td)[:, None]], dim=-1)


def yaw_gauge_fix(x_opt: WindowState, x_before: WindowState) -> WindowState:
    """Re-anchor the optimized window so frame 0 keeps its pre-solve yaw and
    position (falls back to the full rotation near singular pitch)."""
    R_b = quat.q2R(x_before.Q[:, 0])
    R_o = quat.q2R(x_opt.Q[:, 0])
    ypr0 = quat.R2ypr(R_b)
    ypr1 = quat.R2ypr(R_o)
    singular = (torch.abs(ypr1[:, 1]) > 89.0) | (torch.abs(ypr0[:, 1]) > 89.0)
    rot = torch.where(singular[:, None, None], R_b @ R_o.transpose(-1, -2),
                      quat.yaw_R(ypr0[:, 0] - ypr1[:, 0]))
    q_rot = quat.R2q(rot)[:, None]
    P0 = x_opt.P[:, :1]
    return x_opt._replace(
        P=quat.qrot(q_rot, x_opt.P - P0) + x_before.P[:, :1],
        Q=quat.qnormalize(quat.qmul(q_rot.expand_as(x_opt.Q), x_opt.Q)),
        V=quat.qrot(q_rot, x_opt.V))
