"""Projection and IMU factors with closed-form tangent Jacobians (twin of
``projection_factor_analytic``/``imu_factor_whitened_analytic`` in
``vins_rgbd_fast_tpu/ops/factors.py``).

The JAX hot path differentiates the residuals with ``jacfwd``; the port
takes the closed forms the JAX package keeps as its cross-check (the
parity tests hold them to the JAX autodiff Jacobians).  All functions
broadcast over leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FOCAL_LENGTH
from ..utils import quaternion as quat
from . import imu_preintegration as imupre

PROJ_SQRT_INFO = FOCAL_LENGTH / 1.5


class ProjMeas(NamedTuple):
    pts_i: torch.Tensor  # (..., 3) normalized obs in frame i (z = 1)
    pts_j: torch.Tensor  # (..., 3)
    vel_i: torch.Tensor  # (..., 3) (z component 0)
    vel_j: torch.Tensor  # (..., 3)
    td_i: torch.Tensor   # (...)
    td_j: torch.Tensor   # (...)
    row_i: torch.Tensor  # (...) TR/ROW·row
    row_j: torch.Tensor  # (...)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def projection_factor(Pi, Qi, Pj, Qj, tic, qic, inv_dep_i, td, meas: ProjMeas):
    """Whitened reprojection residual (..., 2) and Jacobian (..., 2, 20)
    over [pose_i(6), pose_j(6), ex(6), inv_dep(1), td(1)]."""
    lam = inv_dep_i[..., None]
    pts_i_td = meas.pts_i - (td - meas.td_i + meas.row_i)[..., None] * meas.vel_i
    pts_j_td = meas.pts_j - (td - meas.td_j + meas.row_j)[..., None] * meas.vel_j
    p_ci = pts_i_td / lam
    p_ii = quat.qrot(qic, p_ci) + tic
    p_w = quat.qrot(Qi, p_ii) + Pi
    p_ij = quat.qrot_inv(Qj, p_w - Pj)
    p_cj = quat.qrot_inv(qic, p_ij - tic)
    z = p_cj[..., 2:3]
    r = PROJ_SQRT_INFO * (p_cj[..., :2] / z - pts_j_td[..., :2])

    Ric = quat.q2R(qic)
    Ri = quat.q2R(Qi)
    Rj = quat.q2R(Qj)
    RicT = Ric.transpose(-1, -2)
    RjT = Rj.transpose(-1, -2)
    Bm = RicT @ RjT
    A = Bm @ Ri
    ARic = A @ Ric
    eye = torch.eye(3, dtype=Pi.dtype, device=Pi.device)
    x, y = p_cj[..., 0], p_cj[..., 1]
    zz = z[..., 0]
    zero = torch.zeros_like(zz)
    s = PROJ_SQRT_INFO / zz
    reduce = torch.stack([
        torch.stack([s, zero, -PROJ_SQRT_INFO * x / (zz * zz)], -1),
        torch.stack([zero, s, -PROJ_SQRT_INFO * y / (zz * zz)], -1)], -2)
    shape = torch.broadcast_shapes(Bm.shape, A.shape, ARic.shape)
    J3 = torch.cat([
        Bm.expand(shape),
        (-A @ quat.skew(p_ii)).expand(shape),
        (-Bm).expand(shape),
        (RicT @ quat.skew(p_ij)).expand(shape),
        (RicT @ (RjT @ Ri - eye)).expand(shape),
        (-ARic @ quat.skew(p_ci) + quat.skew(p_cj)).expand(shape),
        (-_mv(ARic, p_ci) / lam)[..., None],
        (-_mv(ARic, meas.vel_i) / lam)[..., None],
    ], dim=-1)
    J = reduce @ J3
    J = torch.cat([J[..., :19], J[..., 19:] + PROJ_SQRT_INFO * meas.vel_j[..., :2, None]], -1)
    return r, J


def cauchy_weight(r: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """IRLS row weight sqrt(ρ'(s)) for CauchyLoss(c); r (..., d) -> (..., 1)."""
    s = torch.sum(r * r, dim=-1, keepdim=True)
    return torch.sqrt(1.0 / (1.0 + s / (c * c)))


def imu_factor_whitened(pre: imupre.Preintegrated, Pi, Qi, Vi, Bai, Bgi,
                        Pj, Qj, Vj, Baj, Bgj, gravity, sqrt_info):
    """Whitened 15-dim IMU residual (the residual of the JAX
    ``imu_preintegration.evaluate``) and Jacobian (..., 15, 30) over
    [pose_i(6), sb_i(9), pose_j(6), sb_j(9)]."""
    dp, dq, dv = imupre.bias_corrected(pre, Bai, Bgi)
    sdt = pre.sum_dt[..., None]
    yp = quat.qrot_inv(Qi, 0.5 * gravity * sdt * sdt + Pj - Pi - Vi * sdt)
    yv = quat.qrot_inv(Qi, gravity * sdt + Vj - Vi)
    Bq = quat.qmul(quat.qconj(Qi), Qj)
    q_err = quat.qmul(quat.qconj(dq), Bq)
    r = torch.cat([yp - dp, 2.0 * q_err[..., 1:4], yv - dv, Baj - Bai, Bgj - Bgi], -1)
    r = _mv(sqrt_info, r)

    Jpre = pre.jacobian

    def blk(a, b):
        return Jpre[..., a:a + 3, b:b + 3]

    RiT = quat.q2R(Qi).transpose(-1, -2)
    Z = torch.zeros_like(RiT)
    eye = torch.eye(3, dtype=Pi.dtype, device=Pi.device).expand_as(RiT)
    M_thi = -(quat.qleft(quat.qconj(dq)) @ quat.qright(Bq))[..., 1:4, 1:4]
    M_thj = quat.qleft(q_err)[..., 1:4, 1:4]
    C = quat.qmul(quat.qconj(pre.delta_q), Bq)
    M_bgi = -quat.qright(C)[..., 1:4, 1:4] @ blk(imupre.O_R, imupre.O_BG)
    Jl = torch.cat([
        torch.cat([-RiT, quat.skew(yp), -RiT * sdt[..., None], -blk(imupre.O_P, imupre.O_BA),
                   -blk(imupre.O_P, imupre.O_BG), RiT, Z, Z, Z, Z], -1),
        torch.cat([Z, M_thi, Z, Z, M_bgi, Z, M_thj, Z, Z, Z], -1),
        torch.cat([Z, quat.skew(yv), -RiT, -blk(imupre.O_V, imupre.O_BA),
                   -blk(imupre.O_V, imupre.O_BG), Z, Z, RiT, Z, Z], -1),
        torch.cat([Z, Z, Z, -eye, Z, Z, Z, Z, eye, Z], -1),
        torch.cat([Z, Z, Z, Z, -eye, Z, Z, Z, Z, eye], -1),
    ], -2)
    return r, sqrt_info @ Jl
