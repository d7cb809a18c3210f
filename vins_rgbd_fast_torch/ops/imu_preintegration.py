"""IMU preintegration (twin of ``preintegrate``, ``bias_corrected``,
``_chol15_inv`` and ``sqrt_information`` in
``vins_rgbd_fast_tpu/ops/imu_preintegration.py``).

Every function broadcasts over leading batch dimensions ``...``.  The
parallel-prefix form is kept: the attitude chain is a Hillis-Steele prefix
product (log2 N steps instead of N sequential ones), Δv/Δp are cumsums,
and the (F, V·Q·Vᵀ) error-state pairs are tree-reduced.  Padded steps
(dt = 0) are exact identities.  State order [δp, δθ, δv, δba, δbg].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import quaternion as quat

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


class ImuNoise(NamedTuple):
    acc_n: float
    gyr_n: float
    acc_w: float
    gyr_w: float


class Preintegrated(NamedTuple):
    delta_p: torch.Tensor        # (..., 3)
    delta_q: torch.Tensor        # (..., 4)
    delta_v: torch.Tensor        # (..., 3)
    jacobian: torch.Tensor       # (..., 15, 15)
    covariance: torch.Tensor     # (..., 15, 15)
    sum_dt: torch.Tensor         # (...)
    linearized_ba: torch.Tensor  # (..., 3)
    linearized_bg: torch.Tensor  # (..., 3)


def _noise_diag(noise: ImuNoise, dtype, device) -> torch.Tensor:
    vals = [noise.acc_n, noise.gyr_n, noise.acc_n, noise.gyr_n, noise.acc_w, noise.gyr_w]
    return quat.const(tuple(float(v) for v in vals for _ in range(3)), dtype,
                      torch.device(device)) ** 2


def _blocks(rows):
    """Assemble a block matrix from a list of rows of (..., 3, 3) blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _fv_step(dt, acc0, acc1, un_gyr, q0, q1, ba):
    """Per-step error-state transition F (..., 15, 15) and noise map V
    (..., 15, 18), given the attitudes before (q0) and after (q1)."""
    eye = torch.eye(3, dtype=dt.dtype, device=dt.device)
    I3 = eye.expand(dt.shape + (3, 3))
    Z3 = torch.zeros_like(I3)
    d = dt[..., None, None]
    R0 = quat.q2R(q0)
    R1 = quat.q2R(q1)
    a0_x = quat.skew(acc0 - ba)
    a1_x = quat.skew(acc1 - ba)
    ImW = I3 - quat.skew(un_gyr) * d
    R1a1 = R1 @ a1_x
    F = _blocks([
        [I3, -0.25 * R0 @ a0_x * d * d - 0.25 * R1a1 @ ImW * d * d, I3 * d,
         -0.25 * (R0 + R1) * d * d, 0.25 * R1a1 * d * d * d],
        [Z3, ImW, Z3, Z3, -I3 * d],
        [Z3, -0.5 * R0 @ a0_x * d - 0.5 * R1a1 @ ImW * d, I3,
         -0.5 * (R0 + R1) * d, 0.5 * R1a1 * d * d],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ])
    v03 = -0.125 * R1a1 * d * d * d
    v63 = -0.25 * R1a1 * d * d
    V = _blocks([
        [0.25 * R0 * d * d, v03, 0.25 * R1 * d * d, v03, Z3, Z3],
        [Z3, 0.5 * I3 * d, Z3, 0.5 * I3 * d, Z3, Z3],
        [0.5 * R0 * d, v63, 0.5 * R1 * d, v63, Z3, Z3],
        [Z3, Z3, Z3, Z3, I3 * d, Z3],
        [Z3, Z3, Z3, Z3, Z3, I3 * d],
    ])
    return F, V


def _prefix_qmul(dq: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products dq_0 ⊗ … ⊗ dq_k along dim -2."""
    n = dq.shape[-2]
    d = 1
    while d < n:
        dq = torch.cat([dq[..., :d, :], quat.qmul(dq[..., :-d, :], dq[..., d:, :])], dim=-2)
        d *= 2
    return dq


def preintegrate(dts, accs, gyrs, ba, bg, noise: ImuNoise) -> Preintegrated:
    """Integrate zero-padded IMU windows: dts (..., N), accs/gyrs
    (..., N+1, 3); dts[k] spans samples k -> k+1."""
    dtype = accs.dtype
    N = dts.shape[-1]
    nd = _noise_diag(noise, dtype, accs.device)
    dt = dts.to(dtype)
    ba_ = ba[..., None, :]

    un_gyr = 0.5 * (gyrs[..., :-1, :] + gyrs[..., 1:, :]) - bg[..., None, :]
    q_after = quat.qnormalize(_prefix_qmul(quat.dq_small(un_gyr * dt[..., None])))
    ident = quat.q_identity(dtype, accs.device).expand(q_after[..., :1, :].shape)
    q_before = torch.cat([ident, q_after[..., :-1, :]], dim=-2)

    un_acc = 0.5 * (quat.qrot(q_before, accs[..., :-1, :] - ba_)
                    + quat.qrot(q_after, accs[..., 1:, :] - ba_))
    v_after = torch.cumsum(un_acc * dt[..., None], dim=-2)
    v_before = torch.cat([torch.zeros_like(v_after[..., :1, :]), v_after[..., :-1, :]], dim=-2)
    delta_p = torch.sum(v_before * dt[..., None] + 0.5 * un_acc * dt[..., None] ** 2, dim=-2)

    F, V = _fv_step(dt, accs[..., :-1, :], accs[..., 1:, :], un_gyr, q_before, q_after, ba_)
    Q = (V * nd) @ V.transpose(-1, -2)
    M = 1
    while M < N:
        M *= 2
    if M != N:
        pad_shape = F.shape[:-3] + (M - N, 15, 15)
        eye = torch.eye(15, dtype=dtype, device=accs.device)
        F = torch.cat([F, eye.expand(pad_shape)], dim=-3)
        Q = torch.cat([Q, torch.zeros(pad_shape, dtype=dtype, device=accs.device)], dim=-3)
    while F.shape[-3] > 1:
        F1, F2 = F[..., 0::2, :, :], F[..., 1::2, :, :]
        Q1, Q2 = Q[..., 0::2, :, :], Q[..., 1::2, :, :]
        Q = (F2 @ Q1) @ F2.transpose(-1, -2) + Q2
        F = F2 @ F1
    return Preintegrated(
        delta_p=delta_p, delta_q=q_after[..., -1, :], delta_v=v_after[..., -1, :],
        jacobian=F[..., 0, :, :], covariance=Q[..., 0, :, :], sum_dt=torch.sum(dt, dim=-1),
        linearized_ba=ba, linearized_bg=bg)


def bias_corrected(pre: Preintegrated, bai, bgi):
    dba = (bai - pre.linearized_ba)[..., None]
    dbg = (bgi - pre.linearized_bg)[..., None]
    J = pre.jacobian

    def blk(a, b):
        return J[..., a:a + 3, b:b + 3]

    dq = quat.qnormalize(quat.qmul(pre.delta_q, quat.dq_small((blk(O_R, O_BG) @ dbg)[..., 0])))
    dv = pre.delta_v + (blk(O_V, O_BA) @ dba)[..., 0] + (blk(O_V, O_BG) @ dbg)[..., 0]
    dp = pre.delta_p + (blk(O_P, O_BA) @ dba)[..., 0] + (blk(O_P, O_BG) @ dbg)[..., 0]
    return dp, dq, dv


def _chol15_inv(cov: torch.Tensor) -> torch.Tensor:
    """L⁻¹ for cov = L·Lᵀ, unrolled over the 15 columns (diagonal clamped
    at 1e-30 instead of failing)."""
    n = cov.shape[-1]
    L = torch.zeros_like(cov)
    Inv = torch.zeros_like(cov)
    for j in range(n):
        s = cov[..., j:, j] - torch.einsum("...ik,...k->...i", L[..., j:, :j], L[..., j, :j])
        d = torch.sqrt(torch.clamp(s[..., 0], min=1e-30))
        L[..., j:, j] = s / d[..., None]
        Inv[..., j, :j] = -torch.einsum("...k,...ki->...i", L[..., j, :j],
                                        Inv[..., :j, :j]) / d[..., None]
        Inv[..., j, j] = 1.0 / d
    return Inv


def sqrt_information(pre: Preintegrated, eps: float = 1e-12) -> torch.Tensor:
    """Lower-triangular W with W·cov·Wᵀ = I."""
    eye = torch.eye(15, dtype=pre.covariance.dtype, device=pre.covariance.device)
    return _chol15_inv(pre.covariance + eps * eye)
