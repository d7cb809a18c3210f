"""Initialization math (twin of ``vins_rgbd_fast_tpu/backend/initialization.py``):
the gravity-aligned first pose and the gyro-bias least squares of static
initialization; the essential-matrix decomposition, the IMU excitation
check, the velocity/gravity alignments (metric with depth, scale-solving
without) and their gravity refinements of dynamic and monocular
initialization; the hand-eye rotation calibration of the extrinsic.

Every function but ``calibrate_extrinsic_rotation`` is batched over a
leading sequence axis B.  The alignments' scan over the window intervals
is a static loop of ``WINDOW_SIZE`` block adds.  Singular solves give NaN
(``solve_ex``), as ``jnp.linalg.solve`` does, instead of raising.
"""

from __future__ import annotations

import torch

from ..ops.solver import cho_solve, cholesky_nan
from ..utils import quaternion as quat
from .state import FRAMES, WINDOW_SIZE


def init_first_imu_pose(accs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Gravity-aligned, yaw-zeroed world-from-body quaternion from the mean
    accelerometer sample; accs (..., K, 3), valid (..., K)."""
    n = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1).to(accs.dtype)
    aver = torch.sum(accs * valid[..., None].to(accs.dtype), dim=-2) / n
    return quat.R2q(quat.g2R(aver))


def _solve_nan(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b for batched systems; NaN where the factorization fails."""
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where((info == 0)[:, None], x, torch.nan)


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
    return _solve_nan(A, b)


def decompose_essential(E, pts1, pts2, valid):
    """Relative rotation from an essential matrix, x2 ~ R·x1 + t: the four
    (R, t) candidates are scored by the points with positive midpoint-
    triangulated depth in both views.  E (B, 3, 3), pts (B, N, 2), valid
    (B, N); returns (R (B, 3, 3), t (B, 3), score (B,))."""
    dtype = E.dtype
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[:, None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[:, None, None]
    Wm = quat.const(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), dtype, E.device)
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    t1 = U[:, :, 2]
    r1 = torch.cat([pts1, torch.ones_like(pts1[..., :1])], dim=-1)
    r2 = torch.cat([pts2, torch.ones_like(pts2[..., :1])], dim=-1)

    def depth_score(R, t):
        # least-squares depths d1, d2 of [R·r1, -r2] [d1; d2] = -t per point
        A = torch.stack([r1 @ R.transpose(1, 2), -r2], dim=-1)  # (B, N, 3, 2)
        AtA = A.transpose(-1, -2) @ A
        Atb = (A.transpose(-1, -2) @ -t[:, None, :, None])[..., 0]
        det = AtA[..., 0, 0] * AtA[..., 1, 1] - AtA[..., 0, 1] * AtA[..., 1, 0]
        inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
        d1 = inv_det * (AtA[..., 1, 1] * Atb[..., 0] - AtA[..., 0, 1] * Atb[..., 1])
        d2 = inv_det * (-AtA[..., 1, 0] * Atb[..., 0] + AtA[..., 0, 0] * Atb[..., 1])
        return torch.sum(((d1 > 0) & (d2 > 0) & valid).to(dtype), dim=-1)

    cands = [(R1, t1), (R1, -t1), (R2, t1), (R2, -t1)]
    scores = torch.stack([depth_score(R, t) for (R, t) in cands], dim=1)  # (B, 4)
    best = torch.argmax(scores, dim=1)
    ar = torch.arange(E.shape[0], device=E.device)
    Rs = torch.stack([c[0] for c in cands], dim=1)
    ts = torch.stack([c[1] for c in cands], dim=1)
    return Rs[ar, best], ts[ar, best], scores[ar, best]


def calibrate_extrinsic_rotation(q_cam, q_imu, ric_guess, valid):
    """Hand-eye rotation from K pairs of relative rotations: the null
    quaternion of the Huber-weighted stack of Qleft(q_cam) − Qright(q_imu)
    blocks, three reweighting rounds from ``ric_guess``.  q_cam, q_imu
    (K, 4), ric_guess (3, 3), valid (K,).  Returns (ric (3, 3), ok): ok
    when at least 10 pairs are valid and the second smallest singular value
    of the stack exceeds 0.25."""
    dtype = q_cam.dtype
    L = quat.qleft(q_cam)
    Rm = quat.qright(q_imu)
    eye4 = torch.eye(4, dtype=dtype, device=q_cam.device)
    w_valid = valid.to(dtype)

    def solve_round(q_guess):
        q_imu_c = quat.qmul(quat.qconj(q_guess)[None], quat.qmul(q_imu, q_guess[None]))
        dq = quat.qmul(quat.qconj(q_cam), q_imu_c)
        ang = torch.rad2deg(torch.linalg.norm(quat.so3_log(dq), dim=-1))
        w = torch.where(ang > 5.0, 5.0 / torch.clamp(ang, min=1e-9), torch.ones_like(ang))
        A = (L - Rm) * (w * w_valid)[:, None, None]
        M = torch.einsum("kia,kib->ab", A, A)
        Lc = cholesky_nan(M + (1e-9 * torch.trace(M) + 1e-20) * eye4)
        v = eye4[0]
        for _ in range(10):  # inverse iteration towards the null vector
            v = cho_solve(Lc, v[:, None])[:, 0]
            v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
        return quat.qconj(quat.qnormalize(v)), torch.linalg.eigvalsh(M)[1]

    q_guess = quat.R2q(ric_guess)
    for _ in range(3):
        q_guess, ev1 = solve_round(q_guess)
    # the threshold is on the stack's singular values; ev1 is an eigenvalue
    # of AᵀA, a squared singular value
    ok = (torch.sum(valid) >= 10) & (torch.sqrt(torch.clamp(ev1, min=0.0)) > 0.25)
    return quat.q2R(q_guess), ok


def imu_excitation_ok(dv, sum_dt, valid, threshold: float = 0.25) -> torch.Tensor:
    """Enough motion to initialize: std of Δv/Δt over the valid intervals
    above ``threshold``.  dv (B, W, 3), sum_dt (B, W), valid (B, W) -> (B,)."""
    vf = valid.to(dv.dtype)
    n = torch.clamp(torch.sum(valid, dim=-1), min=1).to(dv.dtype)
    a = dv / torch.clamp(sum_dt, min=1e-6)[..., None]
    mean = torch.sum(a * vf[..., None], dim=1) / n[:, None]
    var = torch.sum(torch.sum((a - mean[:, None]) ** 2, dim=-1) * vf, dim=1) / n
    return torch.sqrt(var) > threshold


# ---------------------------------------------------------------------------
# velocity / gravity (/ scale) alignment
# ---------------------------------------------------------------------------

def _interval_terms(sum_dt, Q):
    """dt (B, W, 1, 1), Rᵢᵀ (B, W, 3, 3) and Rᵢᵀ·Rⱼ of each window interval."""
    R = quat.q2R(Q)
    RiT = R[:, :-1].transpose(-1, -2)
    return sum_dt[..., None, None], RiT, RiT @ R[:, 1:]


def _solve_window(tA, tb, valid, tail: int):
    """Accumulate each interval's normal equations (rows tA (B, W, 6, 6 +
    tail), right side tb (B, W, 6)) into the window system: the interval's
    velocity pair at 3i, its ``tail`` shared columns last; scale by 1000,
    add 1e-8·I and solve.  Returns x (B, 3·FRAMES + tail)."""
    w = valid.to(tA.dtype)[..., None, None]
    rA = (tA.transpose(-1, -2) @ tA) * w
    rb = (tA.transpose(-1, -2) @ tb[..., None])[..., 0] * w[..., 0]
    B = tA.shape[0]
    n = 3 * FRAMES + tail
    c = n - tail
    A = torch.zeros((B, n, n), dtype=tA.dtype, device=tA.device)
    b = torch.zeros((B, n), dtype=tA.dtype, device=tA.device)
    for i in range(WINDOW_SIZE):
        s = 3 * i
        A[:, s:s + 6, s:s + 6] += rA[:, i, :6, :6]
        b[:, s:s + 6] += rb[:, i, :6]
        A[:, c:, c:] += rA[:, i, 6:, 6:]
        b[:, c:] += rb[:, i, 6:]
        A[:, s:s + 6, c:] += rA[:, i, :6, 6:]
        A[:, c:, s:s + 6] += rA[:, i, 6:, :6]
    A = A * 1000.0 + 1e-8 * torch.eye(n, dtype=A.dtype, device=A.device)
    return _solve_nan(A, b * 1000.0)


def _rows(dt, RiT, RiT_Rj, g_cols, extra=None):
    """(B, W, 6, 6 + k) interval rows: [Δp; Δv] against [vᵢ | vⱼ | g-columns
    (3 or 2: ``g_cols`` (B, W, 3, k_g), the Δp rows take them ·dt/2) |
    ``extra`` (B, W, 3, 1) scale column on the Δp rows]."""
    B, W = RiT.shape[:2]
    dtype, dev = RiT.dtype, RiT.device
    kg = g_cols.shape[-1]
    k = 6 + kg + (0 if extra is None else 1)
    eye = torch.eye(3, dtype=dtype, device=dev).expand(B, W, 3, 3)
    tA = torch.zeros((B, W, 6, k), dtype=dtype, device=dev)
    tA[:, :, 0:3, 0:3] = -dt * eye
    tA[:, :, 0:3, 6:6 + kg] = g_cols * (dt * dt / 2.0)
    if extra is not None:
        tA[:, :, 0:3, 6 + kg:] = extra
    tA[:, :, 3:6, 0:3] = -eye
    tA[:, :, 3:6, 3:6] = RiT_Rj
    tA[:, :, 3:6, 6:6 + kg] = g_cols * dt
    return tA


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _tangent_basis(g):
    """(B, 3, 2) orthonormal basis of the plane normal to g (B, 3)."""
    a = g / torch.linalg.norm(g, dim=-1, keepdim=True)
    ez = quat.const((0.0, 0.0, 1.0), g.dtype, g.device)
    ex = quat.const((1.0, 0.0, 0.0), g.dtype, g.device)
    tmp = torch.where(torch.abs(a[:, 2:3]) > 0.99, ex, ez)
    b1 = tmp - a * torch.sum(a * tmp, dim=-1, keepdim=True)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    return torch.stack([b1, torch.linalg.cross(a, b1, dim=-1)], dim=-1)


def _tic_term(RiT_Rj, tic):
    """Rᵢᵀ·Rⱼ·tic − tic per interval, (B, W, 3)."""
    return _mv(RiT_Rj, tic[:, None].expand(RiT_Rj.shape[:2] + (3,))) - tic[:, None]


def linear_alignment_with_depth(dp, dv, sum_dt, P, Q, tic, valid, g_norm: float):
    """Per-frame body velocities and gravity, no scale (depth gives metric
    positions): dp, dv (B, W, 3), sum_dt (B, W), P (B, FRAMES, 3), Q (B,
    FRAMES, 4), tic (B, 3), valid (B, W).  Returns (V (B, FRAMES, 3), g
    (B, 3) refined on its tangent, ok (B,): ‖g‖ of the linear solve within
    1 of ``g_norm``)."""
    dt, RiT, RiT_Rj = _interval_terms(sum_dt, Q)
    tA = _rows(dt, RiT, RiT_Rj, RiT)
    tb = torch.cat([dp + _tic_term(RiT_Rj, tic) - _mv(RiT, P[:, 1:] - P[:, :-1]), dv], dim=-1)
    x = _solve_window(tA, tb, valid, 3)
    g = x[:, -3:]
    ok = torch.abs(torch.linalg.norm(g, dim=-1) - g_norm) < 1.0
    g, x = refine_gravity_with_depth(dp, dv, sum_dt, P, Q, tic, valid, g, g_norm)
    return x[:, :3 * FRAMES].reshape(-1, FRAMES, 3), g, ok


def refine_gravity_with_depth(dp, dv, sum_dt, P, Q, tic, valid, g0, g_norm: float,
                              iters: int = 4):
    """Gravity refined on its 2-dof tangent at magnitude ``g_norm``, ``iters``
    rounds.  Returns (g (B, 3), x (B, 3·FRAMES + 3): the last round's
    velocities and the final g)."""
    dt, RiT, RiT_Rj = _interval_terms(sum_dt, Q)
    base = dp + _tic_term(RiT_Rj, tic) - _mv(RiT, P[:, 1:] - P[:, :-1])
    g = g0
    for _ in range(iters):
        g0u = g / torch.linalg.norm(g, dim=-1, keepdim=True) * g_norm
        lxly = _tangent_basis(g0u)
        Rg = _mv(RiT, g0u[:, None].expand_as(dp))
        tA = _rows(dt, RiT, RiT_Rj, RiT @ lxly[:, None])
        tb = torch.cat([base - Rg * (dt[..., 0] * dt[..., 0] / 2.0), dv - Rg * dt[..., 0]],
                       dim=-1)
        x = _solve_window(tA, tb, valid, 2)
        g = g0u + _mv(lxly, x[:, -2:])
    return g, torch.cat([x[:, :3 * FRAMES], g], dim=-1)


def linear_alignment(dp, dv, sum_dt, P, Q, tic, valid, g_norm: float):
    """Monocular alignment with metric scale: per-frame body velocities,
    gravity and the scale s mapping the SFM camera positions P (arbitrary
    scale) to metres.  Returns (V (B, FRAMES, 3), g (B, 3), s (B,), ok
    (B,): ‖g‖ within 1 of ``g_norm`` and s > 0, before and after the
    refinement)."""
    dt, RiT, RiT_Rj = _interval_terms(sum_dt, Q)
    dP = _mv(RiT, P[:, 1:] - P[:, :-1])[..., None] / 100.0
    tA = _rows(dt, RiT, RiT_Rj, RiT, extra=dP)
    tb = torch.cat([dp + _tic_term(RiT_Rj, tic), dv], dim=-1)
    x = _solve_window(tA, tb, valid, 4)
    s = x[:, -1] / 100.0
    g = x[:, -4:-1]
    ok = (torch.abs(torch.linalg.norm(g, dim=-1) - g_norm) < 1.0) & (s > 0)
    g, x = _refine_gravity_scale(dp, dv, sum_dt, P, Q, tic, valid, g, g_norm)
    s = x[:, -1] / 100.0
    return x[:, :3 * FRAMES].reshape(-1, FRAMES, 3), g, s, ok & (s > 0)


def _refine_gravity_scale(dp, dv, sum_dt, P, Q, tic, valid, g0, g_norm: float,
                          iters: int = 4):
    """Gravity tangent refinement with the scale still a state.  Returns
    (g (B, 3), the last round's x (B, 3·FRAMES + 3))."""
    dt, RiT, RiT_Rj = _interval_terms(sum_dt, Q)
    dP = _mv(RiT, P[:, 1:] - P[:, :-1])[..., None] / 100.0
    base = dp + _tic_term(RiT_Rj, tic)
    g = g0
    for _ in range(iters):
        g0u = g / torch.linalg.norm(g, dim=-1, keepdim=True) * g_norm
        lxly = _tangent_basis(g0u)
        Rg = _mv(RiT, g0u[:, None].expand_as(dp))
        tA = _rows(dt, RiT, RiT_Rj, RiT @ lxly[:, None], extra=dP)
        tb = torch.cat([base - Rg * (dt[..., 0] * dt[..., 0] / 2.0), dv - Rg * dt[..., 0]],
                       dim=-1)
        x = _solve_window(tA, tb, valid, 3)
        g = g0u + _mv(lxly, x[:, -3:-1])
    return g, x
