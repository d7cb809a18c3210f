"""A plain sliding-window solve: the Levenberg-Marquardt over one window of
the VINS estimator, written from its equations, in float64 by default.

The window holds 11 frames.  Its factors are VINS-Mono's: the
reprojection of each feature from its first frame into every other frame
that sees it (inverse depth in the first frame, the camera-IMU extrinsic,
the time offset td with the features' image velocities, the rolling
shutter's row term), whitened by 460 / 1.5 and weighted by a Cauchy loss
(IRLS: each factor's residual and Jacobian scaled by 1 / sqrt(1 + |r|²));
with an IMU, the preintegrated IMU factor between neighbouring frames
(midpoint integration from the raw samples, its covariance and its bias
Jacobian propagated sample by sample); the linearized marginalization
prior r0 + J (x ⊟ x0), whose Jacobian is J; with fast relocalization, the
reprojection of matched features into a relocalization pose.  Jacobians
come from forward-mode autodiff of the residuals (``torch.func``).

The steps are the estimator's: up to ``max_iters`` scored candidates, each
accepted when it lowers the cost, the damping λ (from 1e-6) times 0.1 on
an accepted step and 10 on a rejected one, the damped normal equations
(λ · diag, clamped at 1e-6) solved densely over the free dimensions; with
an IMU the solved window is re-anchored afterwards to the first frame's
yaw and position before the solve.

The window's inputs (the frames' poses before the solve, the feature
table, the prior, the IMU samples) are the program's own state at the
solve: this follows the program one solve at a time.  Nothing else of the
program is used, and nothing is imported from it.

``Precision(torch.float32, tf32=True)`` is the control: the same
arithmetic in float32 with the operands of every matrix product (the
rotations of the residuals, the preintegration's propagation, the prior,
the normal equations) rounded as a TF32 tensor core rounds them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

FOCAL = 460.0
SQRT_INFO = FOCAL / 1.5
LAMBDA0, LAMBDA_UP, LAMBDA_DOWN = 1e-6, 10.0, 0.1
WINDOW = 10
FRAMES = WINDOW + 1
NP = 6 * FRAMES          # poses: δp, δθ each
SB = NP                  # speed-biases: δv, δba, δbg each
EX = SB + 9 * FRAMES     # extrinsic: δt, δθ
TD = EX + 6
NX = TD + 1


class Precision(NamedTuple):
    dtype: torch.dtype = torch.float64
    tf32: bool = False


class Flags(NamedTuple):
    """What the configuration states about the solve."""
    use_imu: bool
    estimate_extrinsic: bool
    estimate_td: bool
    max_iters: int
    g_norm: float = 9.81
    noise: tuple = (0.0, 0.0, 0.0, 0.0)  # acc_n, gyr_n, acc_w, gyr_w


class Window(NamedTuple):
    """One solve's inputs over B windows (leading dimension B)."""
    P: torch.Tensor    # (B, 11, 3) world-from-IMU position before the solve
    Q: torch.Tensor    # (B, 11, 4) wxyz
    V: torch.Tensor    # (B, 11, 3)
    Ba: torch.Tensor   # (B, 11, 3)
    Bg: torch.Tensor   # (B, 11, 3)
    tic: torch.Tensor  # (B, 3)
    qic: torch.Tensor  # (B, 4)
    td: torch.Tensor   # (B,)
    start: torch.Tensor      # (B, M) the feature's first frame
    pts: torch.Tensor        # (B, M, 11, 2) normalized observations
    vel: torch.Tensor        # (B, M, 11, 2)
    td_obs: torch.Tensor     # (B, M, 11) td when the observation was taken
    row_scaled: torch.Tensor  # (B, M, 11) rolling-shutter row term
    obs_mask: torch.Tensor   # (B, M, 11)
    inv_depth: torch.Tensor  # (B, M)
    depth_free: torch.Tensor  # (B, M)
    valid: torch.Tensor      # (B, M)
    prior_J: torch.Tensor    # (B, 172, 172)
    prior_r0: torch.Tensor   # (B, 172)
    prior_x0: tuple          # (P, Q, V, Ba, Bg, tic, qic, td) of the prior's point
    prior_valid: torch.Tensor  # (B,)
    imu_dts: Optional[torch.Tensor] = None  # (B, 10, N) interval k spans frame k -> k + 1
    imu_acc: Optional[torch.Tensor] = None  # (B, 10, N + 1, 3)
    imu_gyr: Optional[torch.Tensor] = None
    relo_active: Optional[torch.Tensor] = None  # (B,)
    relo_pts: Optional[torch.Tensor] = None     # (B, M, 2)
    relo_valid: Optional[torch.Tensor] = None   # (B, M)
    relo_P: Optional[torch.Tensor] = None       # (B, 3)
    relo_Q: Optional[torch.Tensor] = None       # (B, 4)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 11 significant bits (to nearest, ties to
    even), as a tensor core reads a float32 operand; derivatives pass
    through unrounded."""
    scale = torch.exp2(torch.floor(torch.log2(x.detach().abs().clamp_min(1e-30))) - 10.0)
    return x + (torch.round(x.detach() / scale) * scale - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, tf: bool = False) -> torch.Tensor:
    """a @ b, its operands rounded to TF32 with ``tf``."""
    if tf:
        a, b = tf32(a), tf32(b)
    return a @ b


# -- rotations (unit quaternions wxyz) ---------------------------------------

def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def qnorm(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def small(theta):
    """[1, θ/2]."""
    return torch.cat([torch.ones_like(theta[..., :1]), 0.5 * theta], -1)


def boxplus(q, theta):
    return qnorm(qmul(q, small(theta)))


def q2R(q):
    w, x, y, z = qnorm(q).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)],
        -2)


def rot(q, v, tf: bool = False):
    return mm(q2R(q), v[..., None], tf)[..., 0]


def rot_inv(q, v, tf: bool = False):
    return mm(q2R(q).transpose(-1, -2), v[..., None], tf)[..., 0]


def qdiff(q, q0):
    """2 vec(q0⁻¹ ⊗ q), its scalar made positive."""
    e = qmul(qconj(q0), q)
    e = torch.where(e[..., :1] < 0, -e, e)
    return 2.0 * e[..., 1:]


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def angle_deg(q, q0):
    """The angle between two attitudes, in degrees."""
    e = qmul(qconj(qnorm(q0)), qnorm(q))
    return torch.rad2deg(2.0 * torch.atan2(torch.linalg.norm(e[..., 1:], dim=-1),
                                           torch.abs(e[..., 0])))


def ypr(R):
    """[yaw, pitch, roll] in degrees of R = Rz(yaw) Ry(pitch) Rx(roll)."""
    n, o, a = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
                    -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y))
    return torch.rad2deg(torch.stack([y, p, r], -1))


def Rz(yaw_deg):
    c, s = torch.cos(torch.deg2rad(yaw_deg)), torch.sin(torch.deg2rad(yaw_deg))
    o, i = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, o], -1), torch.stack([s, c, o], -1),
                        torch.stack([o, o, i], -1)], -2)


def R2q(R):
    """A unit quaternion of R (the largest of the four candidates)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]

    def g(i, j):
        return R[..., i, j]

    c = torch.stack([
        torch.stack([1 + tr, g(2, 1) - g(1, 2), g(0, 2) - g(2, 0), g(1, 0) - g(0, 1)], -1),
        torch.stack([g(2, 1) - g(1, 2), 1 + g(0, 0) - g(1, 1) - g(2, 2), g(0, 1) + g(1, 0),
                     g(0, 2) + g(2, 0)], -1),
        torch.stack([g(0, 2) - g(2, 0), g(0, 1) + g(1, 0), 1 - g(0, 0) + g(1, 1) - g(2, 2),
                     g(1, 2) + g(2, 1)], -1),
        torch.stack([g(1, 0) - g(0, 1), g(0, 2) + g(2, 0), g(1, 2) + g(2, 1),
                     1 - g(0, 0) - g(1, 1) + g(2, 2)], -1)], -2)
    k = torch.argmax(torch.stack([tr, g(0, 0), g(1, 1), g(2, 2)], -1), -1)
    q = torch.gather(c, -2, k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    q = qnorm(q)
    return torch.where(q[..., :1] < 0, -q, q)


# -- IMU preintegration ------------------------------------------------------

def preintegrate(dts, acc, gyr, ba, bg, noise, prec: Precision):
    """Midpoint preintegration of each interval, sample by sample: (Δp, Δq,
    Δv, the 15 × 15 Jacobian, the covariance, the interval's length).
    dts (..., N), acc and gyr (..., N + 1, 3), ba and bg (..., 3); state
    order δp, δθ, δv, δba, δbg; zero dts are no step."""
    dt_, tf = prec.dtype, prec.tf32
    lead = dts.shape[:-1]
    dev = dts.device
    acc_n, gyr_n, acc_w, gyr_w = noise
    nd = torch.tensor([acc_n] * 3 + [gyr_n] * 3 + [acc_n] * 3 + [gyr_n] * 3 + [acc_w] * 3
                      + [gyr_w] * 3, dtype=dt_, device=dev) ** 2
    I3 = torch.eye(3, dtype=dt_, device=dev).expand(lead + (3, 3))
    Z3 = torch.zeros_like(I3)
    dp = torch.zeros(lead + (3,), dtype=dt_, device=dev)
    dv = torch.zeros_like(dp)
    dq = torch.zeros(lead + (4,), dtype=dt_, device=dev)
    dq[..., 0] = 1.0
    J = torch.eye(15, dtype=dt_, device=dev).expand(lead + (15, 15)).clone()
    C = torch.zeros(lead + (15, 15), dtype=dt_, device=dev)
    for k in range(dts.shape[-1]):
        dt = dts[..., k]
        d = dt[..., None, None]
        a0 = acc[..., k, :] - ba
        a1 = acc[..., k + 1, :] - ba
        w = 0.5 * (gyr[..., k, :] + gyr[..., k + 1, :]) - bg
        dq1 = boxplus(dq, w * dt[..., None])
        R0, R1 = q2R(dq), q2R(dq1)
        ua = 0.5 * (rot(dq, a0, tf) + rot(dq1, a1, tf))
        dp = dp + dv * dt[..., None] + 0.5 * ua * (dt * dt)[..., None]
        dv = dv + ua * dt[..., None]
        dq = dq1
        R1a1 = mm(R1, skew(a1), tf)
        ImW = I3 - skew(w) * d
        F = torch.cat([
            torch.cat([I3, -0.25 * mm(R0, skew(a0), tf) * d * d - 0.25 * mm(R1a1, ImW, tf) * d * d,
                       I3 * d, -0.25 * (R0 + R1) * d * d, 0.25 * R1a1 * d * d * d], -1),
            torch.cat([Z3, ImW, Z3, Z3, -I3 * d], -1),
            torch.cat([Z3, -0.5 * mm(R0, skew(a0), tf) * d - 0.5 * mm(R1a1, ImW, tf) * d, I3,
                       -0.5 * (R0 + R1) * d, 0.5 * R1a1 * d * d], -1),
            torch.cat([Z3, Z3, Z3, I3, Z3], -1),
            torch.cat([Z3, Z3, Z3, Z3, I3], -1)], -2)
        v03 = -0.125 * R1a1 * d * d * d
        v63 = -0.25 * R1a1 * d * d
        V = torch.cat([
            torch.cat([0.25 * R0 * d * d, v03, 0.25 * R1 * d * d, v03, Z3, Z3], -1),
            torch.cat([Z3, 0.5 * I3 * d, Z3, 0.5 * I3 * d, Z3, Z3], -1),
            torch.cat([0.5 * R0 * d, v63, 0.5 * R1 * d, v63, Z3, Z3], -1),
            torch.cat([Z3, Z3, Z3, Z3, I3 * d, Z3], -1),
            torch.cat([Z3, Z3, Z3, Z3, Z3, I3 * d], -1)], -2)
        J = mm(F, J, tf)
        C = mm(mm(F, C, tf), F.transpose(-1, -2), tf) + mm(V * nd, V.transpose(-1, -2), tf)
    return dp, dq, dv, J, C, dts.sum(-1)


# -- residuals of one factor (autodiff gives their Jacobians) ------------------

def _reproject(d, Pi, Qi, Pj, Qj, tic, qic, lam, td, pi, pj, vi, vj, tdi, tdj, rowi, rowj,
               tf=False):
    """Feature seen at ``pi`` in frame i (inverse depth ``lam``), reprojected
    into frame j against ``pj``; ``d`` perturbs [pose i, pose j, extrinsic,
    inverse depth, td]."""
    Pi, Qi = Pi + d[0:3], boxplus(Qi, d[3:6])
    Pj, Qj = Pj + d[6:9], boxplus(Qj, d[9:12])
    tic, qic = tic + d[12:15], boxplus(qic, d[15:18])
    lam, td = lam + d[18], td + d[19]
    ui = pi - (td - tdi + rowi) * vi
    uj = pj - (td - tdj + rowj) * vj
    p_ci = torch.cat([ui, torch.ones_like(ui[:1])]) / lam
    p_w = rot(Qi, rot(qic, p_ci, tf) + tic, tf) + Pi
    p_cj = rot_inv(qic, rot_inv(Qj, p_w - Pj, tf) - tic, tf)
    return SQRT_INFO * (p_cj[:2] / p_cj[2] - uj)


def _imu_residual(d, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj, dp, dq, dv, Jp, T, lba, lbg,
                  g, U, tf=False):
    """The whitened 15-dim IMU residual between frames i and j; ``d``
    perturbs [pose i, speed-bias i, pose j, speed-bias j]."""
    Pi, Qi, Vi = Pi + d[0:3], boxplus(Qi, d[3:6]), Vi + d[6:9]
    Bai, Bgi = Bai + d[9:12], Bgi + d[12:15]
    Pj, Qj, Vj = Pj + d[15:18], boxplus(Qj, d[18:21]), Vj + d[21:24]
    Baj, Bgj = Baj + d[24:27], Bgj + d[27:30]
    dba, dbg = Bai - lba, Bgi - lbg
    def lin(a, b):
        return mm(a, b[:, None], tf)[:, 0]

    dp_c = dp + lin(Jp[0:3, 9:12], dba) + lin(Jp[0:3, 12:15], dbg)
    dq_c = boxplus(dq, lin(Jp[3:6, 12:15], dbg))
    dv_c = dv + lin(Jp[6:9, 9:12], dba) + lin(Jp[6:9, 12:15], dbg)
    rp = rot_inv(Qi, 0.5 * g * T * T + Pj - Pi - Vi * T, tf) - dp_c
    rq = 2.0 * qmul(qconj(dq_c), qmul(qconj(Qi), Qj))[1:]
    rv = rot_inv(Qi, g * T + Vj - Vi, tf) - dv_c
    return lin(U, torch.cat([rp, rq, rv, Baj - Bai, Bgj - Bgi]))


def _batched(f, tf: bool, jac: bool):
    g = functools.partial(f, tf=tf)
    return vmap(jacfwd(g) if jac else g)


# -- the solve ---------------------------------------------------------------

class _State(NamedTuple):
    P: torch.Tensor
    Q: torch.Tensor
    V: torch.Tensor
    Ba: torch.Tensor
    Bg: torch.Tensor
    tic: torch.Tensor
    qic: torch.Tensor
    td: torch.Tensor
    lam: torch.Tensor
    rP: torch.Tensor
    rQ: torch.Tensor


def _tangent(s: _State, p0: tuple) -> torch.Tensor:
    """(B, 172) s ⊟ the prior's point."""
    P, Q, V, Ba, Bg, tic, qic, td = p0
    B = s.P.shape[0]
    pose = torch.cat([s.P - P, qdiff(s.Q, Q)], -1).reshape(B, -1)
    sb = torch.cat([s.V - V, s.Ba - Ba, s.Bg - Bg], -1).reshape(B, -1)
    return torch.cat([pose, sb, s.tic - tic, qdiff(s.qic, qic), (s.td - td)[:, None]], -1)


def _dense_rows(J, r, cols, N):
    """Rows of a dense (B, R, N) Jacobian from factors' local Jacobians
    J (B, K, d, n), residuals r (B, K, d) and columns cols (B, K, n)."""
    B, K, d, n = J.shape
    out = torch.zeros((B, K * d, N), dtype=J.dtype, device=J.device)
    out.scatter_(2, cols[:, :, None, :].expand(B, K, d, n).reshape(B, K * d, n),
                 J.reshape(B, K * d, n))
    return out, r.reshape(B, K * d)


def _system(s: _State, w: Window, fl: Flags, pre, relo: bool, prec: Precision, N: int,
            lam0: int, with_jac: bool = True):
    """The cost at ``s`` and, with ``with_jac``, the normal equations
    (H (B, N, N), g (B, N))."""
    B, M = w.start.shape
    dt_ = prec.dtype
    dev = s.P.device
    bi = torch.arange(B, device=dev)[:, None, None]
    st = w.start.long()
    si = st[:, :, None].expand(B, M, FRAMES)
    jj = torch.arange(FRAMES, device=dev).expand(B, M, FRAMES)
    first = torch.gather(w.obs_mask, 2, st[:, :, None])
    ok = w.valid[:, :, None] & first & w.obs_mask & (jj != si)

    def at_start(a):  # (B, M, F, ...) at each feature's first frame
        return a[torch.arange(B, device=dev)[:, None], torch.arange(M, device=dev), st]

    def grid(a):  # (B, M, ...) -> (B, M, F, ...)
        return a[:, :, None].expand((B, M, FRAMES) + a.shape[2:])

    zero = torch.zeros((), dtype=dt_, device=dev)
    args = [s.P[bi, si], s.Q[bi, si], s.P[:, None].expand(B, M, FRAMES, 3),
            s.Q[:, None].expand(B, M, FRAMES, 4), s.tic[:, None, None].expand(B, M, FRAMES, 3),
            s.qic[:, None, None].expand(B, M, FRAMES, 4), grid(s.lam),
            s.td[:, None, None].expand(B, M, FRAMES), grid(at_start(w.pts)), w.pts,
            grid(at_start(w.vel)), w.vel, grid(at_start(w.td_obs)), w.td_obs,
            grid(at_start(w.row_scaled)), w.row_scaled]
    flat = [a.reshape((-1,) + a.shape[3:]) for a in args]
    # a feature's first frame against itself is masked: evaluate it elsewhere
    okf = ok.reshape(-1)
    flat[2] = torch.where(okf[:, None], flat[2], flat[2] + 1.0)
    d0 = torch.zeros((okf.shape[0], 20), dtype=dt_, device=dev)
    parts_J, parts_r, parts_c = [], [], []
    tf = prec.tf32
    r = torch.where(okf[:, None], _batched(_reproject, tf, False)(d0, *flat), zero)
    wgt = torch.rsqrt(1.0 + (r * r).sum(-1, keepdim=True))
    cost = ((wgt * r) ** 2).reshape(B, -1).sum(-1)
    if with_jac:
        J = torch.where(okf[:, None, None], _batched(_reproject, tf, True)(d0, *flat),
                        zero) * wgt[..., None]
        pose = lambda k: 6 * k[..., None] + torch.arange(6, device=dev)  # noqa: E731
        cols = torch.cat([pose(si), pose(jj), (EX + torch.arange(6, device=dev)).expand(
            B, M, FRAMES, 6), grid(lam0 + torch.arange(M, device=dev).expand(B, M))[..., None],
            torch.full((B, M, FRAMES, 1), TD, device=dev)], -1)
        parts_J.append(J.reshape(B, M * FRAMES, 2, 20))
        parts_r.append((wgt * r).reshape(B, M * FRAMES, 2))
        parts_c.append(cols.reshape(B, M * FRAMES, 20))
    if relo:
        okr = (w.relo_active[:, None] & w.valid & first[..., 0] & w.relo_valid).reshape(-1)
        z2 = torch.zeros((B, M, 2), dtype=dt_, device=dev)
        z1 = torch.zeros((B, M), dtype=dt_, device=dev)
        tdm = s.td[:, None].expand(B, M)
        rargs = [s.P[bi[..., 0], st], s.Q[bi[..., 0], st], s.rP[:, None].expand(B, M, 3),
                 s.rQ[:, None].expand(B, M, 4), s.tic[:, None].expand(B, M, 3),
                 s.qic[:, None].expand(B, M, 4), s.lam, tdm, at_start(w.pts), w.relo_pts,
                 z2, z2, tdm, tdm, z1, z1]
        rflat = [a.reshape((-1,) + a.shape[2:]) for a in rargs]
        dr = torch.zeros((B * M, 20), dtype=dt_, device=dev)
        rr = torch.where(okr[:, None], _batched(_reproject, tf, False)(dr, *rflat), zero)
        wr = torch.rsqrt(1.0 + (rr * rr).sum(-1, keepdim=True))
        cost = cost + ((wr * rr) ** 2).reshape(B, -1).sum(-1)
        if with_jac:
            Jr = torch.where(okr[:, None, None], _batched(_reproject, tf, True)(dr, *rflat),
                             zero) * wr[..., None]
            a6 = torch.arange(6, device=dev)
            cols = torch.cat([6 * st[..., None] + a6, (NX + a6).expand(B, M, 6),
                              (EX + a6).expand(B, M, 6),
                              (lam0 + torch.arange(M, device=dev)).expand(B, M)[..., None],
                              torch.full((B, M, 1), TD, device=dev)], -1)
            parts_J.append(Jr.reshape(B, M, 2, 20))
            parts_r.append((wr * rr).reshape(B, M, 2))
            parts_c.append(cols)
    if fl.use_imu:
        dp, dq, dv, Jp, C, T, lba, lbg, U, ivalid = pre
        g = torch.tensor([0.0, 0.0, fl.g_norm], dtype=dt_, device=dev).expand(B, WINDOW, 3)
        i0, i1 = slice(0, WINDOW), slice(1, FRAMES)
        iargs = [s.P[:, i0], s.Q[:, i0], s.V[:, i0], s.Ba[:, i0], s.Bg[:, i0], s.P[:, i1],
                 s.Q[:, i1], s.V[:, i1], s.Ba[:, i1], s.Bg[:, i1], dp, dq, dv, Jp, T, lba, lbg,
                 g, U]
        iflat = [a.reshape((B * WINDOW,) + a.shape[2:]) for a in iargs]
        di = torch.zeros((B * WINDOW, 30), dtype=dt_, device=dev)
        okv = ivalid.reshape(-1)
        ri = torch.where(okv[:, None], _batched(_imu_residual, tf, False)(di, *iflat), zero)
        cost = cost + (ri * ri).reshape(B, -1).sum(-1)
        if with_jac:
            Ji = torch.where(okv[:, None, None], _batched(_imu_residual, tf, True)(di, *iflat),
                             zero)
            k = torch.arange(WINDOW, device=dev)[:, None]
            a6, a9 = torch.arange(6, device=dev), torch.arange(9, device=dev)
            cols = torch.cat([6 * k + a6, SB + 9 * k + a9, 6 * (k + 1) + a6,
                              SB + 9 * (k + 1) + a9], -1).expand(B, WINDOW, 30)
            parts_J.append(Ji.reshape(B, WINDOW, 15, 30))
            parts_r.append(ri.reshape(B, WINDOW, 15))
            parts_c.append(cols)
    pv = w.prior_valid.to(dt_)[:, None]
    rp = (w.prior_r0 + mm(w.prior_J, _tangent(s, w.prior_x0)[..., None], tf)[..., 0]) * pv
    cost = 0.5 * (cost + (rp * rp).sum(-1))
    if not with_jac:
        return cost, None, None
    rows, res = [], []
    for J, r_, c in zip(parts_J, parts_r, parts_c):
        a, b = _dense_rows(J, r_, c, N)
        rows.append(a)
        res.append(b)
    Jp_rows = torch.zeros((B, NX, N), dtype=dt_, device=dev)
    Jp_rows[:, :, :NX] = w.prior_J * pv[..., None]
    rows.append(Jp_rows)
    res.append(rp)
    Jd = torch.cat(rows, 1)
    rd = torch.cat(res, 1)
    JT = Jd.transpose(1, 2)
    return cost, mm(JT, Jd, tf), mm(JT, rd[..., None], tf)[..., 0]


def _yaw_anchor(x: _State, before: _State) -> _State:
    """Keep frame 0's yaw and position as they were before the solve (the
    whole rotation near ±90° pitch)."""
    Rb, Ro = q2R(before.Q[:, 0]), q2R(x.Q[:, 0])
    yb, yo = ypr(Rb), ypr(Ro)
    singular = (yo[:, 1].abs() > 89.0) | (yb[:, 1].abs() > 89.0)
    Rr = torch.where(singular[:, None, None], Rb @ Ro.transpose(-1, -2), Rz(yb[:, 0] - yo[:, 0]))
    qr = R2q(Rr)[:, None]
    P0 = x.P[:, :1]
    return x._replace(P=rot(qr, x.P - P0) + before.P[:, :1],
                      Q=qnorm(qmul(qr.expand_as(x.Q), x.Q)), V=rot(qr, x.V))


def _prepare(w: Window, fl: Flags, prec: Precision):
    """The window in the solve's precision, its free dimensions and its
    IMU preintegration."""
    dt_ = prec.dtype
    w = Window(*[a.to(dt_) if isinstance(a, torch.Tensor) and a.is_floating_point()
                 else (tuple(x.to(dt_) for x in a) if isinstance(a, tuple) else a) for a in w])
    B, M = w.start.shape
    dev = w.P.device
    relo = w.relo_active is not None
    lam0 = NX + (6 if relo else 0)
    N = lam0 + M
    free = torch.ones((B, N), dtype=dt_, device=dev)
    if not fl.use_imu:
        free[:, SB:EX] = 0.0
        free[:, 0:6] = 0.0  # without an IMU the first pose anchors the window
    if not fl.estimate_extrinsic:
        free[:, EX:EX + 6] = 0.0
    if not fl.estimate_td:
        free[:, TD] = 0.0
    elif fl.use_imu:
        free[:, TD] = (torch.linalg.norm(w.V[:, 0], dim=-1) > 0.2).to(dt_)
    if relo:
        free[:, NX:NX + 6] = w.relo_active.to(dt_)[:, None]
    free[:, lam0:] = w.depth_free.to(dt_)
    pre = None
    if fl.use_imu:
        lba, lbg = w.Ba[:, :WINDOW], w.Bg[:, :WINDOW]
        dp, dq, dv, Jp, C, T = preintegrate(w.imu_dts, w.imu_acc, w.imu_gyr, lba, lbg, fl.noise,
                                            prec)
        eye = torch.eye(15, dtype=dt_, device=dev)
        info = torch.linalg.inv(C + 1e-12 * eye)
        U = torch.linalg.cholesky(0.5 * (info + info.transpose(-1, -2))).transpose(-1, -2)
        pre = (dp, dq, dv, Jp, C, T, lba, lbg, U, (T > 0) & (T < 10.0))
    z = torch.zeros((B, 3), dtype=dt_, device=dev)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dt_, device=dev).expand(B, 4)
    x0 = _State(w.P, w.Q, w.V, w.Ba, w.Bg, w.tic, w.qic, w.td, w.inv_depth,
                w.relo_P if relo else z, w.relo_Q if relo else ident)
    return w, x0, free, pre, relo, lam0, N


def _at(x0: _State, sol: dict, dtype) -> _State:
    return _State(*[sol[k].to(dtype) if k in sol else getattr(x0, f) for k, f in zip(
        ("P", "Q", "V", "Ba", "Bg", "tic", "qic", "td", "inv_depth", "relo_P", "relo_Q"),
        _State._fields)])


def cost_at(w: Window, fl: Flags, sol: dict, prec: Precision = Precision()) -> torch.Tensor:
    """(B,) the window's cost at a solved window ``sol`` (P, Q, V, Ba, Bg,
    tic, qic, td, inv_depth, and relo_P, relo_Q where the window has a
    relocalization; a key left out keeps the window's value before the
    solve), computed in ``prec``."""
    w, x0, free, pre, relo, lam0, N = _prepare(w, fl, prec)
    return _system(_at(x0, sol, prec.dtype), w, fl, pre, relo, prec, N, lam0,
                   with_jac=False)[0]


def decrement(w: Window, fl: Flags, sol: dict) -> torch.Tensor:
    """(B,) how far a solved window ``sol`` lies from the optimum, in the
    cost's own units: the decrease ½ gᵀ H⁻¹ g that one Gauss-Newton step
    from it predicts (float64, over the free dimensions, H's diagonal
    raised by 1e-9 of itself), over the cost there.  It reads the point
    alone, not the path a solve took to it."""
    prec = Precision()
    w, x0, free, pre, relo, lam0, N = _prepare(w, fl, prec)
    cost, H, g = _system(_at(x0, sol, prec.dtype), w, fl, pre, relo, prec, N, lam0)
    Hf = H * free[:, :, None] * free[:, None, :]
    d = torch.clamp(torch.diagonal(Hf, dim1=1, dim2=2), min=1e-12)
    A = Hf + ((1e-9 * d) * free + (1.0 - free)).diag_embed()
    gf = (g * free)[..., None]
    L, info = torch.linalg.cholesky_ex(A)
    dec = 0.5 * (gf * torch.cholesky_solve(gf, L)).sum((1, 2)) / cost
    return torch.where(info == 0, dec, torch.full_like(dec, float("nan")))


def solve(w: Window, fl: Flags, prec: Precision = Precision()) -> dict:
    """The window after the solve: P, Q, V, Ba, Bg (B, 11, ...), tic, qic,
    td, inv_depth, relo_P, relo_Q and the final cost."""
    w, x0, free, pre, relo, lam0, N = _prepare(w, fl, prec)
    dt_ = prec.dtype
    B = w.P.shape[0]
    dev = w.P.device
    best, cand = x0, x0
    cost_b = torch.full((B,), float("inf"), dtype=dt_, device=dev)
    H_b = torch.zeros((B, N, N), dtype=dt_, device=dev)
    g_b = torch.zeros((B, N), dtype=dt_, device=dev)
    lm = torch.full((B,), LAMBDA0, dtype=dt_, device=dev)
    eye = torch.eye(N, dtype=dt_, device=dev)
    for it in range(fl.max_iters + 1):
        last = it == fl.max_iters
        cost, H, g = _system(cand, w, fl, pre, relo, prec, N, lam0, with_jac=not last)
        acc = (cost < cost_b) & torch.isfinite(cost)
        best = _State(*[torch.where(acc.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
                        for a, b in zip(cand, best)])
        boot = ~torch.isfinite(cost_b)
        cost_b = torch.where(acc, cost, cost_b)
        lm = torch.where(boot, lm, torch.where(acc, lm * LAMBDA_DOWN, lm * LAMBDA_UP))
        if last:
            break
        H_b = torch.where(acc[:, None, None], H, H_b)
        g_b = torch.where(acc[:, None], g, g_b)
        Hf = H_b * free[:, :, None] * free[:, None, :]
        damp = lm[:, None] * torch.clamp(torch.diagonal(Hf, dim1=1, dim2=2), min=1e-6) * free
        A = Hf + (damp + (1.0 - free))[:, :, None] * eye
        L, info = torch.linalg.cholesky_ex(A)
        dx = -torch.cholesky_solve((g_b * free)[..., None], L)[..., 0] * free
        dx = torch.where((info == 0)[:, None], dx, torch.full_like(dx, float("nan")))
        dpose = dx[:, :NP].reshape(B, FRAMES, 6)
        dsb = dx[:, SB:EX].reshape(B, FRAMES, 9)
        cand = _State(best.P + dpose[..., :3], boxplus(best.Q, dpose[..., 3:]),
                      best.V + dsb[..., :3], best.Ba + dsb[..., 3:6], best.Bg + dsb[..., 6:],
                      best.tic + dx[:, EX:EX + 3], boxplus(best.qic, dx[:, EX + 3:EX + 6]),
                      best.td + dx[:, TD], best.lam + dx[:, lam0:],
                      best.rP + dx[:, NX:NX + 3] if relo else best.rP,
                      boxplus(best.rQ, dx[:, NX + 3:NX + 6]) if relo else best.rQ)
    if fl.use_imu:
        best = _yaw_anchor(best, x0)
    return dict(P=best.P, Q=best.Q, V=best.V, Ba=best.Ba, Bg=best.Bg, tic=best.tic,
                qic=best.qic, td=best.td, inv_depth=best.lam, relo_P=best.rP, relo_Q=best.rQ,
                cost=cost_b)


def gaps(prog: dict, ref: dict, imu: bool) -> dict:
    """The widest gaps between two solved windows: positions and the
    extrinsic's translation (mm), attitudes and the extrinsic's rotation
    (degrees), and with an IMU the velocities (mm/s) and td (ms)."""
    def f(a):
        return a.double().to(ref["P"].device)

    p = torch.cat([torch.linalg.norm(f(prog["P"]) - ref["P"].double(), dim=-1).flatten(),
                   torch.linalg.norm(f(prog["tic"]) - ref["tic"].double(), dim=-1).flatten()])
    q = torch.cat([angle_deg(f(prog["Q"]), ref["Q"].double()).flatten(),
                   angle_deg(f(prog["qic"]), ref["qic"].double()).flatten()])
    out = dict(solve_p_gap_mm=1e3 * float(p.max()), solve_q_gap_deg=float(q.max()))
    if imu:
        v = torch.linalg.norm(f(prog["V"]) - ref["V"].double(), dim=-1)
        out["solve_v_gap_mmps"] = 1e3 * float(v.max())
        out["solve_td_gap_ms"] = 1e3 * float((f(prog["td"]) - ref["td"].double()).abs().max())
    return out
