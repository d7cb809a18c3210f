"""Batched Levenberg-Marquardt sliding-window solver with dense Schur on
the diagonal landmark block (twin of ``solve``/``normal_equations_
structured`` in ``vins_rgbd_fast_tpu/ops/solver.py``), over B sequences.

Without relocalization factors (the slice runs with ``fast_relo`` off).
Factorizations that fail give NaN, as ``jnp.linalg.cholesky`` does, so the
LM step rejects the non-finite cost instead of raising and synchronising.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..backend.state import (EX_OFF, FRAMES, NP, NX, POSE_DIM, SB_DIM, TD_OFF,
                             WINDOW_SIZE, WindowState, boxminus, boxplus, where_state,
                             yaw_gauge_fix)
from ..backend.feature_table import take_frame
from ..config import SolverConfig
from . import factors
from . import imu_preintegration as imupre

# the JAX SolverConfig defaults, the only values in use
CAUCHY_C = 1.0
LM_LAMBDA0 = 1e-6
LM_UP = 10.0
LM_DOWN = 0.1


class PriorFactor(NamedTuple):
    """Linearized marginalization prior r(x) = r0 + J·(x ⊟ x0)."""
    J: torch.Tensor    # (B, NX, NX)
    r0: torch.Tensor   # (B, NX)
    x0: WindowState
    valid: torch.Tensor  # (B,) bool


def empty_prior(B: int, device, dtype=torch.float32) -> PriorFactor:
    from ..backend.state import identity_state
    return PriorFactor(J=torch.zeros((B, NX, NX), dtype=dtype, device=device),
                       r0=torch.zeros((B, NX), dtype=dtype, device=device),
                       x0=identity_state(B, device, dtype),
                       valid=torch.zeros((B,), dtype=torch.bool, device=device))


class VisualData(NamedTuple):
    start: torch.Tensor       # (B, MAXF) int32
    pts: torch.Tensor         # (B, MAXF, FRAMES, 2)
    vel: torch.Tensor         # (B, MAXF, FRAMES, 2)
    td_obs: torch.Tensor      # (B, MAXF, FRAMES)
    row_scaled: torch.Tensor  # (B, MAXF, FRAMES)
    obs_mask: torch.Tensor    # (B, MAXF, FRAMES) bool
    inv_depth: torch.Tensor   # (B, MAXF)
    depth_free: torch.Tensor  # (B, MAXF) bool
    valid: torch.Tensor       # (B, MAXF) bool


class ImuData(NamedTuple):
    pre: imupre.Preintegrated  # leaves (B, WINDOW_SIZE, ...)
    valid: torch.Tensor        # (B, WINDOW_SIZE) bool


class StructuredSystem(NamedTuple):
    Hpp: torch.Tensor  # (B, NX, NX)
    Hpl: torch.Tensor  # (B, NX, MAXF)
    dl: torch.Tensor   # (B, MAXF) diagonal of the landmark block
    gp: torch.Tensor   # (B, NX)
    gl: torch.Tensor   # (B, MAXF)


class SolveResult(NamedTuple):
    x: WindowState
    inv_depth: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor
    iters_accepted: torch.Tensor


def _proj_grid(x: WindowState, vis: VisualData):
    """All (MAXF × FRAMES) projection factors, Cauchy-weighted and masked:
    r (B, M, F, 2), Jl (B, M, F, 2, 20)."""
    B, M = vis.start.shape
    dtype = x.P.dtype
    s = vis.start.to(torch.int64)
    bidx = torch.arange(B, device=s.device)[:, None]
    full = (B, M, FRAMES)

    def ex(t):  # (B, M, ...) -> (B, M, F, ...)
        return t[:, :, None].expand(full + t.shape[2:])

    one = torch.ones(full + (1,), dtype=dtype, device=s.device)
    zero = torch.zeros(full + (1,), dtype=dtype, device=s.device)
    meas = factors.ProjMeas(
        pts_i=torch.cat([ex(take_frame(vis.pts, s)), one], -1),
        pts_j=torch.cat([vis.pts, one], -1),
        vel_i=torch.cat([ex(take_frame(vis.vel, s)), zero], -1),
        vel_j=torch.cat([vis.vel, zero], -1),
        td_i=ex(take_frame(vis.td_obs, s)), td_j=vis.td_obs,
        row_i=ex(take_frame(vis.row_scaled, s)), row_j=vis.row_scaled)
    Pi, Qi = ex(x.P[bidx, s]), ex(x.Q[bidx, s])
    Pj = x.P[:, None].expand(full + (3,))
    Qj = x.Q[:, None].expand(full + (4,))
    r, Jl = factors.projection_factor(
        Pi, Qi, Pj, Qj, x.tic[:, None, None].expand(full + (3,)),
        x.qic[:, None, None].expand(full + (4,)), ex(vis.inv_depth),
        x.td[:, None, None].expand(full), meas)
    j_idx = torch.arange(FRAMES, device=s.device)
    ok = (vis.valid[..., None] & take_frame(vis.obs_mask, s)[..., None] & vis.obs_mask
          & (j_idx != s[..., None]))
    r = torch.where(ok[..., None], r, torch.zeros_like(r))
    w = factors.cauchy_weight(r, CAUCHY_C)
    Jl = torch.where(ok[..., None, None], Jl, torch.zeros_like(Jl)) * w[..., None]
    return r * w, Jl


def _accumulate_proj_s(vis: VisualData, r, Jl, s: StructuredSystem) -> StructuredSystem:
    """Normal equations of the projection factors in Schur form: the dynamic
    start-frame index is a one-hot contraction, the others are grid axes."""
    B, M = vis.start.shape
    dtype = s.Hpp.dtype
    # one-hot by comparison: F.one_hot range-checks its input on the host
    frames = torch.arange(FRAMES, device=vis.start.device)
    Oi = (vis.start[..., None] == frames).to(dtype)  # (B, M, F)
    Ji, Jj, Je = Jl[..., 0:6], Jl[..., 6:12], Jl[..., 12:18]
    Jlam, Jt = Jl[..., 18], Jl[..., 19]

    def blk(A, Bm):
        return torch.einsum("bfjpa,bfjpq->bfjaq", A, Bm)

    M_ii, M_ij, M_jj = blk(Ji, Ji), blk(Ji, Jj), blk(Jj, Jj)
    M_ie, M_je, M_ee = blk(Ji, Je), blk(Jj, Je), blk(Je, Je)

    diag_ii = torch.einsum("bfa,bfjxy->baxy", Oi, M_ii)
    diag_jj = M_jj.sum(dim=1)
    cross_ij = torch.einsum("bfa,bfcxy->bacxy", Oi, M_ij)
    Hpp = cross_ij + cross_ij.permute(0, 2, 1, 4, 3)
    idx = torch.arange(FRAMES, device=Oi.device)
    Hpp[:, idx, idx] += diag_ii + diag_jj
    H = s.Hpp.clone()
    H[:, :NP, :NP] += Hpp.permute(0, 1, 3, 2, 4).reshape(B, NP, NP)

    Hpe = (torch.einsum("bfa,bfjxy->baxy", Oi, M_ie) + M_je.sum(dim=1)).reshape(B, NP, 6)
    H[:, :NP, EX_OFF:EX_OFF + 6] += Hpe
    H[:, EX_OFF:EX_OFF + 6, :NP] += Hpe.transpose(1, 2)
    H[:, EX_OFF:EX_OFF + 6, EX_OFF:EX_OFF + 6] += M_ee.sum(dim=(1, 2))

    dl = s.dl + torch.einsum("bfjp,bfjp->bf", Jlam, Jlam)
    A_i = torch.einsum("bfjpx,bfjp->bfx", Ji, Jlam)
    A_j = torch.einsum("bfjpx,bfjp->bfjx", Jj, Jlam)
    Hplam = (torch.einsum("bfa,bfx->baxf", Oi, A_i)
             + A_j.permute(0, 2, 3, 1)).reshape(B, NP, M)
    Hpl = s.Hpl.clone()
    Hpl[:, :NP] += Hplam
    Hpl[:, EX_OFF:EX_OFF + 6] += torch.einsum("bfjpx,bfjp->bxf", Je, Jlam)
    Hpl[:, TD_OFF] += torch.einsum("bfjp,bfjp->bf", Jlam, Jt)

    H[:, TD_OFF, TD_OFF] += torch.einsum("bfjp,bfjp->b", Jt, Jt)
    t_pose = (torch.einsum("bfa,bfjpx,bfjp->bax", Oi, Ji, Jt)
              + torch.einsum("bfjpx,bfjp->bjx", Jj, Jt)).reshape(B, NP)
    H[:, TD_OFF, :NP] += t_pose
    H[:, :NP, TD_OFF] += t_pose
    t_ex = torch.einsum("bfjpx,bfjp->bx", Je, Jt)
    H[:, TD_OFF, EX_OFF:EX_OFF + 6] += t_ex
    H[:, EX_OFF:EX_OFF + 6, TD_OFF] += t_ex

    g = s.gp.clone()
    g_i = torch.einsum("bfjpx,bfjp->bfx", Ji, r)
    g_j = torch.einsum("bfjpx,bfjp->bfjx", Jj, r)
    g[:, :NP] += (torch.einsum("bfa,bfx->bax", Oi, g_i) + g_j.sum(dim=1)).reshape(B, NP)
    g[:, EX_OFF:EX_OFF + 6] += torch.einsum("bfjpx,bfjp->bx", Je, r)
    g[:, TD_OFF] += torch.einsum("bfjp,bfjp->b", Jt, r)
    gl = s.gl + torch.einsum("bfjp,bfjp->bf", Jlam, r)
    return StructuredSystem(Hpp=H, Hpl=Hpl, dl=dl, gp=g, gl=gl)


def _imu_batch(x: WindowState, imu: ImuData, gravity, sqrt_infos):
    """The WINDOW_SIZE IMU factors: r (B, W, 15), Jl (B, W, 15, 30)."""
    def sl(a, lo):
        return a[:, lo:lo + WINDOW_SIZE]
    r, Jl = factors.imu_factor_whitened(
        imu.pre, sl(x.P, 0), sl(x.Q, 0), sl(x.V, 0), sl(x.Ba, 0), sl(x.Bg, 0),
        sl(x.P, 1), sl(x.Q, 1), sl(x.V, 1), sl(x.Ba, 1), sl(x.Bg, 1),
        gravity, sqrt_infos)
    ok = imu.valid[..., None]
    r = torch.where(ok, r, torch.zeros_like(r))
    return r, torch.where(ok[..., None], Jl, torch.zeros_like(Jl))


def _imu_rows(Jl):
    """(B, W·15, NX) dense rows of the IMU factors at static offsets."""
    B = Jl.shape[0]
    rows = torch.zeros((B, WINDOW_SIZE, 15, NX), dtype=Jl.dtype, device=Jl.device)
    for j in range(WINDOW_SIZE):
        rows[:, j, :, POSE_DIM * j:POSE_DIM * (j + 1)] = Jl[:, j, :, 0:6]
        rows[:, j, :, NP + SB_DIM * j:NP + SB_DIM * (j + 1)] = Jl[:, j, :, 6:15]
        rows[:, j, :, POSE_DIM * (j + 1):POSE_DIM * (j + 2)] = Jl[:, j, :, 15:21]
        rows[:, j, :, NP + SB_DIM * (j + 1):NP + SB_DIM * (j + 2)] = Jl[:, j, :, 21:30]
    return rows.reshape(B, -1, NX)


def _prior_residual(x: WindowState, prior: PriorFactor):
    dx = boxminus(x, prior.x0)
    return (prior.r0 + (prior.J @ dx[..., None])[..., 0]) * prior.valid.to(dx.dtype)[:, None]


def free_mask(vis: VisualData, dtype) -> torch.Tensor:
    """(B, NX + MAXF) 1.0 for free tangent dims: extrinsic and td frozen
    (not estimated), inverse depths free where ``depth_free``."""
    B = vis.start.shape[0]
    m = torch.ones((B, NX), dtype=dtype, device=vis.start.device)
    m[:, EX_OFF:EX_OFF + 6] = 0.0
    m[:, TD_OFF] = 0.0
    return torch.cat([m, vis.depth_free.to(dtype)], dim=1)


def normal_equations_structured(x: WindowState, vis: VisualData,
                                imu: Optional[ImuData], prior: PriorFactor, gravity,
                                sqrt_infos=None) -> Tuple[StructuredSystem, torch.Tensor]:
    """Assemble the Schur-form normal equations; returns (system, cost)."""
    B, M = vis.start.shape
    dtype = x.P.dtype
    dev = x.P.device
    rp = _prior_residual(x, prior)
    Jp = prior.J * prior.valid.to(dtype)[:, None, None]
    s = StructuredSystem(
        Hpp=Jp.transpose(1, 2) @ Jp, Hpl=torch.zeros((B, NX, M), dtype=dtype, device=dev),
        dl=torch.zeros((B, M), dtype=dtype, device=dev),
        gp=(Jp.transpose(1, 2) @ rp[..., None])[..., 0],
        gl=torch.zeros((B, M), dtype=dtype, device=dev))
    cost = torch.sum(rp * rp, dim=1)

    r_proj, Jl_proj = _proj_grid(x, vis)
    s = _accumulate_proj_s(vis, r_proj, Jl_proj, s)
    cost = cost + torch.sum(r_proj * r_proj, dim=(1, 2, 3))

    if imu is not None:
        if sqrt_infos is None:
            sqrt_infos = imupre.sqrt_information(imu.pre)
        r_imu, Jl_imu = _imu_batch(x, imu, gravity, sqrt_infos)
        R = _imu_rows(Jl_imu)
        s = s._replace(Hpp=s.Hpp + R.transpose(1, 2) @ R,
                       gp=s.gp + (R.transpose(1, 2) @ r_imu.reshape(B, -1, 1))[..., 0])
        cost = cost + torch.sum(r_imu * r_imu, dim=(1, 2))
    return s, 0.5 * cost


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = b by two triangular solves (``torch.cholesky_solve``
    synchronises the host on CUDA)."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def solve(cfg: SolverConfig, x0: WindowState, vis: VisualData, imu: Optional[ImuData],
          prior: PriorFactor, gravity, sqrt_infos=None) -> SolveResult:
    """Damped Gauss-Newton with delayed accept/reject, ``max_iters`` scored
    candidates (one assembly per iteration), dense Schur, yaw re-anchoring."""
    dtype = x0.P.dtype
    B, M = vis.start.shape
    fm = free_mask(vis, dtype)
    fmp, fml = fm[:, :NX], fm[:, NX:]
    if imu is not None and sqrt_infos is None:
        sqrt_infos = imupre.sqrt_information(imu.pre)
    eye = torch.eye(NX, dtype=dtype, device=x0.P.device)

    def damped_step(s: StructuredSystem, lm):
        Hpp = s.Hpp * fmp[:, None, :] * fmp[:, :, None]
        Hpl = s.Hpl * fmp[:, :, None] * fml[:, None, :]
        dl = s.dl * fml
        gp = s.gp * fmp
        gl = s.gl * fml
        damp_p = lm[:, None] * torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6) + (1.0 - fmp)
        damp_l = lm[:, None] * torch.clamp(dl, min=1e-6) + (1.0 - fml)
        A = Hpp + damp_p[:, :, None] * eye
        Dinv = 1.0 / (dl + damp_l)
        S = A - (Hpl * Dinv[:, None, :]) @ Hpl.transpose(1, 2)
        gs = gp - (Hpl @ (Dinv * gl)[..., None])[..., 0]
        L = cholesky_nan(S)
        dxp = -cho_solve(L, gs[..., None])[..., 0]
        dxl = -Dinv * (gl + (Hpl.transpose(1, 2) @ dxp[..., None])[..., 0])
        return dxp * fmp, dxl * fml

    best = (x0, vis.inv_depth)
    cand = best
    cost_b = torch.full((B,), torch.inf, dtype=dtype, device=x0.P.device)
    z = torch.zeros((B, M), dtype=dtype, device=x0.P.device)
    sys_b = StructuredSystem(Hpp=torch.zeros((B, NX, NX), dtype=dtype, device=z.device),
                             Hpl=torch.zeros((B, NX, M), dtype=dtype, device=z.device),
                             dl=z, gp=torch.zeros((B, NX), dtype=dtype, device=z.device),
                             gl=z)
    lm = torch.full((B,), LM_LAMBDA0, dtype=dtype, device=x0.P.device)
    n_acc = torch.zeros((B,), dtype=torch.int64, device=x0.P.device)
    cost0 = None
    for it in range(cfg.max_iters + 1):
        xc, lamc = cand
        s_c, cost_c = normal_equations_structured(
            xc, vis._replace(inv_depth=lamc), imu, prior, gravity, sqrt_infos)
        if cost0 is None:
            cost0 = cost_c
        accept = (cost_c < cost_b) & torch.isfinite(cost_c)
        best = (where_state(accept, xc, best[0]),
                torch.where(accept[:, None], lamc, best[1]))
        sys_b = where_state(accept, s_c, sys_b)
        bootstrap = ~torch.isfinite(cost_b)
        cost_b = torch.where(accept, cost_c, cost_b)
        lm = torch.where(bootstrap, lm, torch.where(accept, lm * LM_DOWN, lm * LM_UP))
        n_acc = n_acc + accept.to(torch.int64)
        if it == cfg.max_iters:
            break  # the last candidate would never be scored
        dxp, dxl = damped_step(sys_b, lm)
        cand = (boxplus(best[0], dxp), best[1] + dxl)
    x, lam_vec = best
    x = yaw_gauge_fix(x, x0)
    return SolveResult(x=x, inv_depth=lam_vec, cost0=cost0, cost=cost_b,
                       iters_accepted=torch.clamp(n_acc - 1, min=0))
