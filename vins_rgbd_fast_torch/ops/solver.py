"""Batched Levenberg-Marquardt sliding-window solver with dense Schur on
the diagonal landmark block (twin of ``solve``/``normal_equations_
structured`` in ``vins_rgbd_fast_tpu/ops/solver.py``), over B sequences.

With ``SolverConfig.with_relo`` a relocalization pose block (6 tangent
dims after the NX window dims, free only while the constraint is active)
joins the solve, tied to window landmarks by the relo factors of
``ReloData``.  Factorizations that fail give NaN, as ``jnp.linalg.cholesky`` does, so the
LM step rejects the non-finite cost instead of raising and synchronising.

``proj_schur`` is the wrapper of kernel K4 (``csrc/proj_schur.cu``, which
replaces no TPU kernel: JAX assembles the projection factors in plain
``jnp``): on CUDA tensors it launches the kernel, on CPU tensors it runs
the plain version ``proj_schur_plain`` below.  The two sum in different
orders, so they agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..backend.state import (EX_OFF, FRAMES, NP, NX, POSE_DIM, SB_DIM, TD_OFF,
                             WINDOW_SIZE, WindowState, boxminus, boxplus, where_state,
                             yaw_gauge_fix)
from ..backend.feature_table import take_frame
from .. import native
from ..config import SolverConfig
from ..utils import quaternion as quat
from . import factors
from . import imu_preintegration as imupre

# the JAX SolverConfig defaults, the only values in use
CAUCHY_C = 1.0
LM_LAMBDA0 = 1e-6
LM_UP = 10.0
LM_DOWN = 0.1

launches = native.LaunchCount()  # K4 launches (the CUDA path only), by device too


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


class ReloData(NamedTuple):
    """Fast-relocalization constraint: matched old-keyframe observations
    tie an extra pose (initialised at the old keyframe's) to window
    landmarks.  Entries are keyed by feature id; ``remap_relo_by_id`` binds
    them to the rows of the current table."""
    active: torch.Tensor       # (B,) bool
    match_pts: torch.Tensor    # (B, MAXF, 2) old-frame normalized observation per entry
    match_valid: torch.Tensor  # (B, MAXF) bool
    match_ids: torch.Tensor    # (B, MAXF) int32 feature id, -1 = unused
    P: torch.Tensor            # (B, 3)
    Q: torch.Tensor            # (B, 4)


def empty_relo(B: int, maxf: int, device, dtype=torch.float32) -> ReloData:
    """An inactive constraint (what the solve takes when none is pending)."""
    return ReloData(active=torch.zeros((B,), dtype=torch.bool, device=device),
                    match_pts=torch.zeros((B, maxf, 2), dtype=dtype, device=device),
                    match_valid=torch.zeros((B, maxf), dtype=torch.bool, device=device),
                    match_ids=torch.full((B, maxf), -1, dtype=torch.int32, device=device),
                    P=torch.zeros((B, 3), dtype=dtype, device=device),
                    Q=quat.q_identity(dtype, device).expand(B, 4).clone())


def remap_relo_by_id(relo: ReloData, table_ids: torch.Tensor) -> ReloData:
    """Re-key the constraint onto the current table rows (B, MAXF) by
    feature id, by one equality one-hot; entries whose feature left the
    table drop out."""
    E = ((table_ids[:, :, None] == relo.match_ids[:, None, :])
         & (table_ids >= 0)[:, :, None] & relo.match_valid[:, None, :])
    valid = torch.any(E, dim=2)
    return relo._replace(match_pts=E.to(relo.match_pts.dtype) @ relo.match_pts,
                         match_valid=valid,
                         match_ids=torch.where(valid, table_ids, torch.full_like(table_ids, -1)))


class StructuredSystem(NamedTuple):
    Hpp: torch.Tensor  # (B, NXP, NXP): NX window dims [+ 6 relo]
    Hpl: torch.Tensor  # (B, NXP, MAXF)
    dl: torch.Tensor   # (B, MAXF) diagonal of the landmark block
    gp: torch.Tensor   # (B, NXP)
    gl: torch.Tensor   # (B, MAXF)


class SolveResult(NamedTuple):
    x: WindowState
    inv_depth: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor
    iters_accepted: torch.Tensor
    relo_P: Optional[torch.Tensor] = None  # the optimized relo pose (with_relo)
    relo_Q: Optional[torch.Tensor] = None


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


def proj_schur_plain(x: WindowState, vis: VisualData,
                     s: StructuredSystem) -> Tuple[StructuredSystem, torch.Tensor]:
    """The plain version of K4: every projection factor of the grid
    (``_proj_grid``) added into the system ``s`` in Schur form
    (``_accumulate_proj_s``); returns (system, Σ r² (B,))."""
    r, Jl = _proj_grid(x, vis)
    return _accumulate_proj_s(vis, r, Jl, s), torch.sum(r * r, dim=(1, 2, 3))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _scratch_floats() -> int:
    """The floats of one K4 block's partial sum (the library's own count:
    Hpp's upper triangle on the 73 dims the projection factors touch, gp on
    them, Σ r²)."""
    return native.lib().proj_schur_scratch_floats()


def proj_schur_tile(B: int, M: int, n_sm: int) -> int:
    """K4's features per block: the largest of 32, 16 and 8 that still
    gives every SM a block, else 8."""
    for t in (32, 16):
        if B * -(-M // t) >= n_sm:
            return t
    return 8


def proj_schur(x: WindowState, vis: VisualData,
               s: StructuredSystem) -> Tuple[StructuredSystem, torch.Tensor]:
    """The projection factors added into ``s``; returns (system, Σ r² (B,)).
    CPU tensors take ``proj_schur_plain``, CUDA tensors kernel K4 (float32);
    ``s`` is not written."""
    dev = x.P.device
    if dev.type == "cpu":
        return proj_schur_plain(x, vis, s)
    if dev.type != "cuda":
        raise ValueError(f"proj_schur: unsupported device {dev}")
    return _proj_schur_cuda(*[t.contiguous() for t in (x.P, x.Q, x.tic, x.qic, x.td)],
                            VisualData(*[t.contiguous() for t in vis]),
                            StructuredSystem(*[t.contiguous() for t in s]))


def _proj_schur_cuda(P, Q, tic, qic, td, vis: VisualData, s: StructuredSystem):
    B, M = vis.start.shape
    nxp = s.Hpp.shape[-1]
    if nxp < NX:
        raise ValueError(f"proj_schur: the system needs at least {NX} dims (got {nxp})")
    f32, b8 = torch.float32, torch.bool
    g = (B, M, FRAMES)
    native.check_args("proj_schur", P, (
        ("P", P, f32, (B, FRAMES, 3)), ("Q", Q, f32, (B, FRAMES, 4)), ("tic", tic, f32, (B, 3)),
        ("qic", qic, f32, (B, 4)), ("td", td, f32, (B,)),
        ("start", vis.start, torch.int32, (B, M)), ("pts", vis.pts, f32, g + (2,)),
        ("vel", vis.vel, f32, g + (2,)), ("td_obs", vis.td_obs, f32, g),
        ("row_scaled", vis.row_scaled, f32, g), ("obs_mask", vis.obs_mask, b8, g),
        ("inv_depth", vis.inv_depth, f32, (B, M)), ("valid", vis.valid, b8, (B, M)),
        ("Hpp", s.Hpp, f32, (B, nxp, nxp)), ("Hpl", s.Hpl, f32, (B, nxp, M)),
        ("dl", s.dl, f32, (B, M)), ("gp", s.gp, f32, (B, nxp)), ("gl", s.gl, f32, (B, M))))
    tile = proj_schur_tile(B, M, _sm_count(P.device.index))
    out = StructuredSystem(*[torch.empty_like(t) for t in s])
    cost = torch.empty((B,), dtype=f32, device=P.device)
    scratch = torch.empty((B, -(-M // tile), _scratch_floats()), dtype=f32, device=P.device)
    native.launch("proj_schur_launch", P.device,
                  *[t.data_ptr() for t in (P, Q, tic, qic, td) + tuple(vis[:6])
                    + (vis.inv_depth, vis.valid) + tuple(s) + tuple(out) + (cost, scratch)],
                  B, M, nxp, tile, float(factors.PROJ_SQRT_INFO), float(CAUCHY_C) ** 2)
    launches.add(P.device.index)
    return out, cost


def _relo_grid(x: WindowState, vis: VisualData, relo: ReloData):
    """One factor per matched feature: its start-frame landmark reprojected
    into the relo pose (the projection factor with pose j := relo pose, no
    velocity or row terms).  r (B, M, 2), Jl (B, M, 2, 20)."""
    B, M = vis.start.shape
    s = vis.start.to(torch.int64)
    bidx = torch.arange(B, device=s.device)[:, None]
    dtype = x.P.dtype
    one = torch.ones((B, M, 1), dtype=dtype, device=s.device)
    zero3 = torch.zeros((B, M, 3), dtype=dtype, device=s.device)
    zero = torch.zeros((B, M), dtype=dtype, device=s.device)
    td = x.td[:, None].expand(B, M)
    meas = factors.ProjMeas(pts_i=torch.cat([take_frame(vis.pts, s), one], -1),
                            pts_j=torch.cat([relo.match_pts, one], -1), vel_i=zero3,
                            vel_j=zero3, td_i=td, td_j=td, row_i=zero, row_j=zero)
    r, Jl = factors.projection_factor(
        x.P[bidx, s], x.Q[bidx, s], relo.P[:, None].expand(B, M, 3),
        relo.Q[:, None].expand(B, M, 4), x.tic[:, None].expand(B, M, 3),
        x.qic[:, None].expand(B, M, 4), vis.inv_depth, td, meas)
    ok = (relo.active[:, None] & vis.valid & take_frame(vis.obs_mask, s)
          & relo.match_valid)
    r = torch.where(ok[..., None], r, torch.zeros_like(r))
    Jl = torch.where(ok[..., None, None], Jl, torch.zeros_like(Jl))
    w = factors.cauchy_weight(r, CAUCHY_C)
    return r * w, Jl * w[..., None]


def _accumulate_relo_s(vis: VisualData, r, Jl, s: StructuredSystem) -> StructuredSystem:
    """Normal equations of the relo factors; the relo block sits at NX."""
    B, M = vis.start.shape
    dtype = s.Hpp.dtype
    RO = NX
    frames = torch.arange(FRAMES, device=vis.start.device)
    Oi = (vis.start[..., None] == frames).to(dtype)  # (B, M, F)
    Ji, Jr, Je = Jl[..., 0:6], Jl[..., 6:12], Jl[..., 12:18]
    Jlam, Jt = Jl[..., 18], Jl[..., 19]

    def blk(A, Bm):
        return torch.einsum("bfpa,bfpc->bfac", A, Bm)

    eyeF = torch.eye(FRAMES, dtype=dtype, device=Oi.device)
    H = s.Hpp.clone()
    diag = torch.einsum("bfa,bfxy->baxy", Oi, blk(Ji, Ji))
    H[:, :NP, :NP] += torch.einsum("ac,baxy->baxcy", eyeF, diag).reshape(B, NP, NP)
    Hpr = torch.einsum("bfa,bfxy->baxy", Oi, blk(Ji, Jr)).reshape(B, NP, 6)
    H[:, :NP, RO:RO + 6] += Hpr
    H[:, RO:RO + 6, :NP] += Hpr.transpose(1, 2)
    H[:, RO:RO + 6, RO:RO + 6] += blk(Jr, Jr).sum(dim=1)
    Hpe = torch.einsum("bfa,bfxy->baxy", Oi, blk(Ji, Je)).reshape(B, NP, 6)
    H[:, :NP, EX_OFF:EX_OFF + 6] += Hpe
    H[:, EX_OFF:EX_OFF + 6, :NP] += Hpe.transpose(1, 2)
    Hre = blk(Jr, Je).sum(dim=1)
    H[:, RO:RO + 6, EX_OFF:EX_OFF + 6] += Hre
    H[:, EX_OFF:EX_OFF + 6, RO:RO + 6] += Hre.transpose(1, 2)
    H[:, EX_OFF:EX_OFF + 6, EX_OFF:EX_OFF + 6] += blk(Je, Je).sum(dim=1)
    dl = s.dl + torch.einsum("bfp,bfp->bf", Jlam, Jlam)
    Hpl = s.Hpl.clone()
    A_i = torch.einsum("bfpx,bfp->bfx", Ji, Jlam)
    Hpl[:, :NP] += torch.einsum("bfa,bfx->baxf", Oi, A_i).reshape(B, NP, M)
    Hpl[:, RO:RO + 6] += torch.einsum("bfpx,bfp->bxf", Jr, Jlam)
    Hpl[:, EX_OFF:EX_OFF + 6] += torch.einsum("bfpx,bfp->bxf", Je, Jlam)
    Hpl[:, TD_OFF] += torch.einsum("bfp,bfp->bf", Jlam, Jt)
    H[:, TD_OFF, TD_OFF] += torch.einsum("bfp,bfp->b", Jt, Jt)
    t_pose = torch.einsum("bfa,bfpx,bfp->bax", Oi, Ji, Jt).reshape(B, NP)
    H[:, TD_OFF, :NP] += t_pose
    H[:, :NP, TD_OFF] += t_pose
    t_relo = torch.einsum("bfpx,bfp->bx", Jr, Jt)
    H[:, TD_OFF, RO:RO + 6] += t_relo
    H[:, RO:RO + 6, TD_OFF] += t_relo
    g = s.gp.clone()
    g[:, :NP] += torch.einsum("bfa,bfx->bax", Oi,
                              torch.einsum("bfpx,bfp->bfx", Ji, r)).reshape(B, NP)
    g[:, RO:RO + 6] += torch.einsum("bfpx,bfp->bx", Jr, r)
    g[:, EX_OFF:EX_OFF + 6] += torch.einsum("bfpx,bfp->bx", Je, r)
    g[:, TD_OFF] += torch.einsum("bfp,bfp->b", Jt, r)
    gl = s.gl + torch.einsum("bfp,bfp->bf", Jlam, r)
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


def free_mask(cfg: SolverConfig, vis: VisualData, dtype, td_free=None) -> torch.Tensor:
    """(B, NX + MAXF) 1.0 for free tangent dims: the extrinsic frozen unless
    ``cfg.estimate_extrinsic``, td frozen unless ``cfg.estimate_td`` (then
    free where the per-sequence gate ``td_free`` (B,) is 1, when given),
    the speed-biases frozen without an IMU, pose 0 frozen with
    ``fix_pose0``, inverse depths free where ``depth_free``."""
    B = vis.start.shape[0]
    m = torch.ones((B, NX), dtype=dtype, device=vis.start.device)
    if not cfg.use_imu:
        m[:, NP:EX_OFF] = 0.0
    if cfg.fix_pose0:
        m[:, 0:POSE_DIM] = 0.0
    if not cfg.estimate_extrinsic:
        m[:, EX_OFF:EX_OFF + 6] = 0.0
    if not cfg.estimate_td:
        m[:, TD_OFF] = 0.0
    elif td_free is not None:
        m[:, TD_OFF] = td_free.to(dtype)
    return torch.cat([m, vis.depth_free.to(dtype)], dim=1)


def normal_equations_structured(x: WindowState, vis: VisualData,
                                imu: Optional[ImuData], prior: PriorFactor, gravity,
                                sqrt_infos=None, relo: Optional[ReloData] = None
                                ) -> Tuple[StructuredSystem, torch.Tensor]:
    """Assemble the Schur-form normal equations (with the relo block when
    ``relo`` is given); returns (system, cost)."""
    B, M = vis.start.shape
    dtype = x.P.dtype
    dev = x.P.device
    nxp = NX + (6 if relo is not None else 0)
    rp = _prior_residual(x, prior)
    Jp = prior.J * prior.valid.to(dtype)[:, None, None]
    Hpp = torch.zeros((B, nxp, nxp), dtype=dtype, device=dev)
    Hpp[:, :NX, :NX] = Jp.transpose(1, 2) @ Jp
    gp = torch.zeros((B, nxp), dtype=dtype, device=dev)
    gp[:, :NX] = (Jp.transpose(1, 2) @ rp[..., None])[..., 0]
    s = StructuredSystem(
        Hpp=Hpp, Hpl=torch.zeros((B, nxp, M), dtype=dtype, device=dev),
        dl=torch.zeros((B, M), dtype=dtype, device=dev), gp=gp,
        gl=torch.zeros((B, M), dtype=dtype, device=dev))
    cost = torch.sum(rp * rp, dim=1)

    s, cost_proj = proj_schur(x, vis, s)
    cost = cost + cost_proj

    if relo is not None:
        r_rl, Jl_rl = _relo_grid(x, vis, relo)
        s = _accumulate_relo_s(vis, r_rl, Jl_rl, s)
        cost = cost + torch.sum(r_rl * r_rl, dim=(1, 2))

    if imu is not None:
        if sqrt_infos is None:
            sqrt_infos = imupre.sqrt_information(imu.pre)
        r_imu, Jl_imu = _imu_batch(x, imu, gravity, sqrt_infos)
        R = _imu_rows(Jl_imu)
        Hpp = s.Hpp.clone()
        Hpp[:, :NX, :NX] += R.transpose(1, 2) @ R
        gp = s.gp.clone()
        gp[:, :NX] += (R.transpose(1, 2) @ r_imu.reshape(B, -1, 1))[..., 0]
        s = s._replace(Hpp=Hpp, gp=gp)
        cost = cost + torch.sum(r_imu * r_imu, dim=(1, 2))
    return s, 0.5 * cost


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _schur_cholesky(S: torch.Tensor) -> torch.Tensor:
    """``cholesky_nan`` of the solver's damped Schur system, except in
    float64 on the CPU, the setting in which the tests hold the port to
    JAX (the pipelines run float32): there S is symmetrized as
    ``jnp.linalg.cholesky`` takes it and factored by LAPACK's ``potrf``
    through scipy, the routine JAX's CPU backend calls.  The
    initialization's damped LM systems reach condition numbers near 1e17,
    where torch's own CPU factorization rounds the window's biases 1e-5
    away from JAX's.  That route keeps no gradient, so it refuses inputs
    that need one."""
    if S.device.type != "cpu" or S.dtype != torch.float64:
        return cholesky_nan(S)
    if S.requires_grad:
        raise ValueError("_schur_cholesky: the float64 CPU route keeps no gradient")
    from scipy.linalg import get_lapack_funcs

    a = (0.5 * (S + S.transpose(-1, -2))).contiguous().numpy()
    flat = a.reshape(-1, *a.shape[-2:])
    out = np.empty_like(flat)
    potrf, = get_lapack_funcs(("potrf",), (flat,))
    for i, m in enumerate(flat):
        c, info = potrf(m, lower=1, clean=1)
        out[i] = c if info == 0 else np.nan
    return torch.from_numpy(out.reshape(a.shape))


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = b by two triangular solves (``torch.cholesky_solve``
    synchronises the host on CUDA)."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def solve(cfg: SolverConfig, x0: WindowState, vis: VisualData, imu: Optional[ImuData],
          prior: PriorFactor, gravity, sqrt_infos=None,
          relo: Optional[ReloData] = None, td_free=None) -> SolveResult:
    """Damped Gauss-Newton with delayed accept/reject, ``max_iters`` scored
    candidates (one assembly per iteration), dense Schur, yaw re-anchoring
    (with an IMU and ``cfg.yaw_gauge``, pose 0 free); ``imu`` None in VO.
    With ``cfg.with_relo`` the relo pose is optimized alongside (an
    inactive ``relo`` when none is given), free only where it is active.
    ``td_free`` (B,) gates td per sequence (``free_mask``)."""
    dtype = x0.P.dtype
    B, M = vis.start.shape
    dev = x0.P.device
    fm = free_mask(cfg, vis, dtype, td_free)
    fmp, fml = fm[:, :NX], fm[:, NX:]
    if cfg.with_relo:
        if relo is None:
            relo = empty_relo(B, M, dev, dtype)
        fmp = torch.cat([fmp, relo.active.to(dtype)[:, None].expand(B, 6)], dim=1)
    else:
        relo = None
    nxp = fmp.shape[1]
    if imu is not None and sqrt_infos is None:
        sqrt_infos = imupre.sqrt_information(imu.pre)
    eye = torch.eye(nxp, dtype=dtype, device=dev)

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
        L = _schur_cholesky(S)
        dxp = -cho_solve(L, gs[..., None])[..., 0]
        dxl = -Dinv * (gl + (Hpl.transpose(1, 2) @ dxp[..., None])[..., 0])
        return dxp * fmp, dxl * fml

    rP0, rQ0 = (relo.P, relo.Q) if relo is not None else (None, None)
    best = (x0, vis.inv_depth, rP0, rQ0)
    cand = best
    cost_b = torch.full((B,), torch.inf, dtype=dtype, device=dev)
    z = torch.zeros((B, M), dtype=dtype, device=dev)
    sys_b = StructuredSystem(Hpp=torch.zeros((B, nxp, nxp), dtype=dtype, device=dev),
                             Hpl=torch.zeros((B, nxp, M), dtype=dtype, device=dev),
                             dl=z, gp=torch.zeros((B, nxp), dtype=dtype, device=dev), gl=z)
    lm = torch.full((B,), LM_LAMBDA0, dtype=dtype, device=dev)
    n_acc = torch.zeros((B,), dtype=torch.int64, device=dev)
    cost0 = None
    for it in range(cfg.max_iters + 1):
        xc, lamc, rPc, rQc = cand
        s_c, cost_c = normal_equations_structured(
            xc, vis._replace(inv_depth=lamc), imu, prior, gravity, sqrt_infos,
            None if relo is None else relo._replace(P=rPc, Q=rQc))
        if cost0 is None:
            cost0 = cost_c
        accept = (cost_c < cost_b) & torch.isfinite(cost_c)
        best = (where_state(accept, xc, best[0]),
                torch.where(accept[:, None], lamc, best[1]),
                None if relo is None else torch.where(accept[:, None], rPc, best[2]),
                None if relo is None else torch.where(accept[:, None], rQc, best[3]))
        sys_b = where_state(accept, s_c, sys_b)
        bootstrap = ~torch.isfinite(cost_b)
        cost_b = torch.where(accept, cost_c, cost_b)
        lm = torch.where(bootstrap, lm, torch.where(accept, lm * LM_DOWN, lm * LM_UP))
        n_acc = n_acc + accept.to(torch.int64)
        if it == cfg.max_iters:
            break  # the last candidate would never be scored
        dxp, dxl = damped_step(sys_b, lm)
        cand = (boxplus(best[0], dxp[:, :NX]), best[1] + dxl,
                None if relo is None else best[2] + dxp[:, NX:NX + 3],
                None if relo is None else quat.qboxplus(best[3], dxp[:, NX + 3:NX + 6]))
    x, lam_vec, rP, rQ = best
    if cfg.yaw_gauge and cfg.use_imu and not cfg.fix_pose0:
        x = yaw_gauge_fix(x, x0)
    return SolveResult(x=x, inv_depth=lam_vec, cost0=cost0, cost=cost_b,
                       iters_accepted=torch.clamp(n_acc - 1, min=0), relo_P=rP, relo_Q=rQ)
