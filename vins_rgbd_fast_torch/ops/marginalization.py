"""Schur-complement marginalization prior (twin of ``marginalize_old``/
``marginalize_new`` and ``_schur_sqrt_prior(method="chol")`` in
``vins_rgbd_fast_tpu/ops/marginalization.py``), over B sequences.

The drop/keep sets are static index lists, gathered here by plain indexing
where the JAX package contracts constant one-hot matrices (same values:
each selector row has a single 1).  The placement of the new prior at its
post-slide positions stays a one-hot product, as in JAX: marginalize-new
maps the speed-biases of slots W-1 and W to one position, and the product
adds their columns (an indexed store would keep one of them, on CUDA an
unspecified one per element).  A jittered Cholesky factor that fails is
taken again with a stronger jitter (``_jittered_cholesky``).
"""

from __future__ import annotations

import torch

from ..backend.state import EX_OFF, NP, NX, POSE_DIM, SB_DIM, WINDOW_SIZE, WindowState, boxminus
from ..utils import quaternion as quat
from .solver import PriorFactor, SolverConfig, VisualData, cho_solve, cholesky_nan
from . import solver as solver_mod

EIG_EPS = 1e-8


def _pose_dims(i):
    return list(range(POSE_DIM * i, POSE_DIM * (i + 1)))


def _sb_dims(i):
    return list(range(NP + SB_DIM * i, NP + SB_DIM * (i + 1)))


def _shifted_positions_old(keep):
    pos = []
    for d in keep:
        if d < NP:
            k, o = divmod(d, POSE_DIM)
            pos.append(POSE_DIM * (k - 1) + o)
        elif d < EX_OFF:
            k, o = divmod(d - NP, SB_DIM)
            pos.append(NP + SB_DIM * (k - 1) + o)
        else:
            pos.append(d)
    return pos


def _shifted_positions_new(keep):
    pos = []
    for d in keep:
        if d < NP:
            k, o = divmod(d, POSE_DIM)
            pos.append(POSE_DIM * (WINDOW_SIZE - 1 if k == WINDOW_SIZE else k) + o)
        elif d < EX_OFF:
            k, o = divmod(d - NP, SB_DIM)
            pos.append(NP + SB_DIM * (WINDOW_SIZE - 1 if k == WINDOW_SIZE else k) + o)
        else:
            pos.append(d)
    return pos


def shift_state_old(x: WindowState) -> WindowState:
    """Slot i <- slot i+1; the last slot keeps the newest values."""
    def roll(a):
        return torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    return x._replace(P=roll(x.P), Q=roll(x.Q), V=roll(x.V), Ba=roll(x.Ba), Bg=roll(x.Bg))


def shift_state_new(x: WindowState) -> WindowState:
    """Slot W-1 <- slot W."""
    def mv(a):
        out = a.clone()
        out[:, WINDOW_SIZE - 1] = a[:, WINDOW_SIZE]
        return out
    return x._replace(P=mv(x.P), Q=mv(x.Q), V=mv(x.V), Ba=mv(x.Ba), Bg=mv(x.Bg))


def _jitter(Mx):
    """Diagonal-relative jitter 1e-6·d + 1e-10·max(d) + 1e-20."""
    d = torch.diagonal(Mx, dim1=-2, dim2=-1)
    add = 1e-6 * d + 1e-10 * d.amax(dim=-1, keepdim=True) + 1e-20
    return Mx + torch.diag_embed(add)


def _jittered_cholesky(M):
    """``cholesky_nan(_jitter(M))``, and where that fails, the factor of M
    with 1e-6 of its largest diagonal entry added to every diagonal entry
    as well.  In float32 the information matrix's rounding can leave
    eigenvalues near −1e-8 of its largest (a VO window's gauge directions
    once the oldest pose leaves), below the relative jitter, and the
    factor, the prior and every later cost of that sequence came out NaN
    (JAX factors the same jittered matrix).  Both factors are computed and
    one is selected per sequence, so the host never waits."""
    L = cholesky_nan(_jitter(M))
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    strong = cholesky_nan(M + torch.diag_embed(1e-6 * (d + d.amax(dim=-1, keepdim=True))
                                               + 1e-20))
    ok = torch.isfinite(L).flatten(1).all(dim=1)
    return torch.where(ok[:, None, None], L, strong)


def _schur_sqrt_prior(H, b, drop, keep, new_pos):
    """Eliminate the ``drop`` dims of (H, b) by Cholesky; return (J', r')
    embedded at the post-slide positions of the NX layout."""
    dev = H.device
    d_idx = quat.const(tuple(drop), torch.int64, dev)
    k_idx = quat.const(tuple(keep), torch.int64, dev)
    nk = len(keep)
    Hdd = H[:, d_idx][:, :, d_idx]
    Hkd = H[:, k_idx][:, :, d_idx]
    Hkk = H[:, k_idx][:, :, k_idx]
    bd = b[:, d_idx]
    bk = b[:, k_idx]
    Hdd = 0.5 * (Hdd + Hdd.transpose(1, 2))
    Ld = _jittered_cholesky(Hdd)
    X = cho_solve(Ld, Hkd.transpose(1, 2))  # Hdd⁻¹ Hdk
    A = Hkk - Hkd @ X
    g = bk - (X.transpose(1, 2) @ bd[..., None])[..., 0]
    A = 0.5 * (A + A.transpose(1, 2))
    Lk = _jittered_cholesky(A)
    rp = torch.linalg.solve_triangular(Lk, g[..., None], upper=False)[..., 0]
    B = H.shape[0]
    J_new = torch.zeros((B, NX, NX), dtype=H.dtype, device=dev)
    place = (quat.const(tuple(new_pos), torch.int64, dev)[:, None]
             == quat.const(tuple(range(NX)), torch.int64, dev)).to(H.dtype)  # (nk, NX)
    J_new[:, :nk] = Lk.transpose(1, 2) @ place
    r_new = torch.zeros((B, NX), dtype=H.dtype, device=dev)
    r_new[:, :nk] = rp
    return J_new, r_new


_DROP_OLD = _pose_dims(0) + _sb_dims(0)
_KEEP_OLD = [d for d in range(NX) if d not in set(_DROP_OLD)]
_DROP_NEW = _pose_dims(WINDOW_SIZE - 1)
_KEEP_NEW = [d for d in range(NX) if d not in set(_DROP_NEW)]


def marginalize_old(cfg: SolverConfig, x: WindowState, vis: VisualData, imu,
                    prior: PriorFactor, gravity, sqrt_infos=None) -> PriorFactor:
    """New prior when the oldest frame leaves: previous prior + IMU factor
    0-1 (none in VO, ``imu`` None) + projection factors of features rooted
    at frame 0; landmarks are eliminated first (diagonal block), then pose0
    + sb0."""
    vis_m = vis._replace(valid=vis.valid & (vis.start == 0))
    imu_m = imu
    if imu is not None:
        first = torch.arange(imu.valid.shape[1], device=imu.valid.device) == 0
        imu_m = imu._replace(valid=imu.valid & first)
    s, _ = solver_mod.normal_equations_structured(x, vis_m, imu_m, prior, gravity,
                                                  sqrt_infos=sqrt_infos)
    dinv = torch.where(s.dl > EIG_EPS, 1.0 / torch.clamp(s.dl, min=EIG_EPS),
                       torch.zeros_like(s.dl))
    H = s.Hpp - (s.Hpl * dinv[:, None, :]) @ s.Hpl.transpose(1, 2)
    b = s.gp - (s.Hpl @ (dinv * s.gl)[..., None])[..., 0]
    J_new, r_new = _schur_sqrt_prior(H, b, _DROP_OLD, _KEEP_OLD,
                                     _shifted_positions_old(_KEEP_OLD))
    return PriorFactor(J=J_new, r0=r_new, x0=shift_state_old(x),
                       valid=torch.ones_like(prior.valid))


def marginalize_new(cfg: SolverConfig, x: WindowState, prior: PriorFactor) -> PriorFactor:
    """Prior update when the second-newest frame is discarded: relinearize
    the prior alone and eliminate pose[W-1]."""
    dtype = x.P.dtype
    v = prior.valid.to(dtype)
    dx = boxminus(x, prior.x0)
    r = (prior.r0 + (prior.J @ dx[..., None])[..., 0]) * v[:, None]
    Jm = prior.J * v[:, None, None]
    H = Jm.transpose(1, 2) @ Jm
    b = (Jm.transpose(1, 2) @ r[..., None])[..., 0]
    J_new, r_new = _schur_sqrt_prior(H, b, _DROP_NEW, _KEEP_NEW,
                                     _shifted_positions_new(_KEEP_NEW))
    return PriorFactor(J=J_new, r0=r_new, x0=shift_state_new(x), valid=prior.valid)
