"""Sliding-window VIO estimator programs over B sequences in lock step
(twin of ``fill_step``, ``init_full``, ``init_dynamic``, ``init_mono``,
``vio_step`` and their helpers in ``vins_rgbd_fast_tpu/backend/
estimator.py``), plus a numpy port of the host IMU-interval pairing
(``VinsEstimator._collect_interval_np``).

The dynamic and monocular initializations take their RANSAC and PnP draws
as uniforms too, and return per sequence either the initialized state or,
where the attempt failed, the input state slid (the retry path).

Without an IMU (``cfg.use_imu`` False, VO mode) a new frame starts at the
previous pose and the newest pose is initialised by PnP RANSAC on the
depth-anchored landmarks (``_pnp_newest``); the solve has no IMU factors,
frozen speed-biases and a fixed first pose.  PnP's random draws are an
input, (B, 32, MAXF) uniforms, as F-RANSAC's are.

Slot indices (``frame_idx``, the steady slot ``WINDOW_SIZE``) are Python
ints.  Where JAX selects with ``lax.cond`` under ``vmap`` (keyframe vs
non-keyframe slide and marginalization), both branches run and a
per-sequence ``torch.where`` picks — no host synchronisation.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import FOCAL_LENGTH, EstimatorConfig
from ..ops import imu_preintegration as imupre
from ..ops import marginalization as marg
from ..ops import ransac as ransac_ops
from ..ops import solver as slv
from ..utils import quaternion as quat
from ..utils.timing import TRACER
from . import feature_table as ftab
from . import initialization as init_ops
from .feature_table import FeatureTable, FrameFeatures
from .state import FRAMES, WINDOW_SIZE, WindowState, identity_state, where_state


class EstimatorState(NamedTuple):
    x: WindowState
    table: FeatureTable
    prior: slv.PriorFactor
    imu_dts: torch.Tensor  # (B, FRAMES, MAXI); slot j spans (frame j-1, frame j]
    imu_acc: torch.Tensor  # (B, FRAMES, MAXI+1, 3)
    imu_gyr: torch.Tensor  # (B, FRAMES, MAXI+1, 3)
    last_P: torch.Tensor   # (B, 3)
    last_Q: torch.Tensor   # (B, 4)


class ImuInterval(NamedTuple):
    dts: torch.Tensor  # (B, MAXI)
    acc: torch.Tensor  # (B, MAXI+1, 3)
    gyr: torch.Tensor  # (B, MAXI+1, 3)


class StepOutput(NamedTuple):
    P: torch.Tensor  # newest pose, pre-slide
    Q: torch.Tensor
    V: torch.Tensor
    Ba: torch.Tensor
    Bg: torch.Tensor
    is_keyframe: torch.Tensor
    failure: torch.Tensor
    cost: torch.Tensor
    n_features: torch.Tensor
    n_dynamic: torch.Tensor
    last_track_num: torch.Tensor
    relo_P: torch.Tensor  # (B, 3) optimized relocalization pose (zeros if unused)
    relo_Q: torch.Tensor
    relo_used: torch.Tensor  # (B,) bool
    relo_cur_P: torch.Tensor  # (B, 3) slot W-1 after the solve (the relocalized keyframe)
    relo_cur_Q: torch.Tensor
    wp_world: torch.Tensor  # (B, MAXF, 3) newest frame's landmarks, pre-slide
    wp_uv: torch.Tensor
    wp_norm: torch.Tensor
    wp_valid: torch.Tensor
    wp_ids: torch.Tensor


def init_estimator_state(cfg: EstimatorConfig, ric, tic, td: float, B: int, device,
                         dtype=torch.float32) -> EstimatorState:
    """Fresh state; ``ric`` (3, 3) and ``tic`` (3,) are the imu<-cam extrinsic."""
    x = identity_state(B, device, dtype)
    ric_t = torch.as_tensor(np.asarray(ric), dtype=dtype, device=device).expand(B, 3, 3)
    x = x._replace(qic=quat.R2q(ric_t).contiguous(),
                   tic=torch.as_tensor(np.asarray(tic), dtype=dtype, device=device)
                   .expand(B, 3).contiguous(),
                   td=torch.full((B,), float(td), dtype=dtype, device=device))
    z = dict(dtype=dtype, device=device)
    return EstimatorState(
        x=x, table=ftab.empty_table(B, cfg.maxf, device, dtype),
        prior=slv.empty_prior(B, device, dtype),
        imu_dts=torch.zeros((B, FRAMES, cfg.max_imu), **z),
        imu_acc=torch.zeros((B, FRAMES, cfg.max_imu + 1, 3), **z),
        imu_gyr=torch.zeros((B, FRAMES, cfg.max_imu + 1, 3), **z),
        last_P=torch.zeros((B, 3), **z),
        last_Q=quat.q_identity(dtype, device).expand(B, 4).clone())


def _noise(cfg: EstimatorConfig) -> imupre.ImuNoise:
    return imupre.ImuNoise(cfg.acc_n, cfg.gyr_n, cfg.acc_w, cfg.gyr_w)


def _gravity(cfg: EstimatorConfig, ref: torch.Tensor) -> torch.Tensor:
    return quat.const((0.0, 0.0, float(cfg.g_norm)), ref.dtype, ref.device)


def _make_preints(cfg: EstimatorConfig, st: EstimatorState) -> slv.ImuData:
    """Re-propagate all window preintegrations at the current biases."""
    pre = imupre.preintegrate(st.imu_dts[:, 1:], st.imu_acc[:, 1:], st.imu_gyr[:, 1:],
                              st.x.Ba[:, :-1], st.x.Bg[:, :-1], _noise(cfg))
    s = torch.sum(st.imu_dts[:, 1:], dim=2)
    return slv.ImuData(pre=pre, valid=(s > 0) & (s < 10.0))


def _visual_data(cfg: EstimatorConfig, t: FeatureTable) -> slv.VisualData:
    inv_depth, free, valid = ftab.solver_depth_view(t, cfg.fix_depth)
    return slv.VisualData(start=t.start, pts=t.pts, vel=t.vel, td_obs=t.td_obs,
                          row_scaled=t.uv[..., 1] * cfg.tr_over_row, obs_mask=t.obs_mask,
                          inv_depth=inv_depth, depth_free=free, valid=valid)


def _set_slot(a: torch.Tensor, j: int, v: torch.Tensor) -> torch.Tensor:
    out = a.clone()
    out[:, j] = v
    return out


def _propagate_newest(cfg: EstimatorConfig, st: EstimatorState, j: int) -> WindowState:
    """IMU-propagate slot j from slot j-1 through the slot-j samples."""
    x = st.x
    i = j - 1
    pre = imupre.preintegrate(st.imu_dts[:, j], st.imu_acc[:, j], st.imu_gyr[:, j],
                              x.Ba[:, i], x.Bg[:, i], _noise(cfg))
    g = _gravity(cfg, x.P)
    dt = pre.sum_dt[:, None]
    Qi = x.Q[:, i]
    Pj = x.P[:, i] + x.V[:, i] * dt - 0.5 * g * dt * dt + quat.qrot(Qi, pre.delta_p)
    Vj = x.V[:, i] - g * dt + quat.qrot(Qi, pre.delta_v)
    Qj = quat.qnormalize(quat.qmul(Qi, pre.delta_q))
    return x._replace(P=_set_slot(x.P, j, Pj), Q=_set_slot(x.Q, j, Qj),
                      V=_set_slot(x.V, j, Vj), Ba=_set_slot(x.Ba, j, x.Ba[:, i]),
                      Bg=_set_slot(x.Bg, j, x.Bg[:, i]))


def _store_interval(st: EstimatorState, j: int, imu: ImuInterval) -> EstimatorState:
    return st._replace(imu_dts=_set_slot(st.imu_dts, j, imu.dts),
                       imu_acc=_set_slot(st.imu_acc, j, imu.acc),
                       imu_gyr=_set_slot(st.imu_gyr, j, imu.gyr))


def _start_points_world(x: WindowState, t: FeatureTable):
    """World positions of the landmarks from their start-frame depth."""
    t_wc, R_wc = ftab.cam_poses(x.P, x.Q, x.tic, x.qic)
    s = t.start.to(torch.int64)
    bidx = torch.arange(s.shape[0], device=s.device)[:, None]
    pts_s = ftab.take_frame(t.pts, s)
    rays = torch.cat([pts_s, torch.ones_like(pts_s[..., :1])], dim=-1)
    p_w = (R_wc[bidx, s] @ (rays * t.est_depth[..., None])[..., None])[..., 0] + t_wc[bidx, s]
    return p_w, t_wc, R_wc


def _pnp_newest(cfg: EstimatorConfig, st: EstimatorState, u: torch.Tensor) -> WindowState:
    """VO pose init of the newest frame: PnP RANSAC on the depth-anchored
    landmarks it observes, from the previous camera pose; ``u`` (B, 32,
    MAXF) uniforms.  Where PnP fails the pose stays as it was."""
    x, t = st.x, st.table
    j = FRAMES - 1
    p_w, t_wc, R_wc = _start_points_world(x, t)
    ok = ftab.active_rows(t) & (t.est_depth > 0) & t.obs_mask[:, :, j] & ~t.is_dynamic
    R_prev, t_prev = R_wc[:, j - 1], t_wc[:, j - 1]
    R_init = R_prev.transpose(1, 2)
    res = ransac_ops.pnp_ransac_guess(u, p_w, t.pts[:, :, j], ok, R_init,
                                      -(R_init @ t_prev[..., None])[..., 0],
                                      threshold=10.0 / 460.0)
    R_cw, t_cw = res.model[..., :3], res.model[..., 3]
    R_wc_j = R_cw.transpose(1, 2)
    t_wc_j = -(R_wc_j @ t_cw[..., None])[..., 0]
    R_wi = R_wc_j @ quat.q2R(x.qic).transpose(1, 2)
    P_wi = t_wc_j - (R_wi @ x.tic[..., None])[..., 0]
    use = res.ok[:, None]
    return x._replace(P=_set_slot(x.P, j, torch.where(use, P_wi, x.P[:, j])),
                      Q=_set_slot(x.Q, j, torch.where(use, quat.R2q(R_wi), x.Q[:, j])))


def _copy_previous_pose(x: WindowState, j: int) -> WindowState:
    """VO: slot j starts at slot j-1's pose (slot 0 stays)."""
    i = max(j - 1, 0)
    return x._replace(P=_set_slot(x.P, j, x.P[:, i]), Q=_set_slot(x.Q, j, x.Q[:, i]))


def _moving_consistency(cfg: EstimatorConfig, x: WindowState, t: FeatureTable) -> FeatureTable:
    """Mark features whose mean reprojection error exceeds 10 px @ 460 or
    whose mean 3D relative error exceeds 2.0 as dynamic."""
    p_w, t_wc, R_wc = _start_points_world(x, t)
    p_in_j = (torch.einsum("bfji,bnj->bnfi", R_wc, p_w)
              - torch.einsum("bfji,bfj->bfi", R_wc, t_wc)[:, None])
    z = p_in_j[..., 2]
    proj = p_in_j[..., :2] / torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))[..., None]
    obs = t.pts
    err2d = torch.linalg.norm(proj - obs, dim=-1)
    rays_obs = torch.cat([obs, torch.ones_like(obs[..., :1])], dim=-1)
    err3d = torch.linalg.norm(p_in_j - rays_obs, dim=-1) / torch.clamp(t.est_depth[..., None], min=1e-6)
    cnt_mask = t.obs_mask & (torch.arange(FRAMES, device=obs.device) != t.start[..., None])
    cnt = torch.sum(cnt_mask, dim=-1)
    n = torch.clamp(cnt, min=1)
    zero = torch.zeros_like(err2d)
    mean2d = torch.sum(torch.where(cnt_mask, err2d, zero), -1) / n
    mean3d = torch.sum(torch.where(cnt_mask, err3d, zero), -1) / n
    checked = (ftab.active_rows(t) & (ftab.obs_count(t) >= 2) & (t.start < WINDOW_SIZE - 2)
               & (t.est_depth > 0) & (cnt > 0))
    dynamic = checked & ((FOCAL_LENGTH * mean2d > 10.0) | (mean3d > 2.0))
    return t._replace(is_dynamic=torch.where(checked, dynamic, t.is_dynamic))


def _failure_flags(cfg: EstimatorConfig, st: EstimatorState, x_new: WindowState,
                   last_track_num) -> torch.Tensor:
    dp = x_new.P[:, WINDOW_SIZE] - st.last_P
    fail = ((last_track_num < 2) | (torch.linalg.norm(dp, dim=-1) > 5.0)
            | (torch.abs(dp[:, 2]) > 1.0))
    if not cfg.use_imu:  # VO: no bias tests
        return fail
    return (fail | (torch.linalg.norm(x_new.Ba[:, WINDOW_SIZE], dim=-1) > 2.5)
            | (torch.linalg.norm(x_new.Bg[:, WINDOW_SIZE], dim=-1) > 1.0))


def _slide_old(st: EstimatorState) -> EstimatorState:
    t_wc, R_wc = ftab.cam_poses(st.x.P, st.x.Q, st.x.tic, st.x.qic)
    table = ftab.slide_old(st.table, t_wc[:, 0], R_wc[:, 0], t_wc[:, 1], R_wc[:, 1])

    def roll(a):
        return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)

    return st._replace(x=marg.shift_state_old(st.x), table=table, imu_dts=roll(st.imu_dts),
                       imu_acc=roll(st.imu_acc), imu_gyr=roll(st.imu_gyr))


def _slide_new(cfg: EstimatorConfig, st: EstimatorState) -> EstimatorState:
    """Merge interval (8,9] + (9,10] into slot 9; when the merged sample
    list exceeds the capacity it is decimated 2:1 (pair-summed dts)."""
    maxi = cfg.max_imu
    W = WINDOW_SIZE
    d9, d10 = st.imu_dts[:, W - 1], st.imu_dts[:, W]
    n9 = torch.sum(d9 > 0, dim=1)
    n10 = torch.sum(d10 > 0, dim=1)
    dts2 = torch.cat([d9, torch.zeros_like(d9)], dim=1)                    # (B, 2maxi)
    acc2 = torch.cat([st.imu_acc[:, W - 1], torch.zeros_like(st.imu_acc[:, W - 1, 1:])], 1)
    gyr2 = torch.cat([st.imu_gyr[:, W - 1], torch.zeros_like(st.imu_gyr[:, W - 1, 1:])], 1)
    # slot-10 samples go behind the n9 samples of slot 9 (n9 <= maxi, so
    # every target index is in range)
    tgt = n9[:, None] + torch.arange(maxi, device=d9.device)
    dts2.scatter_(1, tgt, d10)
    tgt1 = (tgt + 1)[..., None].expand(-1, -1, 3)
    acc2.scatter_(1, tgt1, st.imu_acc[:, W, 1:])
    gyr2.scatter_(1, tgt1, st.imu_gyr[:, W, 1:])
    fits = (n9 + n10) <= maxi
    m_dts = torch.where(fits[:, None], dts2[:, :maxi], dts2[:, 0::2] + dts2[:, 1::2])
    m_acc = torch.where(fits[:, None, None], acc2[:, :maxi + 1],
                        torch.cat([acc2[:, :1], acc2[:, 2::2]], dim=1))
    m_gyr = torch.where(fits[:, None, None], gyr2[:, :maxi + 1],
                        torch.cat([gyr2[:, :1], gyr2[:, 2::2]], dim=1))
    imu_dts = _set_slot(_set_slot(st.imu_dts, W - 1, m_dts), W, torch.zeros_like(d10))
    return st._replace(x=marg.shift_state_new(st.x), table=ftab.slide_new(st.table),
                       imu_dts=imu_dts, imu_acc=_set_slot(st.imu_acc, W - 1, m_acc),
                       imu_gyr=_set_slot(st.imu_gyr, W - 1, m_gyr))


def _slide(cfg: EstimatorConfig, st: EstimatorState, is_kf: torch.Tensor) -> EstimatorState:
    """Both slide flavours, selected per sequence."""
    return where_state(is_kf, _slide_old(st), _slide_new(cfg, st))


def _window_points(x: WindowState, t: FeatureTable):
    """Newest frame's depth-anchored landmarks (pre-slide)."""
    j = FRAMES - 1
    p_w, _, _ = _start_points_world(x, t)
    valid = ftab.active_rows(t) & (t.est_depth > 0) & t.obs_mask[:, :, j] & ~t.is_dynamic
    return p_w, t.uv[:, :, j], t.pts[:, :, j], valid, t.ids


def fill_step(cfg: EstimatorConfig, st: EstimatorState, frame_idx: int,
              feats: FrameFeatures, imu: ImuInterval) -> Tuple[EstimatorState, torch.Tensor]:
    """Window-filling phase: store IMU, propagate (or gravity-align the
    first frame; without an IMU copy the previous pose), ingest,
    triangulate (not under dynamic init)."""
    st = _store_interval(st, frame_idx, imu)
    if not cfg.use_imu:
        st = st._replace(x=_copy_previous_pose(st.x, frame_idx))
    elif frame_idx == 0:
        q0 = init_ops.init_first_imu_pose(imu.acc, torch.ones_like(imu.acc[..., 0], dtype=torch.bool))
        st = st._replace(x=st.x._replace(Q=_set_slot(st.x.Q, 0, q0)))
    else:
        st = st._replace(x=_propagate_newest(cfg, st, frame_idx))
    table, is_kf, _ = ftab.ingest_frame(st.table, frame_idx, feats, st.x.td,
                                        cfg.depth_min_dist, cfg.min_parallax)
    if cfg.static_init or not cfg.use_imu:  # dynamic init triangulates after its alignment
        table = ftab.triangulate_with_depth(table, st.x.P, st.x.Q, st.x.tic, st.x.qic,
                                            cfg.depth_min_dist, cfg.depth_max_dist)
    return st._replace(table=table), is_kf


def _solve_and_slide(cfg: EstimatorConfig, st: EstimatorState, is_kf, last_track_num,
                     relo: Optional[slv.ReloData] = None) -> Tuple[EstimatorState, StepOutput]:
    """Triangulate → solve → write back → checks → marginalize → slide.
    ``relo`` is bound to the current table rows by feature id first.  td
    (when estimated) is free only in sequences whose oldest frame moves
    faster than 0.2 m/s."""
    g = _gravity(cfg, st.x.P)
    st = st._replace(table=ftab.triangulate_with_depth(
        st.table, st.x.P, st.x.Q, st.x.tic, st.x.qic, cfg.depth_min_dist, cfg.depth_max_dist))
    vis = _visual_data(cfg, st.table)
    imu_data = _make_preints(cfg, st) if cfg.use_imu else None
    sqrt_infos = imupre.sqrt_information(imu_data.pre) if cfg.use_imu else None
    if relo is not None:
        relo = slv.remap_relo_by_id(relo, st.table.ids)
    td_free = (torch.linalg.norm(st.x.V[:, 0], dim=-1) > 0.2).to(g.dtype) if cfg.use_imu else None
    res = slv.solve(cfg.solver, st.x, vis, imu_data, st.prior, g, sqrt_infos=sqrt_infos,
                    relo=relo, td_free=td_free)
    x_new = res.x
    table = ftab.update_depths_from_solver(st.table, res.inv_depth, vis.depth_free)
    table = _moving_consistency(cfg, x_new, table)
    failure = _failure_flags(cfg, st, x_new, last_track_num)
    TRACER.mark("solve")
    st = st._replace(x=x_new, table=table)

    vis_post = _visual_data(cfg, st.table)
    prior = where_state(
        is_kf,
        marg.marginalize_old(cfg.solver, st.x, vis_post, imu_data, st.prior, g,
                             sqrt_infos=sqrt_infos),
        marg.marginalize_new(cfg.solver, st.x, st.prior))
    st = st._replace(prior=prior)
    TRACER.mark("marg")

    wp_world, wp_uv, wp_norm, wp_valid, wp_ids = _window_points(st.x, st.table)
    W = WINDOW_SIZE
    B = x_new.P.shape[0]
    out = StepOutput(
        P=x_new.P[:, W], Q=x_new.Q[:, W], V=x_new.V[:, W], Ba=x_new.Ba[:, W],
        Bg=x_new.Bg[:, W], is_keyframe=is_kf, failure=failure, cost=res.cost,
        n_features=torch.sum(vis.valid, dim=1), n_dynamic=torch.sum(st.table.is_dynamic, dim=1),
        last_track_num=last_track_num,
        relo_P=res.relo_P if res.relo_P is not None else torch.zeros_like(x_new.P[:, W]),
        relo_Q=(res.relo_Q if res.relo_Q is not None
                else quat.q_identity(x_new.Q.dtype, x_new.Q.device).expand(B, 4)),
        relo_used=(relo.active if (cfg.fast_relo and relo is not None)
                   else torch.zeros_like(is_kf, dtype=torch.bool)),
        relo_cur_P=x_new.P[:, W - 1], relo_cur_Q=x_new.Q[:, W - 1],
        wp_world=wp_world, wp_uv=wp_uv, wp_norm=wp_norm, wp_valid=wp_valid, wp_ids=wp_ids)
    st = st._replace(last_P=x_new.P[:, W], last_Q=x_new.Q[:, W])
    return _slide(cfg, st, is_kf), out


def _all(st: EstimatorState, value, dtype=torch.bool) -> torch.Tensor:
    return torch.full((st.x.P.shape[0],), value, dtype=dtype, device=st.x.P.device)


def _gyro_bias_update(cfg: EstimatorConfig, st: EstimatorState, pre0: slv.ImuData,
                      Q) -> EstimatorState:
    """The gyro-bias least squares against frame rotations Q (B, FRAMES, 4)."""
    dbg = init_ops.solve_gyroscope_bias(
        pre0.pre.delta_q,
        pre0.pre.jacobian[..., imupre.O_R:imupre.O_R + 3, imupre.O_BG:imupre.O_BG + 3],
        Q, pre0.valid)
    return st._replace(x=st.x._replace(Bg=st.x.Bg + dbg[:, None]))


def init_full(cfg: EstimatorConfig, st: EstimatorState) -> Tuple[EstimatorState, StepOutput]:
    """Static initialization at window-full: gyro-bias least squares (with
    an IMU), then the solve/marginalize/slide tail with the first frame
    marginalized."""
    if cfg.use_imu:
        st = _gyro_bias_update(cfg, st, _make_preints(cfg, st), st.x.Q)
    return _solve_and_slide(cfg, st, _all(st, True), _all(st, 50, torch.int64))


def _world_aligned(x: WindowState, g_c0, P_wi, R_wi, V_body) -> WindowState:
    """Rotate the window so gravity g_c0 (B, 3) points along world z (yaw
    zeroed), positions relative to frame 0; V_body are body-frame
    velocities."""
    R0 = quat.g2R(g_c0)[:, None]
    P_new = (R0 @ P_wi[..., None])[..., 0]
    R_new = R0 @ R_wi
    return x._replace(P=P_new - P_new[:, :1], Q=quat.R2q(R_new),
                      V=(R_new @ V_body[..., None])[..., 0])


def init_dynamic(cfg: EstimatorConfig, st: EstimatorState,
                 u_chain: torch.Tensor) -> Tuple[EstimatorState, StepOutput, torch.Tensor]:
    """Dynamic (in-motion) initialization at window-full: the IMU
    excitation check; camera poses chained frame to frame by PnP RANSAC on
    the previous frame's depth-measured points (metric, no scale); the
    gyro-bias least squares and the velocity/gravity alignment; the window
    rotated to gravity; the solve/marginalize/slide tail.  ``u_chain`` (B,
    FRAMES - 1, 8, MAXF): the uniforms of each link's 8 PnP trials.
    Returns (state, output, ok (B,)); where not ok the state is the
    original one slid (the failed-init retry path)."""
    dtype = st.x.P.dtype
    pre0 = _make_preints(cfg, st)
    excited = init_ops.imu_excitation_ok(pre0.pre.delta_v, pre0.pre.sum_dt, pre0.valid)
    t, x = st.table, st.x
    rays = torch.cat([t.pts, torch.ones_like(t.pts[..., :1])], dim=-1)  # (B, M, F, 3)
    eye = torch.eye(3, dtype=dtype, device=x.P.device).expand(x.P.shape[0], 3, 3)
    R_wc, t_wc = [eye], [torch.zeros_like(x.P[:, 0])]
    chain_ok = _all(st, True)
    for j in range(1, FRAMES):
        i = j - 1
        d_i = t.depth_meas[:, :, i]
        has_d = t.obs_mask[:, :, i] & t.obs_mask[:, :, j] & (d_i > 0)
        p_w = (rays[:, :, i] * d_i[..., None]) @ R_wc[i].transpose(1, 2) + t_wc[i][:, None]
        R_init = R_wc[i].transpose(1, 2)
        res = ransac_ops.pnp_ransac_guess(
            u_chain[:, i], p_w, t.pts[:, :, j], has_d, R_init,
            -(R_init @ t_wc[i][..., None])[..., 0], threshold=10.0 / 460.0,
            min_inliers=8, refine_iters=6)
        Rj_T = res.model[..., :3].transpose(1, 2)
        ok = res.ok[:, None]
        R_wc.append(torch.where(ok[..., None], Rj_T, R_wc[i]))
        t_wc.append(torch.where(ok, -(Rj_T @ res.model[..., 3:])[..., 0], t_wc[i]))
        chain_ok = chain_ok & res.ok
    R_wi = torch.stack(R_wc, dim=1) @ quat.q2R(x.qic)[:, None].transpose(-1, -2)
    P_wi = torch.stack(t_wc, dim=1) - (R_wi @ x.tic[:, None, :, None])[..., 0]
    Q_wi = quat.R2q(R_wi)

    st1 = _gyro_bias_update(cfg, st, pre0, Q_wi)
    pre1 = _make_preints(cfg, st1)
    V_c0, g_c0, align_ok = init_ops.linear_alignment_with_depth(
        pre1.pre.delta_p, pre1.pre.delta_v, pre1.pre.sum_dt, P_wi, Q_wi, st1.x.tic,
        pre1.valid, cfg.g_norm)
    st1 = st1._replace(x=_world_aligned(st1.x, g_c0, P_wi, R_wi, V_c0))
    ok = excited & chain_ok & align_ok
    st2, out = _solve_and_slide(cfg, st1, _all(st, True), _all(st, 50, torch.int64))
    return where_state(ok, st2, _slide(cfg, st, _all(st, True))), out, ok


def _dlt_triangulate(pts, obs_mask, R_cw, t_cw, pose_known):
    """Multiview DLT triangulation of every feature from the frames with
    known camera poses (the smallest eigenvector of the stacked rows by
    inverse iteration).  pts (B, M, F, 2), obs_mask (B, M, F), R_cw (B, F,
    3, 3), t_cw (B, F, 3) world -> camera, pose_known (B, F).  Returns
    (points_w (B, M, 3), n_obs (B, M), ok (B, M): two observations or more,
    in front of all of its cameras but one)."""
    dtype = pts.dtype
    Pmat = torch.cat([R_cw, t_cw[..., None]], dim=-1)[:, None]  # (B, 1, F, 3, 4)
    use = obs_mask & pose_known[:, None]
    w = use.to(dtype)[..., None]
    r0 = pts[..., 0:1] * Pmat[..., 2, :] - Pmat[..., 0, :]  # (B, M, F, 4)
    r1 = pts[..., 1:2] * Pmat[..., 2, :] - Pmat[..., 1, :]
    A = torch.cat([r0 * w, r1 * w], dim=2)
    Mt = A.transpose(-1, -2) @ A
    n_obs = torch.sum(use, dim=-1)
    tr = torch.diagonal(Mt, dim1=-2, dim2=-1).sum(-1)
    eye4 = torch.eye(4, dtype=dtype, device=pts.device)
    Binv = ransac_ops.inv_nan(Mt + (1e-9 * tr + 1e-12)[..., None, None] * eye4)
    v = torch.full(Mt.shape[:-1], 0.5, dtype=dtype, device=pts.device)
    for _ in range(4):
        v = (Binv @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    h = v[..., 3:4]
    pw = v[..., :3] / torch.where(torch.abs(h) > 1e-9, h, torch.full_like(h, 1e-9))
    depths = torch.einsum("bfa,bna->bnf", R_cw[..., 2, :], pw) + t_cw[:, None, :, 2]
    pos = torch.sum((depths > 0.05) & use, dim=-1)
    ok = (n_obs >= 2) & (pos >= torch.clamp(n_obs - 1, min=2))
    # a row seen once is rank-deficient: its inverse may come out NaN or
    # finite by the rounding of the LU, and a NaN point, even at weight 0,
    # would poison the PnP and bundle-adjustment sums it is masked out of
    return torch.where(ok[..., None], pw, torch.zeros_like(pw)), n_obs, ok


def init_mono(cfg: EstimatorConfig, st: EstimatorState, u_f: torch.Tensor,
              u_pnp: torch.Tensor) -> Tuple[EstimatorState, StepOutput, torch.Tensor]:
    """Monocular (depth-less) initialization at window-full: the IMU
    excitation check; the earliest frame l with ≥ 20 features in common
    with the newest frame and ≥ 30 px @ 460 of mean parallax, their
    relative pose by F-RANSAC (``u_f`` (B, 64, MAXF)) and the essential
    decomposition; three rounds of DLT triangulation and PnP of every
    frame against the structure (``u_pnp`` (B, 3, FRAMES, 8, MAXF)); a
    visual-only bundle adjustment; the gyro-bias least squares and the
    velocity/gravity/scale alignment; the window scaled to metres and
    rotated to gravity; the solve/marginalize/slide tail.  Returns (state,
    output, ok (B,)); where not ok the state is the original one slid."""
    dtype = st.x.P.dtype
    dev = st.x.P.device
    t, x = st.table, st.x
    B, M = t.start.shape
    jW = FRAMES - 1
    pre0 = _make_preints(cfg, st)
    excited = init_ops.imu_excitation_ok(pre0.pre.delta_v, pre0.pre.sum_dt, pre0.valid)

    act = ftab.active_rows(t)
    common = t.obs_mask & t.obs_mask[:, :, jW:] & act[..., None]  # (B, M, F)
    par = torch.linalg.norm(t.pts - t.pts[:, :, jW:], dim=-1)
    n_common = torch.sum(common, dim=1)  # (B, F)
    mean_par = (torch.sum(torch.where(common, par, torch.zeros_like(par)), dim=1)
                / torch.clamp(n_common, min=1))
    frames = torch.arange(FRAMES, device=dev)
    cand = (n_common >= 20) & (mean_par * 460.0 > 30.0) & (frames != jW)
    l = torch.argmax(cand.to(torch.int32), dim=1)  # the earliest candidate
    have_l = torch.any(cand, dim=1)
    l_rows = l[:, None].expand(B, M)
    pts_l = ftab.take_frame(t.pts, l_rows)
    pts_W = t.pts[:, :, jW]
    pair_ok = ftab.take_frame(common, l_rows)
    fm = ransac_ops.fundamental_ransac(u_f, pts_l, pts_W, pair_ok, threshold=0.3 / 460.0,
                                       min_valid=15)
    R_rel, t_rel, cheir = init_ops.decompose_essential(fm.model, pts_l, pts_W, fm.inliers)
    rel_ok = fm.ok & (fm.n_inliers > 12) & (cheir > 8)

    # the world is the camera frame of l
    is_W = frames == jW
    R_cw = torch.where(is_W[None, :, None, None], R_rel[:, None],
                       torch.eye(3, dtype=dtype, device=dev).expand(B, FRAMES, 3, 3))
    t_cw = torch.where(is_W[None, :, None], t_rel[:, None], torch.zeros_like(x.P))
    anchors = (frames == l[:, None]) | is_W
    pose_known = anchors
    obs = t.obs_mask & act[..., None]
    for rnd in range(3):
        pw, _, tri_ok = _dlt_triangulate(t.pts, obs, R_cw, t_cw, pose_known)
        ok_j = (obs & tri_ok[..., None]).transpose(1, 2).reshape(B * FRAMES, M)
        res = ransac_ops.pnp_ransac_guess(
            u_pnp[:, rnd].reshape(B * FRAMES, -1, M),
            pw[:, None].expand(B, FRAMES, M, 3).reshape(B * FRAMES, M, 3),
            t.pts.transpose(1, 2).reshape(B * FRAMES, M, 2), ok_j,
            R_cw.reshape(B * FRAMES, 3, 3), t_cw.reshape(B * FRAMES, 3),
            threshold=10.0 / 460.0, min_inliers=10, refine_iters=8)
        okn = res.ok.reshape(B, FRAMES)
        # only l and the newest frame anchor the gauge; every other frame
        # refines against the re-triangulated structure each round
        upd = okn & ~anchors
        R_cw = torch.where(upd[..., None, None], res.model[..., :3].reshape(B, FRAMES, 3, 3),
                           R_cw)
        t_cw = torch.where(upd[..., None], res.model[..., 3].reshape(B, FRAMES, 3), t_cw)
        pose_known = pose_known | okn
    chain_ok = rel_ok & torch.all(pose_known, dim=1)

    R_wc = R_cw.transpose(-1, -2)
    t_wc = -(R_wc @ t_cw[..., None])[..., 0]
    R_wi = R_wc @ quat.q2R(x.qic)[:, None].transpose(-1, -2)
    pw, _, tri_ok = _dlt_triangulate(t.pts, obs, R_cw, t_cw, pose_known)
    s_all = t.start.to(torch.int64)
    bidx = torch.arange(B, device=dev)[:, None]
    d_start = ((R_cw[bidx, s_all] @ pw[..., None])[..., 0] + t_cw[bidx, s_all])[..., 2]
    # a visual-only bundle adjustment over the bootstrapped window
    ba_cfg = dataclasses.replace(cfg, use_imu=False, fix_depth=False)
    x_ba = x._replace(P=t_wc - (R_wi @ x.tic[:, None, :, None])[..., 0], Q=quat.R2q(R_wi))
    use = tri_ok & act
    vis = slv.VisualData(start=t.start, pts=t.pts, vel=t.vel, td_obs=t.td_obs,
                         row_scaled=t.uv[..., 1] * cfg.tr_over_row, obs_mask=t.obs_mask,
                         inv_depth=1.0 / torch.clamp(d_start, min=0.1), depth_free=use,
                         valid=use)
    x_ba = slv.solve(ba_cfg.solver, x_ba, vis, None, slv.empty_prior(B, dev, dtype),
                     _gravity(cfg, x.P)).x
    R_ba = quat.q2R(x_ba.Q)
    t_wc_ba = x_ba.P + (R_ba @ x.tic[:, None, :, None])[..., 0]

    st1 = _gyro_bias_update(cfg, st, pre0, x_ba.Q)
    pre1 = _make_preints(cfg, st1)
    V_body, g_c0, s_scale, align_ok = init_ops.linear_alignment(
        pre1.pre.delta_p, pre1.pre.delta_v, pre1.pre.sum_dt, t_wc_ba, x_ba.Q, st1.x.tic,
        pre1.valid, cfg.g_norm)
    # metric camera positions -> imu positions
    P_imu = s_scale[:, None, None] * t_wc_ba - (R_ba @ st1.x.tic[:, None, :, None])[..., 0]
    x_new = _world_aligned(st1.x, g_c0, P_imu - P_imu[:, :1], R_ba, V_body)
    # the scaled structure seeds the table's depths
    table1 = st1.table._replace(est_depth=torch.where(
        tri_ok, s_scale[:, None] * d_start, st1.table.est_depth))
    st1 = st1._replace(x=x_new, table=table1)
    ok = excited & have_l & chain_ok & align_ok & torch.isfinite(s_scale)
    st2, out = _solve_and_slide(cfg, st1, _all(st, True), _all(st, 50, torch.int64))
    return where_state(ok, st2, _slide(cfg, st, _all(st, True))), out, ok


def vio_step(cfg: EstimatorConfig, st: EstimatorState, feats: FrameFeatures,
             imu: ImuInterval, relo: Optional[slv.ReloData] = None,
             pnp_u: Optional[torch.Tensor] = None) -> Tuple[EstimatorState, StepOutput]:
    """Steady-state per-frame program (the newest slot is WINDOW_SIZE);
    ``relo`` is the relocalization constraint (``fast_relo``); ``pnp_u``
    (B, 32, MAXF), the PnP uniforms of the VO pose init (VO only)."""
    j = WINDOW_SIZE
    st = _store_interval(st, j, imu)
    if cfg.use_imu:
        st = st._replace(x=_propagate_newest(cfg, st, j))
    else:
        st = st._replace(x=_copy_previous_pose(st.x, j))
    table, is_kf, ltn = ftab.ingest_frame(st.table, j, feats, st.x.td,
                                          cfg.depth_min_dist, cfg.min_parallax)
    st = st._replace(table=table)
    if not cfg.use_imu:
        if pnp_u is None:
            raise ValueError("vio_step: VO mode needs the PnP uniforms pnp_u")
        st = st._replace(x=_pnp_newest(cfg, st, pnp_u))
    TRACER.mark("init")
    return _solve_and_slide(cfg, st, is_kf, ltn, relo)


def relo_to_device(relo: dict, device, dtype=torch.float32) -> slv.ReloData:
    """An active (B = 1) ``ReloData`` from the host arrays of
    ``VinsEstimator.set_relo_frame`` (a synchronous upload)."""
    def put(a, dt):
        return torch.as_tensor(a, dtype=dt).to(device)[None]
    return slv.ReloData(active=torch.ones((1,), dtype=torch.bool, device=device),
                        match_pts=put(relo["match_pts"], dtype),
                        match_valid=put(relo["match_valid"], torch.bool),
                        match_ids=put(relo["match_ids"], torch.int32),
                        P=put(relo["P"], dtype), Q=put(relo["Q"], dtype))


class ImuIntervalBuffer:
    """Host IMU buffer pairing samples to frame intervals (numpy port of
    ``VinsEstimator.push_imu``/``_collect_interval_np``)."""

    def __init__(self, max_imu: int):
        self.max_imu = max_imu
        self._buf: list = []

    def push(self, t: float, acc, gyr) -> None:
        if self._buf and t <= self._buf[-1][0]:
            return  # out-of-order sample dropped
        self._buf.append((float(t), np.asarray(acc, np.float64), np.asarray(gyr, np.float64)))

    def collect(self, t0: float, t1: float):
        """Samples spanning (t0, t1] as fixed buffers (dts, acc, gyr)."""
        maxi = self.max_imu
        dts = np.zeros(maxi)
        acc = np.zeros((maxi + 1, 3))
        gyr = np.zeros((maxi + 1, 3))
        buf = self._buf
        while len(buf) > 1 and buf[1][0] <= t0:
            buf.pop(0)
        if not buf:
            return dts, acc, gyr
        acc[0], gyr[0] = buf[0][1], buf[0][2]
        t_prev, k, idx = t0, 0, 1
        while idx < len(buf) and k < maxi:
            ts, a, w = buf[idx]
            if ts >= t1:
                break
            dts[k] = ts - t_prev
            acc[k + 1], gyr[k + 1] = a, w
            t_prev = ts
            k += 1
            idx += 1
        if k < maxi and idx < len(buf):
            ts, a, w = buf[idx]
            dts[k] = t1 - t_prev
            acc[k + 1], gyr[k + 1] = a, w
            k += 1
        if k > 0:
            acc[k + 1:] = acc[k]
            gyr[k + 1:] = gyr[k]
        while len(buf) > 1 and buf[1][0] < t1:
            buf.pop(0)
        return dts, acc, gyr


class VinsEstimator:
    """Host orchestration of one sequence: IMU pairing, the INITIAL →
    NON_LINEAR phases and the failure reset (twin of ``VinsEstimator``,
    ``vins_rgbd_fast_tpu/backend/estimator.py:960-1319``).  The state is
    the batched state at B = 1.

    At window-full the static initialization runs, or under
    ``static_init`` 0 the dynamic one (``init_dynamic``), then the
    monocular one (``init_mono``) if it fails; if both fail the window
    slides and the next frame retries.  With ``estimate_extrinsic`` 2 the
    imu<-cam rotation is calibrated hand-eye from each frame's tracked
    features and IMU interval (``_update_ex_calibration``) until the
    calibration converges.  With ``estimate_td`` the host re-reads td from
    the state every ``max(failure_check_interval, 4)`` steps to pair the
    IMU intervals (on CUDA through a pinned copy started after the step
    before).

    Random draws come from the estimator's own ``torch.Generator``s (the
    VO pose init's on the device, the initialization's and the
    calibration's on the host, uploaded: the same on every device) or
    from injected callables (tests inject JAX's ``PRNGKey(1)`` draws;
    ``step`` counts every processed frame, as JAX's key index does):
    ``pnp_uniforms(step)`` the VO pose init's (32, MAXF);
    ``init_uniforms(step)`` a triple, the dynamic chain's (FRAMES - 1, 8,
    MAXF), the monocular F-RANSAC's (64, MAXF) and the monocular PnP
    rounds' (3, FRAMES, 8, MAXF); ``ex_uniforms(step, n)`` the hand-eye
    F-RANSAC's (64, n) over n matches.  With ``eager_outputs=False``
    nothing is read back on a steady frame except the failure check, every
    ``failure_check_interval`` frames, and the td refresh.
    ``set_relo_frame`` (from any thread) queues a relocalization constraint
    as host arrays; the next steady step takes it.  A reset (a failure or a
    stream discontinuity) drops the queued one and refuses one made from a
    frame before it (JAX's ``reset`` keeps it for the first solve after the
    re-initialization, whose feature ids and world are new)."""

    INITIAL = 0
    NON_LINEAR = 1

    def __init__(self, vcfg, device, dtype=torch.float32, eager_outputs: bool = True,
                 failure_check_interval: int = 1, pnp_uniforms: Optional[Callable] = None,
                 init_uniforms: Optional[Callable] = None,
                 ex_uniforms: Optional[Callable] = None):
        self.vcfg = vcfg
        self.cfg = EstimatorConfig.from_vins(vcfg)
        self.device = torch.device(device)
        self._pnp_uniforms = pnp_uniforms
        self._init_uniforms = init_uniforms
        self._ex_uniforms = ex_uniforms
        self.pnp_generator = torch.Generator(device=self.device)
        self.pnp_generator.manual_seed(1)
        # the initialization's and the calibration's draws are made on the host
        # and uploaded, the same on every device as JAX's keys are: a card
        # then takes the CPU's initialization decisions on the same stream
        self.init_generator = torch.Generator()
        self.init_generator.manual_seed(3)
        self.dtype = dtype
        self.eager_outputs = eager_outputs
        self.failure_check_interval = failure_check_interval
        self._imu = ImuIntervalBuffer(self.cfg.max_imu)
        self.prev_time = None
        self._pending: list = []  # (t, StepOutput on the device)
        self._latest_base = None
        self._relo_lock = threading.Lock()
        self._pending_relo: Optional[dict] = None  # host arrays of set_relo_frame
        self.epoch = 0  # resets so far: a constraint belongs to the window it was made from
        # extrinsic rotation calibration (estimate_extrinsic 2)
        self._ex_calibrating = vcfg.estimate_extrinsic == 2
        self._ex_pairs: list = []  # (q_cam (4,), q_imu (4,)) host arrays
        self._prev_feats_host: Optional[tuple] = None  # (ids, pts) of the previous frame
        self.reset()

    def reset(self):
        # a queued relocalization binds the old window's feature ids (the
        # tracker restarts them) and poses of the old world: it is dropped,
        # and one made from a frame before this reset is refused later
        with self._relo_lock:
            self._pending_relo = None
            self.epoch += 1
        self.state = init_estimator_state(self.cfg, self.vcfg.ric_matrix(),
                                          self.vcfg.tic_vector(), self.vcfg.td, 1,
                                          self.device, self.dtype)
        self.frame_count = 0
        self.solver_flag = self.INITIAL
        self.headers = [0.0] * FRAMES
        self._step = 0
        self._td_cache = float(self.vcfg.td)
        self._td_copy = None  # (pinned (1,) buffer, event) of a td read in flight

    # -- td -----------------------------------------------------------------
    def _td_refresh_due(self) -> bool:
        return (self.cfg.estimate_td
                and self._step % max(self.failure_check_interval, 4) == 0)

    def refresh_td_cache(self):
        """At the start of a step: every ``max(failure_check_interval, 4)``
        steps, the state's td becomes the host's IMU pairing offset."""
        if not self._td_refresh_due():
            return
        if self._td_copy is not None:
            buf, done = self._td_copy
            self._td_copy = None
            if not done.query():
                with TRACER.wait("wait::td"):
                    done.synchronize()  # the step before is still running
            self._td_cache = float(buf[0])
        else:
            with TRACER.wait("wait::td"):
                self._td_cache = float(self.state.x.td[0])

    def stage_td_copy(self):
        """At the end of a step on CUDA: when the next step refreshes td,
        copy it to pinned memory now, behind the step's launches."""
        if self.device.type != "cuda" or not self._td_refresh_due():
            return
        buf = torch.empty((1,), dtype=self.dtype, pin_memory=True)
        buf.copy_(self.state.x.td, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._td_copy = (buf, done)

    # -- IMU ----------------------------------------------------------------
    def push_imu(self, t: float, acc, gyr):
        self._imu.push(t, acc, gyr)  # disordered samples are dropped

    def imu_available(self, t: float) -> bool:
        buf = self._imu._buf
        return bool(buf) and buf[-1][0] >= t

    def _collect_interval_np(self, t0: float, t1: float):
        return self._imu.collect(t0, t1)

    def draw_pnp_uniforms(self, step: int) -> torch.Tensor:
        """(1, 32, MAXF) uniforms for the VO pose init of step ``step``."""
        shape = (ransac_ops.PNP_TRIALS, self.cfg.maxf)
        if self._pnp_uniforms is not None:
            u = torch.tensor(np.asarray(self._pnp_uniforms(step)), dtype=self.dtype)
            return u.reshape(shape)[None].to(self.device)
        return torch.rand((1,) + shape, generator=self.pnp_generator, device=self.device,
                          dtype=self.dtype)

    def draw_init_uniforms(self, step: int):
        """The uniforms of an initialization attempt at step ``step``: the
        dynamic chain's (1, FRAMES - 1, 8, MAXF), the monocular F-RANSAC's
        (1, 64, MAXF) and PnP rounds' (1, 3, FRAMES, 8, MAXF)."""
        M = self.cfg.maxf
        shapes = ((FRAMES - 1, 8, M), (64, M), (3, FRAMES, 8, M))
        if self._init_uniforms is not None:
            return tuple(torch.tensor(np.asarray(a), dtype=self.dtype).reshape(sh)[None]
                         .to(self.device) for a, sh in zip(self._init_uniforms(step), shapes))
        return tuple(torch.rand((1,) + sh, generator=self.init_generator, dtype=self.dtype)
                     .to(self.device) for sh in shapes)

    def draw_ex_uniforms(self, step: int, n: int) -> torch.Tensor:
        """(1, 64, n) uniforms of the hand-eye F-RANSAC over n matches."""
        if self._ex_uniforms is not None:
            u = torch.tensor(np.asarray(self._ex_uniforms(step, n)), dtype=self.dtype)
            return u.reshape(64, n)[None].to(self.device)
        return torch.rand((1, 64, n), generator=self.init_generator,
                          dtype=self.dtype).to(self.device)

    def _upload_interval(self, dts, acc, gyr) -> ImuInterval:
        def put(a):
            return torch.as_tensor(a[None], dtype=self.dtype).to(self.device)
        return ImuInterval(put(dts), put(acc), put(gyr))

    # -- frames -------------------------------------------------------------
    def process_features(self, feats: FrameFeatures, t: float):
        """One backend step for a tracked frame (B = 1) at time t; returns
        the odometry (a dict, or the device ``StepOutput`` without
        ``eager_outputs``) once NON_LINEAR, else None."""
        cfg = self.cfg
        self.refresh_td_cache()
        cur_time = t + self._td_cache
        if cfg.use_imu:
            iv = self._collect_interval_np(
                self.prev_time if self.prev_time is not None else cur_time - 1e-3, cur_time)
        else:
            iv = (np.zeros(cfg.max_imu), np.zeros((cfg.max_imu + 1, 3)),
                  np.zeros((cfg.max_imu + 1, 3)))
        imu = self._upload_interval(*iv)
        self.prev_time = cur_time

        if self._ex_calibrating:
            self._update_ex_calibration(feats, imu)

        out = None
        if self.solver_flag == self.INITIAL:
            self.state, _ = fill_step(cfg, self.state, self.frame_count, feats, imu)
            self.headers[self.frame_count] = t
            if self.frame_count == WINDOW_SIZE:
                if cfg.use_imu and not cfg.static_init:
                    ok, step_out = self._init_dynamic_or_mono()
                else:
                    self.state, step_out = init_full(cfg, self.state)
                    ok = True
                if ok:
                    self.solver_flag = self.NON_LINEAR
                    out = self._emit(step_out, t)
                else:  # the window was slid: stay INITIAL, retry on the next frame
                    self.headers = self.headers[1:] + [t]
            else:
                self.frame_count += 1
        else:
            relo = None
            if cfg.fast_relo:
                pend = self.take_relo()
                relo = (slv.empty_relo(1, cfg.maxf, self.device, self.dtype) if pend is None
                        else relo_to_device(pend, self.device, self.dtype))
            pnp_u = None if cfg.use_imu else self.draw_pnp_uniforms(self._step)
            self.state, step_out = vio_step(cfg, self.state, feats, imu, relo, pnp_u)
            self.headers = self.headers[1:] + [t]
            if self.failed(step_out):
                self.reset()
                self.prev_time = None
                return None
            out = self._emit(step_out, t)
        self._step += 1
        self.stage_td_copy()
        return out

    def _init_dynamic_or_mono(self):
        """Dynamic initialization, then the monocular one from the same
        window if it failed; returns (ok, StepOutput) and leaves the state
        initialized, or slid where both failed."""
        u_chain, u_f, u_pnp = self.draw_init_uniforms(self._step)
        st_before = self.state
        self.state, step_out, ok = init_dynamic(self.cfg, st_before, u_chain)
        if bool(ok[0]):
            return True, step_out
        st_m, out_m, ok_m = init_mono(self.cfg, st_before, u_f, u_pnp)
        if bool(ok_m[0]):
            self.state = st_m
            return True, out_m
        return False, step_out

    def _update_ex_calibration(self, feats: FrameFeatures, imu: ImuInterval):
        """Online imu<-cam rotation calibration: a (camera, IMU) pair of
        relative rotations per frame, from the features tracked since the
        previous frame (F-RANSAC and the essential decomposition) and the
        gyro-integrated interval; once 12 pairs are in, the hand-eye solve
        over the last 100 each frame, until it converges (then the solver
        refines the extrinsic online, ``estimate_extrinsic`` 1)."""
        ids = feats.ids[0].cpu().numpy()
        pts = feats.pts[0].cpu().numpy()
        prev, self._prev_feats_host = self._prev_feats_host, (ids, pts)
        if prev is None:
            return
        pids, ppts = prev
        common = {int(i): k for k, i in enumerate(pids) if i >= 0}
        pairs = [(ppts[common[int(i)]], pts[k]) for k, i in enumerate(ids)
                 if i >= 0 and int(i) in common]
        if len(pairs) < 9:
            return
        m1, m2 = (torch.as_tensor(np.stack(p), dtype=self.dtype).to(self.device)[None]
                  for p in zip(*pairs))
        res = ransac_ops.fundamental_ransac(
            self.draw_ex_uniforms(self._step, len(pairs)), m1, m2,
            torch.ones(m1.shape[:2], dtype=torch.bool, device=self.device),
            threshold=1.0 / 460.0)
        R_cam, _, _ = init_ops.decompose_essential(res.model, m1, m2, res.inliers)
        # the camera's rotation of frame k in frame k-1, and the IMU's
        zero = torch.zeros_like(imu.acc[:, 0])
        pre = imupre.preintegrate(imu.dts, imu.acc, imu.gyr, zero, zero, _noise(self.cfg))
        self._ex_pairs.append((quat.R2q(R_cam.transpose(1, 2))[0].cpu().numpy(),
                               pre.delta_q[0].cpu().numpy()))
        if len(self._ex_pairs) < 12:
            return
        self._ex_pairs = self._ex_pairs[-100:]
        qc, qi = (torch.as_tensor(np.stack(p), dtype=self.dtype).to(self.device)
                  for p in zip(*self._ex_pairs))
        ric, ok = init_ops.calibrate_extrinsic_rotation(
            qc, qi, quat.q2R(self.state.x.qic[0]),
            torch.ones(qc.shape[0], dtype=torch.bool, device=self.device))
        if bool(ok):
            self.state = self.state._replace(x=self.state.x._replace(qic=quat.R2q(ric)[None]))
            self._ex_calibrating = False

    def latest_odometry(self, t=None):
        """IMU-rate odometry: midpoint-propagate the newest solved state
        through the buffered IMU samples up to ``t`` (numpy, one read-back
        per solved frame)."""
        if self.solver_flag != self.NON_LINEAR or not self._pending:
            return None
        t_last, out = self._pending[-1]
        if self._latest_base is not None and self._latest_base[0] == t_last:
            base = self._latest_base[1]
        else:
            base = self._materialize(t_last, out)
            self._latest_base = (t_last, base)
        P = np.asarray(base["P"], np.float64).copy()
        Q = np.asarray(base["Q"], np.float64).copy()
        V = np.asarray(base["V"], np.float64).copy()
        g = np.array([0.0, 0.0, self.cfg.g_norm])
        ba = np.asarray(base.get("Ba", np.zeros(3)), np.float64)
        bg = np.asarray(base.get("Bg", np.zeros(3)), np.float64)
        samples = [s for s in self._imu._buf if s[0] > t_last and (t is None or s[0] <= t)]
        t_prev = t_last
        acc_prev = gyr_prev = None

        def rot(q, v):
            w0, x, y, z = q
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w0 * z), 2 * (x * z + w0 * y)],
                [2 * (x * y + w0 * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w0 * x)],
                [2 * (x * z - w0 * y), 2 * (y * z + w0 * x), 1 - 2 * (x * x + y * y)],
            ])
            return R @ v

        for (ts, acc, gyr) in samples:
            dt = ts - t_prev
            if acc_prev is None:
                acc_prev, gyr_prev = acc, gyr
            half = 0.5 * (0.5 * (gyr_prev + gyr) - bg) * dt
            dq = np.array([1.0, half[0], half[1], half[2]])
            Qn = np.array([
                Q[0] * dq[0] - Q[1] * dq[1] - Q[2] * dq[2] - Q[3] * dq[3],
                Q[0] * dq[1] + Q[1] * dq[0] + Q[2] * dq[3] - Q[3] * dq[2],
                Q[0] * dq[2] - Q[1] * dq[3] + Q[2] * dq[0] + Q[3] * dq[1],
                Q[0] * dq[3] + Q[1] * dq[2] - Q[2] * dq[1] + Q[3] * dq[0],
            ])
            Qn /= np.linalg.norm(Qn)
            a = 0.5 * ((rot(Q, acc_prev - ba) - g) + (rot(Qn, acc - ba) - g))
            P = P + V * dt + 0.5 * a * dt * dt
            V = V + a * dt
            Q = Qn
            acc_prev, gyr_prev = acc, gyr
            t_prev = ts
        return dict(t=t_prev, P=P, Q=Q, V=V)

    def set_relo_frame(self, match_pts, match_valid, match_ids, P_old, Q_old,
                       epoch: Optional[int] = None) -> bool:
        """Queue a relocalization constraint for the next solve: the matched
        old-keyframe observations (MAXF, 2), their mask, the FEATURE IDS of
        the window points they match (``StepOutput.wp_ids`` of the keyframe)
        and the old keyframe's pose.  ``epoch``: the estimator's ``epoch``
        at the keyframe's frame (a worker thread's constraint); one made
        before a reset is refused.  The queued constraint keeps the epoch
        it belongs to (``"epoch"``).  Returns whether it was queued."""
        relo = dict(match_pts=np.asarray(match_pts, np.float32),
                    match_valid=np.asarray(match_valid, bool),
                    match_ids=np.asarray(match_ids, np.int32),
                    P=np.asarray(P_old, np.float32), Q=np.asarray(Q_old, np.float32))
        with self._relo_lock:
            if epoch is not None and epoch != self.epoch:
                return False
            relo["epoch"] = self.epoch
            self._pending_relo = relo
        return True

    def take_relo(self) -> Optional[dict]:
        """The queued constraint (host arrays), or None; clears the queue."""
        with self._relo_lock:
            relo, self._pending_relo = self._pending_relo, None
        return relo

    def failed(self, step_out: StepOutput) -> bool:
        """The failure check of a steady step, every
        ``failure_check_interval`` steps (a read of the step's flag, which
        waits for the step); a failure is counted."""
        if self._step % self.failure_check_interval:
            return False
        with TRACER.wait("wait::failure"):
            fail = bool(step_out.failure[0])
        if fail:
            TRACER.count("vins::failure_resets")
        return fail

    def _emit(self, step_out: StepOutput, t: float):
        self._pending.append((t, step_out))
        if self.eager_outputs:
            with TRACER.wait("wait::outputs"):
                return self._materialize(t, step_out)
        return step_out

    @staticmethod
    def _materialize(t: float, step_out: StepOutput) -> dict:
        h = StepOutput(*[f[0].detach().cpu().numpy() for f in step_out])
        return dict(t=t, P=h.P, Q=h.Q, V=h.V, Ba=h.Ba, Bg=h.Bg,
                    is_keyframe=bool(h.is_keyframe), cost=float(h.cost),
                    n_features=int(h.n_features), relo_P=h.relo_P, relo_Q=h.relo_Q,
                    relo_used=bool(h.relo_used), relo_cur_P=h.relo_cur_P,
                    relo_cur_Q=h.relo_cur_Q, wp_world=h.wp_world, wp_uv=h.wp_uv,
                    wp_norm=h.wp_norm, wp_valid=h.wp_valid, wp_ids=h.wp_ids)

    @property
    def trajectory(self) -> list:
        """Materialized odometry records; one device fetch per field."""
        if not self._pending:
            return []
        outs = [o for _, o in self._pending]
        host = {k: torch.stack([getattr(o, k)[0] for o in outs]).cpu().numpy()
                for k in ("P", "Q", "V", "is_keyframe", "cost", "n_features")}
        return [dict(t=t, P=host["P"][i], Q=host["Q"][i], V=host["V"][i],
                     is_keyframe=bool(host["is_keyframe"][i]), cost=float(host["cost"][i]),
                     n_features=int(host["n_features"][i]))
                for i, (t, _) in enumerate(self._pending)]
