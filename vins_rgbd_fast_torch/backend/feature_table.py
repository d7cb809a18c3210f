"""Dense landmark table over B sequences (twin of
``vins_rgbd_fast_tpu/backend/feature_table.py``): ingest with the keyframe
parallax test, depth-validated triangulation, solver depth view, window
slides.  ``frame_idx`` is a Python int (the batch runs in lock step).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.ransac import inv_nan
from ..utils import quaternion as quat
from .state import FRAMES, WINDOW_SIZE

INIT_DEPTH = 5.0
MIN_OBS_FOR_DEPTH = 2
FLAG_NONE = 0
FLAG_MEASURED = 1
FLAG_TRIANGULATED = 2


class FeatureTable(NamedTuple):
    ids: torch.Tensor         # (B, MAXF) int32, -1 = empty row
    start: torch.Tensor       # (B, MAXF) int32 slot of first observation
    obs_mask: torch.Tensor    # (B, MAXF, FRAMES) bool
    pts: torch.Tensor         # (B, MAXF, FRAMES, 2) normalized xy
    uv: torch.Tensor          # (B, MAXF, FRAMES, 2) pixels
    vel: torch.Tensor         # (B, MAXF, FRAMES, 2)
    td_obs: torch.Tensor      # (B, MAXF, FRAMES)
    depth_meas: torch.Tensor  # (B, MAXF, FRAMES) metres, 0 = none
    est_depth: torch.Tensor   # (B, MAXF) depth at start frame, <= 0 = none
    flag: torch.Tensor        # (B, MAXF) int32 estimate flag
    is_dynamic: torch.Tensor  # (B, MAXF) bool


class FrameFeatures(NamedTuple):
    ids: torch.Tensor    # (B, MAXC) int32, -1 = invalid slot
    pts: torch.Tensor    # (B, MAXC, 2)
    uv: torch.Tensor     # (B, MAXC, 2)
    vel: torch.Tensor    # (B, MAXC, 2)
    depth: torch.Tensor  # (B, MAXC)


def empty_table(B: int, maxf: int, device, dtype=torch.float32) -> FeatureTable:
    def z(*s, dt=dtype):
        return torch.zeros((B, maxf) + s, dtype=dt, device=device)
    return FeatureTable(
        ids=torch.full((B, maxf), -1, dtype=torch.int32, device=device),
        start=z(dt=torch.int32), obs_mask=z(FRAMES, dt=torch.bool),
        pts=z(FRAMES, 2), uv=z(FRAMES, 2), vel=z(FRAMES, 2), td_obs=z(FRAMES),
        depth_meas=z(FRAMES),
        est_depth=torch.full((B, maxf), -1.0, dtype=dtype, device=device),
        flag=z(dt=torch.int32), is_dynamic=z(dt=torch.bool))


def active_rows(t: FeatureTable) -> torch.Tensor:
    return t.ids >= 0


def obs_count(t: FeatureTable) -> torch.Tensor:
    return torch.sum(t.obs_mask, dim=-1)


def ingest_frame(t: FeatureTable, frame_idx: int, feats: FrameFeatures,
                 td: torch.Tensor, depth_min_dist: float, min_parallax: float
                 ) -> Tuple[FeatureTable, torch.Tensor, torch.Tensor]:
    """Insert one frame of features into slot ``frame_idx``; returns
    (table, is_keyframe (B,), last_track_num (B,))."""
    valid_in = (feats.ids >= 0) & ~((feats.depth > 0) & (feats.depth < depth_min_dist))
    act = active_rows(t)
    match = (t.ids[:, :, None] == feats.ids[:, None, :]) & act[:, :, None] & valid_in[:, None, :]
    col_has_match = torch.any(match, dim=1)

    is_new = valid_in & ~col_has_match
    free = ~act
    free_rank = torch.cumsum(free, dim=1) - 1
    new_rank = torch.cumsum(is_new, dim=1) - 1
    can_alloc = is_new & (new_rank < torch.sum(free, dim=1, keepdim=True))
    assign = free[:, :, None] & can_alloc[:, None, :] & (free_rank[:, :, None] == new_rank[:, None, :])

    matched_r = torch.any(match, dim=2)
    alloc_r = torch.any(assign, dim=2)
    hit_r = matched_r | alloc_r
    # each hit row pulls exactly one incoming column (one-hot per row)
    col = torch.argmax((match | assign).to(torch.uint8), dim=2)

    def pull(values):
        return torch.gather(values, 1, col.reshape(col.shape + (1,) * (values.dim() - 2))
                            .expand(col.shape + values.shape[2:]))

    new_ids = torch.where(alloc_r, pull(feats.ids), t.ids)
    new_start = torch.where(alloc_r, torch.full_like(t.start, frame_idx), t.start)
    new_obs_mask = t.obs_mask & matched_r[..., None]
    new_obs_mask[:, :, frame_idx] = True
    new_obs_mask = torch.where(hit_r[..., None], new_obs_mask, t.obs_mask)

    def set_frame(field, values):
        """Matched rows keep their history, allocated rows clear it; both
        take the incoming value at slot frame_idx; other rows unchanged."""
        shape = hit_r.shape + (1,) * (field.dim() - 2)
        upd = torch.where(matched_r.reshape(shape), field, torch.zeros_like(field))
        upd[:, :, frame_idx] = pull(values)
        return torch.where(hit_r.reshape(shape), upd, field)

    td_in = td[:, None].expand(feats.ids.shape).to(t.td_obs.dtype)
    t2 = FeatureTable(
        ids=new_ids, start=new_start, obs_mask=new_obs_mask,
        pts=set_frame(t.pts, feats.pts), uv=set_frame(t.uv, feats.uv),
        vel=set_frame(t.vel, feats.vel), td_obs=set_frame(t.td_obs, td_in),
        depth_meas=set_frame(t.depth_meas, feats.depth),
        est_depth=torch.where(alloc_r, torch.full_like(t.est_depth, -1.0), t.est_depth),
        flag=torch.where(alloc_r, torch.full_like(t.flag, FLAG_NONE), t.flag),
        is_dynamic=t.is_dynamic & ~alloc_r)

    last_track_num = torch.sum(col_has_match, dim=1)

    fi = min(max(frame_idx - 2, 0), FRAMES - 1)
    fj = min(max(frame_idx - 1, 0), FRAMES - 1)
    ok = (active_rows(t2) & (t2.start <= frame_idx - 2)
          & t2.obs_mask[:, :, fi] & t2.obs_mask[:, :, fj])
    para = torch.linalg.norm(t2.pts[:, :, fi] - t2.pts[:, :, fj], dim=-1)
    parallax_num = torch.sum(ok, dim=1)
    parallax_mean = (torch.sum(torch.where(ok, para, torch.zeros_like(para)), dim=1)
                     / torch.clamp(parallax_num, min=1))
    forced = (last_track_num < 20) | (frame_idx < 2)
    is_kf = forced | (parallax_num == 0) | (parallax_mean >= min_parallax)
    return t2, is_kf, last_track_num


def cam_poses(P, Q, tic, qic):
    """World-from-camera poses per slot: (t_wc (B,F,3), R_wc (B,F,3,3))."""
    R_wi = quat.q2R(Q)
    t_wc = P + torch.einsum("bfij,bj->bfi", R_wi, tic)
    R_wc = R_wi @ quat.q2R(qic)[:, None]
    return t_wc, R_wc


def take_frame(x, s):
    """x (B, M, F, ...) at per-row frame s (B, M) -> (B, M, ...)."""
    idx = s.to(torch.int64).reshape(s.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 2, idx.expand(s.shape + (1,) + x.shape[3:]))[:, :, 0]


def triangulate_with_depth(t: FeatureTable, P, Q, tic, qic, depth_min_dist: float,
                           depth_max_dist: float) -> FeatureTable:
    """Vectorized ``triangulateWithDepth``: cross-validated measured depths
    (flag 1), rough beyond-max depths (flag 0), inverse-iteration DLT when
    no observation has depth (flag 2)."""
    dtype = t.pts.dtype
    t_wc, R_wc = cam_poses(P, Q, tic, qic)            # (B,F,3), (B,F,3,3)
    pts3 = torch.cat([t.pts, torch.ones_like(t.pts[..., :1])], dim=-1)  # (B,M,F,3)
    obs = t.obs_mask
    has_d = obs & (t.depth_meas > 0)
    p_cam = pts3 * t.depth_meas[..., None]
    p_w = torch.einsum("bfij,bmfj->bmfi", R_wc, p_cam) + t_wc[:, None]  # (B,M,F,3)
    # p_in_j[b,m,k,j] = R_wc[j]^T (p_w[k] - t_wc[j])
    p_in_j = (torch.einsum("bjli,bmkl->bmkji", R_wc, p_w)
              - torch.einsum("bjli,bjl->bji", R_wc, t_wc)[:, None, None])
    zj = p_in_j[..., 2]
    proj = p_in_j[..., :2] / torch.where(torch.abs(zj) > 1e-6, zj, torch.full_like(zj, 1e-6))[..., None]
    resid = torch.linalg.norm(proj - pts3[:, :, None, :, :2], dim=-1)  # (B,M,k,j)
    not_self = ~torch.eye(FRAMES, dtype=torch.bool, device=obs.device)
    pair_ok = (has_d[..., :, None] & obs[..., None, :] & not_self
               & (resid < 10.0 / 460.0) & (zj > 0))
    s = t.start.to(torch.int64)
    bidx = torch.arange(s.shape[0], device=s.device)[:, None]
    R_r = R_wc[bidx, s]  # (B,M,3,3)
    t_r = t_wc[bidx, s]  # (B,M,3)
    depth_ref = torch.einsum("bmki,bmi->bmk", p_w - t_r[:, :, None], R_r[..., :, 2])

    in_range = t.depth_meas <= depth_max_dist
    k_valid = torch.any(pair_ok, dim=-1)
    verified_k = k_valid & in_range
    rough_k = k_valid & ~in_range
    n_ver = torch.sum(verified_k, dim=-1)
    n_rough = torch.sum(rough_k, dim=-1)
    zero = torch.zeros_like(depth_ref)
    ver_avg = torch.sum(torch.where(verified_k, depth_ref, zero), -1) / torch.clamp(n_ver, min=1)
    rough_avg = torch.sum(torch.where(rough_k, depth_ref, zero), -1) / torch.clamp(n_rough, min=1)

    # DLT fallback (used only when no observation carries depth)
    no_depth_at_all = ~torch.any(has_d & obs, dim=-1)
    R_rel = torch.einsum("bmli,bflj->bmfij", R_r, R_wc)         # R_r^T R_f
    t_rel = torch.einsum("bmli,bmfl->bmfi", R_r, t_wc[:, None] - t_r[:, :, None])
    R_relT = R_rel.transpose(-1, -2)
    Pmat = torch.cat([R_relT, -torch.einsum("bmfij,bmfj->bmfi", R_relT, t_rel)[..., None]], -1)
    fdir = pts3 / torch.linalg.norm(pts3, dim=-1, keepdim=True)
    row0 = fdir[..., 0:1] * Pmat[..., 2, :] - fdir[..., 2:3] * Pmat[..., 0, :]
    row1 = fdir[..., 1:2] * Pmat[..., 2, :] - fdir[..., 2:3] * Pmat[..., 1, :]
    w = obs.to(dtype)[..., None]
    A = torch.cat([row0 * w, row1 * w], dim=-2)  # (B,M,2F,4)
    AtA = A.transpose(-1, -2) @ A
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    Binv = inv_nan(AtA + (1e-9 * tr + 1e-12)[..., None, None]
                   * torch.eye(4, dtype=dtype, device=A.device))
    v = torch.full(AtA.shape[:-1], 0.5, dtype=dtype, device=A.device)
    for _ in range(4):
        v = (Binv @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    svd_depth = v[..., 2] / torch.where(torch.abs(v[..., 3]) > 1e-12, v[..., 3],
                                        torch.full_like(v[..., 3], 1e-12))
    svd_depth = torch.where(svd_depth < depth_min_dist, torch.full_like(svd_depth, depth_max_dist),
                            svd_depth)

    neg = torch.full_like(ver_avg, -1.0)
    depth = torch.where(n_ver > 0, ver_avg, torch.where(
        n_rough > 0, rough_avg, torch.where(no_depth_at_all, svd_depth, neg)))
    fl = torch.full_like(t.flag, FLAG_NONE)
    flag = torch.where(n_ver > 0, torch.full_like(fl, FLAG_MEASURED), torch.where(
        n_rough > 0, fl, torch.where(no_depth_at_all, torch.full_like(fl, FLAG_TRIANGULATED), fl)))
    bad = (depth > -0.5) & (depth < 0.1)
    depth = torch.where(bad, torch.full_like(depth, INIT_DEPTH), depth)
    flag = torch.where(bad, fl, flag)

    eligible = (active_rows(t) & (t.est_depth <= 0) & ~t.is_dynamic
                & (obs_count(t) >= MIN_OBS_FOR_DEPTH) & (t.start < WINDOW_SIZE - 2)
                & (depth > 0))
    return t._replace(est_depth=torch.where(eligible, depth, t.est_depth),
                      flag=torch.where(eligible, flag, t.flag))


def solver_depth_view(t: FeatureTable, fix_depth: bool):
    """(inv_depth, free_mask, valid_mask), each (B, MAXF)."""
    valid = (active_rows(t) & (obs_count(t) >= 2) & (t.start < WINDOW_SIZE - 2)
             & (t.est_depth > 0) & ~t.is_dynamic)
    inv_depth = torch.where(valid, 1.0 / torch.clamp(t.est_depth, min=1e-6),
                            torch.ones_like(t.est_depth))
    free = valid & ~((t.flag == FLAG_MEASURED) if fix_depth else torch.zeros_like(valid))
    return inv_depth, free, valid


def drop_rows(t: FeatureTable, mask: torch.Tensor) -> FeatureTable:
    keep = ~mask
    return t._replace(
        ids=torch.where(keep, t.ids, torch.full_like(t.ids, -1)),
        obs_mask=t.obs_mask & keep[..., None],
        est_depth=torch.where(keep, t.est_depth, torch.full_like(t.est_depth, -1.0)),
        flag=torch.where(keep, t.flag, torch.zeros_like(t.flag)),
        is_dynamic=t.is_dynamic & keep)


def update_depths_from_solver(t: FeatureTable, inv_depth, free_mask) -> FeatureTable:
    """Write solved inverse depths back; negative depths drop the feature."""
    new_depth = 1.0 / torch.where(torch.abs(inv_depth) > 1e-8, inv_depth,
                                  torch.full_like(inv_depth, 1e-8))
    est = torch.where(free_mask, new_depth, t.est_depth)
    return drop_rows(t._replace(est_depth=est), free_mask & (new_depth <= 0))


def _roll_left(t: FeatureTable) -> FeatureTable:
    def roll(field):
        out = torch.roll(field, -1, dims=2)
        out[:, :, -1] = 0
        return out
    return t._replace(obs_mask=roll(t.obs_mask), pts=roll(t.pts), uv=roll(t.uv),
                      vel=roll(t.vel), td_obs=roll(t.td_obs),
                      depth_meas=roll(t.depth_meas))


def slide_old(t: FeatureTable, marg_t_wc, marg_R_wc, new_t_wc, new_R_wc) -> FeatureTable:
    """Marginalize-oldest shift; depths of features rooted at slot 0 are
    re-expressed in the new start camera.  Poses are (B, 3) / (B, 3, 3)."""
    started0 = active_rows(t) & (t.start == 0)
    pts0 = torch.cat([t.pts[:, :, 0], torch.ones_like(t.pts[:, :, 0, :1])], dim=-1)
    p_cam0 = pts0 * t.est_depth[..., None]
    p_w = p_cam0 @ marg_R_wc.transpose(-1, -2) + marg_t_wc[:, None]
    dep_j = ((p_w - new_t_wc[:, None]) @ new_R_wc)[..., 2]
    shifted = torch.where(dep_j > 0, dep_j, torch.full_like(dep_j, INIT_DEPTH))
    new_est = torch.where(started0 & (t.est_depth > 0), shifted, t.est_depth)
    t2 = _roll_left(t)._replace(start=torch.clamp(t.start - 1, min=0), est_depth=new_est)
    dead = active_rows(t2) & (torch.sum(t2.obs_mask, dim=-1) < 2) & started0
    dead = dead | (active_rows(t2) & ~torch.any(t2.obs_mask, dim=-1))
    return drop_rows(t2, dead)


def slide_new(t: FeatureTable) -> FeatureTable:
    """Marginalize-second-newest shift: slot F-1 moves into slot F-2."""
    last, second = FRAMES - 1, FRAMES - 2
    had_last = t.obs_mask[:, :, last]

    def move(field):
        f = field.clone()
        cond = had_last.reshape(had_last.shape + (1,) * (field.dim() - 3))
        f[:, :, second] = torch.where(cond, field[:, :, last], field[:, :, second])
        f[:, :, last] = 0
        return f

    obs = t.obs_mask.clone()
    obs[:, :, second] = had_last
    obs[:, :, last] = False
    obs_keep = t.obs_mask.clone()
    obs_keep[:, :, last] = False
    obs = torch.where((t.obs_mask[:, :, second] | had_last)[..., None], obs, obs_keep)
    t2 = t._replace(
        obs_mask=obs, pts=move(t.pts), uv=move(t.uv), vel=move(t.vel),
        td_obs=move(t.td_obs), depth_meas=move(t.depth_meas),
        start=torch.where(t.start == last, torch.full_like(t.start, second), t.start))
    return drop_rows(t2, active_rows(t2) & ~torch.any(t2.obs_mask, dim=-1))
