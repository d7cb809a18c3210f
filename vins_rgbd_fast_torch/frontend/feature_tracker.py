"""Frontend feature tracker for a batch of sequences (twin of
``track_frame``/``lookup_depth`` in
``vins_rgbd_fast_tpu/frontend/feature_tracker.py``).

pipeline per frame: CLAHE (``equalize``) → pyramid → IMU-predicted
pyramidal LK on
``pyr_levels_predicted`` levels, or without IMU prediction (VO) LK from the
previous positions on ``pyr_levels_cold`` levels (K3 by default, K2 in the
batched runner: ``TrackerConfig.lk_engine``) →
border/status cull → F-RANSAC → FAST + 3×3 NMS (K1) → the fisheye mask
(``fisheye``: scores and tracks outside the field of view dropped) →
per-grid top-k → min-distance admission (long tracks first) → compaction
→ undistortion and per-id velocities.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from ..backend.feature_table import FrameFeatures
from ..config import FOCAL_LENGTH, TrackerConfig
from ..models.camera import PinholeCamera
from ..ops import fast as fast_ops
from ..ops import image as image_ops
from ..ops import lk as lk_ops
from ..ops import ransac as ransac_ops

BORDER_SIZE = 1


@functools.lru_cache(maxsize=8)
def _fisheye_mask(path: str, height: int, width: int, radius_frac: float,
                  device: torch.device) -> torch.Tensor:
    """The (H, W) bool field-of-view mask, built once per configuration and
    device: the mask image at ``path`` (the reference's FISHEYE_MASK,
    intersected in setMask, feature_tracker.cpp:173-208) or, with no path,
    a centred circle of radius ``radius_frac``·min(H, W)."""
    if path:
        from ..io.images import load_mask

        return torch.from_numpy(load_mask(path, height, width)).to(device)
    yy = torch.arange(height, dtype=torch.float32)[:, None] - height / 2.0
    xx = torch.arange(width, dtype=torch.float32)[None, :] - width / 2.0
    rad = radius_frac * min(height, width)
    return ((yy * yy + xx * xx) < rad * rad).to(device)


def fisheye_mask(cfg: TrackerConfig, device) -> torch.Tensor:
    return _fisheye_mask(cfg.fisheye_mask_path, cfg.height, cfg.width,
                         cfg.fisheye_radius_frac, torch.device(device))


class TrackerState(NamedTuple):
    pyramid: Tuple[torch.Tensor, ...]  # previous-frame pyramid, (B, H_l, W_l)
    pts: torch.Tensor        # (B, MAXC, 2) pixel positions in prev frame
    ids: torch.Tensor        # (B, MAXC) int32, -1 empty
    track_cnt: torch.Tensor  # (B, MAXC) int32
    un_pts: torch.Tensor     # (B, MAXC, 2) normalized coords of prev frame
    prev_time: torch.Tensor  # (B,)
    next_id: torch.Tensor    # (B,) int32
    has_prev: torch.Tensor   # (B,) bool


class TrackerOutput(NamedTuple):
    features: FrameFeatures
    n_tracked: torch.Tensor
    n_total: torch.Tensor


def init_state(cfg: TrackerConfig, B: int, device, dtype=torch.float32) -> TrackerState:
    maxc = cfg.maxc
    pyr = tuple(torch.zeros((B, cfg.height // (2 ** l), cfg.width // (2 ** l)),
                            dtype=dtype, device=device) for l in range(cfg.pyr_levels))
    return TrackerState(
        pyramid=pyr,
        pts=torch.zeros((B, maxc, 2), dtype=dtype, device=device),
        ids=torch.full((B, maxc), -1, dtype=torch.int32, device=device),
        track_cnt=torch.zeros((B, maxc), dtype=torch.int32, device=device),
        un_pts=torch.zeros((B, maxc, 2), dtype=dtype, device=device),
        prev_time=torch.zeros((B,), dtype=dtype, device=device),
        next_id=torch.zeros((B,), dtype=torch.int32, device=device),
        has_prev=torch.zeros((B,), dtype=torch.bool, device=device),
    )


def _grid_id(cfg: TrackerConfig, xy):
    gw = cfg.width // cfg.grid_cols
    gh = cfg.height // cfg.grid_rows
    col = torch.clamp(torch.div(xy[..., 0], gw, rounding_mode="floor").to(torch.int64),
                      0, cfg.grid_cols - 1)
    row = torch.clamp(torch.div(xy[..., 1], gh, rounding_mode="floor").to(torch.int64),
                      0, cfg.grid_rows - 1)
    return col + cfg.grid_cols * row


def _in_border(cfg: TrackerConfig, xy):
    x = torch.round(xy[..., 0])
    y = torch.round(xy[..., 1])
    return ((x >= BORDER_SIZE) & (x < cfg.width - BORDER_SIZE)
            & (y >= BORDER_SIZE) & (y < cfg.height - BORDER_SIZE))


def _parallel_admission(cfg: TrackerConfig, xy, eligible, blocker_only, cand_grid,
                        grid_need, is_new, rounds: int = 16):
    """Fixed-point parallel evaluation of the greedy min-distance admission
    (same lexicographically-first admission set as the sequential scan)."""
    M = xy.shape[1]
    d2 = torch.sum((xy[:, :, None, :] - xy[:, None, :, :]) ** 2, dim=-1)
    idx = torch.arange(M, device=xy.device)
    earlier = idx[:, None] > idx[None, :]
    nb = earlier & (d2 < float(cfg.min_dist) ** 2)
    sgn = earlier & (cand_grid[:, :, None] == cand_grid[:, None, :]) & is_new[:, None, :]
    need = torch.gather(grid_need, 1, cand_grid)

    decided = ~eligible | blocker_only
    admitted = torch.zeros_like(eligible)
    for _ in range(rounds):
        occ = admitted | blocker_only
        blocked = torch.any(nb & occ[:, None, :], dim=2)
        undecided_elig = (~decided & eligible)[:, None, :]
        wait_d = torch.any(nb & undecided_elig, dim=2)
        used = torch.sum(sgn & admitted[:, None, :], dim=2)
        wait_q = torch.any(sgn & undecided_elig, dim=2) & is_new
        quota_ok = torch.where(is_new, used < need, torch.ones_like(is_new))
        can_decide = ~decided & eligible & (blocked | (~wait_d & ~wait_q))
        admitted = admitted | (can_decide & ~blocked & quota_ok)
        decided = decided | can_decide
    return admitted


def _compact(values, mask, capacity: int, fill):
    """Pack masked rows (B, M, ...) to the front of a (B, capacity, ...)
    array; dropped rows go to a sink row past the end."""
    B = values.shape[0]
    target = torch.where(mask, torch.cumsum(mask, dim=1) - 1,
                         torch.full_like(mask, capacity, dtype=torch.int64))
    out = torch.full((B, capacity + 1) + tuple(values.shape[2:]), fill,
                     dtype=values.dtype, device=values.device)
    bidx = torch.arange(B, device=values.device)[:, None].expand_as(target)
    out[bidx, target] = values
    return out[:, :capacity]


def _take(x, idx):
    """x (B, M, ...) gathered along dim 1 by idx (B, K)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def track_frame(cfg: TrackerConfig, cam: PinholeCamera, state: TrackerState,
                img: torch.Tensor, t: torch.Tensor, relative_R: torch.Tensor,
                ransac_u: torch.Tensor) -> Tuple[TrackerState, TrackerOutput]:
    """Process one frame of B sequences.

    ``img`` (B, H, W) f32; ``t`` (B,); ``relative_R`` (B, 3, 3) predicted
    cam_cur <- cam_prev (unused without ``cfg.use_imu_prediction``);
    ``ransac_u`` (B, ransac_trials, MAXC) uniforms."""
    dtype = img.dtype
    maxc = cfg.maxc
    B = img.shape[0]
    if cfg.equalize:  # the pyramid, LK and FAST all see the equalized frame
        img = image_ops.clahe(img).to(dtype)
    pyr = tuple(image_ops.build_pyramid(img, cfg.pyr_levels))
    active = state.ids >= 0

    # ---- LK tracking, IMU-predicted or cold ----
    if cfg.use_imu_prediction:
        rays = cam.lift(state.pts)
        pred = cam.project(torch.einsum("bij,bnj->bni", relative_R, rays))
        pred = torch.where(_in_border(cfg, pred)[..., None], pred, state.pts)
        levels = cfg.pyr_levels_predicted
    else:
        pred = state.pts
        levels = cfg.pyr_levels_cold
    lk = lk_ops.pyramidal_lk(
        list(state.pyramid[:levels]), list(pyr[:levels]), state.pts, pred,
        active & state.has_prev[:, None],
        max_iters=cfg.lk_max_iters, coarse_iters=cfg.lk_coarse_iters,
        engine=cfg.lk_engine)
    in_b = _in_border(cfg, lk.pts)
    tracked = lk.status & in_b
    unstable = active & state.has_prev[:, None] & ~lk.status & in_b
    cur_pts = lk.pts
    track_cnt = torch.where(tracked, state.track_cnt + 1, torch.zeros_like(state.track_cnt))

    # ---- fundamental-matrix RANSAC on virtual-460 coordinates ----
    def virtual_px(px):
        r = cam.lift(px)
        return torch.stack([r[..., 0] * FOCAL_LENGTH + cfg.width / 2.0,
                            r[..., 1] * FOCAL_LENGTH + cfg.height / 2.0], dim=-1)

    un_prev_px = virtual_px(state.pts)
    un_cur_px = virtual_px(cur_pts)
    fm = ransac_ops.fundamental_ransac(ransac_u, un_prev_px, un_cur_px, tracked,
                                       threshold=cfg.f_threshold)
    tracked = tracked & fm.inliers

    # ---- FAST over the whole image, per-grid top-k ----
    score = fast_ops.fast_nms(img, cfg.fast_threshold)
    if cfg.fisheye:  # no detection and no track outside the field of view
        in_fov = fisheye_mask(cfg, img.device)
        score = torch.where(in_fov, score, torch.zeros_like(score))
        px = torch.clamp(torch.round(cur_pts[..., 0]).to(torch.int64), 0, cfg.width - 1)
        py = torch.clamp(torch.round(cur_pts[..., 1]).to(torch.int64), 0, cfg.height - 1)
        tracked = tracked & in_fov[py, px]
    cand_xy, cand_resp = fast_ops.grid_topk(score, cfg.grid_rows, cfg.grid_cols,
                                            cfg.cand_per_grid)
    ncand = cand_xy.shape[1]

    # ---- unified admission: tracked by track count, unstable blockers,
    #      then candidates by response ----
    neg1 = torch.full_like(track_cnt, -1)
    prio = torch.where(tracked, track_cnt, torch.where(unstable, torch.zeros_like(neg1), neg1))
    order_tr = torch.argsort(-prio, dim=1, stable=True)
    tr_xy = _take(cur_pts, order_tr)
    tr_ok = torch.gather(tracked, 1, order_tr)
    tr_block = torch.gather(unstable, 1, order_tr)
    order_cand = torch.argsort(-cand_resp, dim=1, stable=True)
    cd_xy = _take(cand_xy, order_cand)
    cd_ok = torch.gather(cand_resp, 1, order_cand) > 0

    dev = img.device
    all_xy = torch.cat([tr_xy, cd_xy], dim=1)
    eligible = torch.cat([tr_ok, cd_ok], dim=1)
    blocker = torch.cat([tr_block, torch.zeros((B, ncand), dtype=torch.bool, device=dev)], 1)
    is_new = torch.cat([torch.zeros((B, maxc), dtype=torch.bool, device=dev),
                        torch.ones((B, ncand), dtype=torch.bool, device=dev)], 1)
    grids = _grid_id(cfg, all_xy)

    grid_track = torch.zeros((B, cfg.num_grids), dtype=torch.int32, device=dev)
    grid_track.scatter_add_(1, _grid_id(cfg, cur_pts), tracked.to(torch.int32))
    grid_need = torch.where(grid_track < cfg.grid_quota, cfg.grid_quota - grid_track + 2,
                            torch.zeros_like(grid_track))
    n_tracked = torch.sum(tracked, dim=1)
    budget = torch.clamp(cfg.max_cnt - n_tracked, min=0)

    admitted = _parallel_admission(cfg, all_xy, eligible, blocker, grids, grid_need,
                                   is_new, rounds=cfg.admission_rounds)
    new_rank = torch.cumsum(admitted & is_new, dim=1) - 1
    admitted = admitted & torch.where(is_new, new_rank < budget[:, None],
                                      torch.ones_like(is_new))

    # ---- the new fixed-capacity point set ----
    keep_mask = admitted
    keep_ids = torch.cat([torch.gather(state.ids, 1, order_tr),
                          torch.full((B, ncand), -1, dtype=torch.int32, device=dev)], 1)
    keep_cnt = torch.cat([torch.gather(track_cnt, 1, order_tr),
                          torch.ones((B, ncand), dtype=torch.int32, device=dev)], 1)
    fresh = keep_mask & (keep_ids < 0)
    new_rank_all = torch.cumsum(fresh, dim=1) - 1
    assigned_ids = torch.where(fresh, state.next_id[:, None] + new_rank_all.to(torch.int32),
                               keep_ids)
    n_new = torch.sum(fresh, dim=1).to(torch.int32)

    pts_new = _compact(all_xy, keep_mask, maxc, 0.0)
    ids_new = _compact(assigned_ids, keep_mask, maxc, -1)
    cnt_new = _compact(keep_cnt, keep_mask, maxc, 0)

    # ---- undistort + per-id velocity ----
    un_new = cam.lift(pts_new)[..., :2]
    dt = torch.clamp(t - state.prev_time, min=1e-6)
    eq = ((ids_new[:, :, None] == state.ids[:, None, :]) & (ids_new >= 0)[:, :, None]
          & (state.ids >= 0)[:, None, :])
    has_prev_obs = torch.any(eq, dim=2) & state.has_prev[:, None]
    prev_idx = torch.argmax(eq.to(torch.uint8), dim=2)
    vel = torch.where(has_prev_obs[..., None],
                      (un_new - _take(state.un_pts, prev_idx)) / dt[:, None, None],
                      torch.zeros_like(un_new))
    valid_new = (ids_new >= 0)[..., None]
    feats = FrameFeatures(
        ids=ids_new, pts=un_new * valid_new, uv=pts_new, vel=vel * valid_new,
        depth=torch.zeros((B, maxc), dtype=dtype, device=dev))
    new_state = TrackerState(
        pyramid=pyr, pts=pts_new, ids=ids_new, track_cnt=cnt_new, un_pts=un_new,
        prev_time=t.to(dtype), next_id=state.next_id + n_new,
        has_prev=torch.ones_like(state.has_prev))
    return new_state, TrackerOutput(features=feats, n_tracked=n_tracked,
                                    n_total=torch.sum(ids_new >= 0, dim=1))


def lookup_depth(depth_m: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel depth (B, H, W) at uv (B, N, 2); 0 where not valid."""
    B, H, W = depth_m.shape
    x = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, H - 1)
    d = torch.gather(depth_m.reshape(B, H * W), 1, y * W + x)
    return torch.where(valid, d, torch.zeros_like(d))
