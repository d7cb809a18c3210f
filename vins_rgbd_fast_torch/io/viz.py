"""Headless diagnostics (the port's copy of ``vins_rgbd_fast_tpu/io/viz.py``):
the tracking overlay, the landmarks the next marginalization absorbs, and
the calibrated extrinsic in the rig file's layout.  The reference publishes
these to rviz (``visualization.cpp``); here they are numpy arrays and a
file.  Nothing here runs on the frame path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils import quaternion_np as qnp


def draw_track_overlay(img: np.ndarray, uv: np.ndarray, valid: np.ndarray,
                       track_cnt: np.ndarray, vel: Optional[np.ndarray] = None,
                       max_cnt: int = 20, radius: int = 3,
                       vel_scale: float = 10.0) -> np.ndarray:
    """The grey frame with its tracked points coloured by track age (red =
    new, green = long-lived) and, with ``vel``, a velocity ray each.
    Returns (H, W, 3) uint8 RGB."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    lo, hi = float(img.min()), float(img.max())
    base = (img - lo) / max(hi - lo, 1e-6) * 255.0
    out = np.stack([base] * 3, axis=-1)

    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (yy ** 2 + xx ** 2) <= radius ** 2
    uv = np.asarray(uv)
    valid = np.asarray(valid, bool)
    track_cnt = np.asarray(track_cnt)
    for k in np.flatnonzero(valid):
        u, v = uv[k]
        ui, vi = int(round(float(u))), int(round(float(v)))
        if not (0 <= ui < W and 0 <= vi < H):
            continue
        a = min(float(track_cnt[k]) / max_cnt, 1.0)
        color = np.asarray([255.0 * (1 - a), 255.0 * a, 0.0])
        if vel is not None:  # the ray first; the point's marker draws on top
            dx, dy = vel_scale * np.asarray(vel[k])
            n = max(int(max(abs(dx), abs(dy))) + 1, 2)
            ts = np.linspace(0.0, 1.0, n)
            xs = np.clip(np.round(ui + ts * dx).astype(int), 0, W - 1)
            ys = np.clip(np.round(vi + ts * dy).astype(int), 0, H - 1)
            out[ys, xs] = np.asarray([0.0, 128.0, 255.0])
        y0, y1 = max(vi - radius, 0), min(vi + radius + 1, H)
        x0, x1 = max(ui - radius, 0), min(ui + radius + 1, W)
        d = disk[y0 - (vi - radius): y0 - (vi - radius) + (y1 - y0),
                 x0 - (ui - radius): x0 - (ui - radius) + (x1 - x0)]
        out[y0:y1, x0:x1][d] = color
    return np.clip(out, 0, 255).astype(np.uint8)


def margin_cloud(estimator) -> np.ndarray:
    """World positions (N, 3) of the landmarks anchored in the oldest window
    frame, the ones the next ``marginalize_old`` absorbs, from a
    ``VinsEstimator``'s state (batch row 0; read back to the host)."""
    t, x = estimator.state.table, estimator.state.x
    ids, start = t.ids[0].cpu().numpy(), t.start[0].cpu().numpy()
    est_depth = t.est_depth[0].cpu().numpy()
    sel = (ids >= 0) & (start == 0) & (est_depth > 0)
    if not sel.any():
        return np.zeros((0, 3))
    R_wi = qnp.q2R(x.Q[0, 0].cpu().numpy())
    R_ic = qnp.q2R(x.qic[0].cpu().numpy())
    R_wc = R_wi @ R_ic
    t_wc = x.P[0, 0].cpu().numpy() + R_wi @ x.tic[0].cpu().numpy()
    pts0 = t.pts[0].cpu().numpy()[sel, 0]  # start 0: the anchor observation is in slot 0
    rays = np.concatenate([pts0, np.ones((pts0.shape[0], 1))], axis=1)
    p_cam = rays * est_depth[sel, None]
    return p_cam @ R_wc.T + t_wc


def write_extrinsic_yaml(path: str, ric: np.ndarray, tic: np.ndarray,
                         td: float = 0.0) -> None:
    """Write the calibrated imu<-cam extrinsic and td in the rig file's
    layout, so a rig can run again with ``estimate_extrinsic: 0``."""
    ric = np.asarray(ric, np.float64).reshape(3, 3)
    tic = np.asarray(tic, np.float64).reshape(3)
    rows = ",\n           ".join(", ".join(f"{v:.9f}" for v in row) for row in ric)
    with open(path, "w") as f:
        f.write("%YAML:1.0\n\n")
        f.write("extrinsicRotation: !!opencv-matrix\n")
        f.write("   rows: 3\n   cols: 3\n   dt: d\n")
        f.write(f"   data: [{rows}]\n")
        f.write("extrinsicTranslation: !!opencv-matrix\n")
        f.write("   rows: 3\n   cols: 1\n   dt: d\n")
        f.write("   data: [" + ", ".join(f"{v:.9f}" for v in tic) + "]\n")
        f.write(f"td: {td:.6f}\n")
