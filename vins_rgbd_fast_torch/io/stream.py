"""Trajectory evaluation (twin of ``ate_rmse`` in
``vins_rgbd_fast_tpu/io/stream.py``, kept here so the port's entry points
need nothing from the JAX package)."""

from __future__ import annotations

import numpy as np


def ate_rmse(est_t, est_P, gt_t, gt_P, align: bool = True) -> float:
    """Absolute trajectory error RMSE after stamp association (±10 ms) and
    optional SE(3) Umeyama alignment (no scale)."""
    est_t = np.asarray(est_t)
    gt_t = np.asarray(gt_t)
    pairs = []
    for i, t in enumerate(est_t):
        j = int(np.argmin(np.abs(gt_t - t)))
        if abs(gt_t[j] - t) < 0.01:
            pairs.append((i, j))
    if len(pairs) < 3:
        return float("nan")
    E = np.asarray([est_P[i] for i, _ in pairs])
    Gt = np.asarray([gt_P[j] for _, j in pairs])
    if align:
        mu_e, mu_g = E.mean(0), Gt.mean(0)
        U, _, Vt = np.linalg.svd((E - mu_e).T @ (Gt - mu_g))
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        E = (E - mu_e) @ (Vt.T @ S @ U.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((E - Gt) ** 2, axis=1))))
