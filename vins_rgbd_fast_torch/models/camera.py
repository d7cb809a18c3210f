"""Pinhole radtan camera (twin of ``pinhole_lift``/``pinhole_project`` in
``vins_rgbd_fast_tpu/models/camera.py``).  Only the model the main path
uses is ported; the equidistant, Mei and Scaramuzza models are not."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 640
    height: int = 480

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2))

    def lift(self, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
        return pinhole_lift(self, uv, iters)

    def project(self, P: torch.Tensor) -> torch.Tensor:
        return pinhole_project(self, P)


def _radtan_distort(p_u: torch.Tensor, k1, k2, p1, p2) -> torch.Tensor:
    x, y = p_u[..., 0], p_u[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    rho2 = x2 + y2
    rad = k1 * rho2 + k2 * rho2 * rho2
    dx = x * rad + 2.0 * p1 * xy + p2 * (rho2 + 2.0 * x2)
    dy = y * rad + p1 * (rho2 + 2.0 * y2) + 2.0 * p2 * xy
    return torch.stack([dx, dy], dim=-1)


def pinhole_lift(cam: PinholeCamera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Pixels [..., 2] -> normalized rays [..., 3] (z = 1), undistorting
    with the 8-step fixed point p_u <- p_d - d(p_u)."""
    mx_d = (uv[..., 0] - cam.cx) * (1.0 / cam.fx)
    my_d = (uv[..., 1] - cam.cy) * (1.0 / cam.fy)
    p_d = torch.stack([mx_d, my_d], dim=-1)
    p_u = p_d
    if cam.has_distortion:
        p_u = p_d - _radtan_distort(p_d, cam.k1, cam.k2, cam.p1, cam.p2)
        for _ in range(iters - 1):
            p_u = p_d - _radtan_distort(p_u, cam.k1, cam.k2, cam.p1, cam.p2)
    return torch.cat([p_u, torch.ones_like(p_u[..., :1])], dim=-1)


def pinhole_project(cam: PinholeCamera, P: torch.Tensor) -> torch.Tensor:
    """3D points [..., 3] -> pixels [..., 2]."""
    p_u = P[..., :2] / P[..., 2:3]
    p_d = p_u
    if cam.has_distortion:
        p_d = p_u + _radtan_distort(p_u, cam.k1, cam.k2, cam.p1, cam.p2)
    return torch.stack([p_d[..., 0] * cam.fx + cam.cx, p_d[..., 1] * cam.fy + cam.cy], dim=-1)
