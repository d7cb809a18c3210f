"""The four camera models of the reference's camodocal zoo (twins of the
``pinhole_*``, ``equidistant_*``, ``mei_*`` and ``scaramuzza_*`` functions
and ``make_camera`` in ``vins_rgbd_fast_tpu/models/camera.py``): pinhole
with radtan distortion, Kannala-Brandt (equidistant fisheye), Mei (unified
catadioptric) and Scaramuzza (OCAM).

Each model is a frozen dataclass of its parameters with ``lift`` (pixels
[..., 2] -> rays [..., 3] on the z = 1 plane) and ``project`` (camera-frame
points [..., 3] -> pixels [..., 2]), broadcasting over any leading batch.
Iteration counts and guards are JAX's: Newton 10 for the Kannala-Brandt
inverse, the 8-step radtan fixed point for pinhole and Mei, ``finfo.tiny``
in the Kannala-Brandt projection, z clamped at 1e-6 on the z = 1 plane and
``1 / max(norm, 1e-12)`` in the OCAM projection.  A ray whose angle nears
90° (a fisheye corner) lifts to a huge z = 1 ray, as in JAX; the tracker's
border mask drops such points.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple, Union

import torch


class CameraModel(Protocol):
    """What the tracker, the pose graph and the pipelines call on a camera."""

    width: int
    height: int

    def lift(self, uv: torch.Tensor) -> torch.Tensor: ...

    def project(self, P: torch.Tensor) -> torch.Tensor: ...


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


@dataclasses.dataclass(frozen=True)
class EquidistantCamera:
    """Kannala-Brandt: d(θ) = θ + k2θ³ + k3θ⁵ + k4θ⁷ + k5θ⁹ (camodocal names)."""
    mu: float
    mv: float
    u0: float
    v0: float
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    width: int = 640
    height: int = 480

    def lift(self, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
        return equidistant_lift(self, uv, iters)

    def project(self, P: torch.Tensor) -> torch.Tensor:
        return equidistant_project(self, P)


@dataclasses.dataclass(frozen=True)
class MeiCamera:
    """Unified catadioptric: mirror ξ plus radtan on the normalized plane."""
    xi: float
    gamma1: float
    gamma2: float
    u1: float
    v1: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 640
    height: int = 480

    def lift(self, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
        return mei_lift(self, uv, iters)

    def project(self, P: torch.Tensor) -> torch.Tensor:
        return mei_project(self, P)


@dataclasses.dataclass(frozen=True)
class ScaramuzzaCamera:
    """OCAM: forward polynomial z = Σ poly_i·φ^i of the radial distance,
    inverse polynomial ρ = Σ inv_poly_i·θ^i of the incidence angle, the
    affine stretch [[C, D], [E, 1]] and the centre."""
    poly: Tuple[float, ...]
    inv_poly: Tuple[float, ...]
    C: float = 1.0
    D: float = 0.0
    E: float = 0.0
    center_x: float = 320.0
    center_y: float = 240.0
    width: int = 640
    height: int = 480

    def lift(self, uv: torch.Tensor) -> torch.Tensor:
        return scaramuzza_lift(self, uv)

    def project(self, P: torch.Tensor) -> torch.Tensor:
        return scaramuzza_project(self, P)


Camera = Union[PinholeCamera, EquidistantCamera, MeiCamera, ScaramuzzaCamera]


# ---------------------------------------------------------------------------
# pinhole radtan
# ---------------------------------------------------------------------------

def _radtan_distort(p_u: torch.Tensor, k1, k2, p1, p2) -> torch.Tensor:
    x, y = p_u[..., 0], p_u[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    rho2 = x2 + y2
    rad = k1 * rho2 + k2 * rho2 * rho2
    dx = x * rad + 2.0 * p1 * xy + p2 * (rho2 + 2.0 * x2)
    dy = y * rad + p1 * (rho2 + 2.0 * y2) + 2.0 * p2 * xy
    return torch.stack([dx, dy], dim=-1)


def _radtan_undistort(p_d: torch.Tensor, k1, k2, p1, p2, iters: int) -> torch.Tensor:
    """The fixed point p_u <- p_d - d(p_u), ``iters`` steps from p_d."""
    p_u = p_d - _radtan_distort(p_d, k1, k2, p1, p2)
    for _ in range(iters - 1):
        p_u = p_d - _radtan_distort(p_u, k1, k2, p1, p2)
    return p_u


def _on_z1(ray: torch.Tensor) -> torch.Tensor:
    """A ray [..., 3] scaled to the z = 1 plane, z clamped at 1e-6."""
    return ray / torch.clamp(ray[..., 2:3], min=1e-6)


def pinhole_lift(cam: PinholeCamera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Pixels [..., 2] -> normalized rays [..., 3] (z = 1), undistorting
    with the 8-step fixed point p_u <- p_d - d(p_u)."""
    mx_d = (uv[..., 0] - cam.cx) * (1.0 / cam.fx)
    my_d = (uv[..., 1] - cam.cy) * (1.0 / cam.fy)
    p_d = torch.stack([mx_d, my_d], dim=-1)
    p_u = p_d
    if cam.has_distortion:
        p_u = _radtan_undistort(p_d, cam.k1, cam.k2, cam.p1, cam.p2, iters)
    return torch.cat([p_u, torch.ones_like(p_u[..., :1])], dim=-1)


def pinhole_project(cam: PinholeCamera, P: torch.Tensor) -> torch.Tensor:
    """3D points [..., 3] -> pixels [..., 2]."""
    p_u = P[..., :2] / P[..., 2:3]
    p_d = p_u
    if cam.has_distortion:
        p_d = p_u + _radtan_distort(p_u, cam.k1, cam.k2, cam.p1, cam.p2)
    return torch.stack([p_d[..., 0] * cam.fx + cam.cx, p_d[..., 1] * cam.fy + cam.cy], dim=-1)


# ---------------------------------------------------------------------------
# equidistant (Kannala-Brandt)
# ---------------------------------------------------------------------------

def _kb_theta_poly(theta, k2, k3, k4, k5):
    t2 = theta * theta
    return theta * (1.0 + t2 * (k2 + t2 * (k3 + t2 * (k4 + t2 * k5))))


def equidistant_project(cam: EquidistantCamera, P: torch.Tensor) -> torch.Tensor:
    r = torch.linalg.norm(P[..., :2], dim=-1)
    theta = torch.atan2(r, P[..., 2])
    d = _kb_theta_poly(theta, cam.k2, cam.k3, cam.k4, cam.k5)
    scale = d / torch.clamp(r, min=torch.finfo(P.dtype).tiny)
    u = cam.mu * scale * P[..., 0] + cam.u0
    v = cam.mv * scale * P[..., 1] + cam.v0
    return torch.stack([u, v], dim=-1)


def equidistant_lift(cam: EquidistantCamera, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert d(θ) by ``iters`` Newton steps from θ = d."""
    mx = (uv[..., 0] - cam.u0) / cam.mu
    my = (uv[..., 1] - cam.v0) / cam.mv
    d = torch.sqrt(mx * mx + my * my)
    theta = d
    for _ in range(iters):
        f = _kb_theta_poly(theta, cam.k2, cam.k3, cam.k4, cam.k5) - d
        t2 = theta * theta
        fp = 1.0 + t2 * (3 * cam.k2 + t2 * (5 * cam.k3 + t2 * (7 * cam.k4 + t2 * 9 * cam.k5)))
        theta = theta - f / torch.clamp(fp, min=1e-12)
    scale = torch.where(d > 1e-10, torch.sin(theta) / d, torch.ones_like(d))
    ray = torch.stack([scale * mx, scale * my, torch.cos(theta)], dim=-1)
    return _on_z1(ray)


# ---------------------------------------------------------------------------
# Mei (unified catadioptric)
# ---------------------------------------------------------------------------

def mei_project(cam: MeiCamera, P: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(P, dim=-1, keepdim=True)
    z = P[..., 2:3] + cam.xi * norm
    p_u = P[..., :2] / z
    p_d = p_u + _radtan_distort(p_u, cam.k1, cam.k2, cam.p1, cam.p2)
    return torch.stack([p_d[..., 0] * cam.gamma1 + cam.u1,
                        p_d[..., 1] * cam.gamma2 + cam.v1], dim=-1)


def mei_lift(cam: MeiCamera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    mx_d = (uv[..., 0] - cam.u1) / cam.gamma1
    my_d = (uv[..., 1] - cam.v1) / cam.gamma2
    p_d = torch.stack([mx_d, my_d], dim=-1)
    p_u = _radtan_undistort(p_d, cam.k1, cam.k2, cam.p1, cam.p2, iters)
    # back through the unit sphere of the unified model
    rho2 = torch.sum(p_u * p_u, dim=-1)
    xi = cam.xi
    lam = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * rho2)) / (1.0 + rho2)
    ray = torch.cat([lam[..., None] * p_u, (lam - xi)[..., None]], dim=-1)
    return _on_z1(ray)


# ---------------------------------------------------------------------------
# Scaramuzza (OCAM)
# ---------------------------------------------------------------------------

def scaramuzza_lift(cam: ScaramuzzaCamera, uv: torch.Tensor) -> torch.Tensor:
    """Un-stretch by inv([[C, D], [E, 1]]), evaluate the forward polynomial
    on the radial distance: ray (xc, yc, -z), then onto z = 1."""
    xc0 = uv[..., 0] - cam.center_x
    xc1 = uv[..., 1] - cam.center_y
    inv_scale = 1.0 / (cam.C - cam.D * cam.E)
    xa0 = inv_scale * (xc0 - cam.D * xc1)
    xa1 = inv_scale * (-cam.E * xc0 + cam.C * xc1)
    phi = torch.sqrt(xa0 * xa0 + xa1 * xa1)
    z = torch.zeros_like(phi)
    phi_i = torch.ones_like(phi)
    for c in cam.poly:
        z = z + phi_i * c
        phi_i = phi_i * phi
    return _on_z1(torch.stack([xc0, xc1, -z], dim=-1))


def scaramuzza_project(cam: ScaramuzzaCamera, P: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(P[..., 0] ** 2 + P[..., 1] ** 2)
    theta = torch.atan2(-P[..., 2], norm)
    rho = torch.zeros_like(theta)
    theta_i = torch.ones_like(theta)
    for c in cam.inv_poly:
        rho = rho + theta_i * c
        theta_i = theta_i * theta
    inv_norm = 1.0 / torch.clamp(norm, min=1e-12)
    xn0 = P[..., 0] * inv_norm * rho
    xn1 = P[..., 1] * inv_norm * rho
    return torch.stack([xn0 * cam.C + xn1 * cam.D + cam.center_x,
                        xn0 * cam.E + xn1 + cam.center_y], dim=-1)


def make_camera(model_type: str, **kwargs) -> Camera:
    """A camera from its reference ``model_type`` and its parameters, by
    JAX's names (``EQUIDISTANT`` is an alias of ``KANNALA_BRANDT``)."""
    mt = model_type.upper()
    if mt == "PINHOLE":
        return PinholeCamera(**kwargs)
    if mt in ("KANNALA_BRANDT", "EQUIDISTANT"):
        return EquidistantCamera(**kwargs)
    if mt == "MEI":
        return MeiCamera(**kwargs)
    if mt == "SCARAMUZZA":
        return ScaramuzzaCamera(**kwargs)
    raise ValueError(f"unsupported model_type {model_type!r}")
