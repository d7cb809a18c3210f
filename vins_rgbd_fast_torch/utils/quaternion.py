"""Quaternion / SO(3) math (twin of ``vins_rgbd_fast_tpu/utils/quaternion.py``).

Quaternions are ``[..., 4]`` in wxyz order (Hamilton); rotation matrices
``[..., 3, 3]`` act on column vectors.  Every function broadcasts over
leading dimensions and keeps the input dtype and device.
"""

from __future__ import annotations

import functools
import math

import torch


@functools.lru_cache(maxsize=None)
def const(values: tuple, dtype=torch.float32, device=None) -> torch.Tensor:
    """A cached constant tensor: built (and copied to the device) once, so
    frame-path code never issues a host-to-device copy, which would
    synchronise the stream.  Never modify the result in place."""
    return torch.tensor(values, dtype=dtype, device=device)


def qmul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qpositify(q: torch.Tensor) -> torch.Tensor:
    return torch.where(q[..., :1] < 0, -q, q)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) @ v via the expanded Rodrigues form."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def qrot_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return qrot(qconj(q), v)


def q_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return const((1.0, 0.0, 0.0, 0.0), dtype, torch.device(device or "cpu"))


def dq_small(theta: torch.Tensor) -> torch.Tensor:
    """First-order increment [1, θ/2] (unnormalized)."""
    half = 0.5 * theta
    return torch.cat([torch.ones_like(half[..., :1]), half], dim=-1)


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Exact exponential map: rotation vector -> unit quaternion."""
    angle2 = torch.sum(theta * theta, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle2, min=torch.finfo(theta.dtype).tiny))
    small = angle2 < 1e-8
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(0.5 * angle) / angle)
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(0.5 * angle))
    return torch.cat([w, k * theta], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Exact log map: unit quaternion -> rotation vector."""
    q = qpositify(q)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-3),
                        angle / torch.clamp(vn, min=torch.finfo(q.dtype).tiny))
    return scale * v


def qboxplus(q: torch.Tensor, dtheta: torch.Tensor) -> torch.Tensor:
    """q ⊞ δθ = normalize(q ⊗ [1, δθ/2])."""
    return qnormalize(qmul(q, dq_small(dtheta)))


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def q2R(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1),
    ], dim=-2)


def R2q(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion, branchless Shepperd method (the
    best-conditioned candidate is picked by argmax)."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def g(i, j):
        return R[..., i, j]

    qw = torch.stack([1.0 + tr, g(2, 1) - g(1, 2), g(0, 2) - g(2, 0), g(1, 0) - g(0, 1)], -1)
    qx = torch.stack([g(2, 1) - g(1, 2), 1.0 + m00 - m11 - m22, g(0, 1) + g(1, 0), g(2, 0) + g(0, 2)], -1)
    qy = torch.stack([g(0, 2) - g(2, 0), g(0, 1) + g(1, 0), 1.0 - m00 + m11 - m22, g(1, 2) + g(2, 1)], -1)
    qz = torch.stack([g(1, 0) - g(0, 1), g(2, 0) + g(0, 2), g(1, 2) + g(2, 1), 1.0 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4, 4]
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    sel = torch.argmax(scores, dim=-1)
    idx = sel[..., None, None].expand(*sel.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return qpositify(qnormalize(q))


def qleft(q: torch.Tensor) -> torch.Tensor:
    """L(q) with L(q) @ p == q ⊗ p."""
    w = q[..., 0]
    v = q[..., 1:4]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w[..., None, None], -v[..., None, :]], dim=-1)
    bot = torch.cat([v[..., :, None], w[..., None, None] * eye + skew(v)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def qright(p: torch.Tensor) -> torch.Tensor:
    """Rm(p) with Rm(p) @ q == q ⊗ p."""
    w = p[..., 0]
    v = p[..., 1:4]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    top = torch.cat([w[..., None, None], -v[..., None, :]], dim=-1)
    bot = torch.cat([v[..., :, None], w[..., None, None] * eye - skew(v)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def R2ypr(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> [yaw, pitch, roll] in degrees (Z-Y-X)."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
                    -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y))
    return torch.stack([y, p, r], dim=-1) * (180.0 / math.pi)


def ypr2R(ypr_deg: torch.Tensor) -> torch.Tensor:
    y, p, r = (ypr_deg * (math.pi / 180.0)).unbind(-1)
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)


def yaw_R(yaw_deg: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(yaw_deg)
    return ypr2R(torch.stack([yaw_deg, zeros, zeros], dim=-1))


def _any_orthogonal(v: torch.Tensor) -> torch.Tensor:
    ex = torch.zeros_like(v)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v)
    ey[..., 1] = 1.0
    u = torch.where(torch.abs(v[..., 0:1]) < 0.9, ex, ey)
    w = torch.linalg.cross(v, u, dim=-1)
    return w / torch.linalg.norm(w, dim=-1, keepdim=True)


def quat_from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimal-angle unit quaternion rotating direction a onto b."""
    an = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    bn = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    c = torch.sum(an * bn, dim=-1, keepdim=True)
    q = torch.cat([1.0 + c, torch.linalg.cross(an, bn, dim=-1)], dim=-1)
    ortho = torch.cat([torch.zeros_like(c), _any_orthogonal(an)], dim=-1)
    q = torch.where(1.0 + c < 1e-6, ortho, q)
    return qnormalize(q)


def g2R(g: torch.Tensor) -> torch.Tensor:
    """World-from-body rotation aligning measured gravity with +z, yaw-zeroed."""
    ez = torch.zeros_like(g)
    ez[..., 2] = 1.0
    R0 = q2R(quat_from_two_vectors(g, ez))
    yaw = R2ypr(R0)[..., 0]
    return yaw_R(-yaw) @ R0
