"""Host-side (pure numpy) quaternion/Euler helpers: the port's own copy of
``vins_rgbd_fast_tpu/utils/quaternion_np.py`` (that package's ``utils``
imports jax).

The pose graph's bookkeeping (drift composition, sequence alignment, node
setup) runs on the host between device programs; these float64 numpy forms
launch nothing on the device.

Conventions identical to utils/quaternion.py: wxyz, Hamilton product,
yaw-pitch-roll in DEGREES (Z-Y-X intrinsic, the reference's
``Utility::R2ypr``).
"""

from __future__ import annotations

import numpy as np


def qmul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.asarray([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def qconj(q: np.ndarray) -> np.ndarray:
    return q * np.asarray([1.0, -1.0, -1.0, -1.0])


def q2R(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.asarray([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def R2q(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (Shepperd's branch method)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        return np.asarray([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                           (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        return np.asarray([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                           (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    if i == 1:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2.0
        return np.asarray([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                           0.25 * s, (R[1, 2] + R[2, 1]) / s])
    s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2.0
    return np.asarray([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                       (R[1, 2] + R[2, 1]) / s, 0.25 * s])


def R2ypr(R: np.ndarray) -> np.ndarray:
    """Rotation -> (yaw, pitch, roll) degrees (``Utility::R2ypr``)."""
    R = np.asarray(R, np.float64)
    n, o, a = R[:, 0], R[:, 1], R[:, 2]
    y = np.arctan2(n[1], n[0])
    p = np.arctan2(-n[2], n[0] * np.cos(y) + n[1] * np.sin(y))
    r = np.arctan2(a[0] * np.sin(y) - a[1] * np.cos(y),
                   -o[0] * np.sin(y) + o[1] * np.cos(y))
    return np.degrees(np.asarray([y, p, r]))


def ypr2R(ypr_deg) -> np.ndarray:
    y, p, r = np.radians(np.asarray(ypr_deg, np.float64))
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    Rz = np.asarray([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.asarray([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.asarray([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def yaw_R(yaw_deg: float) -> np.ndarray:
    return ypr2R([yaw_deg, 0.0, 0.0])


def normalize_angle_deg(a):
    return (np.asarray(a) + 180.0) % 360.0 - 180.0


# ---------------------------------------------------------------------------
# Batched twins: (N, ...) leading axis, used by the pose graph's vectorized
# build/apply passes (a Python loop of the scalar forms over ~128 PGO nodes
# costs tens of ms per segment; these are one numpy call each).
# ---------------------------------------------------------------------------


def qmul_batch(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """(N,4)x(N,4) -> (N,4) Hamilton products (broadcasts)."""
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def q2R_batch(q: np.ndarray) -> np.ndarray:
    """(N,4) wxyz -> (N,3,3)."""
    q = np.asarray(q, np.float64)
    w, x, y, z = (q[..., i] for i in range(4))
    n = w * w + x * x + y * y + z * z
    s = np.where(n == 0, 0.0, 2.0 / np.where(n == 0, 1.0, n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    one = np.ones_like(w)
    R = np.stack([
        one - (yy + zz), xy - wz, xz + wy,
        xy + wz, one - (xx + zz), yz - wx,
        xz - wy, yz + wx, one - (xx + yy),
    ], axis=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def R2ypr_batch(R: np.ndarray) -> np.ndarray:
    """(N,3,3) -> (N,3) yaw/pitch/roll degrees."""
    R = np.asarray(R, np.float64)
    n, o, a = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    y = np.arctan2(n[..., 1], n[..., 0])
    p = np.arctan2(-n[..., 2], n[..., 0] * np.cos(y) + n[..., 1] * np.sin(y))
    r = np.arctan2(a[..., 0] * np.sin(y) - a[..., 1] * np.cos(y),
                   -o[..., 0] * np.sin(y) + o[..., 1] * np.cos(y))
    return np.degrees(np.stack([y, p, r], axis=-1))


def ypr2R_batch(ypr_deg: np.ndarray) -> np.ndarray:
    """(N,3) yaw/pitch/roll degrees -> (N,3,3)."""
    ypr = np.radians(np.asarray(ypr_deg, np.float64))
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    # Rz @ Ry @ Rx expanded
    R = np.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], axis=-1)
    return R.reshape(ypr.shape[:-1] + (3, 3))


def R2q_batch(R: np.ndarray) -> np.ndarray:
    """(N,3,3) -> (N,4) wxyz (branch-free Shepperd: compute all four
    candidate quaternions, pick per-row by the max of (trace, diag))."""
    R = np.asarray(R, np.float64)
    shp = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    r00, r11, r22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    t = r00 + r11 + r22
    # candidate squared 4*w^2, 4*x^2, 4*y^2, 4*z^2 (all >= 0 up to fp)
    c = np.stack([1.0 + t, 1.0 + r00 - r11 - r22,
                  1.0 - r00 + r11 - r22, 1.0 - r00 - r11 + r22], axis=-1)
    pick = np.argmax(c, axis=-1)
    s = 2.0 * np.sqrt(np.maximum(c[np.arange(len(R)), pick], 1e-300))
    a21 = R[:, 2, 1] - R[:, 1, 2]
    a02 = R[:, 0, 2] - R[:, 2, 0]
    a10 = R[:, 1, 0] - R[:, 0, 1]
    b01 = R[:, 0, 1] + R[:, 1, 0]
    b02 = R[:, 0, 2] + R[:, 2, 0]
    b12 = R[:, 1, 2] + R[:, 2, 1]
    q0 = np.stack([0.25 * s, a21 / s, a02 / s, a10 / s], axis=-1)
    q1 = np.stack([a21 / s, 0.25 * s, b01 / s, b02 / s], axis=-1)
    q2 = np.stack([a02 / s, b01 / s, 0.25 * s, b12 / s], axis=-1)
    q3 = np.stack([a10 / s, b02 / s, b12 / s, 0.25 * s], axis=-1)
    q = np.choose(pick[:, None], [q0, q1, q2, q3])
    return q.reshape(shp + (4,))
