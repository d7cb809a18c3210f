"""The benchmark's own synthetic RGB-D + IMU streams: a frozen copy of the
trajectory, revisit, IMU-corruption and render code of
``vins_rgbd_fast_torch/io/synthetic.py`` (and of the quaternion and radtan
helpers it uses), so that the traffic does not move when the program does.
``vinsbench/tests/test_frozen.py`` holds it to its source bit for bit.

Trajectories and IMU samples are closed forms in float64 numpy; frames are
rendered on the device in chunks: the rig's pinhole ray grid (with radtan
distortion, the 8-step fixed point) against the six textured planes of a
12 × 12 × 4.5 m room.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

G = np.array([0.0, 0.0, 9.805])

# plane: (normal, offset, u-axis, v-axis) with x·n = offset
_PLANES = [
    (np.array([0.0, 0.0, 1.0]), -1.5, np.array([1.0, 0, 0]), np.array([0.0, 1, 0])),  # floor
    (np.array([0.0, 0.0, 1.0]), 3.0, np.array([1.0, 0, 0]), np.array([0.0, 1, 0])),  # ceiling
    (np.array([1.0, 0.0, 0.0]), -6.0, np.array([0.0, 1, 0]), np.array([0.0, 0, 1])),
    (np.array([1.0, 0.0, 0.0]), 6.0, np.array([0.0, 1, 0]), np.array([0.0, 0, 1])),
    (np.array([0.0, 1.0, 0.0]), -6.0, np.array([1.0, 0, 0]), np.array([0.0, 0, 1])),
    (np.array([0.0, 1.0, 0.0]), 6.0, np.array([1.0, 0, 0]), np.array([0.0, 0, 1])),
]


@dataclasses.dataclass(frozen=True)
class SyntheticRig:
    width: int = 640
    height: int = 480
    fx: float = 460.0
    fy: float = 460.0
    cx: float = 320.0
    cy: float = 240.0
    imu_rate: float = 200.0
    frame_rate: float = 20.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2))


class SyntheticSequence(NamedTuple):
    times: np.ndarray  # (N,)
    P: np.ndarray      # (N, 3) imu positions
    Q: np.ndarray      # (N, 4) world-from-imu, wxyz
    V: np.ndarray      # (N, 3)
    imu: List[Tuple[float, np.ndarray, np.ndarray]]  # (t, acc, gyr)
    ric: np.ndarray    # (3, 3) imu<-cam
    tic: np.ndarray    # (3,)


# --- float64 numpy quaternion helpers (wxyz, Hamilton) ---

def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _so3_exp(th):
    a2 = float(th @ th)
    if a2 < 1e-8:
        return np.concatenate([[1.0 - a2 / 8.0], (0.5 - a2 / 48.0) * th])
    a = math.sqrt(a2)
    return np.concatenate([[math.cos(0.5 * a)], math.sin(0.5 * a) / a * th])


def _q2R(q):
    w, x, y, z = q
    return np.array([
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z]])


def _qrot_inv(q, v):
    return _q2R(q).T @ v


# --- torch quaternion helpers (the renderer's and the camera poses') ---

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
    """Rotation matrix -> unit quaternion (branchless Shepperd: the best
    conditioned candidate by argmax), w ≥ 0."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def g(i, j):
        return R[..., i, j]

    qw = torch.stack([1.0 + tr, g(2, 1) - g(1, 2), g(0, 2) - g(2, 0), g(1, 0) - g(0, 1)], -1)
    qx = torch.stack([g(2, 1) - g(1, 2), 1.0 + m00 - m11 - m22, g(0, 1) + g(1, 0), g(2, 0) + g(0, 2)], -1)
    qy = torch.stack([g(0, 2) - g(2, 0), g(0, 1) + g(1, 0), 1.0 - m00 + m11 - m22, g(1, 2) + g(2, 1)], -1)
    qz = torch.stack([g(1, 0) - g(0, 1), g(2, 0) + g(0, 2), g(1, 2) + g(2, 1), 1.0 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    sel = torch.argmax(scores, dim=-1)
    idx = sel[..., None, None].expand(*sel.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def radtan_distort(p_u: torch.Tensor, k1, k2, p1, p2) -> torch.Tensor:
    x, y = p_u[..., 0], p_u[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    rho2 = x2 + y2
    rad = k1 * rho2 + k2 * rho2 * rho2
    dx = x * rad + 2.0 * p1 * xy + p2 * (rho2 + 2.0 * x2)
    dy = y * rad + p1 * (rho2 + 2.0 * y2) + 2.0 * p2 * xy
    return torch.stack([dx, dy], dim=-1)


# --- trajectories ---

def make_trajectory(n_frames: int, rig: SyntheticRig = SyntheticRig(), seed: int = 0,
                    omega_scale: float = 0.25, acc_scale: float = 0.4,
                    v0=(0.25, 0.1, 0.0)) -> SyntheticSequence:
    """Smooth random walk in body rates, exact per-interval integration;
    IMU sampled at ``rig.imu_rate`` with exact specific force; the position
    is pulled back towards the origin."""
    rng = np.random.default_rng(seed)
    T_per = 1.0 / rig.frame_rate
    n_sub = max(int(round(rig.imu_rate / rig.frame_rate)), 1)
    P = [np.zeros(3)]
    Q = [np.array([1.0, 0, 0, 0])]
    V = [np.asarray(v0, np.float64)]
    times = [0.0]
    imu = [(0.0, _qrot_inv(Q[0], G), np.zeros(3))]
    w_b = rng.normal(size=3) * omega_scale
    a_w = rng.normal(size=3) * acc_scale
    for _ in range(n_frames - 1):
        w_b = 0.8 * w_b + 0.2 * rng.normal(size=3) * omega_scale
        a_w = 0.8 * a_w + 0.2 * rng.normal(size=3) * acc_scale
        a_w = a_w - 0.08 * P[-1] - 0.15 * V[-1]
        P0, Q0, V0 = P[-1], Q[-1], V[-1]
        t0 = times[-1]
        for s in range(1, n_sub + 1):
            t = T_per * s / n_sub
            q_t = _qmul(Q0, _so3_exp(w_b * t))
            imu.append((t0 + t, _qrot_inv(q_t, a_w + G), w_b.copy()))
        P.append(P0 + V0 * T_per + 0.5 * a_w * T_per ** 2)
        V.append(V0 + a_w * T_per)
        Q.append(_qmul(Q0, _so3_exp(w_b * T_per)))
        times.append(t0 + T_per)
    ric = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    tic = np.array([0.05, 0.02, 0.01])
    return SyntheticSequence(times=np.asarray(times), P=np.stack(P), Q=np.stack(Q),
                             V=np.stack(V), imu=imu, ric=ric, tic=tic)


def make_revisit_trajectory(n_frames: int, rig: SyntheticRig = SyntheticRig(), seed: int = 0,
                            accel: float = 1.6, axis=(1.0, 0.0, 0.0), cycles: int = 1,
                            tic=(0.0, 0.0, 0.0)) -> SyntheticSequence:
    """Oscillating out-and-back path that re-observes earlier regions (the
    loop-closure scene): bang-bang world acceleration along ``axis``, four
    equal quarters (+A, −A, −A, +A) per cycle, zero body rotation."""
    rng = np.random.default_rng(seed)
    T_per = 1.0 / rig.frame_rate
    n_sub = max(int(round(rig.imu_rate / rig.frame_rate)), 1)
    ax = np.asarray(axis, np.float64)
    ax = ax / max(np.linalg.norm(ax), 1e-9)
    A = accel * (0.85 + 0.3 * rng.random())  # per-seed amplitude variation
    q = max(n_frames // (4 * cycles), 1)
    P = [np.zeros(3)]
    Q = [np.array([1.0, 0, 0, 0])]
    V = [np.zeros(3)]
    times = [0.0]
    imu = [(0.0, G.copy(), np.zeros(3))]
    for k in range(n_frames - 1):
        a_w = (1.0, -1.0, -1.0, 1.0)[(k // q) % 4] * A * ax
        P0, V0, t0 = P[-1], V[-1], times[-1]
        for s in range(1, n_sub + 1):
            imu.append((t0 + T_per * s / n_sub, a_w + G, np.zeros(3)))
        P.append(P0 + V0 * T_per + 0.5 * a_w * T_per ** 2)
        V.append(V0 + a_w * T_per)
        Q.append(Q[-1].copy())
        times.append(t0 + T_per)
    return SyntheticSequence(times=np.asarray(times), P=np.stack(P), Q=np.stack(Q),
                             V=np.stack(V), imu=imu,
                             ric=np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]]),
                             tic=np.asarray(tic, np.float64))


def corrupt_imu(seq: SyntheticSequence, seed: int = 0, gyr_noise: float = 0.0,
                acc_noise: float = 0.0, gyr_bias_ramp: float = 0.0, acc_bias: float = 0.0,
                gyr_pulse: float = 0.0, pulse_frac=(0.25, 0.4),
                pulse_axis=(0.0, 0.0, 1.0)) -> SyntheticSequence:
    """``seq`` with corrupted IMU samples (poses unchanged): white noise, a
    ramping gyro bias, a constant accelerometer bias, and a gyro pulse about
    ``pulse_axis`` during the ``pulse_frac`` part of the sequence."""
    rng = np.random.default_rng((seed, 77))
    t_end = max(float(seq.imu[-1][0]), 1e-9)
    gdir = rng.normal(size=3)
    gdir /= np.linalg.norm(gdir)
    adir = rng.normal(size=3)
    adir /= np.linalg.norm(adir)
    ab = acc_bias * adir
    pdir = np.asarray(pulse_axis, np.float64)
    pdir /= max(np.linalg.norm(pdir), 1e-9)
    p0, p1 = pulse_frac[0] * t_end, pulse_frac[1] * t_end
    out = []
    for (t, acc, gyr) in seq.imu:
        gn = gyr_noise * rng.normal(size=3) if gyr_noise else 0.0
        an = acc_noise * rng.normal(size=3) if acc_noise else 0.0
        gb = (gyr_bias_ramp * (t / t_end)) * gdir
        if gyr_pulse and p0 <= t < p1:
            gb = gb + gyr_pulse * pdir
        out.append((t, np.asarray(acc) + an + ab, np.asarray(gyr) + gn + gb))
    return seq._replace(imu=out)


def camera_poses(seq: SyntheticSequence, k0: int = 0, k1=None):
    """World-from-camera poses of frames [k0, k1): (t_wc (T, 3), q_wc (T, 4)),
    float64 numpy."""
    k1 = len(seq.times) if k1 is None else k1
    R_wi = np.stack([_q2R(seq.Q[k]) for k in range(k0, k1)])
    R_wc = R_wi @ seq.ric
    t_wc = seq.P[k0:k1] + R_wi @ seq.tic
    q = R2q(torch.as_tensor(R_wc, dtype=torch.float64)).numpy()
    return t_wc, q


# --- the renderer ---

def _plane_texture(u, v, seed):
    """Band-limited corner-rich texture: coarse + fine sharp blob grids +
    sinusoids (the constants come from ``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    uw = u + 0.11 * torch.sin(2.9 * v + 1.3) + 0.07 * torch.sin(7.1 * v)
    vw = v + 0.11 * torch.sin(3.7 * u + 0.7) + 0.07 * torch.sin(6.3 * u)
    out = 60.0 * torch.tanh(2.0 * torch.sin(2 * math.pi * uw / 0.9)) * torch.tanh(
        2.0 * torch.sin(2 * math.pi * vw / 0.9))
    ph_u, ph_v = rng.uniform(0, 2 * np.pi, 2)
    mod = 0.55 + 0.45 * torch.sin(1.91 * u + 3.07 * v + 0.9) * torch.sin(
        0.83 * u - 2.11 * v + 2.2)
    out = out + 55.0 * mod * torch.tanh(
        6.0 * torch.sin(2 * math.pi * uw / 0.27 + float(ph_u))) * torch.tanh(
        6.0 * torch.sin(2 * math.pi * vw / 0.27 + float(ph_v)))
    for _ in range(5):
        fu, fv = rng.uniform(2.0, 9.0, 2)
        ph = rng.uniform(0, 2 * np.pi)
        out = out + float(rng.uniform(10, 26)) * torch.sin(float(fu) * u + float(fv) * v + float(ph))
    return out


def ray_grid(rig: SyntheticRig, device, dtype=torch.float32) -> torch.Tensor:
    """The rig's (H, W, 3) z = 1 camera rays, one per pixel: with radtan
    distortion each distorted pixel takes the ray of its undistorted point,
    by an 8-step fixed point."""
    H, W = rig.height, rig.width
    yy, xx = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                            torch.arange(W, dtype=dtype, device=device), indexing="ij")
    xn = (xx - rig.cx) / rig.fx
    yn = (yy - rig.cy) / rig.fy
    if rig.has_distortion:
        p_d = torch.stack([xn, yn], dim=-1)
        p_u = p_d - radtan_distort(p_d, rig.k1, rig.k2, rig.p1, rig.p2)
        for _ in range(7):
            p_u = p_d - radtan_distort(p_u, rig.k1, rig.k2, rig.p1, rig.p2)
        xn, yn = p_u[..., 0], p_u[..., 1]
    return torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)


def render_rays(d_cam: torch.Tensor, P_w: torch.Tensor, q_wc: torch.Tensor):
    """Render N camera poses through the (H, W, 3) ray grid ``d_cam``: P_w
    (N, 3), q_wc (N, 4) on the device -> (images (N, H, W) 0..255, depths
    (N, H, W) metres, along the ray's z)."""
    H, W = d_cam.shape[:2]
    dev, dt = P_w.device, P_w.dtype
    # R d as a broadcast multiply-add over j in a fixed order, so that each
    # pose's frame does not depend on N
    R = q2R(q_wc)[:, None, None]  # (N, 1, 1, 3, 3)
    d_w = (R[..., 0] * d_cam[..., 0:1] + R[..., 1] * d_cam[..., 1:2]
           + R[..., 2] * d_cam[..., 2:3])  # (N, H, W, 3)
    N = P_w.shape[0]
    best_t = torch.full((N, H, W), 1e9, dtype=dt, device=dev)
    best_i = torch.full((N, H, W), 255.0, dtype=dt, device=dev)
    for k, (n, off, ua, va) in enumerate(_PLANES):
        ax = int(np.argmax(np.abs(n)))  # the planes are axis-aligned
        denom = d_w[..., ax] * float(n[ax])
        t = (off - P_w[:, ax] * float(n[ax]))[:, None, None] / torch.where(
            torch.abs(denom) > 1e-9, denom, torch.full_like(denom, 1e-9))
        hit = P_w[:, None, None, :] + t[..., None] * d_w
        u = hit[..., int(np.argmax(ua))]
        v = hit[..., int(np.argmax(va))]
        tex = _plane_texture(u, v, seed=k) + 128.0
        ok = (t > 0.05) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, tex, best_i)
    depth = torch.where(best_t < 1e8, best_t, torch.zeros_like(best_t))
    return torch.clamp(best_i, 0.0, 255.0), depth


def render_into(seq: SyntheticSequence, rig: SyntheticRig, imgs: torch.Tensor,
                depths: torch.Tensor, k0: int = 0, chunk: int = 16) -> None:
    """Render frames [k0, k0 + len(imgs)) of ``seq`` into the (T, H, W)
    device tensors ``imgs`` and ``depths`` (views are fine), in chunks."""
    T = imgs.shape[0]
    t_wc, q_wc = camera_poses(seq, k0, k0 + T)
    dev = imgs.device
    P = torch.as_tensor(t_wc, dtype=torch.float32).to(dev)
    Q = torch.as_tensor(q_wc, dtype=torch.float32).to(dev)
    rays = ray_grid(rig, dev)
    for j in range(0, T, chunk):
        im, dp = render_rays(rays, P[j:j + chunk], Q[j:j + chunk])
        imgs[j:j + chunk] = im
        depths[j:j + chunk] = dp
