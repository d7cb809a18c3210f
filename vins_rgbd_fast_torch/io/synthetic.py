"""Synthetic RGB-D + IMU sequences (twin of ``make_trajectory``,
``make_revisit_trajectory``, ``corrupt_imu``, ``camera_pose``, the
renderer ``_render_core`` with its moving sphere, ``SensorDegradation``,
``degrade_frame``, ``dyn_sphere_center`` and ``frames_degraded`` in
``vins_rgbd_fast_tpu/io/synthetic.py``).

Trajectories and IMU samples are closed forms in float64 numpy; frames are
rendered on the device in batches: a grid of camera rays (``ray_grid``,
the pinhole rig's, or any (H, W, 3) z = 1 grid such as a camera model's
``lift`` of the pixel grid) against the six textured planes of the room
and, optionally, a moving textured sphere (``render_rays``).  The sensor
degradations take their random draws from a ``torch.Generator``, or as
tensors handed in (tests hand in JAX's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import quaternion as quat

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
    Q: np.ndarray      # (N, 4) world-from-imu
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


def make_trajectory(n_frames: int, rig: SyntheticRig = SyntheticRig(), seed: int = 0,
                    omega_scale: float = 0.25, acc_scale: float = 0.4,
                    v0=(0.25, 0.1, 0.0), diverge_seed=None,
                    diverge_after: int = 0) -> SyntheticSequence:
    """Smooth random walk in body rates, exact per-interval integration;
    IMU sampled at ``rig.imu_rate`` with exact specific force.  With
    ``diverge_seed``, sequences of one ``seed`` share their prefix through
    frame ``diverge_after`` and then walk apart, one walk per
    ``diverge_seed``."""
    rng = np.random.default_rng(seed)
    rng2 = np.random.default_rng((seed, diverge_seed)) if diverge_seed is not None else rng
    T_per = 1.0 / rig.frame_rate
    n_sub = max(int(round(rig.imu_rate / rig.frame_rate)), 1)
    P = [np.zeros(3)]
    Q = [np.array([1.0, 0, 0, 0])]
    V = [np.asarray(v0, np.float64)]
    times = [0.0]
    imu = [(0.0, _qrot_inv(Q[0], G), np.zeros(3))]
    w_b = rng.normal(size=3) * omega_scale
    a_w = rng.normal(size=3) * acc_scale
    for k in range(n_frames - 1):
        r = rng2 if (diverge_seed is not None and k >= diverge_after) else rng
        w_b = 0.8 * w_b + 0.2 * r.normal(size=3) * omega_scale
        a_w = 0.8 * a_w + 0.2 * r.normal(size=3) * acc_scale
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
    ``pulse_axis`` during the ``pulse_frac`` part of the sequence (the yaw
    drift that loop closure removes)."""
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


def camera_pose(seq: SyntheticSequence, k: int):
    """World-from-camera pose of frame k: (t_wc (3,), q_wc (4,))."""
    R_wi = _q2R(seq.Q[k])
    R_wc = R_wi @ seq.ric
    t_wc = seq.P[k] + R_wi @ seq.tic
    q = quat.R2q(torch.as_tensor(R_wc, dtype=torch.float64)).numpy()
    return t_wc, q


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
    """The pinhole rig's (H, W, 3) z = 1 camera rays, one per pixel: with
    radtan distortion each distorted pixel takes the ray of its undistorted
    point, by the 8-step fixed point the camera's ``lift`` runs."""
    H, W = rig.height, rig.width
    yy, xx = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                            torch.arange(W, dtype=dtype, device=device), indexing="ij")
    xn = (xx - rig.cx) / rig.fx
    yn = (yy - rig.cy) / rig.fy
    if rig.has_distortion:
        from ..models.camera import _radtan_distort
        p_d = torch.stack([xn, yn], dim=-1)
        p_u = p_d - _radtan_distort(p_d, rig.k1, rig.k2, rig.p1, rig.p2)
        for _ in range(7):
            p_u = p_d - _radtan_distort(p_u, rig.k1, rig.k2, rig.p1, rig.p2)
        xn, yn = p_u[..., 0], p_u[..., 1]
    return torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The last axis's dot product, summed in a fixed order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def render_rays(d_cam: torch.Tensor, P_w: torch.Tensor, q_wc: torch.Tensor,
                dyn_center: Optional[torch.Tensor] = None, dyn_radius: float = 0.0):
    """Render N camera poses through the (H, W, 3) ray grid ``d_cam``: P_w
    (N, 3), q_wc (N, 4) on the device -> (images (N, H, W) 0..255, depths
    (N, H, W) metres, along the ray's z).  With ``dyn_center`` (N, 3) and
    ``dyn_radius`` > 0 a textured sphere at those centres occludes the room."""
    H, W = d_cam.shape[:2]
    dev, dt = P_w.device, P_w.dtype
    # R d as a broadcast multiply-add over j in a fixed order: a batched
    # einsum's arithmetic depends on N, and each pose's frame must not
    R = quat.q2R(q_wc)[:, None, None]  # (N, 1, 1, 3, 3)
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
    if dyn_center is not None and dyn_radius > 0:
        # ray-sphere intersection in the unnormalised ray parameter
        oc = (P_w - dyn_center)[:, None, None, :]
        a = _dot3(d_w, d_w)
        bq = 2.0 * _dot3(d_w, oc)
        cq = _dot3(oc, oc) - dyn_radius * dyn_radius
        disc = bq * bq - 4.0 * a * cq
        t_s = (-bq - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
        hit_s = P_w[:, None, None, :] + t_s[..., None] * d_w
        nrm = (hit_s - dyn_center[:, None, None, :]) / max(dyn_radius, 1e-6)
        tex_s = 128.0 + 70.0 * torch.tanh(3.0 * torch.sin(9.0 * nrm[..., 0])
                                          * torch.sin(9.0 * nrm[..., 1])
                                          + 2.0 * torch.sin(7.0 * nrm[..., 2]))
        ok_s = (disc > 0) & (t_s > 0.05) & (t_s < best_t)
        best_t = torch.where(ok_s, t_s, best_t)
        best_i = torch.where(ok_s, tex_s, best_i)
    depth = torch.where(best_t < 1e8, best_t, torch.zeros_like(best_t))
    return torch.clamp(best_i, 0.0, 255.0), depth


def render_poses(rig: SyntheticRig, P_w: torch.Tensor, q_wc: torch.Tensor):
    """Render N camera poses at once through the rig's pinhole rays: P_w
    (N, 3), q_wc (N, 4) float32 on the device -> (images (N, H, W) 0..255,
    depths (N, H, W) metres)."""
    return render_rays(ray_grid(rig, P_w.device, P_w.dtype), P_w, q_wc)


def render_sequence(seq: SyntheticSequence, rig: SyntheticRig, device, k0: int = 0,
                    k1=None, chunk: int = 16, rays: Optional[torch.Tensor] = None):
    """Render frames [k0, k1) of ``seq`` on ``device`` in chunks, through
    ``rays`` (an (H, W, 3) z = 1 grid on the device; default the rig's
    pinhole grid); returns (times (T,), images (T, H, W), depths (T, H, W))."""
    if k1 is None:
        k1 = len(seq.times)
    poses = [camera_pose(seq, k) for k in range(k0, k1)]
    P = torch.as_tensor(np.stack([p[0] for p in poses]), dtype=torch.float32).to(device)
    Q = torch.as_tensor(np.stack([p[1] for p in poses]), dtype=torch.float32).to(device)
    if rays is None:
        rays = ray_grid(rig, P.device, P.dtype)
    imgs, depths = [], []
    for j in range(0, P.shape[0], chunk):
        im, dp = render_rays(rays, P[j:j + chunk], Q[j:j + chunk])
        imgs.append(im)
        depths.append(dp)
    return np.asarray(seq.times[k0:k1]), torch.cat(imgs), torch.cat(depths)


# ---------------------------------------------------------------------------
# sensor degradation (the bench's BENCH_DEGRADE presets)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SensorDegradation:
    """The D435i failure modes: depth noise σ(z) = depth_sigma·z², 16×16
    block dropouts and holes at depth edges, exposure drift, image read
    noise, a rolling-shutter shear and a moving sphere in the scene."""
    depth_sigma: float = 0.0   # σ(z) = depth_sigma · z² (m)
    hole_p: float = 0.0        # per 16×16 block dropout probability
    edge_hole: bool = False    # zero depth at depth discontinuities
    exposure_amp: float = 0.0  # gain oscillation amplitude
    exposure_period: float = 4.0  # s
    read_noise: float = 0.0    # grayscale σ
    rs_shear_px: float = 0.0   # horizontal shift across the frame height
    dyn_radius: float = 0.0    # moving sphere radius (m); 0 = off
    dyn_orbit: float = 2.0     # the sphere's orbit radius about the room centre (m)
    dyn_omega: float = 0.8     # the sphere's angular rate (rad/s)


def degrade_frame(rig: SyntheticRig, deg: SensorDegradation, img: torch.Tensor,
                  depth: torch.Tensor, t: float, generator: Optional[torch.Generator] = None,
                  read_noise: Optional[torch.Tensor] = None,
                  depth_noise: Optional[torch.Tensor] = None,
                  holes: Optional[torch.Tensor] = None):
    """The configured degradations of one rendered (H, W) frame at time
    ``t``, in JAX's order.  The draws, where a degradation needs one: the
    read noise (H, W) and depth noise (H, W) standard normals and the
    ((H + 15)//16, (W + 15)//16) bool block dropouts, handed in or drawn
    from ``generator`` in that order."""
    H, W = rig.height, rig.width
    dev, dt = img.device, img.dtype

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=dt)

    if deg.exposure_amp > 0:  # in float32, as JAX computes it
        tt = torch.tensor(t, dtype=torch.float32)
        img = img * (1.0 + deg.exposure_amp * torch.sin(2 * math.pi * tt
                                                        / deg.exposure_period)).to(dev, dt)
    if deg.read_noise > 0:
        img = img + deg.read_noise * (normal((H, W)) if read_noise is None else read_noise)
    if deg.rs_shear_px > 0:  # per-row horizontal shift growing down the frame
        rows = torch.arange(H, dtype=dt, device=dev)
        shift = deg.rs_shear_px * (rows / H - 0.5)
        x = torch.arange(W, dtype=dt, device=dev)[None, :] - shift[:, None]
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
        fx = x - x0.to(dt)
        img = torch.gather(img, 1, x0) * (1 - fx) + torch.gather(img, 1, x0 + 1) * fx
    img = torch.clamp(img, 0.0, 255.0)
    if deg.depth_sigma > 0:
        dn = normal((H, W)) if depth_noise is None else depth_noise
        depth = torch.where(depth > 0, depth + deg.depth_sigma * depth * depth * dn, depth)
    if deg.hole_p > 0:
        bh, bw = (H + 15) // 16, (W + 15) // 16
        if holes is None:
            holes = torch.rand((bh, bw), generator=generator, device=dev) < deg.hole_p
        drop = holes.repeat_interleave(16, 0).repeat_interleave(16, 1)[:H, :W]
        depth = torch.where(drop, torch.zeros_like(depth), depth)
    if deg.edge_hole:
        gy = torch.abs(torch.diff(depth, dim=0, prepend=depth[:1]))
        gx = torch.abs(torch.diff(depth, dim=1, prepend=depth[:, :1]))
        depth = torch.where((gy > 0.3) | (gx > 0.3), torch.zeros_like(depth), depth)
    return img, torch.clamp(depth, min=0.0)


def dyn_sphere_center(deg: SensorDegradation, t: float) -> np.ndarray:
    """The moving sphere's world position at time t (a horizontal orbit)."""
    th = deg.dyn_omega * float(t)
    return np.array([deg.dyn_orbit * np.cos(th), deg.dyn_orbit * np.sin(th), 0.6])


def frames_degraded(seq: SyntheticSequence, rig: SyntheticRig, deg: SensorDegradation,
                    device, seed: int = 0, draws: Optional[Callable[[int], dict]] = None
                    ) -> Iterator[Tuple[float, torch.Tensor, torch.Tensor]]:
    """Yield (t, image (H, W), depth (H, W)) per frame of ``seq``, rendered on
    ``device`` through the rig's rays with the moving sphere and the sensor
    degradations.  The draws come from one
    generator seeded ``seed``, or per frame k from ``draws(k)``, a dict of
    ``degrade_frame``'s draw arguments."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rays = ray_grid(rig, device)
    for k in range(len(seq.times)):
        t = float(seq.times[k])
        t_wc, q_wc = camera_pose(seq, k)
        P = torch.as_tensor(t_wc, dtype=torch.float32).to(device)[None]
        Q = torch.as_tensor(q_wc, dtype=torch.float32).to(device)[None]
        ctr = torch.as_tensor(dyn_sphere_center(deg, t), dtype=torch.float32).to(device)[None]
        img, depth = render_rays(rays, P, Q, ctr, deg.dyn_radius)
        img, depth = degrade_frame(rig, deg, img[0], depth[0], t, gen,
                                   **(draws(k) if draws is not None else {}))
        yield t, img, depth
