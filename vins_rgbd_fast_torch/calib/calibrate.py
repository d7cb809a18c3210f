"""Intrinsic camera calibration from chessboard views (twin of
``vins_rgbd_fast_tpu/calib/calibrate.py``; the reference's
``camera_model/src/calib/CameraCalibration.cc`` and the per-model
``estimateIntrinsics``/``estimateExtrinsics``).

The board geometry, Zhang's closed form, the per-view poses from
homographies, Scaramuzza's linear initialization, the inverse-polynomial
fit and the YAML writer are numpy copies of JAX's host code.  The four
vector-parameterized projections are written on tensors with the port's
own distortion and θ-polynomial functions (``models/camera.py``) and its
``so3_exp``/``q2R``, so that ``torch.func.jacfwd`` differentiates them.
``refine`` is one Levenberg-Marquardt program in float64 on the caller's
device: residuals a ``torch.func.vmap`` over views, ``J = jacfwd(res)(x)``,
the damped normal equations through ``torch.linalg.solve``; the host
accepts or rejects each step with JAX's λ schedule, stop and iteration cap.

Supported models: pinhole (radtan), kannala-brandt, mei, scaramuzza.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.camera import (EquidistantCamera, MeiCamera, PinholeCamera, ScaramuzzaCamera,
                             _kb_theta_poly, _radtan_distort)
from ..utils.quaternion import q2R, so3_exp

N_INTR = {"pinhole": 8, "kannala-brandt": 8, "mei": 9, "scaramuzza": 9}


# ---------------------------------------------------------------------------
# board + closed-form initialization (host)
# ---------------------------------------------------------------------------


def board_points(rows: int, cols: int, square: float) -> np.ndarray:
    """(rows*cols, 3) board-frame corner coordinates, z = 0, row-major —
    the reference's object-point layout (``CameraCalibration.cc``
    addChessboardData)."""
    ys, xs = np.mgrid[0:rows, 0:cols].astype(np.float64)
    return np.stack([xs.ravel() * square, ys.ravel() * square,
                     np.zeros(rows * cols)], axis=1)


def _normalize(pts: np.ndarray):
    c = pts.mean(axis=0)
    s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - c, axis=1)), 1e-12)
    T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
    ph = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1) @ T.T
    return ph[:, :2], T


def homography(obj_xy: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Normalized DLT homography board-plane → image (per view)."""
    src, Ts = _normalize(np.asarray(obj_xy, np.float64))
    dst, Td = _normalize(np.asarray(uv, np.float64))
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = np.linalg.inv(Td) @ Vt[-1].reshape(3, 3) @ Ts
    return H / H[2, 2]


def zhang_intrinsics(Hs: Sequence[np.ndarray]) -> np.ndarray:
    """Closed-form K from ≥2 homographies (Zhang's B-matrix constraints,
    zero skew enforced) → [fx, fy, cx, cy]."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j]])

    rows = []
    for H in Hs:
        rows.append(v(H, 0, 1))
        rows.append(v(H, 0, 0) - v(H, 1, 1))
    rows.append([0, 1, 0, 0, 0, 0])  # zero skew
    _, _, Vt = np.linalg.svd(np.asarray(rows))
    B11, B12, B22, B13, B23, B33 = Vt[-1]
    cy = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + cy * (B12 * B13 - B11 * B23)) / B11
    fx = np.sqrt(abs(lam / B11))
    fy = np.sqrt(abs(lam * B11 / (B11 * B22 - B12 * B12)))
    cx = -B13 * fx * fx / lam
    return np.array([fx, fy, cx, cy])


def pose_from_homography(K4: np.ndarray, H: np.ndarray):
    """Per-view extrinsics from H = K [r1 r2 t] → (rvec (3,), t (3,))."""
    fx, fy, cx, cy = K4
    Kinv = np.array([[1 / fx, 0, -cx / fx], [0, 1 / fy, -cy / fy],
                     [0, 0, 1.0]])
    M = Kinv @ H
    s = 1.0 / max(np.linalg.norm(M[:, 0]), 1e-12)
    r1, r2 = s * M[:, 0], s * M[:, 1]
    t = s * M[:, 2]
    if t[2] < 0:  # board must be in front of the camera
        r1, r2, t = -r1, -r2, -t
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    return _nearest_rvec(R), t


def _nearest_rvec(R: np.ndarray) -> np.ndarray:
    """Project to the nearest rotation (SVD) and convert to axis-angle."""
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1.0]) @ Vt
    ang = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    if ang < 1e-9:
        return np.zeros(3)
    ax = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                   R[1, 0] - R[0, 1]]) / (2 * np.sin(ang))
    return ang * ax


def _scaramuzza_init(obj: np.ndarray, uvs: np.ndarray, width: int,
                     height: int):
    """Scaramuzza's linear initialization (thesis no. 17635 p.30; the
    reference reimplements it at ``ScaramuzzaCamera.cc:227-575``
    estimateIntrinsics): per view, the third row of the collinearity
    cross-product p × (R[X Y 1]ᵀ) = 0 is polynomial-free and linear in
    (r11, r12, r21, r22, t1, t2) — solved by SVD null space; the missing
    (r31, r32) follow from orthonormality (sign candidates disambiguated
    by requiring a positive quadratic coefficient and positive t3 in a
    per-view polynomial solve).  A final joint least squares over all
    views recovers the forward polynomial [a0, 0, a2, a3, a4] and every
    view's t3.

    Uses CENTERED pixel coordinates (u, v relative to the image center) —
    the collinearity constraint is stated about the distortion center.
    Returns (poly4 = [a0 a2 a3 a4], rvecs, tvecs)."""
    V, N = uvs.shape[:2]
    ctr = np.array([width / 2.0, height / 2.0])
    X, Y = obj[:, 0], obj[:, 1]
    Rs, Ts = [], []
    for vi in range(V):
        u = uvs[vi, :, 0] - ctr[0]
        v = uvs[vi, :, 1] - ctr[1]
        M = np.stack([-v * X, -v * Y, u * X, u * Y, -v, u], axis=1)
        _, _, Vt = np.linalg.svd(M, full_matrices=True)
        h = -Vt[-1]
        sr11, sr12, sr21, sr22, st1, st2 = h
        AA = (sr11 * sr12 + sr21 * sr22) ** 2
        BB = sr11 ** 2 + sr21 ** 2
        CC = sr12 ** 2 + sr22 ** 2
        disc = np.sqrt((CC - BB) ** 2 + 4.0 * AA)
        cands = []
        for s32sq in ((-(CC - BB) + disc) / 2.0, (-(CC - BB) - disc) / 2.0):
            if s32sq < 0:
                continue
            for sign in (-1.0, 1.0):
                sr32 = sign * np.sqrt(s32sq)
                if s32sq < 1e-16:
                    for s31 in (np.sqrt(max(CC - BB, 0.0)),
                                -np.sqrt(max(CC - BB, 0.0))):
                        cands.append((s31, sr32))
                    break
                cands.append((-(sr11 * sr12 + sr21 * sr22) / sr32, sr32))
        # per-view polynomial probe over every (sign, scale) candidate.
        # The probed polynomial is w(ρ) = −f(ρ), the FORWARD ray
        # z-component (w0 = −a0 > 0); accept candidates with w0 > 0 and
        # t3 > 0 (board in front), keep the lowest-residual one.  (The
        # reference's x(2)>0 check tests the same cross-product system in
        # its flipped native frame, ScaramuzzaCamera.cc:355-425.)
        best, best_res = None, np.inf
        for (sr31, sr32) in cands:
            lam = 1.0 / np.sqrt(sr11 ** 2 + sr21 ** 2 + sr31 ** 2)
            for s in (lam, -lam):
                H = s * np.array([[sr11, sr12, st1],
                                  [sr21, sr22, st2],
                                  [sr31, sr32, 0.0]])
                Aq = H[1, 0] * X + H[1, 1] * Y + H[1, 2]
                Cq = H[0, 0] * X + H[0, 1] * Y + H[0, 2]
                Bq = v * (H[2, 0] * X + H[2, 1] * Y)
                Dq = u * (H[2, 0] * X + H[2, 1] * Y)
                rho = np.sqrt(u * u + v * v)
                A_mat = np.zeros((2 * N, 4))
                b_vec = np.zeros(2 * N)
                A_mat[0::2, 0], A_mat[1::2, 0] = Aq, Cq
                A_mat[0::2, 1], A_mat[1::2, 1] = Aq * rho, Cq * rho
                A_mat[0::2, 2], A_mat[1::2, 2] = Aq * rho ** 2, Cq * rho ** 2
                A_mat[0::2, 3], A_mat[1::2, 3] = -v, -u
                b_vec[0::2], b_vec[1::2] = Bq, Dq
                x, *_ = np.linalg.lstsq(A_mat, b_vec, rcond=None)
                res = float(np.linalg.norm(A_mat @ x - b_vec))
                if x[0] > 0 and x[3] > 0 and res < best_res:
                    best, best_res = H, res
        if best is None:  # degenerate view: keep the first candidate
            sr31, sr32 = cands[0]
            lam = 1.0 / np.sqrt(sr11 ** 2 + sr21 ** 2 + sr31 ** 2)
            best = lam * np.array([[sr11, sr12, st1],
                                   [sr21, sr22, st2],
                                   [sr31, sr32, 0.0]])
        R = np.stack([best[:, 0], best[:, 1],
                      np.cross(best[:, 0], best[:, 1])], axis=1)
        Rs.append(R)
        Ts.append(best[:, 2].copy())

    # joint solve: [a0, a2, a3, a4] + per-view t3
    A_mat = np.zeros((2 * V * N, 4 + V))
    b_vec = np.zeros(2 * V * N)
    for vi in range(V):
        u = uvs[vi, :, 0] - ctr[0]
        v = uvs[vi, :, 1] - ctr[1]
        R, T = Rs[vi], Ts[vi]
        Aq = R[1, 0] * X + R[1, 1] * Y + T[1]
        Cq = R[0, 0] * X + R[0, 1] * Y + T[0]
        Bq = v * (R[2, 0] * X + R[2, 1] * Y)
        Dq = u * (R[2, 0] * X + R[2, 1] * Y)
        rho = np.sqrt(u * u + v * v)
        r0, r1 = 2 * vi * N, 2 * vi * N + 2 * N
        rows = slice(r0, r1)
        blk = np.zeros((2 * N, 4 + V))
        for k, p in enumerate((np.ones_like(rho), rho ** 2, rho ** 3,
                               rho ** 4)):
            blk[0::2, k] = Aq * p
            blk[1::2, k] = Cq * p
        blk[0::2, 4 + vi] = -v
        blk[1::2, 4 + vi] = -u
        A_mat[rows] = blk
        b_vec[r0:r1:2] = Bq
        b_vec[r0 + 1:r1:2] = Dq
    x, *_ = np.linalg.lstsq(A_mat, b_vec, rcond=None)
    poly4 = -x[:4]  # solved w(ρ) = −f(ρ): negate back to OCAM f coeffs
    rvecs = np.stack([_nearest_rvec(R) for R in Rs])
    tvecs = np.stack([np.array([T[0], T[1], x[4 + vi]])
                      for vi, T in enumerate(Ts)])
    return poly4, rvecs, tvecs


# ---------------------------------------------------------------------------
# vector-parameterized projections (device, differentiable)
# ---------------------------------------------------------------------------


def _project_pinhole(th, Pc):
    """θ = [fx fy cx cy k1 k2 p1 p2] (reference spaceToPlane,
    ``PinholeCamera.cc:450-486``)."""
    p = Pc[..., :2] / Pc[..., 2:3]
    p = p + _radtan_distort(p, th[4], th[5], th[6], th[7])
    return torch.stack([th[0] * p[..., 0] + th[2], th[1] * p[..., 1] + th[3]], dim=-1)


def _project_kb(th, Pc):
    """θ = [mu mv u0 v0 k2 k3 k4 k5] (``EquidistantCamera.cc``
    spaceToPlane)."""
    r = torch.linalg.norm(Pc[..., :2], dim=-1)
    theta = torch.atan2(r, Pc[..., 2])
    d = _kb_theta_poly(theta, th[4], th[5], th[6], th[7])
    scale = d / torch.clamp(r, min=1e-12)
    return torch.stack([th[0] * scale * Pc[..., 0] + th[2],
                        th[1] * scale * Pc[..., 1] + th[3]], dim=-1)


def _project_mei(th, Pc):
    """θ = [xi gamma1 gamma2 u1 v1 k1 k2 p1 p2] (``CataCamera.cc``
    spaceToPlane: unit sphere + mirror offset ξ, then radtan)."""
    norm = torch.linalg.norm(Pc, dim=-1, keepdim=True)
    z = Pc[..., 2:3] + th[0] * norm
    p = Pc[..., :2] / torch.clamp(z, min=1e-12)
    p = p + _radtan_distort(p, th[5], th[6], th[7], th[8])
    return torch.stack([th[1] * p[..., 0] + th[3], th[2] * p[..., 1] + th[4]], dim=-1)


def _project_scaramuzza(th, Pc):
    """θ = [a0 a2 a3 a4 cx cy C D E] (forward polynomial with a1 = 0,
    affine stretch [[C, D], [E, 1]], distortion center): the point
    (x, y, z) with r = √(x²+y²) projects to the ρ solving
    f(ρ) + (z/r)·ρ = 0, by 12 unrolled Newton steps from the pure-a0 root
    ρ = −a0·r/z."""
    a0, a2, a3, a4 = th[0], th[1], th[2], th[3]
    x, y, z = Pc[..., 0], Pc[..., 1], Pc[..., 2]
    r = torch.sqrt(x * x + y * y)
    m = z / torch.clamp(r, min=1e-12)

    def f(p):
        return a0 + p * p * (a2 + p * (a3 + p * a4))

    def df(p):
        return p * (2.0 * a2 + p * (3.0 * a3 + 4.0 * a4 * p))

    rho = torch.clamp(-a0 / torch.clamp(m, min=1e-6), min=1e-6)
    for _ in range(12):
        g = f(rho) + m * rho
        rho = torch.clamp(rho - g / (df(rho) + m), 1e-6, 1e6)
    scale = rho / torch.clamp(r, min=1e-12)
    u = x * scale
    v = y * scale
    return torch.stack([th[6] * u + th[7] * v + th[4], th[8] * u + v + th[5]], dim=-1)


_PROJECT = {"pinhole": _project_pinhole, "kannala-brandt": _project_kb,
            "mei": _project_mei, "scaramuzza": _project_scaramuzza}


# ---------------------------------------------------------------------------
# bundle refinement (device LM)
# ---------------------------------------------------------------------------


def _residual_fn(model: str, obj: torch.Tensor, uvs: torch.Tensor, valid: torch.Tensor,
                 n_intr: int):
    project = _PROJECT[model]

    def one(th, pose, uv, ok):
        R = q2R(so3_exp(pose[:3]))
        Pc = obj @ R.transpose(0, 1) + pose[3:]
        r = project(th, Pc) - uv
        return torch.where(ok[:, None], r, torch.zeros_like(r))

    per_view = torch.func.vmap(one, in_dims=(None, 0, 0, 0))

    def residuals(x):
        return per_view(x[:n_intr], x[n_intr:].reshape(-1, 6), uvs, valid).reshape(-1)

    return residuals


@dataclasses.dataclass
class CalibrationResult:
    model: str
    intrinsics: np.ndarray          # the refined θ vector
    params: object                  # the matching models.camera dataclass
    rms_px: float                   # reprojection RMS over valid corners
    per_view_rms_px: np.ndarray
    rvecs: np.ndarray               # (V, 3) refined board poses
    tvecs: np.ndarray


def refine(model: str, theta0: np.ndarray, rvecs: np.ndarray, tvecs: np.ndarray,
           obj: np.ndarray, uvs: np.ndarray, valid: Optional[np.ndarray] = None,
           iters: int = 40, device="cuda"):
    """Joint LM over [θ, every view's (rvec, tvec)] in float64 on
    ``device`` (default cuda; ``"cpu"`` to refine on the CPU): each step
    one residual evaluation, the forward-mode Jacobian and a dense solve
    of the damped normal equations; the host reads the cost back and
    accepts (λ ÷ 3, floor 1e-9) or rejects (λ × 5, cap 1e6), stopping
    when an accepted step's largest entry is below 1e-10."""
    V, N = uvs.shape[:2]
    n_intr = len(theta0)
    if valid is None:
        valid = np.ones((V, N), bool)
    f64 = torch.float64
    obj_d = torch.as_tensor(obj, dtype=f64, device=device)
    uvs_d = torch.as_tensor(uvs, dtype=f64, device=device)
    val_d = torch.as_tensor(valid, device=device)
    res_fn = _residual_fn(model, obj_d, uvs_d, val_d, n_intr)

    def step(x, lam):
        r = res_fn(x)
        J = torch.func.jacfwd(res_fn)(x)
        JtJ = J.T @ J
        g = J.T @ r
        A = JtJ + lam * torch.diag(torch.diagonal(JtJ) + 1e-12)
        return torch.linalg.solve(A, -g)

    def cost(x):
        return float(0.5 * torch.sum(res_fn(x) ** 2))

    x = torch.as_tensor(np.concatenate(
        [theta0, np.concatenate([rvecs, tvecs], axis=1).ravel()]), dtype=f64, device=device)
    lam, c = 1e-3, cost(x)
    for _ in range(iters):
        dx = step(x, lam)
        xn = x + dx
        cn = cost(xn)
        if np.isfinite(cn) and cn < c:
            x, c, lam = xn, cn, max(lam / 3.0, 1e-9)
            if float(torch.max(torch.abs(dx))) < 1e-10:
                break
        else:
            lam = min(lam * 5.0, 1e6)
    r = res_fn(x).reshape(V, N, 2).cpu().numpy()
    x = x.cpu().numpy()
    th = x[:n_intr]
    poses = x[n_intr:].reshape(V, 6)
    nv = np.maximum(valid.sum(axis=1), 1)
    per_view = np.sqrt((r ** 2).sum(axis=2).sum(axis=1) / nv)
    rms = float(np.sqrt((r ** 2).sum() / max(int(valid.sum()), 1)))
    return th, poses[:, :3], poses[:, 3:], rms, per_view


def _fit_inv_poly(poly, width: int, height: int, order: int = 6,
                  n_coeff: int = 12) -> tuple:
    """Fit the inverse polynomial ρ(θ) by sampling the forward polynomial
    — the reference's post-init step (``ScaramuzzaCamera.cc:536-572``: ρ
    sampled to (W+H)/2, order-4 fit to avoid overfitting; stored padded
    to the 12-coefficient layout).  θ here follows ``scaramuzza_project``
    (θ = atan2(−P_z, r) with P_z = −f(ρ) the lifted ray's z), so the
    fitted inverse inverts OUR lift exactly
    (``tests/test_camera.py::test_scaramuzza_roundtrip``).  Order 6 over
    the image radius: the fit source is the analytic forward polynomial
    (noise-free), so the reference's order-4 anti-overfit guard does not
    apply."""
    rho = np.arange(0.1, float(np.hypot(width, height)) / 2.0, 0.1)
    z = np.zeros_like(rho)
    for k, c in enumerate(poly):
        z += c * rho ** k
    theta = np.arctan2(z, rho)  # = atan2(-(−f), ρ) flipped: −P_z = f
    A = np.stack([theta ** i for i in range(order + 1)], axis=1)
    c, *_ = np.linalg.lstsq(A, rho, rcond=None)
    out = np.zeros(n_coeff)
    out[:order + 1] = c
    return tuple(float(x) for x in out)


def _params_from_theta(model: str, th: np.ndarray, width: int, height: int):
    if model == "pinhole":
        return PinholeCamera(fx=float(th[0]), fy=float(th[1]), cx=float(th[2]),
                             cy=float(th[3]), k1=float(th[4]), k2=float(th[5]),
                             p1=float(th[6]), p2=float(th[7]), width=width, height=height)
    if model == "kannala-brandt":
        return EquidistantCamera(mu=float(th[0]), mv=float(th[1]), u0=float(th[2]),
                                 v0=float(th[3]), k2=float(th[4]), k3=float(th[5]),
                                 k4=float(th[6]), k5=float(th[7]), width=width, height=height)
    if model == "scaramuzza":
        poly = (float(th[0]), 0.0, float(th[1]), float(th[2]), float(th[3]))
        return ScaramuzzaCamera(
            poly=poly, inv_poly=_fit_inv_poly(poly, width, height),
            C=float(th[6]), D=float(th[7]), E=float(th[8]),
            center_x=float(th[4]), center_y=float(th[5]), width=width, height=height)
    if model == "mei":
        return MeiCamera(xi=float(th[0]), gamma1=float(th[1]), gamma2=float(th[2]),
                         u1=float(th[3]), v1=float(th[4]), k1=float(th[5]), k2=float(th[6]),
                         p1=float(th[7]), p2=float(th[8]), width=width, height=height)
    raise ValueError(f"unsupported calibration model {model!r}")


def calibrate(model: str, image_points: List[np.ndarray], rows: int,
              cols: int, square: float, width: int, height: int,
              valid: Optional[np.ndarray] = None, device="cuda") -> CalibrationResult:
    """Full intrinsic calibration from ordered chessboard corners.

    ``image_points``: V arrays (rows*cols, 2), row-major board order (from
    :func:`~vins_rgbd_fast_torch.calib.chessboard.find_chessboard`); the
    refinement runs on ``device`` (default cuda; ``"cpu"`` for the CPU).
    """
    model = model.lower()
    if model not in _PROJECT:
        raise ValueError(f"model {model!r} not in {sorted(_PROJECT)}")
    obj = board_points(rows, cols, square)
    uvs = np.asarray(image_points, np.float64)
    V = uvs.shape[0]
    if V < 3:
        raise ValueError("need >= 3 views for a stable calibration")

    if model == "scaramuzza":
        poly4, rvecs, tvecs = _scaramuzza_init(obj, uvs, width, height)
        theta0 = np.concatenate([poly4, [width / 2.0, height / 2.0,
                                         1.0, 0.0, 0.0]])
        th, rvecs, tvecs, rms, per_view = refine(
            model, theta0, rvecs, tvecs, obj, uvs, valid, device=device)
        return CalibrationResult(
            model=model, intrinsics=th,
            params=_params_from_theta(model, th, width, height),
            rms_px=rms, per_view_rms_px=per_view, rvecs=rvecs, tvecs=tvecs)

    Hs = [homography(obj[:, :2], uvs[v]) for v in range(V)]
    K4 = zhang_intrinsics(Hs)
    # guard the closed form against fisheye bias: fall back to a focal
    # guess from the image diagonal if Zhang degenerates
    if not np.all(np.isfinite(K4)) or K4[0] <= 0 or K4[1] <= 0:
        K4 = np.array([0.8 * width, 0.8 * width, width / 2.0, height / 2.0])
    rv, tv = zip(*(pose_from_homography(K4, H) for H in Hs))
    rvecs, tvecs = np.asarray(rv), np.asarray(tv)

    if model == "pinhole":
        theta0 = np.concatenate([K4, np.zeros(4)])
    elif model == "kannala-brandt":
        theta0 = np.concatenate([K4, np.zeros(4)])
    else:  # mei: ξ=1 ⇒ gamma ≈ fx·(1+ξ) for near-axis boards
        xi0 = 1.0
        theta0 = np.concatenate([[xi0, K4[0] * (1 + xi0), K4[1] * (1 + xi0),
                                  K4[2], K4[3]], np.zeros(4)])

    th, rvecs, tvecs, rms, per_view = refine(
        model, theta0, rvecs, tvecs, obj, uvs, valid, device=device)
    return CalibrationResult(
        model=model, intrinsics=th,
        params=_params_from_theta(model, th, width, height),
        rms_px=rms, per_view_rms_px=per_view, rvecs=rvecs, tvecs=tvecs)


# ---------------------------------------------------------------------------
# camera YAML writer (camodocal layout, readable by config.load_config)
# ---------------------------------------------------------------------------


def write_camera_yaml(path: str, result: CalibrationResult,
                      camera_name: str = "camera"):
    """Write the calibrated camera in the reference's camodocal YAML layout
    (``PinholeCamera::writeParametersToYamlFile`` et al.)."""
    p = result.params
    lines = ["%YAML:1.0", "---"]
    if result.model == "pinhole":
        lines += [
            "model_type: PINHOLE",
            f"camera_name: {camera_name}",
            f"image_width: {p.width}", f"image_height: {p.height}",
            "distortion_parameters:",
            f"   k1: {p.k1:.10e}", f"   k2: {p.k2:.10e}",
            f"   p1: {p.p1:.10e}", f"   p2: {p.p2:.10e}",
            "projection_parameters:",
            f"   fx: {p.fx:.10e}", f"   fy: {p.fy:.10e}",
            f"   cx: {p.cx:.10e}", f"   cy: {p.cy:.10e}",
        ]
    elif result.model == "kannala-brandt":
        lines += [
            "model_type: KANNALA_BRANDT",
            f"camera_name: {camera_name}",
            f"image_width: {p.width}", f"image_height: {p.height}",
            "projection_parameters:",
            f"   k2: {p.k2:.10e}", f"   k3: {p.k3:.10e}",
            f"   k4: {p.k4:.10e}", f"   k5: {p.k5:.10e}",
            f"   mu: {p.mu:.10e}", f"   mv: {p.mv:.10e}",
            f"   u0: {p.u0:.10e}", f"   v0: {p.v0:.10e}",
        ]
    elif result.model == "scaramuzza":
        # the reference's OCAM layout (ScaramuzzaCamera.cc:108-140)
        lines += [
            "model_type: scaramuzza",
            f"camera_name: {camera_name}",
            f"image_width: {p.width}", f"image_height: {p.height}",
            "poly_parameters:",
            *[f"   p{i}: {c:.10e}" for i, c in enumerate(p.poly)],
            "inv_poly_parameters:",
            *[f"   p{i}: {c:.10e}" for i, c in enumerate(p.inv_poly)],
            "affine_parameters:",
            f"   ac: {p.C:.10e}", f"   ad: {p.D:.10e}",
            f"   ae: {p.E:.10e}",
            f"   cx: {p.center_x:.10e}", f"   cy: {p.center_y:.10e}",
        ]
    else:
        lines += [
            "model_type: MEI",
            f"camera_name: {camera_name}",
            f"image_width: {p.width}", f"image_height: {p.height}",
            "mirror_parameters:",
            f"   xi: {p.xi:.10e}",
            "distortion_parameters:",
            f"   k1: {p.k1:.10e}", f"   k2: {p.k2:.10e}",
            f"   p1: {p.p1:.10e}", f"   p2: {p.p2:.10e}",
            "projection_parameters:",
            f"   gamma1: {p.gamma1:.10e}", f"   gamma2: {p.gamma2:.10e}",
            f"   u0: {p.u1:.10e}", f"   v0: {p.v1:.10e}",
        ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
