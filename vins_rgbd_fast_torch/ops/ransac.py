"""Fixed-trial RANSAC: the fundamental matrix over a batch of sequences,
PnP from a pose guess over a batch of loop candidates or VO frames, and
PnP from DLT trials (twins of ``fundamental_ransac``, ``pnp_ransac_guess``,
``_pnp_dlt`` and ``pnp_ransac`` in ``vins_rgbd_fast_tpu/ops/ransac.py``).

The random numbers are an input: ``u`` holds one uniform per (trial,
point); trial k takes the 8 points of smallest ``u + 10·~valid``.  The JAX
package draws the same uniforms from PRNG keys, so a test can feed both
packages identical subsets; the runner draws them from a per-sequence
``torch.Generator``.  Singular solves give NaN (``inv_ex``), as
``jnp.linalg.inv`` does, instead of raising and synchronising.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import quaternion as quat


class RansacResult(NamedTuple):
    inliers: torch.Tensor    # (B, N) bool
    model: torch.Tensor      # (B, 3, 3)
    n_inliers: torch.Tensor  # (B,)
    ok: torch.Tensor         # (B,) bool


def inv_nan(M: torch.Tensor) -> torch.Tensor:
    """Batched inverse; NaN where the matrix is singular."""
    inv, info = torch.linalg.inv_ex(M)
    return torch.where((info == 0)[..., None, None], inv, torch.nan)


def _normalize_pts(p, w=None):
    """Hartley normalization over the second-last axis (weighted if w)."""
    if w is None:
        w = torch.ones_like(p[..., 0])
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mean = torch.sum(p * wn[..., None], dim=-2)
    d = torch.sum(wn * torch.linalg.norm(p - mean[..., None, :], dim=-1), dim=-1)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-9)
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack([torch.stack([s, z, -s * mean[..., 0]], -1),
                     torch.stack([z, s, -s * mean[..., 1]], -1),
                     torch.stack([z, z, o], -1)], -2)
    return (p - mean[..., None, :]) * s[..., None, None], T


def _smallest_eigvec(M, iters: int = 3):
    """Near-null eigenvector by inverse iteration on the jittered inverse."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    Binv = inv_nan(M + (1e-9 * tr + 1e-20)[..., None, None] * eye)
    v = torch.full(M.shape[:-1], 1.0 / math.sqrt(n), dtype=M.dtype, device=M.device)
    for _ in range(iters):
        v = (Binv @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def _rank2_project(F):
    u3 = _smallest_eigvec(F @ F.transpose(-1, -2), iters=4)
    v3 = _smallest_eigvec(F.transpose(-1, -2) @ F, iters=4)
    s3 = torch.sum(u3 * (F @ v3[..., None])[..., 0], dim=-1)
    return F - s3[..., None, None] * (u3[..., :, None] * v3[..., None, :])


def _eight_point(p1, p2, rank2: bool = True, w=None):
    p1n, T1 = _normalize_pts(p1, w)
    p2n, T2 = _normalize_pts(p2, w)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    Aw = A if w is None else A * w[..., None]
    M = Aw.transpose(-1, -2) @ A
    F = _smallest_eigvec(M).reshape(*M.shape[:-2], 3, 3)
    if rank2:
        F = _rank2_project(F)
    return T2.transpose(-1, -2) @ F @ T1


def _epipolar_err(F, p1, p2):
    """Symmetric point-to-epiline distance; F (..., 3, 3), p (..., N, 2)."""
    h1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    h2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    l2 = h1 @ F.transpose(-1, -2)
    l1 = h2 @ F
    num = torch.abs(torch.sum(h2 * l2, dim=-1))
    d2 = num / torch.clamp(torch.linalg.norm(l2[..., :2], dim=-1), min=1e-12)
    d1 = num / torch.clamp(torch.linalg.norm(l1[..., :2], dim=-1), min=1e-12)
    return torch.maximum(d1, d2)


def fundamental_ransac(u: torch.Tensor, p1, p2, valid, threshold: float = 1.0,
                       min_valid: int = 8) -> RansacResult:
    """F-matrix RANSAC for B sequences.

    ``u`` (B, n_trials, N) uniforms in [0, 1); ``p1``/``p2`` (B, N, 2);
    ``valid`` (B, N) bool."""
    dtype = p1.dtype
    n_valid = torch.sum(valid, dim=-1)
    score = u + (~valid).to(u.dtype)[:, None, :] * 10.0
    subsets = torch.topk(score, 8, dim=-1, largest=False, sorted=True).indices  # (B,T,8)

    def take(p):
        return torch.gather(p[:, None].expand(-1, subsets.shape[1], -1, -1), 2,
                            subsets[..., None].expand(-1, -1, -1, 2))

    Fs = _eight_point(take(p1), take(p2), rank2=False)  # (B, T, 3, 3)
    e = _epipolar_err(Fs, p1[:, None], p2[:, None])     # (B, T, N)
    counts = torch.sum((e < threshold) & valid[:, None], dim=-1)
    best = torch.argmax(counts, dim=-1)
    F = torch.gather(Fs, 1, best[:, None, None, None].expand(-1, 1, 3, 3))[:, 0]
    inliers = (_epipolar_err(F, p1, p2) < threshold) & valid

    # consensus refit: weighted 8-point over the whole inlier set, twice
    for _ in range(2):
        w = inliers.to(dtype)
        F_ref = _eight_point(p1, p2, rank2=True, w=w)
        inl_ref = (_epipolar_err(F_ref, p1, p2) < threshold) & valid
        better = ((torch.sum(inl_ref, -1) >= torch.sum(inliers, -1))
                  & (torch.sum(w, -1) >= 8)
                  & torch.all(torch.isfinite(F_ref).reshape(F_ref.shape[0], -1), dim=-1))
        F = torch.where(better[:, None, None], F_ref, F)
        inliers = torch.where(better[:, None], inl_ref, inliers)

    ok = n_valid >= min_valid
    inliers = torch.where(ok[:, None], inliers, valid)
    return RansacResult(inliers=inliers, model=F, n_inliers=torch.sum(inliers, -1), ok=ok)


def draw_uniforms(generators, n_trials: int, n: int, device,
                  dtype=torch.float32) -> torch.Tensor:
    """(B, n_trials, n) uniforms, one ``torch.Generator`` per sequence."""
    return torch.stack([torch.rand((n_trials, n), generator=g, device=device, dtype=dtype)
                        for g in generators])


# ---------------------------------------------------------------------------
# PnP from an initial guess (twin of ``_pnp_gn``/``pnp_ransac_guess``), the
# geometric verification of loop closure
# ---------------------------------------------------------------------------

class PnPResult(NamedTuple):
    inliers: torch.Tensor    # (C, N) bool
    model: torch.Tensor      # (C, 3, 4) [R | t], world -> camera
    n_inliers: torch.Tensor  # (C,)
    ok: torch.Tensor         # (C,) bool


def random_subsets(u: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """(..., T, k) indices: trial t takes the k points of smallest
    ``u + 10·~valid`` (``u`` (..., T, N) uniforms, ``valid`` (..., N))."""
    score = u + (~valid).to(u.dtype)[..., None, :] * 10.0
    return torch.topk(score, k, dim=-1, largest=False, sorted=True).indices


def reproj_err_norm(R, t, Pw, uv):
    """Normalized-plane reprojection error (..., N); 1e6 behind the camera."""
    pc = Pw @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    z = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    e = torch.linalg.norm(pc[..., :2] / z[..., None] - uv, dim=-1)
    return torch.where(pc[..., 2] <= 0, torch.full_like(e, 1e6), e)


def _solve6_nan(H, b):
    """H⁻¹ b for batched 6×6 systems; NaN where the factorization fails."""
    x, info = torch.linalg.solve_ex(H, b[..., None])
    return torch.where((info == 0)[..., None], x[..., 0], torch.nan)


PNP_TRIALS = 32        # trials of ``pnp_ransac_guess`` (loop checks, VO pose init)
PNP_DEPTH_WEIGHT = 0.5  # weight of the relative-depth rows against reprojection
PNP_REFINE_ITERS = 8    # Gauss-Newton steps per trial and per refit


def pnp_gn(Pw, uv, w, R0, t0, iters: int = 10, z_meas=None):
    """Weighted Gauss-Newton pose refinement (R ← exp(δθ)·R, t ← t + δt),
    batched over leading axes: Pw (..., N, 3), uv (..., N, 2), w (..., N),
    R0 (..., 3, 3), t0 (..., 3).  ``z_meas`` (..., N), the measured depths,
    adds the relative-depth rows ``PNP_DEPTH_WEIGHT·(z − z_m)/z_m``.  The
    Jacobian is the closed form of JAX's ``jacfwd`` at δ = 0; a non-finite
    or runaway (‖δ‖ > 1e3) update is dropped."""
    dtype = Pw.dtype
    eye6 = torch.eye(6, dtype=dtype, device=Pw.device)
    eye3 = torch.eye(3, dtype=dtype, device=Pw.device)
    if z_meas is not None:
        wz = w * torch.where((z_meas > 0.1) & (z_meas < 100.0),
                             torch.full_like(z_meas, PNP_DEPTH_WEIGHT), torch.zeros_like(z_meas))
        z_safe = torch.clamp(z_meas, min=0.1)
    R, t = R0, t0
    for _ in range(iters):
        q = Pw @ R.transpose(-1, -2)                     # (..., N, 3) rotated points
        pc = q + t[..., None, :]
        front = torch.abs(pc[..., 2]) > 1e-6
        z = torch.where(front, pc[..., 2], torch.full_like(pc[..., 2], 1e-6))
        r = (pc[..., :2] / z[..., None] - uv) * w[..., None]  # (..., N, 2)
        dz = torch.where(front, 1.0 / (z * z), torch.zeros_like(z))
        zero = torch.zeros_like(z)
        dproj = torch.stack([torch.stack([1.0 / z, zero, -pc[..., 0] * dz], -1),
                             torch.stack([zero, 1.0 / z, -pc[..., 1] * dz], -1)], -2)
        dpc = torch.cat([-quat.skew(q), eye3.expand(q.shape[:-1] + (3, 3))], -1)  # (..., N, 3, 6)
        J = (dproj @ dpc) * w[..., None, None]                               # (..., N, 2, 6)
        H = torch.einsum("...npa,...npb->...ab", J, J)
        g = torch.einsum("...npa,...np->...a", J, r)
        if z_meas is not None:
            rz = (pc[..., 2] - z_meas) / z_safe * wz
            Jz = dpc[..., 2, :] * (wz / z_safe)[..., None]
            H = H + torch.einsum("...na,...nb->...ab", Jz, Jz)
            g = g + torch.einsum("...na,...n->...a", Jz, rz)
        d = -_solve6_nan(H + 1e-8 * eye6, g)
        bad = ~torch.isfinite(d).all(-1) | (torch.linalg.norm(d, dim=-1) > 1e3)
        d = torch.where(bad[..., None], torch.zeros_like(d), d)
        R = quat.q2R(quat.so3_exp(d[..., 0:3])) @ R
        t = t + d[..., 3:6]
    return R, t


def pnp_ransac_guess(u: torch.Tensor, Pw, uv, valid, R_init, t_init,
                     threshold: float = 10.0 / 460.0, min_inliers: int = 10,
                     refine_iters: int = PNP_REFINE_ITERS) -> PnPResult:
    """PnP RANSAC around Gauss-Newton from a pose guess for C problems:
    ``u`` (C, T, N) uniforms (T trials, each refines on an 8-subset with
    ``refine_iters`` GN steps), Pw (C, N, 3) world points, ``uv`` (C, N,
    2|3) normalized observations (a third column: measured depths), valid
    (C, N), R_init (C, 3, 3), t_init (C, 3).  The best trial is re-refined
    on its inliers, then on its tight (3 px) inliers when there are enough
    of them; inliers count at ``threshold``."""
    dtype = Pw.dtype
    z_meas = uv[..., 2] if uv.shape[-1] == 3 else None
    uv = uv[..., :2]
    T = u.shape[-2]
    idx = random_subsets(u, valid, 8)                                     # (C, T, 8)
    w = torch.zeros(idx.shape[:-1] + (Pw.shape[-2],), dtype=dtype, device=Pw.device)
    w = w.scatter(-1, idx, 1.0) * valid[:, None].to(dtype)
    ex = (lambda a: a[:, None].expand((a.shape[0], T) + a.shape[1:]))
    R, t = pnp_gn(ex(Pw), ex(uv), w, ex(R_init), ex(t_init), iters=refine_iters,
                  z_meas=None if z_meas is None else ex(z_meas))
    counts = torch.sum((reproj_err_norm(R, t, ex(Pw), ex(uv)) < threshold) & valid[:, None], -1)
    best = torch.argmax(counts, dim=-1)
    ar = torch.arange(Pw.shape[0], device=Pw.device)
    R, t = R[ar, best], t[ar, best]
    inl0 = (reproj_err_norm(R, t, Pw, uv) < threshold) & valid
    R, t = pnp_gn(Pw, uv, inl0.to(dtype), R, t, iters=refine_iters, z_meas=z_meas)
    e = reproj_err_norm(R, t, Pw, uv)
    inliers = (e < threshold) & valid
    n_in = torch.sum(inliers, -1)
    tight = ((e < 3.0 / 460.0) & valid).to(dtype)
    R2, t2 = pnp_gn(Pw, uv, tight, R, t, iters=4, z_meas=z_meas)
    use2 = torch.sum(tight, -1) >= min(min_inliers, 12)
    R = torch.where(use2[:, None, None], R2, R)
    t = torch.where(use2[:, None], t2, t)
    return PnPResult(inliers=inliers, model=torch.cat([R, t[..., None]], -1),
                     n_inliers=n_in, ok=n_in >= min_inliers)


# ---------------------------------------------------------------------------
# PnP from DLT trials (twin of ``_pnp_dlt``/``pnp_ransac``)
# ---------------------------------------------------------------------------

def pnp_dlt(Pw, uv):
    """Pose from n >= 6 3D-2D pairs by DLT on the projection matrix,
    batched over leading axes: Pw (..., n, 3), uv (..., n, 2) normalized-
    plane observations.  Returns (R (..., 3, 3), t (..., 3)), camera <- world;
    the sign is chosen so that most points lie in front of the camera."""
    n = Pw.shape[-2]
    dtype = Pw.dtype
    Ph = torch.cat([Pw, torch.ones_like(Pw[..., :1])], dim=-1)
    zeros = torch.zeros_like(Ph)
    r1 = torch.cat([Ph, zeros, -uv[..., 0:1] * Ph], dim=-1)
    r2 = torch.cat([zeros, Ph, -uv[..., 1:2] * Ph], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2n, 12)
    P = _smallest_eigvec(A.transpose(-1, -2) @ A).reshape(*A.shape[:-2], 3, 4)

    def proper(U, Vh):  # U diag(1, 1, det(U Vh)) Vh, and det(U Vh)
        d = torch.linalg.det(U @ Vh)
        D = torch.ones(d.shape + (3,), dtype=dtype, device=Pw.device)
        D[..., 2] = d
        return (U * D[..., None, :]) @ Vh, d

    U, S, Vh = torch.linalg.svd(P[..., :3])
    R, detUV = proper(U, Vh)
    scale = torch.sum(S, dim=-1) / 3.0 * torch.sign(detUV)
    t = P[..., 3] / torch.clamp(torch.abs(scale), min=1e-12)[..., None] \
        * torch.sign(scale)[..., None]
    depth = (Pw @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    flip = torch.sum(depth > 0, dim=-1) < (n / 2)
    R = torch.where(flip[..., None, None], -R, R)
    U2, _, Vh2 = torch.linalg.svd(R)
    R, _ = proper(U2, Vh2)
    return R, torch.where(flip[..., None], -t, t)


def pnp_ransac(u: torch.Tensor, Pw, uv, valid, threshold: float = 10.0 / 460.0,
               min_inliers: int = 10) -> PnPResult:
    """PnP RANSAC from DLT trials for C problems: ``u`` (C, T, N) uniforms
    (trial t takes the 6 points of smallest ``u + 10·~valid``), Pw (C, N, 3),
    uv (C, N, 2), valid (C, N).  The best trial's model is returned as it
    is (no refit), with its inliers at ``threshold``."""
    idx = random_subsets(u, valid, 6)                                    # (C, T, 6)
    C, T = idx.shape[:2]

    def take(a):
        return torch.gather(a[:, None].expand(C, T, -1, -1), 2,
                            idx[..., None].expand(-1, -1, -1, a.shape[-1]))

    R, t = pnp_dlt(take(Pw), take(uv))
    ex = (lambda a: a[:, None].expand((C, T) + a.shape[1:]))
    counts = torch.sum((reproj_err_norm(R, t, ex(Pw), ex(uv)) < threshold) & valid[:, None], -1)
    best = torch.argmax(counts, dim=-1)
    ar = torch.arange(C, device=Pw.device)
    R, t = R[ar, best], t[ar, best]
    inliers = (reproj_err_norm(R, t, Pw, uv) < threshold) & valid
    n_in = torch.sum(inliers, -1)
    return PnPResult(inliers=inliers, model=torch.cat([R, t[..., None]], -1), n_inliers=n_in,
                     ok=n_in >= min_inliers)
