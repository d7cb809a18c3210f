"""Fixed-trial fundamental-matrix RANSAC over a batch of sequences (twin of
``fundamental_ransac`` in ``vins_rgbd_fast_tpu/ops/ransac.py``).

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
