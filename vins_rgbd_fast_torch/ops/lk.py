"""Pyramidal Lucas-Kanade optical flow over a batch of sequences (twin of
the matmul-sampler path of ``vins_rgbd_fast_tpu/ops/lk.py``).

One pyramid level is ``lk_level``, the wrapper of kernel K2
(``csrc/lk_level.cu``, the Hopper replacement of
``ops/lk_pallas3.py:lk_level_fused``).  For CPU tensors it runs
``lk_level_plain``, the port of ``_track_level_matmul``: the same
semantics with the selector matmuls written as masked bilinear gathers
(a selector row has at most two non-zero weights) and the while-loop as a
fixed-count done-masked loop.

Level semantics (shared by both versions):
  * the level images are edge-padded by WIN = win + 1 + 2·search_margin;
    the template anchor is clamped to [0, Wp−PS−1] and the window anchor
    to [0, Wp−WIN] in padded coordinates — realised here by clamp-to-edge
    reads, so no padded copy is made;
  * every Gauss-Newton step samples win×win bilinearly inside the WIN×WIN
    window; samples that fall outside the window read 0;
  * status = active & ok_eig & in_win & in-border (finest level).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from .. import native

launches = 0  # K2 launches (the CUDA path only)
_BIG = float(2 ** 20)  # sample coordinates are clamped here before floor()


class LKResult(NamedTuple):
    pts: torch.Tensor     # (B, N, 2) tracked positions, level-0 coords
    status: torch.Tensor  # (B, N) bool
    err: torch.Tensor     # (B, N) mean abs residual of the final patch


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    """floor() as int32 with NaN/absurd values sent far outside any image."""
    return torch.floor(torch.nan_to_num(x, nan=_BIG).clamp(-_BIG, _BIG)).to(torch.int32)


def window_anchor(pts_l, flow, H: int, W: int, win: int, search_margin: int):
    """Search-window origin (ax, ay) in padded coordinates, (B, N) int32."""
    WIN = win + 1 + 2 * search_margin
    pad = WIN
    q = pts_l + flow
    ax = torch.clamp(_floor_int(q[..., 0]) + (pad - win // 2 - search_margin),
                     0, W + 2 * pad - WIN)
    ay = torch.clamp(_floor_int(q[..., 1]) + (pad - win // 2 - search_margin),
                     0, H + 2 * pad - WIN)
    return ax.contiguous(), ay.contiguous()


def _gather_tiles(img, y0, x0, rows: int, cols: int, pad: int):
    """(B, N, rows, cols) tiles of the edge-padded image at padded origins
    (y0, x0), read from the unpadded image with clamp-to-edge."""
    B, H, W = img.shape
    r = torch.clamp(y0[..., None] + torch.arange(rows, device=img.device) - pad, 0, H - 1)
    c = torch.clamp(x0[..., None] + torch.arange(cols, device=img.device) - pad, 0, W - 1)
    flat = (r[..., :, None] * W + c[..., None, :]).reshape(B, -1).to(torch.int64)
    return img.reshape(B, H * W).gather(1, flat).reshape(*y0.shape, rows, cols)


def lk_level_plain(prev, cur, pts_l, flow, active, ax, ay, win: int,
                   search_margin: int, iters: int, eps: float, min_eig: float):
    """Plain PyTorch LK level.  Returns (u (B,N,2), ok_eig (B,N), err (B,N))."""
    B, H, W = prev.shape
    dtype = prev.dtype
    PS = win + 2
    WIN = win + 1 + 2 * search_margin
    pad = WIN
    Hp, Wp = H + 2 * pad, W + 2 * pad
    half = (PS - 1) // 2
    hw = win // 2

    # template patch + central-difference gradients
    bx = _floor_int(pts_l[..., 0])
    by = _floor_int(pts_l[..., 1])
    fxT = (pts_l[..., 0] - bx.to(dtype))[..., None, None]
    fyT = (pts_l[..., 1] - by.to(dtype))[..., None, None]
    x0 = torch.clamp(bx + pad - half, 0, Wp - PS - 1)
    y0 = torch.clamp(by + pad - half, 0, Hp - PS - 1)
    E = _gather_tiles(prev, y0, x0, PS + 1, PS + 1, pad)
    Ey = E[..., :-1, :] * (1.0 - fyT) + E[..., 1:, :] * fyT
    pe = Ey[..., :-1] * (1.0 - fxT) + Ey[..., 1:] * fxT  # (B, N, PS, PS)
    tmpl = pe[..., 1:-1, 1:-1]
    Ix = (pe[..., 1:-1, 2:] - pe[..., 1:-1, :-2]) * 0.5
    Iy = (pe[..., 2:, 1:-1] - pe[..., :-2, 1:-1]) * 0.5
    Gxx = torch.sum(Ix * Ix, dim=(-2, -1))
    Gxy = torch.sum(Ix * Iy, dim=(-2, -1))
    Gyy = torch.sum(Iy * Iy, dim=(-2, -1))
    det = Gxx * Gyy - Gxy * Gxy
    tr = Gxx + Gyy
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    ok_eig = eig_min / (win * win) >= min_eig
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))

    win_img = _gather_tiles(cur, ay, ax, WIN, WIN, pad)  # (B, N, WIN, WIN)
    axf = ax.to(dtype) - pad
    ayf = ay.to(dtype) - pad
    offs = torch.arange(win, device=prev.device, dtype=torch.int32)

    def sample(u):
        sx = torch.nan_to_num(pts_l[..., 0] + u[..., 0] - axf - hw, nan=_BIG).clamp(-_BIG, _BIG)
        sy = torch.nan_to_num(pts_l[..., 1] + u[..., 1] - ayf - hw, nan=_BIG).clamp(-_BIG, _BIG)
        bxs = torch.floor(sx)
        bys = torch.floor(sy)
        fx = (sx - bxs)[..., None, None]
        fy = (sy - bys)[..., None, None]
        idy = bys.to(torch.int32)[..., None] + offs  # (B, N, win)
        idx = bxs.to(torch.int32)[..., None] + offs

        def rows(i):
            ok = ((i >= 0) & (i < WIN)).to(dtype)[..., None]
            g = torch.clamp(i, 0, WIN - 1).to(torch.int64)[..., None].expand(B, -1, win, WIN)
            return win_img.gather(2, g), ok

        r0, m0 = rows(idy)
        r1, m1 = rows(idy + 1)
        RW = r0 * ((1.0 - fy) * m0) + r1 * (fy * m1)  # (B, N, win, WIN)

        def cols(i):
            ok = ((i >= 0) & (i < WIN)).to(dtype)[..., None, :]
            g = torch.clamp(i, 0, WIN - 1).to(torch.int64)[..., None, :].expand(B, -1, win, win)
            return RW.gather(3, g), ok

        c0, n0 = cols(idx)
        c1, n1 = cols(idx + 1)
        return c0 * ((1.0 - fx) * n0) + c1 * (fx * n1)

    done = ~(active & ok_eig)
    u = flow
    eps2 = eps * eps
    for _ in range(iters):
        dI = sample(u) - tmpl
        bxv = torch.sum(dI * Ix, dim=(-2, -1))
        byv = torch.sum(dI * Iy, dim=(-2, -1))
        du = torch.stack([inv_det * (Gyy * bxv - Gxy * byv),
                          inv_det * (-Gxy * bxv + Gxx * byv)], dim=-1)
        u = torch.where(done[..., None], u, u - du)
        done = done | (torch.sum(du * du, dim=-1) < eps2)
    err = torch.mean(torch.abs(sample(u) - tmpl), dim=(-2, -1))
    return u, ok_eig, err


def _lk_level_cuda(prev, cur, pts_l, flow, active, ax, ay, win, search_margin,
                   iters, eps, min_eig):
    global launches
    B, H, W = prev.shape
    N = pts_l.shape[1]
    PS = win + 2
    WIN = win + 1 + 2 * search_margin
    if PS + 1 > 33 or WIN > 48:
        raise ValueError(f"lk_level: win={win}, search_margin={search_margin} "
                         "exceed the kernel's shared-memory tiles")
    for name, t, dt, shape in (
            ("prev", prev, torch.float32, (B, H, W)),
            ("cur", cur, torch.float32, (B, H, W)),
            ("pts_l", pts_l, torch.float32, (B, N, 2)),
            ("flow", flow, torch.float32, (B, N, 2)),
            ("active", active, torch.bool, (B, N)),
            ("ax", ax, torch.int32, (B, N)), ("ay", ay, torch.int32, (B, N))):
        if t.device != prev.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"lk_level: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {prev.device}")
    u = torch.empty((B, N, 2), dtype=torch.float32, device=prev.device)
    ok = torch.empty((B, N), dtype=torch.bool, device=prev.device)
    err = torch.empty((B, N), dtype=torch.float32, device=prev.device)
    stream = torch.cuda.current_stream(prev.device).cuda_stream
    native.check(native.lib().lk_level_launch(
        prev.data_ptr(), cur.data_ptr(), pts_l.data_ptr(), flow.data_ptr(),
        active.data_ptr(), ax.data_ptr(), ay.data_ptr(), u.data_ptr(),
        ok.data_ptr(), err.data_ptr(), B, N, H, W, win, search_margin, iters,
        float(eps) * float(eps), float(min_eig), stream), "lk_level")
    launches += 1
    return u, ok, err


def lk_level(prev, cur, pts_l, flow, active, win: int, max_iters: int,
             eps: float, min_eig: float, check_border: bool,
             search_margin: int = 8):
    """One LK pyramid level for B×N points; returns (u, status, err)."""
    B, H, W = prev.shape
    ax, ay = window_anchor(pts_l, flow, H, W, win, search_margin)
    if prev.device.type == "cpu":
        u, ok_eig, err = lk_level_plain(prev, cur, pts_l, flow, active, ax, ay,
                                        win, search_margin, max_iters, eps, min_eig)
    elif prev.device.type == "cuda":
        u, ok_eig, err = _lk_level_cuda(
            prev.contiguous(), cur.contiguous(), pts_l.contiguous(),
            flow.contiguous(), active.contiguous(), ax, ay, win,
            search_margin, max_iters, eps, min_eig)
    else:
        raise ValueError(f"lk_level: unsupported device {prev.device}")
    status = level_status(pts_l, u, ok_eig, active, ax, ay, H, W, win, search_margin,
                          check_border)
    return u, status, err


def level_status(pts_l, u, ok_eig, active, ax, ay, H: int, W: int, win: int,
                 search_margin: int, check_border: bool):
    """active & ok_eig & in-window (& in-border at the finest level)."""
    WIN = win + 1 + 2 * search_margin
    axf = ax.to(u.dtype) - WIN
    ayf = ay.to(u.dtype) - WIN
    new_pos = pts_l + u
    hb = win // 2
    in_win = ((new_pos[..., 0] - hb >= axf) & (new_pos[..., 0] + hb + 1 < axf + WIN)
              & (new_pos[..., 1] - hb >= ayf) & (new_pos[..., 1] + hb + 1 < ayf + WIN))
    status = active & ok_eig & in_win
    if check_border:
        status = status & ((new_pos[..., 0] >= hb) & (new_pos[..., 0] < W - hb)
                           & (new_pos[..., 1] >= hb) & (new_pos[..., 1] < H - hb))
    return status


def pyramidal_lk(prev_pyr: List[torch.Tensor], cur_pyr: List[torch.Tensor],
                 pts, init_pts, active, win: int = 21, max_iters: int = 30,
                 eps: float = 0.01, min_eig: float = 1e-4,
                 coarse_iters: int = 0) -> LKResult:
    """Track pts (B, N, 2) from prev to cur coarse→fine, warm-started at
    ``init_pts``; ``coarse_iters`` caps the iterations of levels > 0."""
    levels = len(prev_pyr)
    flow = (init_pts - pts) / (2.0 ** (levels - 1))
    status = active
    err = torch.zeros_like(pts[..., 0])
    for l in range(levels - 1, -1, -1):
        pts_l = pts / (2.0 ** l)
        iters_l = max_iters if (l == 0 or coarse_iters <= 0) else min(coarse_iters, max_iters)
        flow, status_l, err = lk_level(prev_pyr[l], cur_pyr[l], pts_l, flow, active,
                                       win, iters_l, eps, min_eig, check_border=(l == 0))
        status = status & status_l
        if l > 0:
            flow = flow * 2.0
    return LKResult(pts=pts + flow, status=status, err=err)
