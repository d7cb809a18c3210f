"""Plain FAST-9/16 with 3×3 non-maximum suppression, the Gaussian pyramid
and pyramidal Lucas-Kanade, as the VINS-RGBD-FAST frontend defines them
(the same arithmetic, in the same order, as the program's plain versions,
so that a float32 run of either agrees with the other to rounding).

``dtype`` runs the arithmetic in another precision (the control: bfloat16).
LK also counts the Gauss-Newton steps it takes and the pixels its tiles
cover, the work that ``vinsbench/bounds.py`` turns into a kernel's bound.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (OpenCV ordering), (dy, dx)
FAST_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
ARC_LEN = 9
# LK as the tracker runs it: a 21 × 21 window, a search margin of 8, steps
# until |du| < 0.01 px, the min-eigenvalue gate 1e-4
WIN, SEARCH_MARGIN, EPS, MIN_EIG = 21, 8, 0.01, 1e-4
_BIG = float(2 ** 20)


def ring_differences(f: torch.Tensor) -> torch.Tensor:
    """(16, B, H, W): ring point k minus the centre; the image wraps."""
    ring = torch.stack([torch.roll(f, (-dy, -dx), dims=(-2, -1)) for dy, dx in FAST_OFFSETS])
    return ring - f[None]


def fast_nms(img: torch.Tensor, threshold: float, dtype=torch.float32) -> torch.Tensor:
    """(B, H, W) score map: the FAST-9/16 V-measure (the max over contiguous
    9-arcs of the arc's min ring difference, bright and dark apart) where it
    exceeds ``threshold``, 0 in the 3-px border, then kept only where it is
    the max of its 3×3 neighbourhood (outside the image counts as -inf)."""
    f = img.to(dtype)
    d = ring_differences(f)
    terms = []
    for x in (d, -d):
        x2 = torch.cat([x, x[:ARC_LEN - 1]])
        m = x2[:16]
        for k in range(1, ARC_LEN):
            m = torch.minimum(m, x2[k:k + 16])
        terms.append(m.amax(0))
    score = torch.maximum(*terms)
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    H, W = f.shape[-2:]
    yy = torch.arange(H, device=f.device)[:, None]
    xx = torch.arange(W, device=f.device)[None, :]
    inb = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    score = torch.where(inb, score, torch.zeros_like(score))
    m = F.max_pool2d(score.float()[:, None], 3, stride=1, padding=1)[:, 0].to(dtype)
    return torch.where((score >= m) & (score > 0), score, torch.zeros_like(score))


def _tap5(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(-2, n + 2, device=x.device), 0, n - 1)
    xp = x.index_select(dim, idx)

    def sl(off):
        return xp.narrow(dim, off, n)

    return (sl(0) + 4.0 * sl(1) + 6.0 * sl(2) + 4.0 * sl(3) + sl(4)) * (1.0 / 16.0)


def pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Separable [1 4 6 4 1]/16 with edge padding, then 2× decimation."""
    pyr = [img]
    for _ in range(levels - 1):
        x = _tap5(_tap5(pyr[-1], -2), -1)
        pyr.append(x[..., ::2, ::2].contiguous())
    return pyr


def floor_int(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.nan_to_num(x, nan=_BIG).clamp(-_BIG, _BIG)).to(torch.int32)


def gather_tiles(img, y0, x0, rows: int, cols: int, pad: int):
    """(B, N, rows, cols) tiles of the edge-padded image at padded origins."""
    B, H, W = img.shape
    r = torch.clamp(y0[..., None] + torch.arange(rows, device=img.device) - pad, 0, H - 1)
    c = torch.clamp(x0[..., None] + torch.arange(cols, device=img.device) - pad, 0, W - 1)
    flat = (r[..., :, None] * W + c[..., None, :]).reshape(B, -1).to(torch.int64)
    return img.reshape(B, H * W).gather(1, flat).reshape(*y0.shape, rows, cols)


class Level(NamedTuple):
    """What one level of one call did: its points, window anchors and the
    Gauss-Newton steps taken (for the kernel's bound)."""
    pts_l: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    steps: int
    iters: int


def lk_level(prev, cur, pts_l, flow, active, iters: int, check_border: bool):
    """One level: template, gradients and structure tensor from prev,
    ``iters`` done-masked Gauss-Newton steps in the search window of cur.
    Returns (u, status, steps taken, anchors)."""
    B, H, W = prev.shape
    dt = prev.dtype
    win, PS, WINS = WIN, WIN + 2, WIN + 1 + 2 * SEARCH_MARGIN
    pad = WINS
    half = (PS - 1) // 2
    q = pts_l + flow
    ax = torch.clamp(floor_int(q[..., 0]) + (pad - win // 2 - SEARCH_MARGIN), 0, W + 2 * pad - WINS)
    ay = torch.clamp(floor_int(q[..., 1]) + (pad - win // 2 - SEARCH_MARGIN), 0, H + 2 * pad - WINS)
    bx, by = floor_int(pts_l[..., 0]), floor_int(pts_l[..., 1])
    fxT = (pts_l[..., 0] - bx.to(dt))[..., None, None]
    fyT = (pts_l[..., 1] - by.to(dt))[..., None, None]
    x0 = torch.clamp(bx + pad - half, 0, W + 2 * pad - PS - 1)
    y0 = torch.clamp(by + pad - half, 0, H + 2 * pad - PS - 1)
    E = gather_tiles(prev, y0, x0, PS + 1, PS + 1, pad)
    Ey = E[..., :-1, :] * (1.0 - fyT) + E[..., 1:, :] * fyT
    pe = Ey[..., :-1] * (1.0 - fxT) + Ey[..., 1:] * fxT
    tmpl = pe[..., 1:-1, 1:-1]
    Ix = (pe[..., 1:-1, 2:] - pe[..., 1:-1, :-2]) * 0.5
    Iy = (pe[..., 2:, 1:-1] - pe[..., :-2, 1:-1]) * 0.5
    Gxx = torch.sum(Ix * Ix, dim=(-2, -1))
    Gxy = torch.sum(Ix * Iy, dim=(-2, -1))
    Gyy = torch.sum(Iy * Iy, dim=(-2, -1))
    det = Gxx * Gyy - Gxy * Gxy
    tr = Gxx + Gyy
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    ok_eig = eig_min / (win * win) >= MIN_EIG
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    wimg = gather_tiles(cur, ay, ax, WINS, WINS, pad)
    px = pts_l[..., 0] - (ax.to(dt) - pad) - win // 2
    py = pts_l[..., 1] - (ay.to(dt) - pad) - win // 2
    offs = torch.arange(win, device=prev.device, dtype=torch.int32)
    N = pts_l.shape[1]

    def sample(u):
        sx = torch.nan_to_num(px + u[..., 0], nan=_BIG).clamp(-_BIG, _BIG)
        sy = torch.nan_to_num(py + u[..., 1], nan=_BIG).clamp(-_BIG, _BIG)
        bxs, bys = torch.floor(sx), torch.floor(sy)
        fx = (sx - bxs)[..., None, None]
        fy = (sy - bys)[..., None, None]
        idy = bys.to(torch.int32)[..., None] + offs
        idx = bxs.to(torch.int32)[..., None] + offs

        def rows(i):
            ok = ((i >= 0) & (i < WINS)).to(dt)[..., None]
            g = torch.clamp(i, 0, WINS - 1).to(torch.int64)[..., None].expand(B, N, win, WINS)
            return wimg.gather(2, g), ok

        r0, m0 = rows(idy)
        r1, m1 = rows(idy + 1)
        RW = r0 * ((1.0 - fy) * m0) + r1 * (fy * m1)

        def cols(i):
            ok = ((i >= 0) & (i < WINS)).to(dt)[..., None, :]
            g = torch.clamp(i, 0, WINS - 1).to(torch.int64)[..., None, :].expand(B, N, win, win)
            return RW.gather(3, g), ok

        c0, n0 = cols(idx)
        c1, n1 = cols(idx + 1)
        return c0 * ((1.0 - fx) * n0) + c1 * (fx * n1)

    done = ~(active & ok_eig)
    u = flow
    steps = 0
    for _ in range(iters):
        steps += int((~done).sum())
        dI = sample(u) - tmpl
        bxv = torch.sum(dI * Ix, dim=(-2, -1))
        byv = torch.sum(dI * Iy, dim=(-2, -1))
        du = torch.stack([inv_det * (Gyy * bxv - Gxy * byv),
                          inv_det * (-Gxy * bxv + Gxx * byv)], dim=-1)
        u = torch.where(done[..., None], u, u - du)
        done = done | (torch.sum(du * du, dim=-1) < EPS * EPS)
    axf, ayf = ax.to(dt) - WINS, ay.to(dt) - WINS
    new = pts_l + u
    hb = win // 2
    status = active & ok_eig & ((new[..., 0] - hb >= axf) & (new[..., 0] + hb + 1 < axf + WINS)
                                & (new[..., 1] - hb >= ayf) & (new[..., 1] + hb + 1 < ayf + WINS))
    if check_border:
        status = status & ((new[..., 0] >= hb) & (new[..., 0] < W - hb)
                           & (new[..., 1] >= hb) & (new[..., 1] < H - hb))
    return u, status, steps, ax, ay


def pyramidal_lk(prev_pyr, cur_pyr, pts, init_pts, active, max_iters: int, coarse_iters: int):
    """Track ``pts`` (B, N, 2) from prev to cur, coarse to fine, started at
    ``init_pts``; the levels above 0 take at most ``coarse_iters`` steps.
    Returns (tracked (B, N, 2), status (B, N), [Level per level, finest
    last])."""
    levels = len(prev_pyr)
    flow = (init_pts - pts) / (2.0 ** (levels - 1))
    status = active
    done = []
    for l in range(levels - 1, -1, -1):
        pts_l = pts / (2.0 ** l)
        it = max_iters if (l == 0 or coarse_iters <= 0) else min(coarse_iters, max_iters)
        flow, st_l, steps, ax, ay = lk_level(prev_pyr[l], cur_pyr[l], pts_l, flow, active, it,
                                             check_border=(l == 0))
        done.append(Level(pts_l, ax, ay, steps, it))
        status = status & st_l
        if l > 0:
            flow = flow * 2.0
    return pts + flow, status, done
