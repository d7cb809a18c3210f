"""Pyramidal Lucas-Kanade optical flow over a batch of sequences (twin of
``vins_rgbd_fast_tpu/ops/lk.py``: the matmul sampler's level engines, and
the gather sampler's plain level ``track_level_gather``).

One pyramid level runs by one of three engines, as in JAX:
  * ``"pallas3"``: ``lk_level`` launches kernel K2 (``csrc/lk_level.cu``,
    the Hopper replacement of ``ops/lk_pallas3.py:lk_level_fused``), the
    whole level in one kernel: one warp per point, its template and
    gradients in registers, no block barrier (``win`` must be 21);
  * ``"pallas"``: ``level_patches`` (template, gradients, structure tensor
    and search window: plain gathers, the work JAX does outside its
    kernel) followed by ``lk_iterate``, the wrapper of kernel K3 (the
    iterate-only entry of ``csrc/lk_level.cu``, replacing
    ``ops/lk_pallas2.py:lk_iterate``), which runs K2's Gauss-Newton loop
    on the given patches: one block of 4 warps per point (``K3_WARPS``),
    its template and gradients in registers, no block-wide barrier
    (``win`` must be 21);
  * ``"xla"``: ``lk_level_plain``, CPU tensors only.
For CPU tensors every wrapper runs its plain version: ``lk_level_plain``
(= ``level_patches`` + ``lk_iterate_plain``), the port of
``_track_level_matmul`` with the selector matmuls written as masked
bilinear gathers (a selector row has at most two non-zero weights) and the
while-loop as the fixed-count done-masked loop of ``lk_pallas2``.

The gather sampler's level ``track_level_gather`` (JAX's
``_track_level_gather``) is a plain function on any device: JAX runs it as
XLA, not as a Pallas kernel, and no pipeline of either package uses it, so
``pyramidal_lk`` runs the matmul sampler only.  Its level has no
search window: each step samples a fresh bilinear patch of the level image
(edge-padded by PS//2 + 2) at ``p + u``, and its status is active & ok_eig
(& in-border at the finest level).

Level semantics of the matmul sampler (shared by every engine):
  * the level images are edge-padded by WIN = win + 1 + 2·search_margin;
    the template anchor is clamped to [0, Wp−PS−1] and the window anchor
    to [0, Wp−WIN] in padded coordinates — realised here by clamp-to-edge
    reads, so no padded copy is made;
  * every Gauss-Newton step samples win×win bilinearly inside the WIN×WIN
    window at ``p + u`` with ``p = pts_l − window origin − win//2`` taken
    once per level; samples that fall outside the window read 0;
  * status = active & ok_eig & in_win & in-border (finest level).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from .. import native

level_launches = native.LaunchCount()    # K2 launches (the CUDA path only), by device too
iterate_launches = native.LaunchCount()  # K3 launches (the CUDA path only), by device too
K2_WIN = 21           # K2's and K3's compile-time patch side (both pipelines run 21)
MAX_WIN = 48          # the largest search window K2 and K3 take
K3_WARPS = 4          # K3's warps per point (``K3_WARPS`` of csrc/lk_level.cu)
_BIG = float(2 ** 20)  # sample coordinates are clamped here before floor()


class LKResult(NamedTuple):
    pts: torch.Tensor     # (B, N, 2) tracked positions, level-0 coords
    status: torch.Tensor  # (B, N) bool
    err: torch.Tensor     # (B, N) mean abs residual of the final patch


class LevelPatches(NamedTuple):
    tmpl: torch.Tensor     # (B, N, win, win) bilinear template
    Ix: torch.Tensor       # (B, N, win, win) central-difference gradients
    Iy: torch.Tensor
    win_img: torch.Tensor  # (B, N, WIN, WIN) search window of cur
    Gxx: torch.Tensor      # (B, N) structure tensor
    Gxy: torch.Tensor
    Gyy: torch.Tensor
    inv_det: torch.Tensor  # (B, N)
    ok_eig: torch.Tensor   # (B, N) bool min-eigenvalue gate
    px: torch.Tensor       # (B, N) patch origin at u = 0, window coords
    py: torch.Tensor


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


def batched_subpix_patches(img_padded: torch.Tensor, pts: torch.Tensor, size: int,
                           pad: int) -> torch.Tensor:
    """(N, size, size) bilinear patches centred at ``pts`` (N, 2) of an
    image already padded by ``pad`` (twin of ``_batched_subpix_patches``):
    the patch origin is clamped into the padded image, then the rows and
    the columns are blended in that order, as the JAX row-strip and
    column-selector formulation does (a selector column holds two weights)."""
    Hp, Wp = img_padded.shape
    half = (size - 1) // 2
    base = torch.floor(pts)
    fx = (pts[:, 0] - base[:, 0])[:, None, None]
    fy = (pts[:, 1] - base[:, 1])[:, None, None]
    x0 = torch.clamp(base[:, 0].to(torch.int64) + (pad - half), 0, Wp - size - 1)
    y0 = torch.clamp(base[:, 1].to(torch.int64) + (pad - half), 0, Hp - size - 1)
    offs = torch.arange(size + 1, device=pts.device)
    E = img_padded[(y0[:, None] + offs)[:, :, None], (x0[:, None] + offs)[:, None, :]]
    Ey = E[:, :-1, :] * (1.0 - fy) + E[:, 1:, :] * fy
    return Ey[:, :, :-1] * (1.0 - fx) + Ey[:, :, 1:] * fx


def level_patches(prev, cur, pts_l, ax, ay, win: int, search_margin: int,
                  min_eig: float) -> LevelPatches:
    """Everything of one level outside the GN loop (``ops/lk.py:139-163``
    and ``:193`` of the JAX package)."""
    B, H, W = prev.shape
    dtype = prev.dtype
    PS = win + 2
    WIN = win + 1 + 2 * search_margin
    pad = WIN
    Hp, Wp = H + 2 * pad, W + 2 * pad
    half = (PS - 1) // 2

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
    px = pts_l[..., 0] - (ax.to(dtype) - pad) - win // 2
    py = pts_l[..., 1] - (ay.to(dtype) - pad) - win // 2
    return LevelPatches(tmpl.contiguous(), Ix.contiguous(), Iy.contiguous(), win_img,
                        Gxx, Gxy, Gyy, inv_det, ok_eig, px, py)


def lk_iterate_plain(tmpl, Ix, Iy, win_img, px, py, u0, done0, inv_det, Gxx, Gxy, Gyy,
                     iters: int, eps: float):
    """Plain version of K3: ``iters`` done-masked Gauss-Newton steps from
    ``u0`` and the mean |final sample − template|.  Returns (u (B, N, 2),
    err (B, N))."""
    B, N, win, _ = tmpl.shape
    WIN = win_img.shape[-1]
    dtype = tmpl.dtype
    offs = torch.arange(win, device=tmpl.device, dtype=torch.int32)

    def sample(u):
        sx = torch.nan_to_num(px + u[..., 0], nan=_BIG).clamp(-_BIG, _BIG)
        sy = torch.nan_to_num(py + u[..., 1], nan=_BIG).clamp(-_BIG, _BIG)
        bxs = torch.floor(sx)
        bys = torch.floor(sy)
        fx = (sx - bxs)[..., None, None]
        fy = (sy - bys)[..., None, None]
        idy = bys.to(torch.int32)[..., None] + offs  # (B, N, win)
        idx = bxs.to(torch.int32)[..., None] + offs

        def rows(i):
            ok = ((i >= 0) & (i < WIN)).to(dtype)[..., None]
            g = torch.clamp(i, 0, WIN - 1).to(torch.int64)[..., None].expand(B, N, win, WIN)
            return win_img.gather(2, g), ok

        r0, m0 = rows(idy)
        r1, m1 = rows(idy + 1)
        RW = r0 * ((1.0 - fy) * m0) + r1 * (fy * m1)  # (B, N, win, WIN)

        def cols(i):
            ok = ((i >= 0) & (i < WIN)).to(dtype)[..., None, :]
            g = torch.clamp(i, 0, WIN - 1).to(torch.int64)[..., None, :].expand(B, N, win, win)
            return RW.gather(3, g), ok

        c0, n0 = cols(idx)
        c1, n1 = cols(idx + 1)
        return c0 * ((1.0 - fx) * n0) + c1 * (fx * n1)

    done = done0
    u = u0
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
    return u, err


def lk_level_plain(prev, cur, pts_l, flow, active, ax, ay, win: int,
                   search_margin: int, iters: int, eps: float, min_eig: float):
    """Plain PyTorch LK level (the plain version of K2).  Returns
    (u (B,N,2), ok_eig (B,N), err (B,N))."""
    p = level_patches(prev, cur, pts_l, ax, ay, win, search_margin, min_eig)
    u, err = lk_iterate_plain(p.tmpl, p.Ix, p.Iy, p.win_img, p.px, p.py, flow,
                              ~(active & p.ok_eig), p.inv_det, p.Gxx, p.Gxy, p.Gyy,
                              iters, eps)
    return u, p.ok_eig, err


def _lk_level_cuda(prev, cur, pts_l, flow, active, ax, ay, win, search_margin,
                   iters, eps, min_eig):
    B, H, W = prev.shape
    N = pts_l.shape[1]
    WIN = win + 1 + 2 * search_margin
    if win != K2_WIN or search_margin < 0 or WIN > MAX_WIN:
        raise ValueError(f"lk_level: the kernel takes win={K2_WIN} and a search window "
                         f"of at most {MAX_WIN} (got win={win}, "
                         f"search_margin={search_margin})")
    f32, i32 = torch.float32, torch.int32
    native.check_args("lk_level", prev, (
        ("prev", prev, f32, (B, H, W)), ("cur", cur, f32, (B, H, W)),
        ("pts_l", pts_l, f32, (B, N, 2)), ("flow", flow, f32, (B, N, 2)),
        ("active", active, torch.bool, (B, N)),
        ("ax", ax, i32, (B, N)), ("ay", ay, i32, (B, N))))
    u = torch.empty((B, N, 2), dtype=f32, device=prev.device)
    ok = torch.empty((B, N), dtype=torch.bool, device=prev.device)
    err = torch.empty((B, N), dtype=f32, device=prev.device)
    native.launch("lk_level_launch", prev.device,
                  prev.data_ptr(), cur.data_ptr(), pts_l.data_ptr(), flow.data_ptr(),
                  active.data_ptr(), ax.data_ptr(), ay.data_ptr(), u.data_ptr(),
                  ok.data_ptr(), err.data_ptr(), B, N, H, W, win, search_margin, iters,
                  float(eps) * float(eps), float(min_eig))
    level_launches.add(prev.device.index)
    return u, ok, err


def _lk_iterate_cuda(tmpl, Ix, Iy, win_img, px, py, u0, done0, inv_det, Gxx, Gxy, Gyy,
                     iters, eps):
    B, N, win, _ = tmpl.shape
    WIN = win_img.shape[-1]
    if win != K2_WIN or WIN > MAX_WIN:
        raise ValueError(f"lk_iterate: the kernel takes win={K2_WIN} and a search window "
                         f"of at most {MAX_WIN} (got win={win}, WIN={WIN})")
    f32 = torch.float32
    pw, pn = (B, N, win, win), (B, N)
    native.check_args("lk_iterate", tmpl, (
        ("tmpl", tmpl, f32, pw), ("Ix", Ix, f32, pw), ("Iy", Iy, f32, pw),
        ("win", win_img, f32, (B, N, WIN, WIN)), ("px", px, f32, pn), ("py", py, f32, pn),
        ("u0", u0, f32, (B, N, 2)), ("done0", done0, torch.bool, pn),
        ("inv_det", inv_det, f32, pn), ("Gxx", Gxx, f32, pn), ("Gxy", Gxy, f32, pn),
        ("Gyy", Gyy, f32, pn)))
    u = torch.empty((B, N, 2), dtype=f32, device=tmpl.device)
    err = torch.empty((B, N), dtype=f32, device=tmpl.device)
    native.launch("lk_iterate_launch", tmpl.device,
                  tmpl.data_ptr(), Ix.data_ptr(), Iy.data_ptr(), win_img.data_ptr(),
                  px.data_ptr(), py.data_ptr(), u0.data_ptr(), done0.data_ptr(),
                  inv_det.data_ptr(), Gxx.data_ptr(), Gxy.data_ptr(), Gyy.data_ptr(),
                  u.data_ptr(), err.data_ptr(), B, N, win, WIN, iters,
                  float(eps) * float(eps))
    iterate_launches.add(tmpl.device.index)
    return u, err


def lk_iterate(tmpl, Ix, Iy, win_img, px, py, u0, done0, inv_det, Gxx, Gxy, Gyy,
               iters: int, eps: float):
    """K3's wrapper: the GN loop of one level for B×N points; returns
    (u (B, N, 2), err (B, N))."""
    args = (tmpl, Ix, Iy, win_img, px, py, u0, done0, inv_det, Gxx, Gxy, Gyy, iters, eps)
    if tmpl.device.type == "cpu":
        return lk_iterate_plain(*args)
    if tmpl.device.type == "cuda":
        return _lk_iterate_cuda(*[a.contiguous() for a in args[:12]], iters, eps)
    raise ValueError(f"lk_iterate: unsupported device {tmpl.device}")


def lk_level(prev, cur, pts_l, flow, active, win: int, max_iters: int,
             eps: float, min_eig: float, check_border: bool,
             search_margin: int = 8, engine: str = "pallas3"):
    """One LK pyramid level for B×N points by ``engine`` ("pallas3": K2,
    "pallas": patches + K3, "xla": the plain level, CPU only); returns
    (u, status, err)."""
    B, H, W = prev.shape
    dev = prev.device.type
    if engine == "xla" and dev != "cpu":
        raise ValueError("lk_level: engine 'xla' (the plain level) runs on CPU "
                         "tensors only; use 'pallas' or 'pallas3' on the card")
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"lk_level: unsupported device {prev.device}")
    ax, ay = window_anchor(pts_l, flow, H, W, win, search_margin)
    if engine == "pallas":
        p = level_patches(prev, cur, pts_l, ax, ay, win, search_margin, min_eig)
        u, err = lk_iterate(p.tmpl, p.Ix, p.Iy, p.win_img, p.px, p.py, flow,
                            ~(active & p.ok_eig), p.inv_det, p.Gxx, p.Gxy, p.Gyy,
                            max_iters, eps)
        ok_eig = p.ok_eig
    elif engine == "xla" or (engine == "pallas3" and dev == "cpu"):
        u, ok_eig, err = lk_level_plain(prev, cur, pts_l, flow, active, ax, ay,
                                        win, search_margin, max_iters, eps, min_eig)
    elif engine == "pallas3":
        u, ok_eig, err = _lk_level_cuda(
            prev.contiguous(), cur.contiguous(), pts_l.contiguous(),
            flow.contiguous(), active.contiguous(), ax, ay, win,
            search_margin, max_iters, eps, min_eig)
    else:
        raise ValueError(f"lk_level: unknown engine {engine!r}")
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


def track_level_gather(prev, cur, pts_l, flow, active, win: int, max_iters: int,
                       eps: float, min_eig: float, check_border: bool):
    """The gather sampler's LK level (twin of ``_track_level_gather``):
    template and gradients from a (win + 2)² bilinear patch of prev, then
    ``max_iters`` done-masked Gauss-Newton steps, each on a bilinear
    patch of cur at ``pts_l + u``.  Returns (u (B, N, 2), status, err)."""
    B, H, W = prev.shape
    dtype = prev.dtype
    PS = win + 2
    pad = PS // 2 + 2
    half = (PS - 1) // 2

    def patch(img, p):  # (B, N, PS, PS), JAX's _subpix_patch on the padded level
        base_x, base_y = _floor_int(p[..., 0]), _floor_int(p[..., 1])
        fx = (p[..., 0] - base_x.to(dtype))[..., None, None]
        fy = (p[..., 1] - base_y.to(dtype))[..., None, None]
        x0 = torch.clamp(base_x + pad - half, 0, W + 2 * pad - PS - 1)
        y0 = torch.clamp(base_y + pad - half, 0, H + 2 * pad - PS - 1)
        t = _gather_tiles(img, y0, x0, PS + 1, PS + 1, pad)
        return (t[..., :-1, :-1] * (1 - fy) * (1 - fx) + t[..., :-1, 1:] * (1 - fy) * fx
                + t[..., 1:, :-1] * fy * (1 - fx) + t[..., 1:, 1:] * fy * fx)

    pe = patch(prev, pts_l)
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

    u, done = flow, ~(active & ok_eig)
    for _ in range(max_iters):
        dI = patch(cur, pts_l + u)[..., 1:-1, 1:-1] - tmpl
        bx = torch.sum(dI * Ix, dim=(-2, -1))
        by = torch.sum(dI * Iy, dim=(-2, -1))
        du = torch.stack([inv_det * (Gyy * bx - Gxy * by),
                          inv_det * (-Gxy * bx + Gxx * by)], dim=-1)
        u = torch.where(done[..., None], u, u - du)
        done = done | (torch.sum(du * du, dim=-1) < eps * eps)
    err = torch.mean(torch.abs(patch(cur, pts_l + u)[..., 1:-1, 1:-1] - tmpl), dim=(-2, -1))
    status = active & ok_eig
    if check_border:
        new_pos = pts_l + u
        hb = win // 2
        status = status & ((new_pos[..., 0] >= hb) & (new_pos[..., 0] < W - hb)
                           & (new_pos[..., 1] >= hb) & (new_pos[..., 1] < H - hb))
    return u, status, err


def pyramidal_lk(prev_pyr: List[torch.Tensor], cur_pyr: List[torch.Tensor],
                 pts, init_pts, active, win: int = 21, max_iters: int = 30,
                 eps: float = 0.01, min_eig: float = 1e-4,
                 coarse_iters: int = 0, engine: str = "auto") -> LKResult:
    """Track pts (B, N, 2) from prev to cur coarse→fine, warm-started at
    ``init_pts``; ``coarse_iters`` caps the iterations of levels > 0.
    ``engine``: "pallas3" (K2), "pallas" (patches + K3), "xla" (the plain
    level, CPU only); "auto" is "pallas"."""
    eng = "pallas" if engine == "auto" else engine
    levels = len(prev_pyr)
    flow = (init_pts - pts) / (2.0 ** (levels - 1))
    status = active
    err = torch.zeros_like(pts[..., 0])
    for l in range(levels - 1, -1, -1):
        pts_l = pts / (2.0 ** l)
        iters_l = max_iters if (l == 0 or coarse_iters <= 0) else min(coarse_iters, max_iters)
        flow, status_l, err = lk_level(prev_pyr[l], cur_pyr[l], pts_l, flow, active,
                                       win, iters_l, eps, min_eig, check_border=(l == 0),
                                       engine=eng)
        status = status & status_l
        if l > 0:
            flow = flow * 2.0
    return LKResult(pts=pts + flow, status=status, err=err)
