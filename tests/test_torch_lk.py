"""Parity of the port's LK level (plain versions of kernels K2 and K3) and
``pyramidal_lk`` with the JAX matmul-sampler path, the Pallas v2 iteration
kernel and the Pallas v3 level kernel in interpret mode, batched over B = 2.

Tolerances: status equal; u, tracked points and err within 1e-3 (float32
sums over the 21×21 patch are taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import tn, tt
from vins_rgbd_fast_torch.ops import image as timage
from vins_rgbd_fast_torch.ops import lk as tlk
from vins_rgbd_fast_tpu.ops import image as jimage
from vins_rgbd_fast_tpu.ops import lk as jlk
from vins_rgbd_fast_tpu.ops import lk_pallas2

H, W = 120, 160


def _inputs():
    """The images and points of test_frontend_ops' LK kernel tests, plus a
    second sequence with another shift: (imgs0, imgs1 (2, H, W), pts (2, 24, 2),
    active (2, 24))."""
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    img0 = 120 + 50 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
    imgs1 = [120 + 50 * np.sin((xx - 1.4) / 7.0) * np.cos((yy + 0.8) / 9.0),
             120 + 50 * np.sin((xx + 2.1) / 7.0) * np.cos((yy - 1.7) / 9.0)]
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(15, 145, 24), rng.uniform(15, 105, 24)], -1)
    pts[0] = [11.0, 11.0]      # near the border
    pts[1] = [-40.0, 200.0]    # far out: a diverged track
    pts2 = np.stack([rng.uniform(5, 155, 24), rng.uniform(5, 115, 24)], -1)
    act = np.ones((2, 24), bool)
    act[0, 2] = False
    imgs0 = np.stack([img0, img0]).astype(np.float32)
    return (imgs0, np.stack(imgs1).astype(np.float32),
            np.stack([pts, pts2]).astype(np.float32), act)


@pytest.mark.parametrize("engine", ["xla", "pallas3", "pallas"])
def test_pyramidal_lk_matches_jax(engine):
    imgs0, imgs1, pts, act = _inputs()
    init = pts + np.float32(0.5)
    out = tlk.pyramidal_lk(timage.build_pyramid(tt(imgs0), 2),
                           timage.build_pyramid(tt(imgs1), 2), tt(pts), tt(init), tt(act),
                           max_iters=8, coarse_iters=4, engine=engine)
    for b in range(2):
        p0 = tuple(jimage.build_pyramid(jnp.asarray(imgs0[b]), 2))
        p1 = tuple(jimage.build_pyramid(jnp.asarray(imgs1[b]), 2))
        ref = jlk.pyramidal_lk(p0, p1, jnp.asarray(pts[b]), jnp.asarray(init[b]),
                               jnp.asarray(act[b]), max_iters=8, coarse_iters=4,
                               sampler="matmul", engine=engine,
                               engine_interpret=(engine != "xla"))
        ok = np.asarray(ref.status)
        assert np.array_equal(tn(out.status[b]), ok), b
        assert ok.sum() >= 15
        assert np.abs(tn(out.pts[b]) - np.asarray(ref.pts))[ok].max() < 1e-3
        assert np.abs(tn(out.err[b]) - np.asarray(ref.err))[ok].max() < 1e-3


def test_lk_level_matches_track_level_matmul():
    """One level with a non-trivial warm start, against the JAX level
    function directly (u, status and err)."""
    imgs0, imgs1, pts, act = _inputs()
    rng = np.random.default_rng(11)
    flow = rng.normal(0, 2.0, pts.shape).astype(np.float32)
    flow[:, 3] = [30.0, -25.0]  # a start outside the search margin
    u, st, err = tlk.lk_level(tt(imgs0), tt(imgs1), tt(pts), tt(flow), tt(act), 21, 12,
                              0.01, 1e-4, check_border=True)
    for b in range(2):
        ju, jst, jerr = jlk._track_level_matmul(
            jnp.asarray(imgs0[b]), jnp.asarray(imgs1[b]), jnp.asarray(pts[b]),
            jnp.asarray(flow[b]), jnp.asarray(act[b]), 21, 12, 0.01, 1e-4, True)
        ok = np.asarray(jst)
        assert np.array_equal(tn(st[b]), ok), b
        assert np.abs(tn(u[b]) - np.asarray(ju))[ok].max() < 1e-3
        assert np.abs(tn(err[b]) - np.asarray(jerr))[ok].max() < 1e-3


def test_window_anchor_clamps_like_jax():
    """Window origins are clamped to [0, Wp−WIN] in padded coordinates."""
    pts = np.array([[[-500.0, 3.0], [5.0, 900.0], [80.0, 60.0]]], np.float32)
    ax, ay = tlk.window_anchor(tt(pts), tt(np.zeros_like(pts)), H, W, 21, 8)
    WIN = 21 + 1 + 16
    assert tn(ax).tolist() == [[0, 0 + 5 + WIN - 10 - 8, 80 + WIN - 18]]
    assert tn(ay).tolist() == [[3 + WIN - 18, H + 2 * WIN - WIN, 60 + WIN - 18]]


def test_lk_iterate_matches_jax_lk_pallas2():
    """K3's plain version against ``lk_pallas2.lk_iterate`` in interpret
    mode on the same numpy inputs: real patches of one level, two rows that
    start done and one whose warm start lies far outside its window."""
    imgs0, imgs1, pts, act = _inputs()
    win, sm, iters, eps, min_eig = 21, 8, 8, 0.01, 1e-4
    WIN = win + 1 + 2 * sm
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 1.5, pts.shape).astype(np.float32)
    ax, ay = tlk.window_anchor(tt(pts), tt(flow), H, W, win, sm)
    p = tlk.level_patches(tt(imgs0), tt(imgs1), tt(pts), ax, ay, win, sm, min_eig)
    done0 = ~(tt(act) & p.ok_eig)
    done0[:, 4] = True
    done0[1, 5] = True
    u0 = tt(flow)
    u0[:, 6] = torch.tensor([40.0, -35.0])  # diverged: every sample leaves the window
    assert not bool(done0[:, 6].any())
    u, err = tlk.lk_iterate_plain(p.tmpl, p.Ix, p.Iy, p.win_img, p.px, p.py, u0, done0,
                                  p.inv_det, p.Gxx, p.Gxy, p.Gyy, iters, eps)
    for b in range(2):
        ju, jerr = lk_pallas2.lk_iterate(
            *[jnp.asarray(tn(a[b]), jnp.float32) for a in (p.tmpl, p.Ix, p.Iy, p.win_img,
                                                           p.px, p.py, u0)],
            jnp.asarray(tn(done0[b])),
            *[jnp.asarray(tn(a[b]), jnp.float32) for a in (p.inv_det, p.Gxx, p.Gxy, p.Gyy)],
            w=win, WIN=WIN, iters=iters, eps=eps, interpret=True)
        ju, jerr = np.asarray(ju), np.asarray(jerr)
        assert np.array_equal(tn(u[b])[tn(done0[b])], tn(u0[b])[tn(done0[b])])  # done rows stay
        assert np.abs(tn(u[b]) - ju).max() < 1e-3, b
        assert np.abs(tn(err[b]) - jerr).max() < 1e-3, b
        assert np.all(np.isfinite(jerr)) and tn(err[b])[6] > 10.0  # the zero samples' error


def test_lk_iterate_and_plain_engine_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; the plain
    level ("xla") is not allowed off the CPU either."""
    t = torch.zeros((1, 1, 21, 21), device="meta")
    s = torch.zeros((1, 1), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tlk.lk_iterate(t, t, t, torch.zeros((1, 1, 38, 38), device="meta"), s, s,
                       torch.zeros((1, 1, 2), device="meta"), s.bool(), s, s, s, s, 4, 0.01)
    img = torch.zeros((1, 40, 40), device="meta")
    pts = torch.zeros((1, 3, 2), device="meta")
    with pytest.raises(ValueError, match="'xla'"):
        tlk.pyramidal_lk([img], [img], pts, pts, torch.ones((1, 3), dtype=torch.bool,
                                                            device="meta"), engine="xla")


PITCH = 53  # K3's row pitch of the window in shared memory


def _k3_emulate(tmpl, Ix, Iy, win_img, px, py, u0, done0, inv_det, Gxx, Gxy, Gyy, iters,
                eps, nw):
    """Plain-torch emulation of K3's indexing with ``nw`` warps per point:
    the window at a row pitch of 53; thread t takes samples t + 32·nw·k at
    offset r·53 + c, the last k masked past 441; the unmasked path where
    ibx, iby ≥ 0 and ibx + 21, iby + 21 < WIN, clamped taps and masks
    otherwise; per thread two partial sums (even and odd k) in the kernel's
    order, an xor-butterfly per warp, then the warps in order.  Returns u,
    err and, per pass, whether each point took the unmasked path, whether
    every tap of the masked path lay inside the window, and which points
    were not done."""
    B, N, w, _ = tmpl.shape
    WIN = win_img.shape[-1]
    S, T = w * w, 32 * nw
    NK = -(-S // T)
    wn = torch.zeros((B, N, WIN, PITCH))
    wn[..., :WIN] = win_img
    wn = wn.reshape(B, N, WIN * PITCH)
    i = torch.arange(T)[:, None] + T * torch.arange(NK)  # (T, NK)
    valid = i < S
    iv = torch.where(valid, i, 0)
    r, c = iv // w, iv % w
    off = r * PITCH + c

    def per_thread(x):  # (B, N, w, w) -> (B, N, T, NK), 0 past 441
        return torch.where(valid, x.reshape(B, N, S)[..., iv], torch.zeros(()))

    tm, gx, gy = per_thread(tmpl), per_thread(Ix), per_thread(Iy)
    lane = torch.arange(32)

    def point_sum(v):  # (B, N, T) -> (B, N): butterflies, then warps in order
        v = v.reshape(B, N, nw, 32)
        for o in (16, 8, 4, 2, 1):
            v = v + v[..., lane ^ o]
        assert torch.equal(v, v[..., :1].expand_as(v))  # every lane the same bits
        s = v[..., 0, 0]
        for q in range(1, nw):
            s = s + v[..., q, 0]
        return s

    def gather(q):
        return wn.gather(2, q.clamp(0, WIN * PITCH - 1).reshape(B, N, -1)).reshape(q.shape)

    def samples(ux, uy):
        sx = torch.nan_to_num(px + ux, nan=2.0 ** 20).clamp(-2.0 ** 20, 2.0 ** 20)
        sy = torch.nan_to_num(py + uy, nan=2.0 ** 20).clamp(-2.0 ** 20, 2.0 ** 20)
        bx, by = torch.floor(sx), torch.floor(sy)
        fx, fy = (sx - bx)[..., None, None], (sy - by)[..., None, None]
        ibx, iby = bx.to(torch.int64), by.to(torch.int64)
        fast = (ibx >= 0) & (iby >= 0) & (ibx + w < WIN) & (iby + w < WIN)

        def blend(v00, v10, v01, v11):
            return (v00 * (1 - fy) + v10 * fy) * (1 - fx) + (v01 * (1 - fy) + v11 * fy) * fx

        q = (iby * PITCH + ibx)[..., None, None] + off
        v_fast = blend(gather(q), gather(q + PITCH), gather(q + 1), gather(q + PITCH + 1))
        iy, ix = iby[..., None, None] + r, ibx[..., None, None] + c
        my0, my1 = (iy >= 0) & (iy < WIN), (iy + 1 >= 0) & (iy + 1 < WIN)
        mx0, mx1 = (ix >= 0) & (ix < WIN), (ix + 1 >= 0) & (ix + 1 < WIN)
        y0, y1 = iy.clamp(0, WIN - 1) * PITCH, (iy + 1).clamp(0, WIN - 1) * PITCH
        x0, x1 = ix.clamp(0, WIN - 1), (ix + 1).clamp(0, WIN - 1)
        zero = torch.zeros(())
        v_masked = blend(torch.where(my0 & mx0, gather(y0 + x0), zero),
                         torch.where(my1 & mx0, gather(y1 + x0), zero),
                         torch.where(my0 & mx1, gather(y0 + x1), zero),
                         torch.where(my1 & mx1, gather(y1 + x1), zero))
        inside = ((my0 & my1 & mx0 & mx1) | ~valid).all(-1).all(-1)
        return torch.where(fast[..., None, None], v_fast, v_masked), fast, inside

    def thread_sums(terms):  # (B, N, T, NK) -> (B, N, T), the kernel's order
        a = [torch.zeros((B, N, T)), torch.zeros((B, N, T))]
        for k in range(NK):
            a[k & 1] = a[k & 1] + torch.where(valid[:, k], terms[..., k], torch.zeros(()))
        return a[0] + a[1]

    ux, uy = u0[..., 0].clone(), u0[..., 1].clone()
    done = done0.clone()
    paths = []
    for _ in range(iters):
        v, fast, inside = samples(ux, uy)
        paths.append((fast, inside, ~done))
        dI = v - tm
        bx, by = point_sum(thread_sums(dI * gx)), point_sum(thread_sums(dI * gy))
        dux = inv_det * (Gyy * bx - Gxy * by)
        duy = inv_det * (-Gxy * bx + Gxx * by)
        ux = torch.where(done, ux, ux - dux)
        uy = torch.where(done, uy, uy - duy)
        done = done | (dux * dux + duy * duy < eps * eps)
    v, _, _ = samples(ux, uy)
    err = point_sum(thread_sums((v - tm).abs())) / S
    return torch.stack([ux, uy], -1), err, paths


@pytest.mark.parametrize("nw", [1, 2, 4])
def test_k3_indexing_matches_lk_iterate_plain(nw):
    """K3's sample ownership, pitch-53 offsets, path choice and summation
    order, emulated in plain torch, against ``lk_iterate_plain`` on real
    patches: warm starts inside, on and just past the window edge, two rows
    that start done and one whose warm start lies far outside its window.
    The unmasked path is taken exactly where every tap lies inside the
    window, and both paths are exercised."""
    imgs0, imgs1, pts, act = _inputs()
    win, sm, iters, eps, min_eig = 21, 8, 8, 0.01, 1e-4
    WIN = win + 1 + 2 * sm
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 1.5, pts.shape).astype(np.float32)
    ax, ay = tlk.window_anchor(tt(pts), tt(flow), H, W, win, sm)
    p = tlk.level_patches(tt(imgs0), tt(imgs1), tt(pts), ax, ay, win, sm, min_eig)
    done0 = ~(tt(act) & p.ok_eig)
    done0[:, 4] = True
    done0[1, 5] = True
    u0 = tt(flow)
    u0[:, 6] = torch.tensor([40.0, -35.0])  # diverged: every sample leaves the window
    # patch origins (window coordinates) on and past the edges of the
    # unmasked path: ibx = 0, WIN - 22 (last unmasked), WIN - 21 and -1
    for n, x in ((7, 0.0), (8, WIN - 22 + 0.25), (9, WIN - 21 + 0.5), (10, -0.5)):
        u0[:, n, 0] = x - p.px[:, n]
        u0[:, n, 1] = 8.5 - p.py[:, n]
        done0[:, n] = False
    args = (p.tmpl, p.Ix, p.Iy, p.win_img, p.px, p.py, u0, done0, p.inv_det, p.Gxx, p.Gxy,
            p.Gyy, iters, eps)
    u_ref, err_ref = tlk.lk_iterate_plain(*args)
    u, err, paths = _k3_emulate(*args, nw=nw)
    assert torch.abs(u - u_ref).max() < 1e-3
    assert torch.abs(err - err_ref).max() < 1e-3
    assert torch.equal(u[done0], u0[done0])
    fast = torch.cat([f[m] for f, _, m in paths])
    inside = torch.cat([i[m] for _, i, m in paths])
    assert torch.equal(fast, inside)
    assert bool(fast.any()) and bool((~fast).any())
    # the edge starts: ibx = 0 and WIN - 22 unmasked, WIN - 21 and -1 masked
    assert paths[0][0][:, 7:11].tolist() == [[True, True, False, False]] * 2
