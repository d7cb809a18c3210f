"""CLAHE (``ops/image.clahe``) and the tracker's equalize and fisheye arms
(``frontend/feature_tracker.track_frame``) against the JAX package.

Tolerances: ``clahe`` within 1e-3 of JAX's on the 0-255 scale, jitted
(``jax.vmap`` for B = 2) and op by op (``jax.disable_jit``): the float32
cumulative sums and the LUT blend round differently where XLA fuses or
orders them otherwise (the largest difference seen is 1.5e-4; at 640×480
the histograms' sums are exact and the op-by-op results equal bit for
bit).  One ``track_frame`` step from a bridged JAX
state (B = 2, 320×240, radtan rig) is exact on ids, track counts, the
tracked count and the next id, uv within 1e-3 px (LK's float32 sums), with
``equalize`` given the same equalized frame JAX computed (a FAST corner at
a tie would flip on an ulp of the LUT), and with ``fisheye`` on the
analytic circle and on a mask file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import DISTORTION
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.config import TrackerConfig
from vins_rgbd_fast_torch.frontend import feature_tracker as tft
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.io.writers import write_png
from vins_rgbd_fast_torch.models.camera import PinholeCamera
from vins_rgbd_fast_torch.ops import image as timage
from vins_rgbd_fast_tpu.frontend import feature_tracker as jft
from vins_rgbd_fast_tpu.models.camera import make_camera
from vins_rgbd_fast_tpu.ops import image as jimage


def _frames(B, H, W, seed=0):
    """B frames in [0, 255]: smooth structure, texture and noise, with
    saturated patches (clipped histogram bins)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for b in range(B):
        img = (90 + 80 * np.sin(xx / (23.0 + 7 * b)) * np.cos(yy / 31.0)
               + 40 * (((xx // 16) + (yy // 16)) % 2) + rng.normal(0, 6, (H, W)))
        img[H // 3:H // 2, W // 4:W // 3] = 255.0
        out.append(np.clip(img, 0, 255))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("H,W", [(480, 640), (480, 848), (478, 638)])
def test_clahe_matches_jax(H, W):
    imgs = _frames(2, H, W)
    got = tn(timage.clahe(tt(imgs)))
    ref = np.asarray(jax.vmap(jimage.clahe)(jnp.asarray(imgs)))
    assert got.shape == imgs.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-3
    with jax.disable_jit():
        eager = np.asarray(jimage.clahe(jnp.asarray(imgs[1])))
    assert np.abs(got[1] - eager).max() <= 1e-3
    if (H, W) == (480, 640):  # clip limit 56.25: every float32 sum is exact
        np.testing.assert_array_equal(got[1], eager)
    th, tw = H // 8, W // 8  # the margin past the last whole tile is passed through
    np.testing.assert_array_equal(got[:, 8 * th:, :], imgs[:, 8 * th:, :])
    np.testing.assert_array_equal(got[:, :, 8 * tw:], imgs[:, :, 8 * tw:])
    assert np.abs(got[:, :8 * th, :8 * tw] - imgs[:, :8 * th, :8 * tw]).max() > 10.0


W, H, B = 320, 240, 2
CFG = dict(width=W, height=H, max_cnt=60, capacity=96, min_dist=15, grid_rows=3,
           grid_cols=4, fast_threshold=20.0, lk_max_iters=12, lk_coarse_iters=6)


@pytest.fixture(scope="module")
def scene():
    rig = tsyn.SyntheticRig(width=W, height=H, fx=230.0, fy=230.0, cx=160.0, cy=120.0,
                            **DISTORTION)
    cam_kw = dict(fx=rig.fx, fy=rig.fy, cx=rig.cx, cy=rig.cy, width=W, height=H, **DISTORTION)
    seqs = []
    for b in range(B):
        seq = tsyn.make_trajectory(3, rig, seed=100 + b, omega_scale=0.15, acc_scale=0.3)
        times, im, _ = tsyn.render_sequence(seq, rig, "cpu", 0, 2)
        (_, q0), (_, q1) = tsyn.camera_pose(seq, 0), tsyn.camera_pose(seq, 1)
        R = (tsyn._q2R(q1).T @ tsyn._q2R(q0)).astype(np.float32)  # cam1 <- cam0
        seqs.append((times, tn(im), R))
    return make_camera("PINHOLE", **cam_kw), PinholeCamera(**cam_kw), seqs


def _step_both(scene, monkeypatch, **opts):
    """Frame 0 then frame 1 through JAX's tracker; frame 1 through the port
    from JAX's state after frame 0.  Returns JAX's and the port's results."""
    jcam, tcam, seqs = scene
    jcfg = jft.TrackerConfig(lk_sampler="matmul", lk_engine="xla", **CFG, **opts)
    tcfg = TrackerConfig(**CFG, **opts)
    imgs, ts, Rs, states, refs, us = [], [], [], [], [], []
    for b, (times, im, R) in enumerate(seqs):
        s0 = jft.init_state(jcfg)
        s1, _ = jft.track_frame(jcfg, jcam, s0, jnp.asarray(im[0]), jnp.float32(times[0]),
                                jnp.eye(3, dtype=jnp.float32), jax.random.PRNGKey(b))
        key = jax.random.PRNGKey(10 + b)
        s2, out = jft.track_frame(jcfg, jcam, s1, jnp.asarray(im[1]), jnp.float32(times[1]),
                                  jnp.asarray(R), key)
        imgs.append(im[1])
        ts.append(np.float32(times[1]))
        Rs.append(R)
        states.append(jax.device_get(s1))
        refs.append(jax.device_get((s2, out)))
        us.append(jax_ransac_uniforms(key, jcfg.ransac_trials, jcfg.maxc))
    if tcfg.equalize:
        # the equalized frame JAX's tracker stored (its pyramid's level 0)
        jax_eq = np.stack([np.asarray(r[0].pyramid[0]) for r in refs])
        ours = tn(timage.clahe(tt(np.stack(imgs))))
        assert np.abs(ours - jax_eq).max() <= 1e-3
        monkeypatch.setattr(tft.image_ops, "clahe", lambda img: tt(jax_eq))
    new, out = tft.track_frame(tcfg, tcam, bridge.to_torch(bridge.stack(states)),
                               tt(np.stack(imgs)), tt(np.stack(ts)), tt(np.stack(Rs)),
                               tt(np.stack(us)))
    return refs, new, out, tcfg


def _assert_same(refs, new, out):
    for b in range(B):
        js2, jout = refs[b]
        ids = np.asarray(jout.features.ids)
        assert (ids >= 0).sum() >= 20 and int(jout.n_tracked) >= 10
        assert np.array_equal(tn(out.features.ids[b]), ids), b
        assert np.array_equal(tn(new.track_cnt[b]), np.asarray(js2.track_cnt)), b
        assert int(out.n_tracked[b]) == int(jout.n_tracked)
        assert int(new.next_id[b]) == int(js2.next_id)
        valid = ids >= 0
        assert np.abs(tn(out.features.uv[b]) - np.asarray(jout.features.uv))[valid].max() < 1e-3
        np.testing.assert_array_equal(tn(new.pyramid[0][b]), np.asarray(js2.pyramid[0]))


def test_track_frame_equalize_matches_jax(scene, monkeypatch):
    refs, new, out, _ = _step_both(scene, monkeypatch, equalize=True)
    _assert_same(refs, new, out)
    raw = scene[2][0][1][1]
    assert np.abs(tn(new.pyramid[0][0]) - raw).max() > 10.0  # the stored frame is equalized


@pytest.mark.parametrize("mask", ["circle", "file"])
def test_track_frame_fisheye_matches_jax(scene, monkeypatch, tmp_path, mask):
    opts = dict(fisheye=True, fisheye_radius_frac=0.4)
    if mask == "file":  # a non-circular field of view: the left 60 % minus a notch
        m = np.zeros((H // 2, W // 2), np.uint8)  # half size: resized to the frame
        m[:, : int(0.3 * W)] = 255
        m[H // 8:H // 4, W // 8:W // 4] = 0
        write_png(str(tmp_path / "mask.png"), m)
        opts["fisheye_mask_path"] = str(tmp_path / "mask.png")
    refs, new, out, tcfg = _step_both(scene, monkeypatch, **opts)
    _assert_same(refs, new, out)
    fov = tn(tft.fisheye_mask(tcfg, "cpu"))
    for b in range(B):
        ok = tn(out.features.ids[b]) >= 0
        px = np.clip(np.round(tn(out.features.uv[b])).astype(int), 0, [W - 1, H - 1])
        assert fov[px[ok, 1], px[ok, 0]].all()
        assert 0.2 < fov.mean() < 0.8
