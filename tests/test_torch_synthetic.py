"""The port's synthetic sensor degradations and moving sphere
(``vins_rgbd_fast_torch/io/synthetic.py``) against the JAX package on the
same numpy inputs, the cases of ``tests/test_synthetic_degradation.py`` on
the port, and the pinhole renderer unchanged by the ray-grid refactor.

Tolerances: ``degrade_frame`` on the same float32 frame bit-exact for the
no-op configuration, exposure drift and the edge holes, the shear within
1e-5 relative (XLA fuses its blend into multiply-adds); with
JAX's draws injected the block dropouts exact and the noisy values within
1e-4 relative (JAX's normals are float64 under the suite's x64 setting).
The rendered sphere: depth within 1e-4 m of JAX's and the image within
0.05 grey levels (the two renderers' plane textures already differ by up
to 0.01).  ``frames_degraded`` with the bench's harsh preset and JAX's
draws: depth holes equal on ≥ 99.9 % of pixels, depth within 1e-4 m and
the image within 0.5 grey levels elsewhere (the read noise and shear carry
the renderers' difference).  Trajectories within 1e-12.  The pinhole
renderer bit-equal to the one before the refactor, kept below."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import tn, tt
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.utils import quaternion as tquat
from vins_rgbd_fast_tpu.io import synthetic as jsyn

W, H = 160, 120
RIG = dict(width=W, height=H, fx=115.0, fy=115.0, cx=80.0, cy=60.0)
TRIG, JRIG = tsyn.SyntheticRig(**RIG), jsyn.SyntheticRig(**RIG)
# bench.py's BENCH_DEGRADE=harsh preset
HARSH = dict(depth_sigma=0.006, hole_p=0.10, edge_hole=True, exposure_amp=0.3, read_noise=3.0,
             rs_shear_px=2.0, dyn_radius=0.5)


def _render_poses_before(rig, P_w, q_wc):
    """The port's pinhole renderer as it was before the ray grid was
    factored out (``render_poses``), the reference for bit-equality."""
    Hh, Ww = rig.height, rig.width
    dev, dt = P_w.device, P_w.dtype
    yy, xx = torch.meshgrid(torch.arange(Hh, dtype=dt, device=dev),
                            torch.arange(Ww, dtype=dt, device=dev), indexing="ij")
    xn = (xx - rig.cx) / rig.fx
    yn = (yy - rig.cy) / rig.fy
    if rig.has_distortion:
        from vins_rgbd_fast_torch.models.camera import _radtan_distort
        p_d = torch.stack([xn, yn], dim=-1)
        p_u = p_d - _radtan_distort(p_d, rig.k1, rig.k2, rig.p1, rig.p2)
        for _ in range(7):
            p_u = p_d - _radtan_distort(p_u, rig.k1, rig.k2, rig.p1, rig.p2)
        xn, yn = p_u[..., 0], p_u[..., 1]
    d_cam = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    # the rotation in the renderer's fixed order (a batched einsum's
    # arithmetic depends on the number of poses)
    R = tquat.q2R(q_wc)[:, None, None]
    d_w = (R[..., 0] * d_cam[..., 0:1] + R[..., 1] * d_cam[..., 1:2]
           + R[..., 2] * d_cam[..., 2:3])
    N = P_w.shape[0]
    best_t = torch.full((N, Hh, Ww), 1e9, dtype=dt, device=dev)
    best_i = torch.full((N, Hh, Ww), 255.0, dtype=dt, device=dev)
    for k, (n, off, ua, va) in enumerate(tsyn._PLANES):
        ax = int(np.argmax(np.abs(n)))
        denom = d_w[..., ax] * float(n[ax])
        t = (off - P_w[:, ax] * float(n[ax]))[:, None, None] / torch.where(
            torch.abs(denom) > 1e-9, denom, torch.full_like(denom, 1e-9))
        hit = P_w[:, None, None, :] + t[..., None] * d_w
        u = hit[..., int(np.argmax(ua))]
        v = hit[..., int(np.argmax(va))]
        tex = tsyn._plane_texture(u, v, seed=k) + 128.0
        ok = (t > 0.05) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, tex, best_i)
    depth = torch.where(best_t < 1e8, best_t, torch.zeros_like(best_t))
    return torch.clamp(best_i, 0.0, 255.0), depth


def _poses(seq, ks):
    poses = [tsyn.camera_pose(seq, k) for k in ks]
    return (tt(np.stack([p[0] for p in poses]), torch.float32),
            tt(np.stack([p[1] for p in poses]), torch.float32))


@pytest.mark.parametrize("radtan", [False, True], ids=["plain", "radtan"])
def test_render_poses_bit_equal_to_the_renderer_before(radtan):
    kw = dict(k1=0.13, k2=-0.27, p1=0.002, p2=-0.0004) if radtan else {}
    rig = tsyn.SyntheticRig(**RIG, **kw)
    P, Q = _poses(tsyn.make_trajectory(4, rig, seed=3), range(4))
    for new, old in zip(tsyn.render_poses(rig, P, Q), _render_poses_before(rig, P, Q)):
        assert torch.equal(new, old)
    _, im, dp = tsyn.render_sequence(tsyn.make_trajectory(4, rig, seed=3), rig, "cpu")
    assert torch.equal(im, _render_poses_before(rig, P, Q)[0])


def _jax_frame(k=1, seed=2):
    seq = tsyn.make_trajectory(3, TRIG, seed=seed)
    t_wc, q_wc = tsyn.camera_pose(seq, k)
    img, dep = jsyn.render_frame(JRIG, jnp.asarray(t_wc, jnp.float32),
                                 jnp.asarray(q_wc, jnp.float32))
    return float(seq.times[k]) + 0.4, np.asarray(img, np.float32), np.asarray(dep, np.float32)


@pytest.mark.parametrize("case", ["noop", "exposure", "shear", "edge_hole"])
def test_degrade_frame_matches_jax_exactly(case):
    deg = dict(noop={}, exposure=dict(exposure_amp=0.25), shear=dict(rs_shear_px=3.0),
               edge_hole=dict(edge_hole=True))[case]
    t, img, dep = _jax_frame()
    ji, jd = jsyn.degrade_frame(JRIG, jsyn.SensorDegradation(**deg), jnp.asarray(img),
                                jnp.asarray(dep), jax.random.PRNGKey(0), jnp.float32(t))
    ti, td = tsyn.degrade_frame(TRIG, tsyn.SensorDegradation(**deg), tt(img), tt(dep), t)
    assert ti.dtype == td.dtype == torch.float32
    ji = np.asarray(ji, np.float32)
    if case == "shear":
        assert np.all(np.abs(tn(ti) - ji) <= 1e-5 * np.maximum(1.0, np.abs(ji)))
        assert np.abs(tn(ti) - img).max() > 1.0  # the rows did move
    else:
        np.testing.assert_array_equal(tn(ti), ji)
    np.testing.assert_array_equal(tn(td), np.asarray(jd, np.float32))
    if case == "noop":
        np.testing.assert_array_equal(tn(ti), img)


def _jax_draws(key, deg):
    """The draws of JAX's ``degrade_frame`` from ``key``, as ``degrade_frame``
    takes them."""
    k1, k2, k3 = jax.random.split(key, 3)
    out = {}
    if deg.read_noise > 0:
        out["read_noise"] = tt(np.asarray(jax.random.normal(k1, (H, W))), torch.float32)
    if deg.depth_sigma > 0:
        out["depth_noise"] = tt(np.asarray(jax.random.normal(k2, (H, W))), torch.float32)
    if deg.hole_p > 0:
        out["holes"] = tt(np.asarray(jax.random.bernoulli(
            k3, deg.hole_p, ((H + 15) // 16, (W + 15) // 16))))
    return out


def test_degrade_frame_with_jax_draws_matches_jax():
    kw = dict(depth_sigma=0.01, hole_p=0.08, read_noise=2.0)
    t, img, dep = _jax_frame()
    key = jax.random.PRNGKey(7)
    ji, jd = jsyn.degrade_frame(JRIG, jsyn.SensorDegradation(**kw), jnp.asarray(img),
                                jnp.asarray(dep), key, jnp.float32(t))
    ti, td = tsyn.degrade_frame(TRIG, tsyn.SensorDegradation(**kw), tt(img), tt(dep), t,
                                **_jax_draws(key, tsyn.SensorDegradation(**kw)))
    ji, jd = np.asarray(ji), np.asarray(jd)
    np.testing.assert_array_equal(tn(td) == 0, jd == 0)
    assert (jd == 0).mean() > (dep == 0).mean()
    assert np.all(np.abs(tn(ti) - ji) <= 1e-4 * np.maximum(1.0, np.abs(ji)))
    assert np.all(np.abs(tn(td) - jd) <= 1e-4 * np.maximum(1.0, np.abs(jd)))


def test_degrade_frame_draws_from_its_generator():
    """Without injected draws the generator gives them, in a fixed order:
    the same seed, the same frame."""
    t, img, dep = _jax_frame()
    deg = tsyn.SensorDegradation(**HARSH)
    outs = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(5)
        outs.append(tsyn.degrade_frame(TRIG, deg, tt(img), tt(dep), t, g))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0][0], tt(img))


def test_dynamic_sphere_matches_jax():
    deg = dict(dyn_radius=0.6, dyn_orbit=1.5)
    seq = tsyn.make_trajectory(3, TRIG, seed=2)
    jdeg, tdeg = jsyn.SensorDegradation(**deg), tsyn.SensorDegradation(**deg)
    P, Q = _poses(seq, range(3))
    ctr = np.stack([tsyn.dyn_sphere_center(tdeg, t) for t in seq.times])
    for k, t in enumerate(seq.times):
        np.testing.assert_array_equal(ctr[k], jsyn.dyn_sphere_center(jdeg, t))
    ti, td = tsyn.render_rays(tsyn.ray_grid(TRIG, P.device, P.dtype), P, Q,
                              tt(ctr, torch.float32), 0.6)
    plain = tn(tsyn.render_poses(TRIG, P, Q)[1])
    for k in range(3):
        ji, jd = (np.asarray(a) for a in jsyn.render_frame_dynamic(
            JRIG, jnp.asarray(tn(P[k])), jnp.asarray(tn(Q[k])), jnp.asarray(ctr[k], jnp.float32),
            jnp.float32(0.6)))
        sphere = np.abs(plain[k] - jd) > 1e-3
        assert sphere.sum() > 100  # in view on every frame
        np.testing.assert_array_equal(np.abs(plain[k] - tn(td[k])) > 1e-3, sphere)
        assert np.abs(tn(td[k]) - jd).max() < 1e-4
        assert np.abs(tn(ti[k]) - ji).max() < 0.05


def test_frames_degraded_matches_jax_with_its_draws():
    seq = tsyn.make_trajectory(3, TRIG, seed=2)
    jdeg, tdeg = jsyn.SensorDegradation(**HARSH), tsyn.SensorDegradation(**HARSH)
    key = jax.random.PRNGKey(3)
    ref = list(jsyn.frames_degraded(seq, JRIG, jdeg, seed=3))
    port = list(tsyn.frames_degraded(
        seq, TRIG, tdeg, "cpu", draws=lambda k: _jax_draws(jax.random.fold_in(key, k), tdeg)))
    for (jt, ji, jd), (t, ti, td) in zip(ref, port):
        ji, jd, ti, td = np.asarray(ji), np.asarray(jd), tn(ti), tn(td)
        assert t == jt
        assert ((jd == 0) == (td == 0)).mean() >= 0.999
        both = (jd > 0) & (td > 0)
        assert np.abs(jd - td)[both].max() < 1e-4
        assert np.abs(ji - ti).max() < 0.5


# ---------------------------------------------------------------------------
# tests/test_synthetic_degradation.py's cases on the port
# ---------------------------------------------------------------------------

def test_noop_degradation_is_exact():
    seq = tsyn.make_trajectory(3, TRIG, seed=1)
    _, imgs, deps = tsyn.render_sequence(seq, TRIG, "cpu")
    for k, (_, i1, d1) in enumerate(tsyn.frames_degraded(seq, TRIG, tsyn.SensorDegradation(),
                                                         "cpu")):
        assert torch.equal(imgs[k], i1) and torch.equal(deps[k], d1)


def test_degradations_engage():
    seq = tsyn.make_trajectory(3, TRIG, seed=1)
    _, imgs, deps = tsyn.render_sequence(seq, TRIG, "cpu")
    cfg = tsyn.SensorDegradation(depth_sigma=0.01, hole_p=0.08, exposure_amp=0.25,
                                 read_noise=2.0, rs_shear_px=3.0)
    deg = list(tsyn.frames_degraded(seq, TRIG, cfg, "cpu", seed=3))
    i0, d0 = tn(imgs[1]), tn(deps[1])
    ia, da = tn(deg[1][1]), tn(deg[1][2])
    assert np.isfinite(ia).all() and np.isfinite(da).all()
    assert not np.allclose(i0, ia)
    assert (da == 0).mean() > (d0 == 0).mean()
    valid = (d0 > 0) & (da > 0)
    assert np.abs(da - d0)[valid].max() > 0
    assert ia.min() >= 0 and ia.max() <= 255


def test_dynamic_sphere_occludes_consistently():
    seq = tsyn.make_trajectory(2, TRIG, seed=2)
    cfg = tsyn.SensorDegradation(dyn_radius=0.6, dyn_orbit=1.5)
    _, imgs, deps = tsyn.render_sequence(seq, TRIG, "cpu")
    _, ia, da = next(tsyn.frames_degraded(seq, TRIG, cfg, "cpu"))
    d0, da, i0, ia = tn(deps[0]), tn(da), tn(imgs[0]), tn(ia)
    changed = ~np.isclose(d0, da)
    assert changed.any()  # the sphere is in view of frame 0
    assert (da[changed] < d0[changed] + 1e-3).all()
    assert not np.allclose(i0[changed], ia[changed])


def test_divergent_prefix_trajectories():
    s1 = tsyn.make_trajectory(10, TRIG, seed=5, diverge_seed=1, diverge_after=5)
    s2 = tsyn.make_trajectory(10, TRIG, seed=5, diverge_seed=2, diverge_after=5)
    base = tsyn.make_trajectory(10, TRIG, seed=5)
    np.testing.assert_allclose(s1.P[:6], s2.P[:6])
    np.testing.assert_allclose(s1.P[:6], base.P[:6])
    assert not np.allclose(s1.P[9], s2.P[9])
    t_cut = s1.times[5]
    imu1 = [(t, a, w) for (t, a, w) in s1.imu if t <= t_cut]
    imu2 = [(t, a, w) for (t, a, w) in s2.imu if t <= t_cut]
    assert len(imu1) == len(imu2)
    for (t1, a1, w1), (t2, a2, w2) in zip(imu1, imu2):
        assert t1 == t2
        np.testing.assert_allclose(a1, a2)
        np.testing.assert_allclose(w1, w2)


@pytest.mark.parametrize("diverge", [None, 1])
def test_make_trajectory_matches_jax(diverge):
    kw = dict(seed=5, diverge_seed=diverge, diverge_after=4)
    t, j = tsyn.make_trajectory(9, TRIG, **kw), jsyn.make_trajectory(9, JRIG, **kw)
    for f in ("times", "P", "Q", "V", "ric", "tic"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=0, atol=1e-12)
    for (ta, aa, wa), (tb, ab, wb) in zip(t.imu, j.imu):
        assert ta == tb
        np.testing.assert_allclose(aa, ab, rtol=0, atol=1e-12)
        np.testing.assert_allclose(wa, wb, rtol=0, atol=1e-12)
    assert [f.name for f in dataclasses.fields(tsyn.SensorDegradation)] == \
        [f.name for f in dataclasses.fields(jsyn.SensorDegradation)]
    assert tsyn.SensorDegradation() == tsyn.SensorDegradation(
        **dataclasses.asdict(jsyn.SensorDegradation()))


def test_harsh_stream_keeps_the_latency_pipeline_on_track():
    """chip_smoke phase 17 at 160×120 on the CPU: the latency stream through
    ``frames_degraded`` with the harsh preset, 16 warm-up and 24 timed
    frames, the ATE under ``tests/test_dynamic_scene.py``'s bound
    (max(0.08·travelled, 0.12 m)) and a feature flagged dynamic."""
    import chip_smoke
    res = chip_smoke.run_latency_path("cpu", n_frames=40, warmup=16, W=W, H=H, max_cnt=32,
                                      degrade=tsyn.SensorDegradation(**HARSH))
    chip_smoke.check_degraded_path(res, on_gpu=False)
