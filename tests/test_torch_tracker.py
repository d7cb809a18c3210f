"""One ``track_frame`` step of the port from a bridged JAX ``TrackerState``,
against the JAX tracker on the same rendered frames, with the JAX RANSAC
draws injected (B = 2, 160×120, radtan rig, MAXC = 48).

Tolerances: feature ids, track counts and the tracked count exact; uv
within 1e-3 px (LK flow is a float32 Gauss-Newton sum)."""

import jax
import jax.numpy as jnp
import numpy as np

from tests.torch_parity import tn, tt
from chip_smoke import DISTORTION
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.config import TrackerConfig
from vins_rgbd_fast_torch.frontend import feature_tracker as tft
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.models.camera import PinholeCamera
from vins_rgbd_fast_tpu.frontend import feature_tracker as jft
from vins_rgbd_fast_tpu.models.camera import make_camera

W, H, B = 160, 120, 2
CFG = dict(width=W, height=H, max_cnt=32, capacity=48, min_dist=8, grid_rows=3,
           grid_cols=4, fast_threshold=20.0, lk_max_iters=12, lk_coarse_iters=6)


def jax_ransac_uniforms(key, n_trials, n):
    """The uniforms ``ops/ransac.py:_random_subsets`` draws from ``key``."""
    keys = jax.random.split(key, n_trials)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


def test_track_frame_matches_jax_from_bridged_state():
    rig = tsyn.SyntheticRig(width=W, height=H, fx=115.0, fy=115.0, cx=80.0, cy=60.0,
                            **DISTORTION)
    jcfg = jft.TrackerConfig(lk_sampler="matmul", lk_engine="xla", **CFG)
    tcfg = TrackerConfig(**CFG)
    cam_kw = dict(fx=rig.fx, fy=rig.fy, cx=rig.cx, cy=rig.cy, width=W, height=H, **DISTORTION)
    jcam = make_camera("PINHOLE", **cam_kw)
    tcam = PinholeCamera(**cam_kw)

    imgs, ts, Rs, states, refs, us = [], [], [], [], [], []
    for b in range(B):
        seq = tsyn.make_trajectory(3, rig, seed=100 + b, omega_scale=0.15, acc_scale=0.3)
        times, im, _ = tsyn.render_sequence(seq, rig, "cpu", 0, 2)
        im = tn(im)
        (_, q0), (_, q1) = tsyn.camera_pose(seq, 0), tsyn.camera_pose(seq, 1)
        R = (tsyn._q2R(q1).T @ tsyn._q2R(q0)).astype(np.float32)  # cam1 <- cam0
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

    port_state = bridge.to_torch(bridge.stack(states))
    new, out = tft.track_frame(tcfg, tcam, port_state, tt(np.stack(imgs)), tt(np.stack(ts)),
                               tt(np.stack(Rs)), tt(np.stack(us)))
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
        assert np.abs(tn(out.features.pts[b]) - np.asarray(jout.features.pts))[valid].max() < 1e-5
