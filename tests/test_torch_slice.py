"""The port's batched frame step against the JAX package over 3 steady
frames from a JAX-warmed state, and the port's own warm + run against
ground truth (B = 2, 160×120 radtan rig, max_cnt 32).

The JAX side warms each sequence in lock step (tracker → depth lookup →
``fill_step`` for frames 0..10, then ``init_full``), the states are
bridged into the port, and both packages run ``fused_frame_step`` on the
same frames with the same RANSAC draws.  Tolerance: per-frame newest
position within 5 mm of JAX's.  The self-warmed run keeps the ATE bound of
``test_batched_pipeline.py``: max(0.05·travelled, 0.08 m)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.frontend import feature_tracker as jft
from vins_rgbd_fast_tpu.models.camera import make_camera
from vins_rgbd_fast_tpu.parallel import batched_pipeline as jbp

W, H, B, MAX_CNT, STEADY = 160, 120, 2, 32, 3


def _jax_configs(tcfg, ecfg, cam):
    jtcfg = jft.TrackerConfig(
        width=tcfg.width, height=tcfg.height, max_cnt=tcfg.max_cnt, capacity=tcfg.capacity,
        min_dist=tcfg.min_dist, grid_rows=tcfg.grid_rows, grid_cols=tcfg.grid_cols,
        f_threshold=tcfg.f_threshold, fast_threshold=tcfg.fast_threshold,
        lk_sampler="matmul", lk_engine="xla", lk_max_iters=12, lk_coarse_iters=6)
    jecfg = jest.EstimatorConfig(
        maxf=ecfg.maxf, max_imu=ecfg.max_imu, fix_depth=ecfg.fix_depth,
        depth_min_dist=ecfg.depth_min_dist, depth_max_dist=ecfg.depth_max_dist,
        min_parallax=ecfg.min_parallax, g_norm=ecfg.g_norm, acc_n=ecfg.acc_n,
        gyr_n=ecfg.gyr_n, acc_w=ecfg.acc_w, gyr_w=ecfg.gyr_w, max_iters=ecfg.max_iters)
    jcam = make_camera("PINHOLE", fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, k1=cam.k1,
                       k2=cam.k2, p1=cam.p1, p2=cam.p2, width=W, height=H)
    return jtcfg, jecfg, jcam


def jax_steady_frames(B: int, steady: int):
    """B sequences warmed by the JAX package in lock step, then ``steady``
    frames of its ``fused_frame_step``; returns the port's runner and
    staged batch (frames 0 .. 10 + steady), the bridged warmed states and
    per steady frame JAX's RANSAC uniforms (B, trials, maxc) and newest
    positions (B, 3), with the sequences."""
    rig, tcfg, ecfg, cam = chip_smoke.slice_config(W, H, MAX_CNT)
    runner = tbp.BatchedVioRunner(tcfg, cam, ecfg, "cpu", B)
    tcfg = runner.tcfg
    jtcfg, jecfg, jcam = _jax_configs(tcfg, ecfg, cam)
    n = 11 + steady
    seqs, rendered, bufs = chip_smoke.make_sequences(rig, B, n, "cpu")
    batch = tbp.stage_frames([r[1] for r in rendered], [r[2] for r in rendered],
                             [r[0] for r in rendered], bufs, 0, n, "cpu")
    frames = jax.tree.map(lambda t: np.asarray(tn(t), np.float32), tuple(batch))

    # the JAX package's own jitted programs (track_frame, fill_step,
    # init_full, vio_step), so the steady step reuses the warm-up's tracker
    track = functools.partial(jft.track_frame, jtcfg, jcam)
    fill = functools.partial(jest.fill_step, jecfg)
    init = functools.partial(jest.init_full, jecfg)
    step = functools.partial(jbp.fused_frame_step, jtcfg, jcam, jecfg)
    relR = jax.jit(jbp.gyro_relative_R)

    jtrk, jst = [], []
    for b in range(B):
        trk = jft.init_state(jtcfg)
        st = jest.init_estimator_state(jecfg, seqs[b].ric, seqs[b].tic, 0.0)
        for k in range(11):
            img, dep, t, dts, acc, gyr = (jnp.asarray(f[k, b]) for f in frames)
            R = relR(dts, gyr, st.x.Bg[10], st.x.qic)
            trk, out = track(trk, img, t, R, jax.random.PRNGKey(100 * b + k))
            feats = out.features
            feats = feats._replace(depth=jft.lookup_depth(dep, feats.uv, feats.ids >= 0))
            st, _ = fill(st, jnp.asarray(k, jnp.int32), feats, jest.ImuInterval(dts, acc, gyr))
        st, _ = init(st)
        jtrk.append(jax.device_get(trk))
        jst.append(jax.device_get(st))

    trk = bridge.to_torch(bridge.stack(jtrk))
    st = bridge.to_torch(bridge.stack(jst))
    base_keys = jax.random.split(jax.random.PRNGKey(17), B)
    steps = []
    for i in range(steady):
        k = 11 + i
        us, jP = [], []
        for b in range(B):
            key = jax.random.fold_in(base_keys[b], i)
            img, dep, t, dts, acc, gyr = (jnp.asarray(f[k, b]) for f in frames)
            jtrk[b], jst[b], out = step(jtrk[b], jst[b], img, dep, t,
                                        jest.ImuInterval(dts, acc, gyr), key)
            jP.append(np.asarray(out.P))
            us.append(jax_ransac_uniforms(key, jtcfg.ransac_trials, jtcfg.maxc))
        steps.append((np.stack(us), np.stack(jP)))
    return runner, batch, trk, st, steps, seqs


def test_frame_step_matches_jax_from_jax_warmed_state():
    runner, batch, trk, st, steps, seqs = jax_steady_frames(B, STEADY)
    for i, (us, jP) in enumerate(steps):
        k = 11 + i
        imu = tes.ImuInterval(batch.imu_dts[k], batch.imu_acc[k], batch.imu_gyr[k])
        trk, st, sout = tbp.fused_frame_step(runner.tcfg, runner.cam, runner.ecfg, trk, st,
                                             batch.imgs[k], batch.depths[k], batch.ts[k], imu,
                                             tt(us))
        err = np.abs(tn(sout.P) - jP).max()
        assert err < 5e-3, (i, err)
        assert np.all(np.isfinite(tn(sout.cost)))
        for b in range(B):
            assert np.linalg.norm(jP[b] - seqs[b].P[k]) < 0.05


def test_port_warms_itself_and_tracks_ground_truth():
    res = chip_smoke.run_main_path("cpu", B, 6, W=W, H=H, max_cnt=MAX_CNT)
    chip_smoke.check_main_path(res, B, 6, on_gpu=False)
    assert np.all(res["n_features"] > 15)
