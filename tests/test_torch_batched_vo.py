"""Batched VO (the TUM RGB-D rig's knobs on ``BatchedVioRunner``: no IMU,
cold LK on 4 levels, the PnP pose init) against the JAX package on the CPU.

The JAX side warms each sequence in lock step (the cold tracker, depth
lookup, ``fill_step`` over frames 0..10, then ``init_full``), the states are
bridged into the port, and both packages run ``fused_frame_step`` on the
same frames with JAX's draws injected: one key per sequence and step
gives both the F-RANSAC and the PnP uniforms, as in JAX's runner (B = 2,
160×120, max_cnt 32).  Tolerance: the newest position within 5e-3 m of
JAX's per frame, the cost finite where JAX's is and there within 1e-3
relative.  The port's own warm + run keeps the ATE bound of
``tests/test_batched_pipeline.py``, max(0.05·travelled, 0.08 m).  Its VO
segments on the revisit scene (B = 2, 320×240) feed the port's and JAX's
``BatchedLoopCloser`` with 6-DoF graphs (JAX's ``PRNGKey(index)`` PnP draws
injected): keyframes and loops (cur, old, inlier count) equal, the
corrected path within 1e-3 m (the bound of ``tests/test_torch_vo.py``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from tests.test_torch_batched_loop import _pnp_draws
from tests.test_torch_slice import _jax_configs
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import assert_close, tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.loop import pose_graph as tpg
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_torch.parallel import loop_closer as tlc
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.frontend import feature_tracker as jft
from vins_rgbd_fast_tpu.loop import pose_graph as jpg
from vins_rgbd_fast_tpu.models import make_camera
from vins_rgbd_fast_tpu.parallel import batched_pipeline as jbp
from vins_rgbd_fast_tpu.parallel import loop_closer as jlc

W, H, B, MAX_CNT, STEADY = 160, 120, 2, 32, 3


def test_vo_frame_step_matches_jax_from_jax_warmed_state():
    rig, tcfg, ecfg, cam = chip_smoke.vo_batched_config(W, H, MAX_CNT)
    runner = tbp.BatchedVioRunner(tcfg, cam, ecfg, "cpu", B)
    tcfg = runner.tcfg
    jtcfg, jecfg, jcam = _jax_configs(tcfg, ecfg, cam)
    jtcfg = dataclasses.replace(jtcfg, use_imu_prediction=False)
    jecfg = dataclasses.replace(jecfg, use_imu=False)
    n = 11 + STEADY
    seqs, rendered, _ = chip_smoke.make_sequences(rig, B, n, "cpu")
    batch = tbp.stage_frames([r[1] for r in rendered], [r[2] for r in rendered],
                             [r[0] for r in rendered], None, 0, n, "cpu")
    assert not np.any(tn(batch.imu_dts)) and not np.any(tn(batch.imu_gyr))
    frames = jax.tree.map(lambda t: np.asarray(tn(t), np.float32), tuple(batch))

    track = functools.partial(jft.track_frame, jtcfg, jcam)
    fill = functools.partial(jest.fill_step, jecfg)
    init = functools.partial(jest.init_full, jecfg)
    step = functools.partial(jbp.fused_frame_step, jtcfg, jcam, jecfg)
    eye = jnp.eye(3, dtype=jnp.float32)

    jtrk, jst = [], []
    for b in range(B):
        trk = jft.init_state(jtcfg)
        st = jest.init_estimator_state(jecfg, seqs[b].ric, seqs[b].tic, 0.0)
        for k in range(11):
            img, dep, t, dts, acc, gyr = (jnp.asarray(f[k, b]) for f in frames)
            trk, out = track(trk, img, t, eye, jax.random.PRNGKey(100 * b + k))
            feats = out.features
            feats = feats._replace(depth=jft.lookup_depth(dep, feats.uv, feats.ids >= 0))
            st, _ = fill(st, jnp.asarray(k, jnp.int32), feats, jest.ImuInterval(dts, acc, gyr))
        st, _ = init(st)
        jtrk.append(jax.device_get(trk))
        jst.append(jax.device_get(st))
    assert len(jtrk[0].pyramid) == 4

    trk = bridge.to_torch(bridge.stack(jtrk))
    st = bridge.to_torch(bridge.stack(jst))
    base_keys = jax.random.split(jax.random.PRNGKey(17), B)
    for i in range(STEADY):
        k = 11 + i
        us, pus, jP, jcost = [], [], [], []
        for b in range(B):
            key = jax.random.fold_in(base_keys[b], i)
            img, dep, t, dts, acc, gyr = (jnp.asarray(f[k, b]) for f in frames)
            jtrk[b], jst[b], out = step(jtrk[b], jst[b], img, dep, t,
                                        jest.ImuInterval(dts, acc, gyr), key)
            jP.append(np.asarray(out.P))
            jcost.append(float(out.cost))
            us.append(jax_ransac_uniforms(key, jtcfg.ransac_trials, jtcfg.maxc))
            pus.append(jax_ransac_uniforms(key, 32, jecfg.maxf))
        imu = tes.ImuInterval(batch.imu_dts[k], batch.imu_acc[k], batch.imu_gyr[k])
        trk, st, sout = tbp.fused_frame_step(tcfg, cam, ecfg, trk, st, batch.imgs[k],
                                             batch.depths[k], batch.ts[k], imu,
                                             tt(np.stack(us)), pnp_u=tt(np.stack(pus)))
        err = np.abs(tn(sout.P) - np.stack(jP)).max()
        assert err < 5e-3, (i, err)
        # JAX's cost is inf where the state it warmed gives one; the port's with it
        cost, jcost = tn(sout.cost), np.asarray(jcost)
        assert np.array_equal(np.isfinite(cost), np.isfinite(jcost)), (cost, jcost)
        fin = np.isfinite(jcost)
        assert np.all(np.abs(cost[fin] - jcost[fin]) <= 1e-3 * np.maximum(1.0, jcost[fin]))
        for b in range(B):
            assert np.linalg.norm(jP[b] - seqs[b].P[k]) < 0.05


def test_port_vo_warms_itself_and_tracks_ground_truth():
    res = chip_smoke.run_main_path("cpu", B, 6, W=W, H=H, max_cnt=MAX_CNT, vo=True)
    chip_smoke.check_main_path(res, B, 6, on_gpu=False)
    assert res["levels"] == 4 and res["runner"].pnp_generators is not None
    assert np.all(res["n_features"] > 15)


def test_batched_vo_segments_feed_6dof_closers_as_jax():
    res = chip_smoke.run_batched_loop_path("cpu", B=2, n_frames=98, seg_len=12, W=320, H=240,
                                           max_cnt=64, max_kp=128, k_pad=8, vo=True,
                                           mode="none", keep_segments=True)
    segs = [(tuple(map(tn, bt)), tuple(map(tn, so))) for bt, so in res["segments"]]
    rig = dict(width=320, height=240, fx=230.0, fy=230.0, cx=160.0, cy=120.0,
               **chip_smoke.DISTORTION)
    seq = chip_smoke.syn.make_revisit_trajectory(8, chip_smoke.syn.SyntheticRig(**rig))
    cfg = dict(max_kp=128, max_wp=96, recency_exclusion=8, score_best=0.08, score_second=0.02,
               pad_nodes_min=128, pad_edges_min=1024, use_6dof=True)
    kw = dict(k_pad=8, seq_pad=32, db_capacity=128, pgo_period=2.0)
    jc = jlc.BatchedLoopCloser(make_camera("PINHOLE", **rig), seq.ric, seq.tic, 2,
                               jpg.PoseGraphConfig(**cfg), **kw)
    tc = tlc.BatchedLoopCloser(chip_smoke.slice_config(320, 240, 64)[3], seq.ric, seq.tic, 2,
                               "cpu", tpg.PoseGraphConfig(**cfg), pnp_uniforms=_pnp_draws, **kw)
    for bt, so in segs:
        jc.consume(jbp.FrameBatch(*map(jnp.asarray, bt)), jbp.ScanOutputs(*map(jnp.asarray, so)))
        tc.consume(bridge.to_torch(tbp.FrameBatch(*bt)), bridge.to_torch(tbp.ScanOutputs(*so)))
    for c in (jc, tc):  # the deferred appends and the last PGO wake-up
        c.pipeline_drain()
    assert sum(g.n_solves_6dof for g in tc.graphs) >= 1
    assert len(tc.graphs[0].loops) >= 2
    for tg, jg in zip(tc.graphs, jc.graphs):
        assert len(tg.keyframes) == len(jg.keyframes)
        assert ([(lp["cur"], lp["old"], lp["n_inliers"]) for lp in tg.loops]
                == [(lp["cur"], lp["old"], lp["n_inliers"]) for lp in jg.loops])
        assert_close(np.stack([p[1] for p in tg.path()]), np.stack([p[1] for p in jg.path()]),
                     1e-3, what="path")
