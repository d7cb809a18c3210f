"""VO mode of the port (no IMU: the TUM RGB-D rig) against the JAX package
on the CPU, on the same seeded numpy inputs: the solver's free mask and VO
solve, marginalization without IMU factors, PnP from DLT trials, the VO
estimator programs (``fill_step``, ``init_full``, ``_pnp_newest``,
``vio_step``) from bridged states and ``VinsEstimator`` over a 20-frame
sequence, the cold-LK tracker, the 6-DoF pose graph (``optimize_6dof``,
``PoseGraph.optimize``, ``BatchedLoopCloser``) and ``VinsPipeline`` (fused
and unfused, and with the pose graph inline).  JAX's PnP draws are injected
into the port throughout.

Tolerances: the free mask exact; the VO solve's state within 1e-4;
marginalize-old's prior information and gradient within 1e-4 of their
largest entries (its square-root factor within 1e-2); PnP inliers
equal and the model within 1e-4 (float64; in float32 its reprojection
error within 0.1 px); the estimator programs' poses within 1e-4 and
``VinsEstimator``'s per-frame position within 1e-3 m; the
tracker's ids exact and positions within 1e-3 px; ``optimize_6dof`` within
1e-4 (both in float32), ``PoseGraph.optimize`` within 1e-5 (both in
float64: JAX's host path runs in float64 under the suite's x64 setting, and
the port's graph takes its dtype); loops equal (cur, old, inlier count) and
the corrected path within 1e-3 m; the pipeline's newest position within
5 mm per frame (the bound of ``tests/test_torch_pipeline.py``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.helpers import (G, make_landmark_field, make_visual_data, perturb_state,
                           project_frame_features, simulate_long_trajectory,
                           simulate_window_trajectory)
from tests.test_torch_backend import _rel, _to_jax, _window
from tests.test_torch_batched_loop import (CFG as BL_CFG, CLOSER, RIG as BL_RIG, _drive,
                                           _pnp_draws as _bl_draws, segments)  # noqa: F401
from tests.test_torch_pipeline import _drive as _drive_pipe, _envelope
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import assert_close, f32, tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch import config as tconfig
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.backend import feature_table as tftab
from vins_rgbd_fast_torch.config import EstimatorConfig, SolverConfig, TrackerConfig
from vins_rgbd_fast_torch.frontend import feature_tracker as tft
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.loop import pose_graph as tpg
from vins_rgbd_fast_torch.models.camera import PinholeCamera
from vins_rgbd_fast_torch.ops import marginalization as tmarg
from vins_rgbd_fast_torch.ops import ransac as transac
from vins_rgbd_fast_torch.ops import solver as tslv
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_torch.parallel import loop_closer as tlc
from vins_rgbd_fast_torch.pipeline import VinsPipeline as TPipeline
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.frontend import feature_tracker as jft
from vins_rgbd_fast_tpu.loop import pose_graph as jpg
from vins_rgbd_fast_tpu.models import make_camera
from vins_rgbd_fast_tpu.ops import marginalization as jmarg
from vins_rgbd_fast_tpu.ops import ransac as jransac
from vins_rgbd_fast_tpu.ops import solver as jslv
from vins_rgbd_fast_tpu.parallel import loop_closer as jlc
from vins_rgbd_fast_tpu.pipeline import VinsPipeline as JPipeline
from vins_rgbd_fast_tpu.utils import quaternion as jquat

MAXF = 32
VO_SOLVER = dict(maxf=MAXF, use_imu=False, fix_pose0=True, yaw_gauge=False)


def _vo_window_problem():
    """``tests/test_solver.py``'s VO problem (seed 0, half the depths fixed,
    frame 0 kept), in float32."""
    gt, _ = simulate_window_trajectory(seed=0)
    jvis, _ = make_visual_data(gt, maxf=MAXF, depth_fixed_frac=0.5)
    jvis = f32(jvis)
    x0 = f32(perturb_state(gt, keep_frame0=True))
    tvis = tslv.VisualData(*[tt(np.asarray(v))[None] for v in jvis])
    return gt, x0, jvis, tvis


@pytest.mark.parametrize("mode", [dict(use_imu=False, fix_pose0=True),
                                  dict(use_imu=True, fix_pose0=False),
                                  dict(use_imu=False, fix_pose0=False)],
                         ids=["vo", "vio", "vo-free-pose0"])
def test_free_mask_matches_jax(mode):
    _, _, jvis, tvis = _vo_window_problem()
    jm = jslv.free_mask(jslv.SolverConfig(maxf=MAXF, **mode), jvis, jnp.float32)
    tm = tslv.free_mask(SolverConfig(maxf=MAXF, **mode), tvis, torch.float32)
    np.testing.assert_array_equal(tn(tm[0]), np.asarray(jm))


def test_vo_solve_matches_jax():
    gt, x0, jvis, tvis = _vo_window_problem()
    jres = jax.jit(functools.partial(jslv.solve, jslv.SolverConfig(max_iters=8, **VO_SOLVER)))(
        x0, jvis, None, f32(jslv.empty_prior(jnp.float32)), jnp.asarray(G, jnp.float32))
    res = tslv.solve(SolverConfig(max_iters=8, **VO_SOLVER), _window(x0), tvis, None,
                     tslv.empty_prior(1, "cpu"), tt(G.astype(np.float32)))
    assert_close(tn(res.x.P[0]), jres.x.P, 1e-4, what="P")
    assert_close(tn(res.x.Q[0]), jres.x.Q, 1e-4, what="Q")
    assert_close(tn(res.inv_depth[0]), jres.inv_depth, 1e-4, what="inv_depth")
    # pose 0 and the speed-biases stay where they were (VO gauge)
    np.testing.assert_array_equal(tn(res.x.P[0, 0]), np.asarray(x0.P[0]))
    np.testing.assert_array_equal(tn(res.x.V[0]), np.asarray(x0.V))
    assert np.abs(tn(res.x.P[0]) - np.asarray(gt.P)).max() < 1e-3


def test_marginalize_old_without_imu_matches_jax():
    gt, _, jvis, tvis = _vo_window_problem()
    x = f32(perturb_state(gt, seed=2, dp=0.01, dth=0.005, dv=0.0, dbias=0.0))
    jp = jax.jit(functools.partial(jmarg.marginalize_old, jslv.SolverConfig(**VO_SOLVER)))(
        x, jvis, None, f32(jslv.empty_prior(jnp.float32)), jnp.asarray(G, jnp.float32))
    tp = tmarg.marginalize_old(SolverConfig(**VO_SOLVER), _window(x), tvis, None,
                               tslv.empty_prior(1, "cpu"), tt(G.astype(np.float32)))
    # the prior's quadratic (its information JᵀJ and gradient Jᵀr0) within
    # 1e-4; the square-root factor itself within 1e-2 as in the VIO test: a
    # visual-only window leaves the 6 gauge directions to the jitter, and the
    # float32 Cholesky rows after them differ by up to 1e-3 of the largest entry
    J, r0, jJ, jr0 = tn(tp.J[0]), tn(tp.r0[0]), np.asarray(jp.J), np.asarray(jp.r0)
    _rel(J.T @ J, jJ.T @ jJ, 1e-4, "information")
    _rel(J.T @ r0, jJ.T @ jr0, 1e-4, "gradient")
    _rel(J, jJ, 1e-2, "J")
    _rel(r0, jr0, 1e-2, "r0")
    assert bool(tp.valid[0])


def _pnp_problem(seed, n=60, outliers=12):
    rng = np.random.default_rng(seed)
    Pw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 7, n)], -1)
    R = np.asarray(jquat.q2R(jquat.so3_exp(jnp.asarray(rng.normal(0, 0.2, 3)))))
    t = rng.normal(0, 0.3, 3)
    pc = Pw @ R.T + t
    uv = pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.5 / 460.0, (n, 2))
    uv[:outliers] += rng.uniform(-0.2, 0.2, (outliers, 2))
    valid = np.ones(n, bool)
    valid[-3:] = False
    return [a.astype(np.float32) for a in (Pw, uv)] + [valid]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_pnp_dlt_and_pnp_ransac_match_jax(dtype):
    """Inliers equal in both precisions; in float64 the models within 1e-4;
    in float32 (DLT's null vector of AᵀA by inverse iteration moves a
    few-point model by up to 1e-3) the models' mean reprojection errors on
    the inliers within 2e-4 (0.1 px at 460) of each other."""
    f64 = dtype == np.float64

    def reproj(M, Pw, uv, inl):
        pc = Pw @ M[:, :3].T + M[:, 3]
        return np.linalg.norm(pc[:, :2] / pc[:, 2:3] - uv, axis=-1)[inl].mean()

    for seed in (3, 4):
        Pw, uv, valid = _pnp_problem(seed)
        Pw, uv = Pw.astype(dtype), uv.astype(dtype)
        jR, jt = jax.jit(jransac._pnp_dlt)(jnp.asarray(Pw[20:32]), jnp.asarray(uv[20:32]))
        R, t = transac.pnp_dlt(tt(Pw[20:32]), tt(uv[20:32]))
        assert_close(tn(R), jR, 1e-4 if f64 else 1e-3, what="dlt R")
        assert_close(tn(t), jt, 1e-4 if f64 else 1e-3, what="dlt t")
        key = jax.random.PRNGKey(seed)
        jres = jransac.pnp_ransac(key, *map(jnp.asarray, (Pw, uv, valid)))
        res = transac.pnp_ransac(tt(jax_ransac_uniforms(key, 100, len(Pw)).astype(dtype))[None],
                                 tt(Pw)[None], tt(uv)[None], tt(valid)[None])
        inl = np.asarray(jres.inliers)
        np.testing.assert_array_equal(tn(res.inliers[0]), inl)
        assert int(res.n_inliers[0]) == int(jres.n_inliers) > 30 and bool(res.ok[0])
        if f64:
            assert_close(tn(res.model[0]), jres.model, 1e-4, what="pnp_ransac model")
        else:
            e_t, e_j = (reproj(np.asarray(M, np.float64), Pw, uv, inl)
                        for M in (tn(res.model[0]), jres.model))
            assert abs(e_t - e_j) < 2e-4 and e_t < 10.0 / 460.0, (e_t, e_j)


# ---------------------------------------------------------------------------
# the VO estimator
# ---------------------------------------------------------------------------

def _vo_vcfg(**kw):
    base = dict(imu=False, static_init=True, max_cnt=48, max_features=48, max_imu_per_frame=16,
                fix_depth=True, depth_min_dist=0.3, depth_max_dist=10.0, keyframe_parallax=10.0,
                acc_n=0.1, gyr_n=0.01, acc_w=1e-4, gyr_w=1e-5)
    base.update(kw)
    return jconfig.VinsConfig(**base)


def _port_feats(feats):
    """JAX FrameFeatures of one frame -> the port's, B = 1, float32."""
    return tftab.FrameFeatures(*[tt(np.asarray(v, np.float32 if np.asarray(v).dtype.kind == "f"
                                               else None))[None] for v in feats])


def test_vo_estimator_programs_match_jax_from_bridged_states():
    vcfg = _vo_vcfg()
    jcfg = jest.EstimatorConfig.from_vins(vcfg)
    cfg = EstimatorConfig.from_vins(tconfig.VinsConfig(**{
        f.name: getattr(vcfg, f.name) for f in dataclasses.fields(tconfig.VinsConfig)}))
    assert not cfg.use_imu and cfg.solver.fix_pose0 and not cfg.solver.yaw_gauge
    maxf = cfg.maxf
    tr = simulate_long_trajectory(13, seed=7)
    L = make_landmark_field(tr, n_landmarks=500, seed=8)
    feats = [project_frame_features(tr["P"][k], tr["Q"][k], L, maxf) for k in range(13)]
    empty = tes.ImuInterval(torch.zeros((1, 16)), torch.zeros((1, 17, 3)),
                            torch.zeros((1, 17, 3)))
    jempty = jest.empty_interval(jcfg, jnp.float32)

    def to_jax(st):
        return _to_jax(bridge.to_numpy(st), 0)

    def check_state(st, jst, atol, what):
        assert_close(tn(st.x.P[0]), jst.x.P, atol, what=f"{what} P")
        assert_close(tn(st.x.Q[0]), jst.x.Q, atol, what=f"{what} Q")
        np.testing.assert_array_equal(tn(st.table.ids[0]), np.asarray(jst.table.ids))

    st = tes.init_estimator_state(cfg, np.eye(3), np.zeros(3), 0.0, 1, "cpu")
    for k in range(11):
        jst1, jkf = jest.fill_step(jcfg, to_jax(st), jnp.asarray(k, jnp.int32), f32(feats[k]),
                                   jempty)
        st, kf = tes.fill_step(cfg, st, k, _port_feats(feats[k]), empty)
        assert bool(kf[0]) == bool(jkf)
        check_state(st, jst1, 1e-6, f"fill_step {k}")
        assert_close(tn(st.table.est_depth[0]), jst1.table.est_depth, 1e-5, what="depths")
    jst1, jout = jest.init_full(jcfg, to_jax(st))
    st, out = tes.init_full(cfg, st)
    check_state(st, jst1, 1e-4, "init_full")
    assert_close(tn(out.P[0]), jout.P, 1e-4, what="init_full newest P")
    assert np.linalg.norm(tn(out.P[0]) - tr["P"][10]) < 0.01

    key = jax.random.PRNGKey(5)
    u = tt(jax_ransac_uniforms(key, 32, maxf))[None]
    # the VO pose init on the ingested frame 11 (what vio_step runs before its solve)
    pre = st._replace(x=tes._copy_previous_pose(st.x, 10))
    table, _, _ = tftab.ingest_frame(pre.table, 10, _port_feats(feats[11]), pre.x.td,
                                     cfg.depth_min_dist, cfg.min_parallax)
    pre = pre._replace(table=table)
    jx = jest._pnp_newest(jcfg, to_jax(pre), key)
    x = tes._pnp_newest(cfg, pre, u)
    assert_close(tn(x.P[0, 10]), jx.P[10], 1e-4, what="_pnp_newest P")
    assert_close(tn(x.Q[0, 10]), jx.Q[10], 1e-4, what="_pnp_newest Q")
    assert np.linalg.norm(tn(x.P[0, 10]) - tr["P"][11]) < 0.02
    jst2, jout2 = jest.vio_step(jcfg, to_jax(st), f32(feats[11]), jempty, key)
    st2, out2 = tes.vio_step(cfg, st, _port_feats(feats[11]), empty, pnp_u=u)
    assert bool(out2.is_keyframe[0]) == bool(jout2.is_keyframe)
    assert bool(out2.failure[0]) == bool(jout2.failure) is False
    assert_close(tn(out2.P[0]), jout2.P, 1e-4, what="vio_step P")
    assert_close(tn(out2.Q[0]), jout2.Q, 1e-4, what="vio_step Q")
    check_state(st2, jst2, 1e-4, "vio_step")
    with pytest.raises(ValueError, match="pnp_u"):
        tes.vio_step(cfg, st, _port_feats(feats[11]), empty)


def test_vo_estimator_matches_jax_e2e():
    """``test_vo_mode_e2e``'s 20-frame sequence through both ``VinsEstimator``s
    in float32, JAX's ``PRNGKey(1)`` PnP draws injected."""
    vcfg = _vo_vcfg()
    tr = simulate_long_trajectory(20, seed=7)
    L = make_landmark_field(tr, n_landmarks=500, seed=8)
    keys = jax.random.split(jax.random.PRNGKey(1), 4096)
    je = jest.VinsEstimator(vcfg, dtype=jnp.float32)
    te = tes.VinsEstimator(tconfig.VinsConfig(**{
        f.name: getattr(vcfg, f.name) for f in dataclasses.fields(tconfig.VinsConfig)}), "cpu",
        pnp_uniforms=lambda step: jax_ransac_uniforms(keys[step % 4096], 32, 48))
    n_out = 0
    for k in range(20):
        feats = project_frame_features(tr["P"][k], tr["Q"][k], L, 48)
        a = je.process_features(f32(feats), float(tr["times"][k]))
        b = te.process_features(_port_feats(feats), float(tr["times"][k]))
        assert (a is None) == (b is None), k
        if a is not None:
            n_out += 1
            assert np.linalg.norm(np.asarray(b["P"]) - np.asarray(a["P"])) < 1e-3, k
    assert n_out >= 9 and te.solver_flag == te.NON_LINEAR
    assert np.linalg.norm(np.asarray(b["P"]) - tr["P"][19]) < 0.05


def test_cold_track_frame_matches_jax():
    """One ``track_frame`` without IMU prediction (4 pyramid levels, LK from
    the previous positions) from a bridged JAX state, B = 2 at 160×120."""
    W, H = 160, 120
    cfg = dict(width=W, height=H, max_cnt=32, capacity=48, min_dist=8, grid_rows=3,
               grid_cols=4, fast_threshold=20.0, lk_max_iters=12, lk_coarse_iters=6,
               use_imu_prediction=False)
    rig = tsyn.SyntheticRig(width=W, height=H, fx=115.0, fy=115.0, cx=80.0, cy=60.0,
                            **chip_smoke.DISTORTION)
    jcfg = jft.TrackerConfig(lk_sampler="matmul", lk_engine="xla", **cfg)
    tcfg = TrackerConfig(**cfg)
    cam_kw = dict(fx=rig.fx, fy=rig.fy, cx=rig.cx, cy=rig.cy, width=W, height=H,
                  **chip_smoke.DISTORTION)
    jcam, tcam = make_camera("PINHOLE", **cam_kw), PinholeCamera(**cam_kw)
    imgs, ts, states, refs, us = [], [], [], [], []
    for b in range(2):
        seq = tsyn.make_trajectory(3, rig, seed=100 + b, omega_scale=0.15, acc_scale=0.3)
        times, im, _ = tsyn.render_sequence(seq, rig, "cpu", 0, 2)
        im = tn(im)
        s1, _ = jft.track_frame(jcfg, jcam, jft.init_state(jcfg), jnp.asarray(im[0]),
                                jnp.float32(times[0]), jnp.eye(3, dtype=jnp.float32),
                                jax.random.PRNGKey(b))
        key = jax.random.PRNGKey(10 + b)
        refs.append(jax.device_get(jft.track_frame(
            jcfg, jcam, s1, jnp.asarray(im[1]), jnp.float32(times[1]),
            jnp.eye(3, dtype=jnp.float32), key)))
        imgs.append(im[1])
        ts.append(np.float32(times[1]))
        states.append(jax.device_get(s1))
        us.append(jax_ransac_uniforms(key, jcfg.ransac_trials, jcfg.maxc))
    assert len(states[0].pyramid) == 4
    new, out = tft.track_frame(tcfg, tcam, bridge.to_torch(bridge.stack(states)),
                               tt(np.stack(imgs)), tt(np.stack(ts)),
                               torch.eye(3).expand(2, 3, 3), tt(np.stack(us)))
    for b in range(2):
        js2, jout = refs[b]
        ids = np.asarray(jout.features.ids)
        assert (ids >= 0).sum() >= 20 and int(jout.n_tracked) >= 10
        np.testing.assert_array_equal(tn(out.features.ids[b]), ids)
        np.testing.assert_array_equal(tn(new.track_cnt[b]), np.asarray(js2.track_cnt))
        valid = ids >= 0
        assert np.abs(tn(out.features.uv[b]) - np.asarray(jout.features.uv))[valid].max() < 1e-3


# ---------------------------------------------------------------------------
# the 6-DoF pose graph
# ---------------------------------------------------------------------------

def _loop_6dof_problem():
    """``tests/test_loop.py:129``'s problem: a circle with 6 % scale drift and
    a band of exact loop edges."""
    K = 20
    gt_t = np.zeros((K, 3))
    gt_q = np.zeros((K, 4))
    for k in range(K):
        ang = 2 * np.pi * k / K
        gt_t[k] = [3 * np.sin(ang), 3 * (1 - np.cos(ang)), 0.1 * np.sin(2 * ang)]
        gt_q[k] = tpg.nq.R2q(tpg.nq.yaw_R(np.degrees(ang)))
    vio_t = np.zeros((K, 3))
    for k in range(1, K):
        R = tpg.nq.q2R(gt_q[k - 1])
        vio_t[k] = vio_t[k - 1] + R @ (R.T @ (gt_t[k] - gt_t[k - 1]) * 1.06)
    e_i, e_j, e_rt, e_rq, e_loop = [], [], [], [], []

    def edge(a, b, t, q, loop):
        R = tpg.nq.q2R(q[a])
        e_i.append(a)
        e_j.append(b)
        e_rt.append(R.T @ (t[b] - t[a]))
        e_rq.append(tpg.nq.qmul(tpg.nq.qconj(q[a]), q[b]))
        e_loop.append(loop)

    for k in range(1, K):
        for b in range(1, 5):
            if k - b >= 0:
                edge(k - b, k, vio_t, gt_q, False)
    for i in range(6):
        edge(i, K - 1 - i, gt_t, gt_q, True)
    E = len(e_i)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return [vio_t.astype(np.float32), gt_q.astype(np.float32), np.ones(K, bool), fixed,
            np.asarray(e_i, np.int32), np.asarray(e_j, np.int32),
            np.asarray(e_rt, np.float32), np.asarray(e_rq, np.float32), np.asarray(e_loop),
            np.ones(E, bool)], gt_t


def test_optimize_6dof_matches_jax():
    args, gt_t = _loop_6dof_problem()
    K = args[0].shape[0]
    for huber in (5.0, 0.1):
        jt, jq, jc0, jc1 = jpg.optimize_6dof(*map(jnp.asarray, args), n_nodes_static=K,
                                             iters=20, huber=huber)
        t, q, c0, c1 = tpg.optimize_6dof(*map(tt, args), iters=20, huber=huber)
        assert_close(tn(t), jt, 1e-4, what="t")
        assert_close(tn(q), jq, 1e-4, what="q")
        assert_close(tn(c0), jc0, 0.0, 1e-5, what="cost0")
        assert_close(tn(c1), jc1, 1e-6, 1e-3, what="cost")
        assert float(c1) < (0.5 if huber == 5.0 else 1.0) * float(c0)
    before = np.linalg.norm(args[0] - gt_t, axis=1).mean()
    assert np.linalg.norm(tn(t) - gt_t, axis=1).mean() < before


def _mini_graph(mod, dev):
    """Six keyframes along +x turning in yaw and pitch, sequence 1, with a
    loop 5 -> 1 whose relative pose disagrees with the odometry."""
    cam = (PinholeCamera(**BL_RIG) if mod is tpg
           else make_camera("PINHOLE", k1=0, k2=0, p1=0, p2=0, **BL_RIG))
    g = mod.PoseGraph(mod.PoseGraphConfig(max_kp=32, max_wp=16, use_6dof=True), cam, np.eye(3),
                      np.zeros(3), *dev)
    z = dict(kp_uv=np.zeros((32, 2)), kp_norm=np.zeros((32, 3)), kp_valid=np.zeros(32, bool),
             kp_desc=np.zeros((32, 256), np.int8), wp_world=np.zeros((16, 3)),
             wp_norm=np.zeros((16, 2)), wp_valid=np.zeros(16, bool),
             wp_desc=np.zeros((16, 256), np.int8))
    for i in range(7):
        R = tpg.nq.ypr2R(np.array([8.0 * i, 2.0 * i, -1.0 * i]))
        g.keyframes.append(mod.KeyFrameData(index=i, t=float(i), sequence=1,
                                            P_vio=np.array([0.5 * i, 0.05 * i * i, 0.02 * i]),
                                            Q_vio=tpg.nq.R2q(R), **z))
        g.corrected[i] = (g.keyframes[i].P_vio, g.keyframes[i].Q_vio)
    q = tpg.nq.R2q(tpg.nq.ypr2R(np.array([30.0, 7.0, -3.0])))
    g.loops.append(dict(cur=5, old=1, rel_t=np.array([2.1, 0.3, -0.05]), rel_yaw=30.0, rel_q=q,
                        n_inliers=40))
    g.earliest_loop_index = 1
    return g


def test_pose_graph_optimize_6dof_matches_jax():
    tg, jg = _mini_graph(tpg, ("cpu", torch.float64)), _mini_graph(jpg, ())
    tg.optimize()
    jg.optimize()
    assert tg.n_solves_6dof == 1
    for (ta, tP, tQ), (ja, jP, jQ) in zip(tg.path(), jg.path()):
        assert ta == ja
        assert_close(tP, np.asarray(jP), 1e-5, what="corrected P")
        assert_close(tQ, np.asarray(jQ), 1e-5, what="corrected Q")
    assert abs(tg.yaw_drift - jg.yaw_drift) < 1e-5 and abs(tg.yaw_drift) > 0.01
    assert_close(tg.t_drift, jg.t_drift, 1e-5, what="t_drift")
    # keyframe 6 lies past the optimized window: corrected by the drift
    P6, _ = tg.apply_drift(tg.keyframes[6].P_vio, tg.keyframes[6].Q_vio)
    assert_close(tg.path()[6][1], P6, 1e-12, what="drift-corrected tail")


def test_batched_closer_with_6dof_graphs_matches_jax(segments):  # noqa: F811
    """``tests/test_torch_batched_loop.py``'s segments through both closers with
    6-DoF graphs (``_optimize_graphs``' VO arm)."""
    seqs, segs = segments
    cfg = dict(BL_CFG, use_6dof=True)
    jcam = make_camera("PINHOLE", k1=0, k2=0, p1=0, p2=0, **BL_RIG)
    jc = jlc.BatchedLoopCloser(jcam, seqs[0].ric, seqs[0].tic, 2, jpg.PoseGraphConfig(**cfg),
                               **CLOSER)
    for bt, so in segs:
        jc.consume(jax.tree.map(jnp.asarray, bt), jax.tree.map(jnp.asarray, so))
    tc = tlc.BatchedLoopCloser(PinholeCamera(**BL_RIG), seqs[0].ric, seqs[0].tic, 2, "cpu",
                               tpg.PoseGraphConfig(**cfg), pnp_uniforms=_bl_draws, **CLOSER)
    _drive(tc, segs, "consume")
    assert tc.graphs[0].n_solves_6dof >= 1
    for tg, jg in zip(tc.graphs, jc.graphs):
        assert ([(lp["cur"], lp["old"], lp["n_inliers"]) for lp in tg.loops]
                == [(lp["cur"], lp["old"], lp["n_inliers"]) for lp in jg.loops])
        assert_close(np.stack([p[1] for p in tg.path()]), np.stack([p[1] for p in jg.path()]),
                     1e-3, what="path")
    assert len(jc.graphs[0].loops) >= 2


def test_batched_runner_accepts_vo_and_refuses_dynamic_init():
    """The batched runner accepts VO (``tests/test_torch_batched_vo.py``)
    and any initialization; only its own ``warm`` refuses dynamic init,
    since it warms by static init.  A VO config (``use_imu=False``) keeps
    the 12/6 LK envelope on K2 (engine "pallas3") and draws PnP uniforms
    per sequence; a VIO config draws none."""
    rig, tcfg, ecfg, cam = chip_smoke.vo_batched_config(160, 120, 32)
    r = tbp.BatchedVioRunner(tcfg, cam, ecfg, "cpu", 3)
    assert (r.tcfg.lk_engine, r.tcfg.lk_max_iters, r.tcfg.lk_coarse_iters) == ("pallas3", 12, 6)
    assert not r.ecfg.use_imu and not r.tcfg.use_imu_prediction and r.tcfg.pyr_levels_cold == 4
    assert len(r.pnp_generators) == 3 and tuple(r.pnp_uniforms().shape) == (3, 32, ecfg.maxf)
    _, vtcfg, vecfg, _ = chip_smoke.slice_config(160, 120, 32)
    assert tbp.BatchedVioRunner(vtcfg, cam, vecfg, "cpu", 1).pnp_uniforms() is None
    dyn = tbp.BatchedVioRunner(vtcfg, cam, dataclasses.replace(vecfg, static_init=False),
                               "cpu", 1)
    assert not dyn.ecfg.static_init and dyn.pnp_uniforms() is None
    with pytest.raises(NotImplementedError, match="static initialization"):
        dyn.warm(None, None, None)


# ---------------------------------------------------------------------------
# the VO pipeline
# ---------------------------------------------------------------------------

W, H, MAX_CNT, FRAMES = 160, 120, 32, 18


@pytest.fixture(scope="module")
def vo_stream():
    rig, _, _, _ = chip_smoke.slice_config(W, H, MAX_CNT)
    seq = tsyn.make_trajectory(FRAMES, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    cfg = dataclasses.replace(chip_smoke.latency_config(rig, seq, MAX_CNT), imu=False)
    return seq, ts, tn(imgs), tn(deps), cfg


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_vo_pipeline_matches_jax(vo_stream, fused):
    """No IMU is pushed: every frame is processed (none waits for IMU), the
    newest position follows JAX's, F-RANSAC's and PnP's draws from JAX's
    keys (fused: one ``fold_in(PRNGKey(2), step)`` key for both)."""
    seq, ts, imgs, deps, tcfg = vo_stream
    fkeys = jax.random.split(jax.random.PRNGKey(0), 4096)
    ekeys = jax.random.split(jax.random.PRNGKey(1), 4096)
    maxf = tcfg.feature_capacity

    def ransac(is_fused, i):
        key = jax.random.fold_in(jax.random.PRNGKey(2), i) if is_fused else fkeys[i % 4096]
        return jax_ransac_uniforms(key, 64, maxf)

    def pnp(is_fused, i):
        key = jax.random.fold_in(jax.random.PRNGKey(2), i) if is_fused else ekeys[i % 4096]
        return jax_ransac_uniforms(key, 32, maxf)

    jpipe = _envelope(JPipeline(jconfig.VinsConfig(**dataclasses.asdict(tcfg)),
                                dtype=jnp.float32, fused_steady_state=fused))
    tpipe = _envelope(TPipeline(tcfg, "cpu", fused_steady_state=fused, ransac_uniforms=ransac,
                                vo_pnp_uniforms=pnp))
    seq_no_imu = seq._replace(imu=[])
    jflags, jP = _drive_pipe(jpipe, seq_no_imu, ts, imgs, deps)
    tflags, tP = _drive_pipe(tpipe, seq_no_imu, ts, imgs, deps)
    assert tpipe.tcfg.pyr_levels_cold == 4 and not tpipe.tcfg.use_imu_prediction
    assert tflags == jflags
    assert [p is None for p in tP] == [p is None for p in jP]
    assert sum(p is not None for p in tP) == FRAMES - 10
    for k, (a, b) in enumerate(zip(tP, jP)):
        if a is not None:
            assert np.linalg.norm(a - b) < 5e-3, (k, a, b)
    if fused:
        assert tpipe._fused_step == FRAMES - 11


LW, LH, LMAX_CNT, LFRAMES = 320, 240, 64, 112


def test_vo_loop_pipeline_eager_matches_jax_pose_graph():
    """The VO pipeline with the 6-DoF graph inline at 320×240: its keyframe
    stream and relocalization feedback, replayed into JAX's 6-DoF
    ``PoseGraph`` (JAX's pipeline over the stream is too slow for tier-1),
    give the same loops and corrected path; the keyframes' ATE stays
    within 1e-3 m between the two graphs."""
    rig, _, _, _ = chip_smoke.slice_config(LW, LH, LMAX_CNT)
    seq = chip_smoke.revisit_scene(rig, LFRAMES)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    cfg, pg_cfg = chip_smoke.vo_config(rig, seq, LMAX_CNT, max_kp=128)
    pg_cfg = dataclasses.replace(pg_cfg, pad_nodes_min=8, pad_edges_min=8)

    def pnp_draws(index, n):
        return jax_ransac_uniforms(jax.random.PRNGKey(index), 32, n)

    pipe = _envelope(TPipeline(cfg, "cpu", fused_steady_state=True, pose_graph_config=pg_cfg,
                               pnp_uniforms=pnp_draws))
    g = pipe.pose_graph
    calls = []
    add, update = g.add_keyframe, g.update_keyframe_loop

    def rec_add(img, t, P, Q, wp_world, wp_uv, wp_norm, wp_valid, depth=None):
        calls.append(("add", (tn(img), t, np.array(P), np.array(Q), np.array(wp_world),
                              np.array(wp_uv), np.array(wp_norm), np.array(wp_valid)),
                      tn(depth)))
        return add(img, t, P, Q, wp_world, wp_uv, wp_norm, wp_valid, depth=depth)

    def rec_update(*args):
        calls.append(("update", args, None))
        return update(*args)

    g.add_keyframe, g.update_keyframe_loop = rec_add, rec_update
    flags, _ = _drive_pipe(pipe, seq._replace(imu=[]), ts, tn(imgs), tn(deps), 0,
                           LFRAMES)
    pipe.close()
    assert flags[16] == tes.VinsEstimator.NON_LINEAR
    assert len(g.loops) >= 1 and g.n_solves_6dof >= 1
    jg = jpg.PoseGraph(jpg.PoseGraphConfig(**dataclasses.asdict(pg_cfg)),
                       make_camera("PINHOLE", fx=rig.fx, fy=rig.fy, cx=rig.cx, cy=rig.cy,
                                   k1=rig.k1, k2=rig.k2, p1=rig.p1, p2=rig.p2, width=LW,
                                   height=LH), seq.ric, seq.tic)
    for kind, args, depth in calls:
        if kind == "add":
            jg.add_keyframe(np.asarray(args[0], np.float32), *args[1:],
                            depth=jnp.asarray(depth, jnp.float32))
        else:
            jg.update_keyframe_loop(*args)
    assert ([(lp["cur"], lp["old"], lp["n_inliers"]) for lp in g.loops]
            == [(lp["cur"], lp["old"], lp["n_inliers"]) for lp in jg.loops])
    tpath = np.stack([p[1] for p in g.path()])
    jpath = np.stack([np.asarray(p[1]) for p in jg.path()])
    assert_close(tpath, jpath, 1e-3, what="corrected path")
    t_kf = [p[0] for p in g.path()]
    ates = [chip_smoke.ate_rmse(t_kf, P, seq.times, seq.P, align=False) for P in (tpath, jpath)]
    assert abs(ates[0] - ates[1]) < 1e-3 and ates[0] < 0.05, ates
