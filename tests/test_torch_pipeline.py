"""The port's single-sequence latency pipeline (``VinsPipeline`` +
``VinsEstimator``) against the JAX package's on the same small stream
(160×120 radtan rig, max_cnt 32, 18 frames, the bench's latency envelope:
LM 2 iterations, LK 12/6), unfused and with the fused steady state, with
the JAX RANSAC draws injected; and the port-only behaviour of the host
shell.

Loop closure (the bench's revisit scene at 320×240, max_cnt 64, 112
frames): the port's pipeline with ``eager_outputs`` runs the pose graph
inline, with JAX's PnP draws injected, and its recorded keyframe stream
(and fast-relocalization feedback) replayed into the JAX package's
``PoseGraph`` finds the same loops; without ``eager_outputs`` the pose
graph runs on the ``AsyncLoopStager`` worker (``chip_smoke.run_loop_path``
on the CPU).  JAX's own pipeline over that stream is too slow for tier-1,
so the comparison is on the recorded keyframes.

Tolerances: the same solver-flag sequence and output count; per-frame
newest position within 5 mm of JAX's (the bound of
``test_torch_slice.py``: float32 Gauss-Newton from a large initial cost);
ATE under max(0.05·travelled, 0.08 m); loops equal (cur, old, inlier
count), ``rel_t`` within 1e-4 and the corrected path within 1e-3 m."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import tn
from vins_rgbd_fast_torch import config as tconfig
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.io import stream as tstream
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.models.camera import MeiCamera
from vins_rgbd_fast_torch.pipeline import VinsPipeline as TPipeline
from vins_rgbd_fast_torch.loop import pose_graph as tpg
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.io import stream as jstream
from vins_rgbd_fast_tpu.loop import pose_graph as jpg
from vins_rgbd_fast_tpu.models import make_camera
from vins_rgbd_fast_tpu.pipeline import VinsPipeline as JPipeline

W, H, MAX_CNT, FRAMES = 160, 120, 32, 18
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stream():
    rig, _, _, _ = chip_smoke.slice_config(W, H, MAX_CNT)
    seq = tsyn.make_trajectory(FRAMES, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    return seq, ts, tn(imgs), tn(deps), chip_smoke.latency_config(rig, seq, MAX_CNT)


def _envelope(pipe):
    pipe.estimator.cfg = dataclasses.replace(pipe.estimator.cfg, max_iters=2)
    pipe.tcfg = dataclasses.replace(pipe.tcfg, lk_max_iters=12, lk_coarse_iters=6)
    return pipe


def _drive(pipe, seq, ts, imgs, deps, k0=0, k1=FRAMES):
    """Push IMU (once) and frames [k0, k1); per frame the solver flag and the
    newest position (None before NON_LINEAR)."""
    if k0 == 0:
        for (t, a, g) in seq.imu:
            pipe.push_imu(t, a, g)
    flags, Ps = [], []
    for k in range(k0, k1):
        pipe.push_image(ts[k], imgs[k])
        pipe.push_depth(ts[k], deps[k])
        out = pipe.spin_once()
        flags.append(pipe.estimator.solver_flag)
        Ps.append(None if out is None else np.asarray(out["P"], np.float64))
    return flags, Ps


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_pipeline_matches_jax(stream, fused):
    seq, ts, imgs, deps, tcfg = stream
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)

    def jax_draws(is_fused, i):  # the keys JAX's pipeline hands its tracker
        key = jax.random.fold_in(jax.random.PRNGKey(2), i) if is_fused else keys[i % 4096]
        return jax_ransac_uniforms(key, 64, tcfg.feature_capacity)

    jpipe = _envelope(JPipeline(jconfig.VinsConfig(**dataclasses.asdict(tcfg)),
                                dtype=jnp.float32, fused_steady_state=fused))
    tpipe = _envelope(TPipeline(tcfg, "cpu", fused_steady_state=fused,
                                ransac_uniforms=jax_draws))
    jflags, jP = _drive(jpipe, seq, ts, imgs, deps)
    tflags, tP = _drive(tpipe, seq, ts, imgs, deps)
    assert tflags == jflags
    assert [p is None for p in tP] == [p is None for p in jP]
    n_out = sum(p is not None for p in tP)
    assert n_out == FRAMES - 10
    for k, (a, b) in enumerate(zip(tP, jP)):
        if a is not None:
            assert np.linalg.norm(a - b) < 5e-3, (k, a, b)
    if fused:
        assert tpipe._fused_step == FRAMES - 11  # the steady frames took the fused path
    traj = tpipe.run()
    assert len(traj) == n_out
    ate = tstream.ate_rmse([r["t"] for r in traj], [r["P"] for r in traj], seq.times,
                           seq.P, align=False)
    travelled = np.sum(np.linalg.norm(np.diff(seq.P, axis=0), axis=1))
    assert np.isfinite(ate) and ate < max(0.05 * travelled, 0.08), (ate, travelled)


def test_frame_without_imu_coverage_is_held(stream):
    """A frame whose IMU interval is not complete is held and processed on
    a later spin once the samples arrive, not dropped."""
    seq, ts, imgs, deps, tcfg = stream
    pipe = TPipeline(tcfg, "cpu")
    late = [s for s in seq.imu if s[0] > ts[0]]
    for (t, a, g) in seq.imu[:len(seq.imu) - len(late)]:
        pipe.push_imu(t, a, g)
    for k in (0, 1):
        pipe.push_image(ts[k], imgs[k])
        pipe.push_depth(ts[k], deps[k])
    assert pipe.spin_once() is None and pipe.estimator.frame_count == 1
    assert pipe.spin_once() is None and pipe._held_frame is not None
    assert pipe.estimator.frame_count == 1
    for (t, a, g) in late:
        pipe.push_imu(t, a, g)
    pipe.spin_once()
    assert pipe._held_frame is None and pipe.estimator.frame_count == 2
    assert pipe.pairer.next_frame() is None


def test_stream_discontinuity_resets(stream):
    """A >1 s gap in the image stream resets the tracker and the estimator:
    the frame after it starts a new window."""
    seq, ts, imgs, deps, tcfg = stream
    pipe = TPipeline(tcfg, "cpu")
    _drive(pipe, seq, ts, imgs, deps, 0, 3)
    assert pipe.estimator.frame_count == 3
    t_gap = float(ts[3]) + 2.0
    pipe.push_imu(t_gap, seq.imu[-1][1], seq.imu[-1][2])
    pipe.push_image(t_gap, imgs[3])
    pipe.push_depth(t_gap, deps[3])
    pipe.spin_once()
    assert pipe.estimator.frame_count == 1
    assert pipe.estimator.headers[0] == t_gap
    assert int(pipe.tracker_state.next_id[0]) == int((tn(pipe.tracker_state.ids) >= 0).sum())


def test_fused_failure_reset(stream):
    """A poisoned bias is caught by the failure check of the fused path:
    no output, the estimator back to INITIAL (as ``test_fused_latency``)."""
    seq, ts, imgs, deps, tcfg = stream
    pipe = _envelope(TPipeline(tcfg, "cpu", fused_steady_state=True))
    _drive(pipe, seq, ts, imgs, deps, 0, 13)
    assert pipe.estimator.solver_flag == tes.VinsEstimator.NON_LINEAR
    st = pipe.estimator.state
    pipe.estimator.state = st._replace(x=st.x._replace(Ba=st.x.Ba + 100.0))
    flags, Ps = _drive(pipe, seq, ts, imgs, deps, 13, 14)
    assert Ps == [None] and flags == [tes.VinsEstimator.INITIAL]
    assert pipe.estimator.frame_count == 0


def test_latest_odometry_matches_jax(stream):
    """IMU-rate propagation of the newest solved state through the buffered
    samples, from the same base record and the same samples."""
    seq, ts, _, _, tcfg = stream
    je = jest.VinsEstimator(jconfig.VinsConfig(**dataclasses.asdict(tcfg)), jnp.float32)
    te = tes.VinsEstimator(tcfg, "cpu")
    rng = np.random.default_rng(4)
    t_last = float(ts[5])
    base = dict(P=rng.normal(size=3), Q=np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm(
        [0.9, 0.1, -0.3, 0.2]), V=rng.normal(size=3), Ba=rng.normal(0, 0.05, 3),
        Bg=rng.normal(0, 0.01, 3))
    for e in (je, te):
        for (t, a, g) in seq.imu:
            e.push_imu(t, a, g)
        e.push_imu(0.5 * (seq.imu[3][0] + seq.imu[4][0]), np.ones(3), np.ones(3))  # dropped
        e.solver_flag = e.NON_LINEAR
        e._pending = [(t_last, None)]
        e._latest_base = (t_last, base)
    for t in (None, float(ts[7]), float(ts[5]) + 0.012):
        a, b = te.latest_odometry(t), je.latest_odometry(t)
        assert a["t"] == b["t"]
        for k in ("P", "Q", "V"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12)


RIG_YAML = """%YAML:1.0
---
# the rig of a RealSense D435i (reference-format rig file)
imu: 1
static_init: 1
image_topic: "/camera/color/image_raw"
depth_topic: "/camera/aligned_depth_to_color/image_raw"
output_path: "/tmp/output/"   # trailing comment
model_type: PINHOLE
camera_name: camera
image_width: 640
image_height: 480
distortion_parameters:
   k1: 1.3387871564774004e-01
   k2: -2.731913133377051e-01
   p1: 2.0296263577681264e-03
   p2: -4.4384544608203714e-04
projection_parameters:
   fx: 6.045821781259577e+02
   fy: 6.0425e+02
   cx: 3.2126e+02
   cy: 2.3971e+02
estimate_extrinsic: 0
extrinsicRotation: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 0.99964621,  0.01105994,  0.02418954,
           -0.01088975,  0.9999151, -0.00715601,
           -0.02426663,  0.00689047,  0.99965894]
extrinsicTranslation: !!opencv-matrix
   rows: 3
   cols: 1
   dt: d
   data: [0.17336835, 0.049596, -0.10574841]
max_cnt: 130
min_dist: 30
freq: 10
frontend_freq: 20
F_threshold: 1.0
fast_threshold: 25
equalize: 0
fisheye: 0
max_solver_time: 0.04
max_num_iterations: 8
keyframe_parallax: 10.0
acc_n: 0.1
gyr_n: 0.01
acc_w: 1e-4
gyr_w: 0.0001
g_norm: 9.805
depth_min_dist: 0.3
depth_max_dist: 12
fix_depth: 1
estimate_td: 1
td: 0.001
rolling_shutter: 1
rolling_shutter_tr: 0.033
loop_closure: 0
"""


def test_load_config_matches_jax(tmp_path):
    path = tmp_path / "rig.yaml"
    path.write_text(RIG_YAML)
    t, j = tconfig.load_config(str(path)), jconfig.load_config(str(path))
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.fast_threshold == 25 and t.estimate_td and t.tic[2] == -0.10574841
    np.testing.assert_array_equal(t.ric_matrix(), j.ric_matrix())


def test_unported_options_raise(stream):
    """What the port still refuses: dynamic initialization in the batched
    runner's own ``warm`` (its lanes warm through ``VinsPipeline`` and
    ``stack_states``; ``tests/test_torch_batched_rigs.py``).  CLAHE and the fisheye mask build into the latency pipeline's
    tracker (``tests/test_torch_clahe.py`` runs them).  Dynamic init, td and
    extrinsic estimation run on the latency pipeline
    (``tests/test_torch_init.py``, ``tests/test_torch_td_ex.py``,
    ``tests/test_torch_td_pipeline.py``); VO mode there, its 6-DoF graph and
    the map's save and load too (``tests/test_torch_vo.py``,
    ``tests/test_torch_persistence.py``).  The Mei camera now builds
    (``tests/test_torch_camera.py``), and the batched runner runs VO
    (``tests/test_torch_vo.py::test_batched_runner_accepts_vo_and_refuses_dynamic_init``)."""
    tcfg = stream[4]
    for change, field in ((dict(equalize=True), "equalize"), (dict(fisheye=True), "fisheye"),
                          (dict(fisheye=True, fisheye_mask="mask.png"), "fisheye_mask_path")):
        pipe = TPipeline(dataclasses.replace(tcfg, **change), "cpu")
        assert getattr(pipe.tcfg, field) == list(change.values())[-1], field
    for change in (dict(static_init=False), dict(estimate_td=True, rolling_shutter=True),
                   dict(estimate_extrinsic=2), dict(estimate_extrinsic=1)):
        cfg = TPipeline(dataclasses.replace(tcfg, **change), "cpu").estimator.cfg
        assert cfg == tes.EstimatorConfig.from_vins(dataclasses.replace(tcfg, **change))
    mei = chip_smoke.camera_config("MEI", tcfg)
    assert isinstance(TPipeline(mei, "cpu").cam, MeiCamera)
    rig, btcfg, becfg, bcam = chip_smoke.slice_config(W, H, MAX_CNT)
    runner = tbp.BatchedVioRunner(dataclasses.replace(btcfg, equalize=True), bcam, becfg,
                                  "cpu", 1)
    assert runner.tcfg.equalize  # the batched tracker equalizes too
    dyn = tbp.BatchedVioRunner(btcfg, bcam, dataclasses.replace(becfg, static_init=False),
                               "cpu", 1)
    with pytest.raises(NotImplementedError, match="static"):
        dyn.warm(None, None, None)
    pipe = TPipeline(dataclasses.replace(tcfg, imu=False, loop_closure=True,
                                         fast_relocalization=True), "cpu")
    assert pipe.pose_graph.cfg.use_6dof and not pipe.estimator.cfg.use_imu
    vo = tpg.PoseGraph(dataclasses.replace(pipe.pose_graph.cfg, use_6dof=True), pipe.cam,
                       np.eye(3), np.zeros(3), "cpu")
    vo.keyframes = [tpg.KeyFrameData(index=i, t=float(i), sequence=1, P_vio=np.full(3, 0.1 * i),
                                     Q_vio=np.array([1.0, 0, 0, 0]), kp_uv=None, kp_norm=None,
                                     kp_valid=None, kp_desc=None, wp_world=None, wp_norm=None,
                                     wp_valid=None, wp_desc=None) for i in range(2)]
    vo.loops = [dict(cur=1, old=0, rel_t=np.zeros(3), rel_yaw=0.0,
                     rel_q=np.array([1.0, 0, 0, 0]))]
    vo.earliest_loop_index = 0
    vo.optimize()
    assert vo.n_solves_6dof == 1


def test_stream_pairer_matches_jax():
    """The port's copy of the pairer gives JAX's frames on a jittered
    stream with unmatched stamps, a >1 s gap and a backwards jump."""
    rng = np.random.default_rng(9)
    t_img = list(np.arange(0.0, 1.5, 1 / 30.0)) + list(np.arange(3.0, 3.6, 1 / 30.0)) \
        + list(np.arange(2.0, 2.3, 1 / 30.0))
    pairers = (tstream.StreamPairer(), jstream.StreamPairer())
    msgs = (tstream, jstream)
    outs = ([], [])
    for k, t in enumerate(t_img):
        td = t + rng.uniform(-0.004, 0.004)
        for p, m, out in zip(pairers, msgs, outs):
            if k % 11 != 5:  # some images lose their depth
                p.push_depth(m.DepthMsg(t=td, depth=None))
            p.push_image(m.ImageMsg(t=t, image=None))
            while (f := p.next_frame()) is not None:
                out.append((f.t, f.publish, p.consume_reset()))
    assert outs[0] == outs[1]
    assert any(r for _, _, r in outs[0]) and not all(pub for _, pub, _ in outs[0])


def test_port_imports_nothing_of_jax():
    """The pipeline, chip_smoke, the calibration package, the throughput
    module and the graft twins import in a process where ``jax`` cannot be
    imported, and load no module of the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import vins_rgbd_fast_torch.pipeline, chip_smoke; "
            "import vins_rgbd_fast_torch.loop.pose_graph, "
            "vins_rgbd_fast_torch.parallel.loop_closer, vins_rgbd_fast_torch.loop.interop, "
            "vins_rgbd_fast_torch.io.checkpoint, vins_rgbd_fast_torch.backend.initialization, "
            "vins_rgbd_fast_torch.runtime, vins_rgbd_fast_torch.io.rosbag, "
            "vins_rgbd_fast_torch.io.tum, vins_rgbd_fast_torch.io.images, "
            "vins_rgbd_fast_torch.io.writers, vins_rgbd_fast_torch.run_vio, "
            "vins_rgbd_fast_torch.models.camera, vins_rgbd_fast_torch.io.synthetic, "
            "vins_rgbd_fast_torch.io.viz, vins_rgbd_fast_torch.parallel.batched_pipeline, "
            "vins_rgbd_fast_torch.calib, vins_rgbd_fast_torch.calib.__main__, "
            "vins_rgbd_fast_torch.calib.chessboard, vins_rgbd_fast_torch.calib.calibrate, "
            "vins_rgbd_fast_torch.parallel.throughput, __graft_entry_torch__; "
            "bad = [m for m in sys.modules if m.startswith('vins_rgbd_fast_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


# ---------------------------------------------------------------------------
# loop closure
# ---------------------------------------------------------------------------

LW, LH, LMAX_CNT, LFRAMES = 320, 240, 64, 112


def _pnp_draws(index, n):  # the draws JAX's PoseGraph makes for keyframe ``index``
    return jax_ransac_uniforms(jax.random.PRNGKey(index), 32, n)


def test_loop_pipeline_eager_matches_jax_pose_graph():
    """The inline pose graph: the port's keyframe stream and relocalization
    feedback, replayed into JAX's ``PoseGraph``, give the same loops."""
    rig, _, _, _ = chip_smoke.slice_config(LW, LH, LMAX_CNT)
    seq = chip_smoke.revisit_scene(rig, LFRAMES)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    cfg, pg_cfg = chip_smoke.loop_config(rig, seq, LMAX_CNT, max_kp=128)
    # the LM's padding floors only fix compiled shapes in JAX: the least ones here
    pg_cfg = dataclasses.replace(pg_cfg, pad_nodes_min=8, pad_edges_min=8)
    pipe = _envelope(TPipeline(cfg, "cpu", fused_steady_state=True, pose_graph_config=pg_cfg,
                               pnp_uniforms=_pnp_draws))
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
    flags, _ = _drive(pipe, seq, ts, tn(imgs), tn(deps), 0, LFRAMES)
    assert flags[16] == tes.VinsEstimator.NON_LINEAR
    assert len(g.loops) >= 1 and any(c[0] == "update" for c in calls)
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
    for a, b in zip(g.loops, jg.loops):
        np.testing.assert_allclose(a["rel_t"], b["rel_t"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.stack([p[1] for p in g.path()]),
                               np.stack([p[1] for p in jg.path()]), rtol=0, atol=1e-3)
    assert len(pipe.corrected_trajectory()) == len(g.keyframes)
    pipe.close()


def test_loop_pipeline_async_on_the_worker():
    """Phases 9 and 9e of ``chip_smoke.py`` on the CPU at 320×240: the pose
    graph on the stager's worker finds loops, the corrected keyframes beat
    the drifted ones, and the traced worker's spans take time."""
    res = chip_smoke.run_loop_path("cpu", LFRAMES, W=LW, H=LH, max_cnt=LMAX_CNT, max_kp=128,
                                   trace=True)
    chip_smoke.check_loop_path(res, on_gpu=False)
    assert res["kf_timed"] >= 10 and sum(res["worker_s"].values()) > 0


def test_stager_failure_surfaces_at_drain(stream):
    seq, ts, imgs, deps, tcfg = stream
    pipe = _envelope(TPipeline(dataclasses.replace(tcfg, loop_closure=True), "cpu",
                               eager_outputs=False, fused_steady_state=True))

    def boom(*args):
        raise RuntimeError("worker failed")

    pipe._loop_stager._process = boom
    for (t, a, g) in seq.imu:
        pipe.push_imu(t, a, g)
    for k in range(14):
        pipe.push_image(ts[k], imgs[k])
        pipe.push_depth(ts[k], deps[k])
        pipe.spin_once()
    assert pipe._fused_step > 0
    with pytest.raises(RuntimeError, match="worker failed"):
        pipe.drain()
    pipe.drain()  # reported once
    pipe.close()
    assert not pipe._loop_stager._worker.is_alive()
