"""Map persistence of the port against the JAX package on the CPU: a pose
graph saved by either package (``PoseGraph.save``, the ``.npz`` layout of
version 3, and a legacy version-1 file) loads in the other with the same
keyframes, descriptors, loops and drift, and the loaded map relocalizes a
live keyframe as JAX's does; the reference-format map directory
(``loop/interop.py``) round-trips both ways, file for file; and a pipeline
checkpoint (``io/checkpoint.py``) resumes exactly.  Phases 11, 11b and 11c
of ``chip_smoke.py`` are rehearsed here at 320×240.

Tolerances: keyframe fields, descriptors, loop edges, drift and the
reference map's files equal; the relocalized keyframe's loop (cur, old,
inlier count) equal and its pose within 1e-4 m; the resumed run equal to
the uninterrupted one bit for bit (the CPU is deterministic)."""

import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest

import chip_smoke
from tests.test_posegraph_persistence import _build_map, _cam as _jcam, _cfg as _jcfg, _kf_fields
from tests.test_torch_tracker import jax_ransac_uniforms
from vins_rgbd_fast_torch.io import checkpoint as tckpt
from vins_rgbd_fast_torch.loop import interop as tinterop
from vins_rgbd_fast_torch.loop import pose_graph as tpg
from vins_rgbd_fast_torch.models.camera import PinholeCamera
from vins_rgbd_fast_torch.pipeline import VinsPipeline as TPipeline
from vins_rgbd_fast_tpu.loop import interop as jinterop
from vins_rgbd_fast_tpu.loop import pose_graph as jpg
from vins_rgbd_fast_tpu.models import make_camera

W, H, MAX_CNT, FRAMES = 320, 240, 64, 112


def _pnp_draws(index, n):
    return jax_ransac_uniforms(jax.random.PRNGKey(index), 32, n)


def _port_graph(cfg=None, use_6dof=False):
    cfg = cfg or tpg.PoseGraphConfig(**dataclasses.asdict(_jcfg()))
    return tpg.PoseGraph(dataclasses.replace(cfg, use_6dof=use_6dof),
                         PinholeCamera(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96),
                         np.eye(3), np.zeros(3), "cpu", pnp_uniforms=_pnp_draws)


def _host(a):
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a)


def _same_graph(a, b):
    """Keyframes, retrieval DB, loops, drift and corrected poses equal."""
    assert len(a.keyframes) == len(b.keyframes)
    for x, y in zip(a.keyframes, b.keyframes):
        assert (x.index, x.t, x.sequence) == (y.index, y.t, y.sequence)
        for f in ("P_vio", "Q_vio", "kp_uv", "kp_norm", "kp_valid", "kp_desc", "wp_norm",
                  "wp_valid", "wp_desc"):
            np.testing.assert_array_equal(_host(getattr(x, f)), _host(getattr(y, f)), err_msg=f)
    np.testing.assert_array_equal(a.desc_db, b.desc_db)
    np.testing.assert_array_equal(a._db_index, b._db_index)
    assert a.earliest_loop_index == b.earliest_loop_index
    assert len(a.loops) == len(b.loops)
    for x, y in zip(a.loops, b.loops):
        assert (x["cur"], x["old"], x["n_inliers"], x["rel_yaw"]) == \
            (y["cur"], y["old"], y["n_inliers"], y["rel_yaw"])
        np.testing.assert_array_equal(x["rel_t"], y["rel_t"])
        np.testing.assert_array_equal(x["rel_q"], y["rel_q"])
    assert a.yaw_drift == b.yaw_drift
    np.testing.assert_array_equal(a.t_drift, b.t_drift)
    for k in a.corrected:
        for u, v in zip(a.corrected[k], b.corrected[k]):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_map_saved_by_one_package_loads_in_the_other(tmp_path, writer):
    """``tests/test_posegraph_persistence.py``'s optimized 6-keyframe map,
    saved by one package and loaded by both, twice (the second load into a
    non-empty graph offsets every index)."""
    jg, _, _ = _build_map()
    path = str(tmp_path / "map.npz")
    if writer == "jax":
        jg.save(path)
    else:
        tg = _port_graph()
        tg.keyframes, tg.loops = list(jg.keyframes), [dict(lp) for lp in jg.loops]
        tg.corrected, tg.earliest_loop_index = dict(jg.corrected), jg.earliest_loop_index
        tg.yaw_drift, tg.t_drift = jg.yaw_drift, np.asarray(jg.t_drift)
        tg.save(path)
    loaded = [_port_graph(), jpg.PoseGraph(_jcfg(), _jcam(), np.eye(3), np.zeros(3))]
    for g in loaded:
        g.load(path)
        g.load(path)
        assert len(g.keyframes) == 12 and all(k.sequence == 0 for k in g.keyframes)
        assert [(lp["cur"], lp["old"]) for lp in g.loops] == [(4, 0), (10, 6)]
    _same_graph(*loaded)


def test_legacy_v1_map_loads_alike(tmp_path):
    jg, _, _ = _build_map()
    path = str(tmp_path / "legacy.npz")
    jg.save(path)
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files if not k.startswith(("loop_", "wp_", "earliest"))}
    arrs["loops"] = np.array([[4, 0, 0.5, 0.4, 0.0, 0.0], [5, 2, -1.0, 0.2, 0.1, 0.0]])
    np.savez(path, **arrs)
    loaded = [_port_graph(), jpg.PoseGraph(_jcfg(), _jcam(), np.eye(3), np.zeros(3))]
    for g in loaded:
        g.load(path)
    _same_graph(*loaded)
    assert loaded[0].earliest_loop_index == 0 and loaded[0].loops[1]["n_inliers"] == 0
    assert not loaded[0].keyframes[0].wp_valid.any()


@pytest.mark.parametrize("use_6dof", [False, True], ids=["4dof", "6dof"])
def test_loaded_map_relocalizes_like_jax(tmp_path, use_6dof):
    """``test_loaded_map_relocalizes_live_sequence``: a live keyframe whose
    world is shifted from the map's closes a loop onto a loaded keyframe in
    both packages, with the same cross-sequence alignment and PGO."""
    jg, L, desc = _build_map()
    path = str(tmp_path / "map.npz")
    jg.save(path)
    t_shift = np.array([0.3, -0.2, 0.0])
    P_true = np.array([0.5, 0.0, 0.0])
    fields = _kf_fields(L - t_shift, P_true - t_shift, desc)
    graphs = [_port_graph(use_6dof=use_6dof),
              jpg.PoseGraph(dataclasses.replace(_jcfg(), use_6dof=use_6dof), _jcam(), np.eye(3),
                            np.zeros(3))]
    infos = []
    for g in graphs:
        g.load(path)
        infos.append(g.add_keyframe_extracted(
            10.0, P_true - t_shift, np.array([1.0, 0, 0, 0]), fields["wp_world"],
            fields["wp_norm"], fields["wp_valid"], fields["kp_uv"], fields["kp_norm"],
            fields["kp_valid"], fields["kp_desc"], fields["wp_desc"]))
    ti, ji = infos
    assert ti is not None and ji is not None and ti["old"] < 6
    assert (ti["cur"], ti["old"], ti["n_inliers"]) == (ji["cur"], ji["old"], ji["n_inliers"])
    tg, jg2 = graphs
    assert tg.sequence_aligned[1] and jg2.sequence_aligned[1]
    np.testing.assert_allclose(tg.w_t_vio, jg2.w_t_vio, atol=1e-4)
    np.testing.assert_allclose(tg.w_t_vio, t_shift, atol=1e-2)
    assert len(tg.loops) == 2
    for (_, Pa, _), (_, Pb, _) in zip(tg.path(), jg2.path()):
        np.testing.assert_allclose(Pa, np.asarray(Pb), atol=1e-4)
    np.testing.assert_allclose(tg.path()[-1][1], P_true, atol=5e-2)
    if use_6dof:
        assert tg.n_solves_6dof == 1


# ---------------------------------------------------------------------------
# phase 11 at 320×240 and what it leaves: the map, the reference directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vo_run():
    """Phase 11 on the CPU: the VO loop cell, the 6-DoF graph on the worker,
    in lockstep with the frame thread (deterministic).  The asynchronous
    stager that the card runs is covered by
    ``test_torch_pipeline.py::test_loop_pipeline_async_on_the_worker``."""
    res = chip_smoke.run_loop_path("cpu", FRAMES, W=W, H=H, max_cnt=MAX_CNT, max_kp=128,
                                   vo=True, lockstep=True)
    return res


def test_vo_loop_path_rehearsal(vo_run):
    chip_smoke.check_loop_path(vo_run, on_gpu=False)
    assert vo_run["kf_timed"] >= 10 and vo_run["solves_6dof"] >= 1
    assert vo_run["lk_levels"] == 4


def test_map_roundtrip_rehearsal(vo_run, tmp_path):
    """Phase 11b: the run's map saved, loaded into a fresh VO pipeline that
    replays the revisit part from its own origin, loops onto the map; and
    through the reference directory."""
    res = chip_smoke.run_map_roundtrip("cpu", vo_run, workdir=str(tmp_path))
    chip_smoke.check_map_roundtrip(res)
    assert res["aligned"] and res["map_keyframes"] == vo_run["latency_kf"]


def test_reference_map_roundtrips_both_ways(vo_run, tmp_path):
    """The phase-11 graph (real descriptors, loops, corrected poses) written
    by the port and by JAX (after loading the port's directory) gives the
    same files, and both packages load them into equal graphs."""
    g = vo_run["graph"]
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    tinterop.save_reference_pose_graph(d_port, g)
    c = g.cam
    jcam = make_camera("PINHOLE", fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, k1=c.k1, k2=c.k2, p1=c.p1,
                       p2=c.p2, width=c.width, height=c.height)
    jg = jpg.PoseGraph(jpg.PoseGraphConfig(**dataclasses.asdict(g.cfg)), jcam, g.ric, g.tic)
    assert jinterop.load_reference_pose_graph(d_port, jg) == len(g.keyframes)
    jinterop.save_reference_pose_graph(d_jax, jg)
    names = sorted(os.listdir(d_port))
    assert names == sorted(os.listdir(d_jax)) and "pose_graph.txt" in names
    match, mismatch, errors = filecmp.cmpfiles(d_port, d_jax, names, shallow=False)
    assert not mismatch and not errors, mismatch
    tg = tpg.PoseGraph(g.cfg, g.cam, g.ric, g.tic, "cpu")
    assert tinterop.load_reference_pose_graph(d_jax, tg) == len(g.keyframes)
    _same_graph(tg, jg)
    # the live graph's kept state survives: keyframes, poses, descriptors, loops
    for a, b in zip(g.keyframes, tg.keyframes):
        np.testing.assert_allclose(b.P_vio, a.P_vio, atol=1e-8)
        va = np.asarray(a.kp_valid, bool)
        np.testing.assert_array_equal(b.kp_desc[:int(va.sum())], _host(a.kp_desc)[va])
    assert {(lp["cur"], lp["old"]) for lp in tg.loops} <= {(lp["cur"], lp["old"]) for lp in g.loops}
    assert len(tg.loops) == len({lp["cur"] for lp in g.loops})


def test_checkpoint_resume_rehearsal(tmp_path):
    """Phase 11c: a VO pipeline with the pose graph inline checkpointed after
    frame 64 and resumed in a fresh one equals the uninterrupted run bit for
    bit over frames 64-95, loops included."""
    res = chip_smoke.run_checkpoint_resume("cpu", 96, 64, W=W, H=H, max_cnt=MAX_CNT,
                                           max_kp=128, workdir=str(tmp_path))
    chip_smoke.check_checkpoint_resume(res)
    assert res["max_dP"] == 0.0 and res["loops"][0] == res["loops"][1] >= 1


def test_checkpoint_refuses_another_config(tmp_path):
    rig, _, _, _ = chip_smoke.slice_config(160, 120, 32)
    seq = chip_smoke.syn.make_trajectory(12, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    cfg = dataclasses.replace(chip_smoke.latency_config(rig, seq, 32), imu=False)
    ts, imgs, deps = chip_smoke.syn.render_sequence(seq, rig, "cpu")
    pipe = TPipeline(cfg, "cpu")
    for k in range(12):
        pipe.push_image(ts[k], imgs[k])
        pipe.push_depth(ts[k], deps[k])
        pipe.spin_once()
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_pipeline(pipe, path)
    back = tckpt.load_pipeline(cfg, path, "cpu")
    assert back.estimator.solver_flag == back.estimator.NON_LINEAR
    assert back.estimator._step == pipe.estimator._step == 12
    for a, b in zip(tckpt._leaves(back.estimator.state), tckpt._leaves(pipe.estimator.state)):
        assert a.dtype == b.dtype and bool((a == b).all())
    with pytest.raises(ValueError, match="config mismatch"):
        tckpt.load_pipeline(dataclasses.replace(cfg, max_features=64), path, "cpu")
