"""The port's loop closure against the JAX package on the CPU, on the same
numpy inputs (320×240 renders, ``max_kp`` 128, ``max_wp`` 64, as
``tests/test_loop.py``): the BRIEF pattern and its file parser,
descriptors, Hamming matching, keyframe extraction, retrieval scores, PnP
RANSAC with JAX's draws injected, the 4-DoF LM, and a ``PoseGraph`` fed one
keyframe stream with a yaw drift; plus the revisit scene and the IMU
corruption.

Tolerances: descriptor bits equal wherever the two samples of a pair
differ by more than 1e-4 in the port, and ≥ 99.9 % equal overall (JAX's
box filter sums in another order); ``kp_uv`` equal in order, ``kp_norm``
within 1e-5; Hamming distances, matches and retrieval scores exact; PnP
inliers and counts equal, the model within 1e-4; the 4-DoF LM within 1e-4
(yaw in degrees, t in metres); the graph's loops equal (cur, old, inlier
count), ``rel_t`` within 1e-4 and ``path()`` within 1e-3 m (the JAX graph's
LM runs in float64 under the suite's x64 setting, the port's in float32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import assert_close, f32, tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.loop import brief as tbrief
from vins_rgbd_fast_torch.loop import interop as tinterop
from vins_rgbd_fast_torch.loop import pose_graph as tpg
from vins_rgbd_fast_torch.models.camera import PinholeCamera
from vins_rgbd_fast_torch.ops import fast as tfast
from vins_rgbd_fast_torch.ops import ransac as transac
from vins_rgbd_fast_tpu.io import synthetic as jsyn
from vins_rgbd_fast_tpu.loop import brief as jbrief
from vins_rgbd_fast_tpu.loop import pose_graph as jpg
from vins_rgbd_fast_tpu.models import make_camera
from vins_rgbd_fast_tpu.ops import lk as jlk
from vins_rgbd_fast_tpu.ops import ransac as jransac
from vins_rgbd_fast_tpu.utils import quaternion as jquat

W, H = 320, 240
RIG = dict(width=W, height=H, fx=230.0, fy=230.0, cx=160.0, cy=120.0)
CFG = dict(max_kp=128, max_wp=64, recency_exclusion=8, min_loop_num=15, score_best=0.08,
           score_second=0.02)


def _cams():
    return (PinholeCamera(**RIG), make_camera("PINHOLE", k1=0, k2=0, p1=0, p2=0, **RIG))


@pytest.fixture(scope="module")
def scene():
    """The bench's revisit scene at 320×240: 112 frames, rendered."""
    rig = tsyn.SyntheticRig(**RIG)
    seq = tsyn.make_revisit_trajectory(112, rig, seed=207, accel=1.5, axis=(0.0, 1.0, 0.0),
                                       cycles=2)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    return seq, ts, tn(imgs), tn(deps)


def test_revisit_scene_and_imu_corruption_match_jax():
    rig = tsyn.SyntheticRig(**RIG)
    jrig = jsyn.SyntheticRig(**RIG)
    a = tsyn.make_revisit_trajectory(40, rig, seed=207, accel=1.5, axis=(0.0, 1.0, 0.0), cycles=2)
    b = jsyn.make_revisit_trajectory(40, jrig, seed=207, accel=1.5, axis=(0.0, 1.0, 0.0), cycles=2)
    kw = dict(seed=307, gyr_noise=0.003, acc_noise=0.01, gyr_bias_ramp=0.01, acc_bias=0.02,
              gyr_pulse=0.2, pulse_frac=(0.18, 0.3))
    for x, y in ((a, b), (tsyn.corrupt_imu(a, **kw), jsyn.corrupt_imu(b, **kw))):
        for f in ("times", "P", "Q", "V", "ric", "tic"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        assert len(x.imu) == len(y.imu)
        for (t1, a1, g1), (t2, a2, g2) in zip(x.imu, y.imu):
            assert t1 == t2
            np.testing.assert_array_equal(a1, a2)
            np.testing.assert_array_equal(g1, g2)


def test_brief_pattern_and_pattern_file(tmp_path, monkeypatch):
    np.testing.assert_array_equal(tbrief.make_pattern(), jbrief.make_pattern())
    np.testing.assert_array_equal(tbrief.PATTERN, jbrief._PATTERN_NP)
    assert tbrief.pattern_hash() == jbrief.pattern_hash()
    pat = tbrief.make_pattern(11)
    lists = {k: ", ".join(str(int(v)) for v in pat[:, i])
             for i, k in enumerate(("x1", "y1", "x2", "y2"))}
    path = tmp_path / "brief_pattern.yml"
    path.write_text("%YAML:1.0\n---\n" + "".join(f"{k}: [ {v} ]\n" for k, v in lists.items()))
    np.testing.assert_array_equal(tbrief.load_pattern_yml(str(path)),
                                  jbrief.load_pattern_yml(str(path)))
    np.testing.assert_array_equal(tbrief.load_pattern_yml(str(path)), pat)
    monkeypatch.setenv("VINS_BRIEF_PATTERN", str(path))
    np.testing.assert_array_equal(tbrief._select_pattern(), jbrief._select_pattern())
    monkeypatch.setenv("VINS_BRIEF_PATTERN", "generated")
    np.testing.assert_array_equal(tbrief._select_pattern(), jbrief._select_pattern())
    bad = tmp_path / "bad.yml"
    bad.write_text("x1: [1, 2]\n")
    monkeypatch.setenv("VINS_BRIEF_PATTERN", str(bad))
    np.testing.assert_array_equal(tbrief._select_pattern(), tbrief.make_pattern())


def test_brief_descriptors_and_matching(scene):
    _, _, imgs, _ = scene
    rng = np.random.default_rng(3)
    uv = np.concatenate([rng.uniform(0, [W - 1, H - 1], (90, 2)),
                         [[0.5, 0.5], [W - 1.2, H - 1.7], [3.3, 200.9], [25.0, 25.0]],
                         rng.uniform(24, [W - 25, H - 25], (34, 2))]).astype(np.float32)
    valid = rng.random(len(uv)) < 0.9
    d_j = [np.asarray(d) for d in jax.jit(jbrief.compute_descriptors_pair)(
        *f32((imgs[5], uv, valid, uv[::-1].copy(), valid[::-1].copy())))]
    sp = tbrief.smoothed_padded(tt(imgs[5]))
    a, b = (tn(v) for v in tbrief.pair_values(sp, tt(uv)))
    d_t = [tn(d) for d in tbrief.compute_descriptors_pair(
        tt(imgs[5]), tt(uv), tt(valid), tt(uv[::-1].copy()), tt(valid[::-1].copy()))]
    clear = (np.abs(a - b) > 1e-4) & valid[:, None]
    assert np.array_equal(d_t[0][clear], d_j[0][clear])
    for x, y in zip(d_t, d_j):
        assert x.dtype == np.int8 and np.mean(x == y) >= 0.999
        assert np.all(x[~np.any(x != 0, 1)] == 0)
    # the JAX pair values themselves (its patches and selector matmuls)
    spj = jnp.pad(jbrief.smooth(jnp.asarray(imgs[5])), tbrief.PAD, mode="edge")
    flat = np.asarray(jlk._batched_subpix_patches(spj, jnp.asarray(uv), 49, tbrief.PAD)
                      ).reshape(len(uv), -1)
    assert_close(a, flat @ np.asarray(jbrief._SEL_A), 1e-3, what="pair a")
    D_t = tn(tbrief.hamming_matrix(tt(d_j[0]), tt(d_j[1])))
    np.testing.assert_array_equal(D_t, np.asarray(jbrief.hamming_matrix(*d_j)))
    va, vb = valid, valid[::-1].copy()
    for thr in (80.0, 40.0):
        it, ot = tbrief.match(tt(d_j[0]), tt(d_j[1]), tt(va), tt(vb), thr)
        ij, oj = jbrief.match(jnp.asarray(d_j[0]), jnp.asarray(d_j[1]), jnp.asarray(va),
                              jnp.asarray(vb), thr)
        np.testing.assert_array_equal(tn(ot), np.asarray(oj))
        np.testing.assert_array_equal(tn(it), np.asarray(ij))


def test_keyframe_extraction_matches_jax(scene):
    seq, ts, imgs, deps = scene
    tcam, jcam = _cams()
    cfg_t, cfg_j = tpg.PoseGraphConfig(**CFG), jpg.PoseGraphConfig(**CFG)
    rng = np.random.default_rng(5)
    wp_uv = rng.uniform(0, [W, H], (64, 2)).astype(np.float32)
    wp_valid = rng.random(64) < 0.8
    for k in (0, 40):
        out_j = jax.jit(functools.partial(jpg._extract_kf_device, cfg_j, jcam))(
            *f32((imgs[k], wp_uv, wp_valid, deps[k])))
        out_t = tpg.extract_kf_device(cfg_t, tcam, tt(imgs[k])[None], tt(wp_uv)[None],
                                      tt(wp_valid)[None], tt(deps[k])[None])
        kp_uv, kp_norm, kp_valid, kp_desc, wp_desc = (tn(o[0]) for o in out_t)
        np.testing.assert_array_equal(kp_uv, np.asarray(out_j[0]))
        np.testing.assert_array_equal(kp_valid, np.asarray(out_j[2]))
        assert kp_valid.sum() > 60
        assert_close(kp_norm, out_j[1], 1e-5, what="kp_norm")
        for x, y in ((kp_desc, out_j[3]), (wp_desc, out_j[4])):
            assert np.mean(x == np.asarray(y)) >= 0.999


def test_retrieval_scores_match_jax():
    rng = np.random.default_rng(7)
    cap, width = 64, 40
    db = rng.choice(np.asarray([-1, 1], np.int8), (cap, width, 256))
    dbv = rng.random((cap, width)) < 0.85
    qs = db[[3, 17]].copy()
    flip = rng.random(qs.shape) < 0.15
    qs[flip] = -qs[flip]
    qvs = rng.random((2, width)) < 0.9
    s_t = tn(tpg.db_query_multi(tt(db), tt(dbv), tt(qs), tt(qvs), 60.0))
    s_j = np.asarray(jpg._db_query_multi(*map(jnp.asarray, (db, dbv, qs, qvs)), score_dist=60.0))
    np.testing.assert_array_equal(s_t, s_j)
    assert s_t[0, 3] > 0.5 and s_t[1, 17] > 0.5
    np.testing.assert_array_equal(
        tn(tpg.db_query(tt(db), tt(dbv), tt(qs[0]), tt(qvs[0]), 20, 60.0)),
        np.asarray(jpg._db_query(*map(jnp.asarray, (db, dbv, qs[0], qvs[0])),
                                 jnp.asarray(20, jnp.int32), score_dist=60.0)))


def _pnp_problem(seed, n=64):
    rng = np.random.default_rng(seed)
    pc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(1.5, 5, n)], 1)
    R = jquat.q2R(jquat.so3_exp(jnp.asarray(rng.normal(0, 0.3, 3))))
    R = np.asarray(R, np.float64)
    t = rng.normal(0, 0.5, 3)
    Pw = (pc - t) @ R  # world points: pc = R Pw + t
    uv = pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.002, (n, 2))
    out = rng.random(n) < 0.2
    uv[out] += rng.normal(0, 0.3, (out.sum(), 2))
    z = pc[:, 2] * (1 + rng.normal(0, 0.01, n))
    valid = rng.random(n) < 0.95
    dR = np.asarray(jquat.q2R(jquat.so3_exp(jnp.asarray(rng.normal(0, 0.03, 3)))), np.float64)
    obs = np.concatenate([uv, z[:, None]], 1)
    return [np.asarray(a, np.float32) for a in (Pw, obs, dR @ R, t + rng.normal(0, 0.05, 3))] \
        + [valid]


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_guess_matches_jax(seed):
    Pw, obs, R0, t0, valid = _pnp_problem(seed)
    key = jax.random.PRNGKey(seed + 11)
    j = jransac.pnp_ransac_guess(key, *f32((Pw, obs)), jnp.asarray(valid), *f32((R0, t0)),
                                 n_trials=32, min_inliers=25)
    u = jax_ransac_uniforms(key, 32, len(Pw))
    r = transac.pnp_ransac_guess(tt(u)[None], tt(Pw)[None], tt(obs)[None], tt(valid)[None],
                                 tt(R0)[None], tt(t0)[None], min_inliers=25)
    np.testing.assert_array_equal(tn(r.inliers[0]), np.asarray(j.inliers))
    assert int(r.n_inliers[0]) == int(j.n_inliers) > 30
    assert bool(r.ok[0]) == bool(j.ok)
    assert_close(tn(r.model[0]), j.model, 1e-4, what="model")
    # one Gauss-Newton step, the closed-form Jacobian against JAX's jacfwd
    w = valid.astype(np.float32)
    gj = jransac._pnp_gn(*f32((Pw, obs[:, :2], w, R0, t0)), iters=1,
                         z_meas=jnp.asarray(obs[:, 2]))
    gt_ = transac.pnp_gn(tt(Pw), tt(obs[:, :2]), tt(w), tt(R0), tt(t0), iters=1,
                         z_meas=tt(obs[:, 2]))
    assert_close(tn(gt_[0]), gj[0], 1e-5, what="GN R")
    assert_close(tn(gt_[1]), gj[1], 1e-5, what="GN t")


def _square_graph():
    """The graph of ``tests/test_loop.py:67``: a square path with 6 %
    translation drift and three exact loop edges."""
    K = 24
    gt_t, gt_yaw = [], []
    for k in range(K):
        leg, s = k // 6, k % 6
        base = {0: (0, 0), 1: (6, 0), 2: (6, 6), 3: (0, 6)}[leg]
        d = {0: (1, 0), 1: (0, 1), 2: (-1, 0), 3: (0, -1)}[leg]
        gt_t.append([base[0] + d[0] * s, base[1] + d[1] * s, 0.0])
        gt_yaw.append(leg * 90.0)
    gt_t, gt_yaw = np.asarray(gt_t, float), np.asarray(gt_yaw, float)

    def yaw_R(y):
        return np.asarray(jquat.yaw_R(jnp.asarray(y)), np.float64)

    vio_t = np.zeros((K, 3))
    for k in range(1, K):
        R_prev = yaw_R(gt_yaw[k - 1])
        vio_t[k] = vio_t[k - 1] + R_prev @ ((R_prev.T @ (gt_t[k] - gt_t[k - 1])) * 1.06)
    e_i, e_j, e_rt, e_ry, e_loop = [], [], [], [], []
    for k in range(1, K):
        for b in range(1, 5):
            if k - b >= 0:
                e_i.append(k - b), e_j.append(k), e_loop.append(False)
                e_rt.append(yaw_R(gt_yaw[k - b]).T @ (vio_t[k] - vio_t[k - b]))
                e_ry.append(gt_yaw[k] - gt_yaw[k - b])
    for (a, b) in [(0, K - 1), (1, K - 2), (2, K - 3)]:
        e_i.append(a), e_j.append(b), e_loop.append(True)
        e_rt.append(yaw_R(gt_yaw[a]).T @ (gt_t[b] - gt_t[a]))
        e_ry.append(gt_yaw[b] - gt_yaw[a])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    E = len(e_i)
    return [gt_yaw.astype(np.float32), vio_t.astype(np.float32), np.zeros(K, np.float32),
            np.zeros(K, np.float32), np.ones(K, bool), fixed, np.asarray(e_i, np.int32),
            np.asarray(e_j, np.int32), np.asarray(e_rt, np.float32),
            np.asarray(e_ry, np.float32), np.ones(E, np.float32), np.asarray(e_loop),
            np.ones(E, bool)], gt_t


def test_optimize_4dof_matches_jax():
    args, gt_t = _square_graph()
    K = args[0].shape[0]
    for huber in (0.1, 1.0):
        yj, tj, c0j, c1j = jpg.optimize_4dof(*map(jnp.asarray, args), n_nodes_static=K,
                                             iters=12, huber=huber)
        yt, tt_, c0t, c1t = tpg.optimize_4dof(*map(tt, args[:10] + args[11:]), iters=12,
                                              huber=huber)
        assert_close(tn(yt), yj, 1e-4, what="yaw")
        assert_close(tn(tt_), tj, 1e-4, what="t")
        assert_close(tn(c0t), c0j, 0.0, 1e-5, what="cost0")
        assert_close(tn(c1t), c1j, 1e-6, 1e-3, what="cost")
        if huber == 0.1:  # the loop test's setting: the end pulled back near truth
            assert np.linalg.norm(tn(tt_)[K - 1] - gt_t[K - 1]) < 0.5 * np.linalg.norm(
                args[1][K - 1] - gt_t[K - 1])
    # the closed-form edge Jacobians against jacfwd of JAX's residual
    rng = np.random.default_rng(2)
    E = 16
    yaw = rng.uniform(-180, 180, 2 * E).astype(np.float32)
    tv = rng.normal(0, 3, (2 * E, 3)).astype(np.float32)
    pr = rng.uniform(-20, 20, (2, 2 * E)).astype(np.float32)
    ei, ej = np.arange(E), np.arange(E, 2 * E)
    rel_t = rng.normal(0, 1, (E, 3)).astype(np.float32)
    rel_y = rng.uniform(-30, 30, E).astype(np.float32)
    r, J = tpg._edge_terms(tt(yaw), tt(tv), tt(pr[0]), tt(pr[1]), tt(ei), tt(ej), tt(rel_t),
                           tt(rel_y), True)
    for e in range(E):
        meas = (jnp.asarray(rel_t[e]), jnp.asarray(rel_y[e]), jnp.asarray(pr[0, e]),
                jnp.asarray(pr[1, e]), jnp.asarray(0.1, jnp.float32))
        x = jnp.concatenate([jnp.asarray(yaw[e:e + 1]), jnp.asarray(tv[e]),
                             jnp.asarray(yaw[E + e:E + e + 1]), jnp.asarray(tv[E + e])])

        def res(x):
            return jpg._edge_residual(x[0], x[1:4], x[4], x[5:8], meas)

        assert_close(tn(r[e]), res(x), 1e-4, what="edge residual")
        assert_close(tn(J[e]), jax.jacfwd(res)(x), 1e-5, what="edge Jacobian")


def _keyframe_stream(scene, tcam, every=4, drift_deg=4.0):
    """Keyframes every ``every`` frames of the revisit scene: the strongest
    64 FAST corners with rendered depth as window points, and a yaw drift
    about the origin that grows to ``drift_deg`` in the outbound sweep."""
    seq, ts, imgs, deps = scene
    out = []
    for k in range(0, len(ts), every):
        frac = np.clip((k - 20) / 14.0, 0.0, 1.0)
        Rd = tpg.nq.yaw_R(drift_deg * frac)
        img = imgs[k]
        score = tfast.nms3(tfast.fast_score(tt(img)[None], 20.0))[0]
        idx = torch.sort(score.reshape(-1), descending=True, stable=True).indices[:64]
        uv = np.stack([tn(idx % W), tn(idx // W)], -1).astype(np.float64)
        d = deps[k][uv[:, 1].astype(int), uv[:, 0].astype(int)].astype(np.float64)
        rays = tn(tcam.lift(tt(uv)))
        t_wc, q_wc = tsyn.camera_pose(seq, k)
        wp_world = ((rays * d[:, None]) @ tpg.nq.q2R(q_wc).T + t_wc) @ Rd.T
        out.append(dict(img=img, t=float(ts[k]), P=Rd @ seq.P[k],
                        Q=tpg.nq.qmul(tpg.nq.R2q(Rd), seq.Q[k]), wp_world=wp_world, wp_uv=uv,
                        wp_norm=rays[:, :2], wp_valid=d > 0.2, depth=deps[k]))
    return seq, out


def _record_candidates(graph):
    seen = []
    inner = graph._accept_from_scores

    def wrapped(scores):
        c = inner(scores)
        seen.append(c)
        return c
    graph._accept_from_scores = wrapped
    return seen


def test_pose_graph_matches_jax_on_a_keyframe_stream(scene):
    tcam, jcam = _cams()
    seq, stream = _keyframe_stream(scene, tcam)
    jg = jpg.PoseGraph(jpg.PoseGraphConfig(**CFG), jcam, seq.ric, seq.tic)
    tg = tpg.PoseGraph(tpg.PoseGraphConfig(**CFG), tcam, seq.ric, seq.tic, "cpu",
                       pnp_uniforms=lambda i, n: jax_ransac_uniforms(jax.random.PRNGKey(i), 32, n))
    cand_j, cand_t = _record_candidates(jg), _record_candidates(tg)
    for kf in stream:
        args = (kf["t"], kf["P"], kf["Q"], kf["wp_world"], kf["wp_uv"], kf["wp_norm"],
                kf["wp_valid"])
        info_j = jg.add_keyframe(np.asarray(kf["img"], np.float32), *args,
                                 depth=jnp.asarray(kf["depth"], jnp.float32))
        info_t = tg.add_keyframe(tt(kf["img"]), *args, depth=tt(kf["depth"]))
        assert (info_j is None) == (info_t is None)
    assert cand_t == cand_j
    assert len(jg.loops) >= 2, [(lp["cur"], lp["old"]) for lp in jg.loops]
    assert ([(lp["cur"], lp["old"], lp["n_inliers"]) for lp in tg.loops]
            == [(lp["cur"], lp["old"], lp["n_inliers"]) for lp in jg.loops])
    for a, b in zip(tg.loops, jg.loops):
        assert_close(a["rel_t"], b["rel_t"], 1e-4, what="rel_t")
        assert_close(a["rel_yaw"], b["rel_yaw"], 1e-3, what="rel_yaw")
        np.testing.assert_array_equal(a["inlier_mask"], b["inlier_mask"])
    assert_close(np.stack([p[1] for p in tg.path()]), np.stack([p[1] for p in jg.path()]),
                 1e-3, what="path")
    np.testing.assert_array_equal(tg.desc_db, jg.desc_db)
    # the corrected path beats the drifted keyframes against ground truth
    gt = {float(t): P for t, P in zip(seq.times, seq.P)}
    err_c = np.mean([np.linalg.norm(p[1] - gt[p[0]]) for p in tg.path()[-6:]])
    err_v = np.mean([np.linalg.norm(k.P_vio - gt[k.t]) for k in tg.keyframes[-6:]])
    assert err_c < err_v, (err_c, err_v)

    # the bridge: JAX's graph copied into an empty port graph holds the
    # same state and builds the same PGO problem
    cg = bridge.copy_pose_graph(jg, tpg.PoseGraph(tg.cfg, tcam, seq.ric, seq.tic, "cpu"))
    np.testing.assert_array_equal(cg.desc_db, jg.desc_db)
    np.testing.assert_array_equal(cg._db_index, jg._db_index)
    assert cg._dev_db.shape == tuple(jg._dev_db.shape)
    pj, pc = jg._build_4dof(), cg._build_4dof()
    for k in ("yaw", "tt", "pitch", "roll", "valid", "fixed", "ei", "ej", "ert", "ery", "elo"):
        np.testing.assert_array_equal(pc[k], pj[k])
    kf_back = bridge.to_numpy(cg.keyframes[3])
    for x, y in zip(kf_back, jg.keyframes[3]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _mini_graphs():
    tcam, jcam = _cams()
    kw = dict(max_kp=32, max_wp=16)
    return (tpg.PoseGraph(tpg.PoseGraphConfig(**kw), tcam, np.eye(3), np.zeros(3), "cpu"),
            jpg.PoseGraph(jpg.PoseGraphConfig(**kw), jcam, np.eye(3), np.zeros(3)))


def _zeros_kp():
    return dict(kp_uv=np.zeros((32, 2)), kp_norm=np.zeros((32, 2)), kp_valid=np.zeros(32, bool),
                kp_desc=np.zeros((32, 256), np.int8), wp_world=np.zeros((16, 3)),
                wp_norm=np.zeros((16, 2)), wp_valid=np.zeros(16, bool),
                wp_desc=np.zeros((16, 256), np.int8))


def test_update_keyframe_loop_matches_jax():
    """The fast-relocalization feedback case of ``tests/test_loop.py:400``,
    with a yawed current keyframe."""
    graphs = []
    for g, mod in zip(_mini_graphs(), (tpg, jpg)):
        g.keyframes.append(mod.KeyFrameData(index=0, t=0.0, sequence=1, P_vio=np.zeros(3),
                                            Q_vio=np.array([1.0, 0, 0, 0]), **_zeros_kp()))
        q = np.array([0.99, 0.0, 0.0, 0.14])
        g.keyframes.append(mod.KeyFrameData(index=1, t=5.0, sequence=1,
                                            P_vio=np.array([2.4, 0.3, 0.0]),
                                            Q_vio=q / np.linalg.norm(q), **_zeros_kp()))
        g.loops.append(dict(cur=1, old=0, rel_t=np.zeros(3), rel_yaw=0.0,
                            rel_q=np.array([1.0, 0, 0, 0])))
        g.update_keyframe_loop(1, np.array([2.0, 0.0, 0.0]), np.array([1.0, 0, 0, 0]), 0.0)
        graphs.append(g)
    tg, jg = graphs
    assert tg.yaw_drift == jg.yaw_drift and abs(tg.yaw_drift) > 1.0
    np.testing.assert_allclose(tg.t_drift, jg.t_drift, rtol=0, atol=1e-12)
    a = tg.apply_drift(np.array([2.4, 0.3, 0.0]), np.array([1.0, 0, 0, 0]))
    b = jg.apply_drift(np.array([2.4, 0.3, 0.0]), np.array([1.0, 0, 0, 0]))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tg.loops[-1]["rel_t"], jg.loops[-1]["rel_t"])


def test_cross_sequence_alignment_matches_jax():
    """The case of ``tests/test_loop.py:433``: the first cross-sequence loop
    merges the new sequence's world onto the map."""
    out = []
    for g, mod in zip(_mini_graphs(), (tpg, jpg)):
        g.keyframes.append(mod.KeyFrameData(index=0, t=0.0, sequence=1,
                                            P_vio=np.array([1.0, 0, 0]),
                                            Q_vio=np.array([1.0, 0, 0, 0]), **_zeros_kp()))
        g._db_append(np.zeros((32, 256), np.int8))
        g.new_sequence()
        assert g.sequence == 2 and not g.sequence_aligned[2]
        q = np.array([0.98, 0.0, 0.0, 0.2])
        kf = mod.KeyFrameData(index=1, t=10.0, sequence=2, P_vio=np.array([0.1, 0.2, 0.0]),
                              Q_vio=q / np.linalg.norm(q), **_zeros_kp())
        g.keyframes.append(kf)
        info = dict(cur=1, old=0, rel_t=np.array([0.5, 0, 0]), rel_yaw=3.0,
                    rel_q=np.array([0.9997, 0, 0, 0.026]))
        g.accept_loop(kf, 0, info)
        out.append((g.keyframes[1].P_vio, g.keyframes[1].Q_vio, g.w_r_vio, g.w_t_vio,
                    g.corrected[1][0], g.sequence_aligned[2], g.earliest_loop_index))
    for x, y in zip(*out):
        np.testing.assert_allclose(np.asarray(x, float), np.asarray(y, float), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out[0][0], [1.5, 0.0, 0.0], atol=0.1)


def test_pose_graph_unported_parts_raise(tmp_path):
    """The parts once refused now run (the 6-DoF ``optimize``, ``save`` and
    ``load``; their parity is ``tests/test_torch_vo.py`` and
    ``tests/test_torch_persistence.py``); what still raises is a malformed
    reference map.  Then the DB compaction's parity."""
    tcam, _ = _cams()
    g = tpg.PoseGraph(tpg.PoseGraphConfig(max_kp=32, max_wp=16, use_6dof=True), tcam,
                      np.eye(3), np.zeros(3), "cpu")
    for i in range(2):
        g.keyframes.append(tpg.KeyFrameData(index=i, t=float(i), sequence=1,
                                            P_vio=np.full(3, 0.1 * i),
                                            Q_vio=np.array([1.0, 0, 0, 0]), **_zeros_kp()))
    g.loops.append(dict(cur=1, old=0, rel_t=np.zeros(3), rel_yaw=0.0,
                        rel_q=np.array([1.0, 0, 0, 0])))
    g.earliest_loop_index = 0
    g.optimize()
    assert g.n_solves_6dof == 1 and set(g.corrected) == {0, 1}
    path = str(tmp_path / "map.npz")
    g.save(path)
    back = tpg.PoseGraph(g.cfg, tcam, np.eye(3), np.zeros(3), "cpu")
    back.load(path)
    assert [k.index for k in back.keyframes] == [0, 1] and back.loops[0]["old"] == 0
    bad = tmp_path / "bad_map"
    bad.mkdir()
    (bad / "pose_graph.txt").write_text("0 0.0 1 2 3\n")
    with pytest.raises(ValueError, match="26 fields"):
        tinterop.load_reference_pose_graph(str(bad), back)
    # the retrieval DB at max_keyframes compacts as JAX's (keyframe 1 is in a
    # loop: kept), through both appends, a padded block included ...
    _, jcam = _cams()
    rng = np.random.default_rng(8)
    rows = rng.choice(np.asarray([-1, 1], np.int8), (16, 48, 256))
    valid = rng.random((16, 48)) < 0.9
    norm = rng.normal(size=(16, 48, 3)).astype(np.float32)
    graphs = []
    for mod, cam, dev in ((tpg, tcam, ("cpu",)), (jpg, jcam, ())):
        cg = mod.PoseGraph(mod.PoseGraphConfig(max_kp=32, max_wp=16, max_keyframes=8), cam,
                           np.eye(3), np.zeros(3), *dev)
        cg.loops.append(dict(cur=6, old=1, rel_t=np.zeros(3), rel_yaw=0.0,
                             rel_q=np.array([1.0, 0, 0, 0])))
        steps = []
        for i in range(10):
            cg._db_append(rows[i], valid[i], norm[i], kf_index=i)
            steps.append((cg.desc_db, cg._db_index.copy(), cg.db_evicted))
        cg._db_append_block(rows[10:14], valid[10:14], count=3, norms=norm[10:14],
                            kf_indices=[10, 11, 12])
        steps.append((cg.desc_db, cg._db_index.copy(), cg.db_evicted))
        cg._db_append_block(rows[13:16], valid[13:16], norms=norm[13:16], kf_indices=[13, 14, 15])
        steps.append((cg.desc_db, cg._db_index.copy(), cg.db_evicted))
        graphs.append(steps)
    for (dt, it, et), (dj, ij, ej) in zip(*graphs):
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(it, ij)
        assert et == ej
    assert graphs[0][-1][2] == 3 and 1 in graphs[0][-1][1] and len(graphs[0][-1][1]) == 8
    # ... and a full DB that nothing can leave refuses appends without raising
    full = [tpg.PoseGraph(tpg.PoseGraphConfig(max_kp=32, max_wp=16, max_keyframes=2), tcam,
                          np.eye(3), np.zeros(3), "cpu"),
            jpg.PoseGraph(jpg.PoseGraphConfig(max_kp=32, max_wp=16, max_keyframes=2), jcam,
                          np.eye(3), np.zeros(3))]
    for fg in full:
        for i in range(3):
            fg._db_append(rows[i], valid[i], norm[i], kf_index=i)
        fg._db_append_block(rows[3:5], valid[3:5], norms=norm[3:5], kf_indices=[3, 4])
    np.testing.assert_array_equal(full[0].desc_db, full[1].desc_db)
    np.testing.assert_array_equal(full[0]._db_index, [0, 1])
    np.testing.assert_array_equal(full[1]._db_index, [0, 1])
    assert full[0].db_evicted == full[1].db_evicted == 0
