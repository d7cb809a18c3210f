"""The port's batched-path loop closure against the JAX package on the CPU
(``BatchedLoopCloser``, ``ThreadedLoopCloser``, ``db_query_all``,
``verify_loops_device``, the batched ``optimize_4dof``), on the same numpy
segments: B = 2 sequences at 320×240, the revisit scene with the yaw drift
of ``tests/test_torch_loop.py``'s keyframe stream and one clean
trajectory; every second frame a keyframe, segments of 6 frames;
``ScanOutputs`` from ground truth (the 64 strongest FAST corners of each
keyframe with their rendered depth as window points), so no VIO runs; JAX's
``PRNGKey(index)`` PnP draws injected into the port.

Tolerances: keyframes, candidates, loops (cur, old, inlier count), the DB
rows and their slot -> keyframe map equal; ``rel_t`` within 1e-4 m,
``rel_yaw`` within 1e-3 deg, ``path()`` within 1e-3 m (JAX's PGO runs in
float64 under the suite's x64 setting, the port's in float32); the batched
4-DoF solve within 1e-5 of the port's per-problem solves and 1e-4 of JAX's
vmapped one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_loop import _square_graph
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import assert_close, tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.loop import pose_graph as tpg
from vins_rgbd_fast_torch.models.camera import PinholeCamera
from vins_rgbd_fast_torch.ops import fast as tfast
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_torch.parallel import loop_closer as tlc
from vins_rgbd_fast_tpu.loop import pose_graph as jpg
from vins_rgbd_fast_tpu.models import make_camera
from vins_rgbd_fast_tpu.parallel import batched_pipeline as jbp
from vins_rgbd_fast_tpu.parallel import loop_closer as jlc

W, H = 320, 240
RIG = dict(width=W, height=H, fx=230.0, fy=230.0, cx=160.0, cy=120.0)
CFG = dict(max_kp=128, max_wp=64, recency_exclusion=8, min_loop_num=15, score_best=0.08,
           score_second=0.02)
N_FRAMES, SEG, MAXI = 64, 6, 4
# a fixed chunk of 6 keyframes (3 per sequence per segment; the last segment pads)
CLOSER = dict(pgo_period=1.0, k_pad=6)
DRIVERS = ("consume", "split", "pipeline", "threaded")


@functools.lru_cache(maxsize=None)
def _pnp_draws(index, n):  # the draws JAX's graphs make for keyframe ``index``
    return jax_ransac_uniforms(jax.random.PRNGKey(index), 32, n)


def _window_points(tcam, seq, img, dep, k):
    """The 64 strongest FAST corners of frame k with their rendered depth:
    world points, pixels, normalized coordinates, valid."""
    score = tfast.nms3(tfast.fast_score(tt(img)[None], 20.0))[0]
    idx = torch.sort(score.reshape(-1), descending=True, stable=True).indices[:64]
    uv = np.stack([tn(idx % W), tn(idx // W)], -1).astype(np.float64)
    d = dep[uv[:, 1].astype(int), uv[:, 0].astype(int)].astype(np.float64)
    rays = tn(tcam.lift(tt(uv)))
    t_wc, q_wc = tsyn.camera_pose(seq, k)
    return (rays * d[:, None]) @ tpg.nq.q2R(q_wc).T + t_wc, uv, rays[:, :2], d > 0.2


@pytest.fixture(scope="module")
def segments():
    """The two sequences as JAX-typed numpy ``FrameBatch``/``ScanOutputs``
    segments, and the per-frame keyframe data for sequential replay."""
    rig = tsyn.SyntheticRig(**RIG)
    tcam = PinholeCamera(**RIG)
    seqs = [tsyn.make_revisit_trajectory(N_FRAMES, rig, seed=207, accel=1.5,
                                         axis=(0.0, 1.0, 0.0), cycles=2),
            tsyn.make_trajectory(N_FRAMES, rig, seed=55, omega_scale=0.15, acc_scale=0.3)]
    B, mw = len(seqs), CFG["max_wp"]
    f32 = np.float32
    imgs = np.zeros((N_FRAMES, B, H, W), f32)
    deps = np.zeros((N_FRAMES, B, H, W), f32)
    ts = np.zeros((N_FRAMES, B), f32)
    P = np.zeros((N_FRAMES, B, 3), f32)
    Q = np.zeros((N_FRAMES, B, 4), f32)
    is_kf = np.zeros((N_FRAMES, B), bool)
    wp_world = np.zeros((N_FRAMES, B, mw, 3), f32)
    wp_uv = np.zeros((N_FRAMES, B, mw, 2), f32)
    wp_norm = np.zeros((N_FRAMES, B, mw, 2), f32)
    wp_valid = np.zeros((N_FRAMES, B, mw), bool)
    for b, seq in enumerate(seqs):
        t_b, im_b, dp_b = (tn(x) if isinstance(x, torch.Tensor) else np.asarray(x)
                           for x in tsyn.render_sequence(seq, rig, "cpu"))
        imgs[:, b], deps[:, b], ts[:, b] = im_b, dp_b, t_b
        for k in range(N_FRAMES):
            # sequence 0 drifts in yaw about the origin, up to 4° over frames 20-34
            Rd = tpg.nq.yaw_R(4.0 * np.clip((k - 20) / 14.0, 0.0, 1.0) if b == 0 else 0.0)
            P[k, b] = Rd @ seq.P[k]
            Q[k, b] = tpg.nq.qmul(tpg.nq.R2q(Rd), seq.Q[k])
            if k % 2:
                continue
            is_kf[k, b] = True
            wpw, uv, nrm, ok = _window_points(tcam, seq, im_b[k], dp_b[k], k)
            wp_world[k, b], wp_uv[k, b], wp_norm[k, b], wp_valid[k, b] = wpw @ Rd.T, uv, nrm, ok
    segs = []
    for k0 in range(0, N_FRAMES, SEG):
        sl = slice(k0, min(k0 + SEG, N_FRAMES))
        T = sl.stop - sl.start
        segs.append((
            jbp.FrameBatch(imgs=imgs[sl], depths=deps[sl], ts=ts[sl],
                           imu_dts=np.zeros((T, B, MAXI), f32),
                           imu_acc=np.zeros((T, B, MAXI + 1, 3), f32),
                           imu_gyr=np.zeros((T, B, MAXI + 1, 3), f32)),
            jbp.ScanOutputs(P=P[sl], Q=Q[sl], V=np.zeros((T, B, 3), f32),
                            cost=np.zeros((T, B), f32), is_keyframe=is_kf[sl],
                            n_features=wp_valid[sl].sum(-1).astype(np.int32),
                            wp_world=wp_world[sl], wp_uv=wp_uv[sl], wp_norm=wp_norm[sl],
                            wp_valid=wp_valid[sl],
                            wp_ids=np.broadcast_to(np.arange(mw, dtype=np.int32),
                                                   (T, B, mw)).copy())))
    return seqs, segs


def _record_candidates(graph):
    seen = []
    inner = graph._accept_from_scores

    def wrapped(scores):
        c = inner(scores)
        seen.append(c)
        return c
    graph._accept_from_scores = wrapped
    return seen


def _seg_stats(stats):
    return [(s["n_keyframes"], s["n_loops"]) for s in stats if s and s.get("n_keyframes")]


def _unequal_capacities(closer):
    """Graph 1 pre-sized to 128 slots, graph 0 growing from none: the DBs
    never stack, so retrieval and verification take the per-sequence
    forms."""
    cfg = closer.cfg
    closer.graphs[1]._ensure_capacity(128, (cfg.max_kp + cfg.max_wp, 256))


_JAX = {}


def _jax_run(segs, retrieval, drained):
    """JAX's closer over the segments (``consume``), once per retrieval form;
    with ``drained``, a clone of it after ``pipeline_drain`` (the last PGO
    wake-up that the pipelined and threaded drivers run at their end)."""
    if drained:
        c, cands, stats = _jax_run(segs, retrieval, False)
        c = c.clone()
        c.pipeline_drain()
        return c, cands, stats
    if retrieval not in _JAX:
        rig = tsyn.SyntheticRig(**RIG)
        seq = tsyn.make_revisit_trajectory(8, rig)
        jcam = make_camera("PINHOLE", k1=0, k2=0, p1=0, p2=0, **RIG)
        kw = dict(CLOSER, db_capacity=64) if retrieval == "merged" else dict(CLOSER)
        c = jlc.BatchedLoopCloser(jcam, seq.ric, seq.tic, 2, jpg.PoseGraphConfig(**CFG), **kw)
        if retrieval == "per_sequence":
            _unequal_capacities(c)
        cands = [_record_candidates(g) for g in c.graphs]
        stats = [c.consume(jax.tree.map(jnp.asarray, bt), jax.tree.map(jnp.asarray, so))
                 for bt, so in segs]
        _JAX[retrieval] = (c, cands, _seg_stats(stats))
    return _JAX[retrieval]


def _port_closer(retrieval, seq, device="cpu"):
    kw = dict(CLOSER, db_capacity=64) if retrieval == "merged" else dict(CLOSER)
    c = tlc.BatchedLoopCloser(PinholeCamera(**RIG), seq.ric, seq.tic, 2, device,
                              tpg.PoseGraphConfig(**CFG), pnp_uniforms=_pnp_draws, **kw)
    if retrieval == "per_sequence":
        _unequal_capacities(c)
    return c


def _drive(closer, segs, driver):
    """The port's closer over the segments by one of its four drivers;
    returns the per-segment stats."""
    tsegs = [(bridge.to_torch(bt), bridge.to_torch(so)) for bt, so in segs]
    stats = []
    if driver == "consume":
        stats = [closer.consume(bt, so) for bt, so in tsegs]
    elif driver == "split":
        pend = None
        for bt, so in tsegs:
            if pend is not None:
                stats.append(closer.consume_finish(pend))
            pend = closer.consume_dispatch(bt, so)
        stats.append(closer.consume_finish(pend))
        closer.flush()
    elif driver == "pipeline":
        for bt, so in tsegs:
            stats.append(closer.pipeline_advance_packed(closer.pack_dispatch(bt, so)))
        stats += closer.pipeline_drain()
    else:
        tc = tlc.ThreadedLoopCloser(closer)
        for bt, so in tsegs:
            tc.submit(bt, so)
        stats = list(tc.drain())
        tc.close()
        assert not tc._worker.is_alive()
    return _seg_stats(stats)


@pytest.mark.parametrize("retrieval", ["merged", "per_sequence"])
@pytest.mark.parametrize("driver", DRIVERS)
def test_batched_closer_matches_jax(segments, driver, retrieval):
    seqs, segs = segments
    jc, jcands, jstats = _jax_run(segs, retrieval, driver in ("pipeline", "threaded"))
    tc = _port_closer(retrieval, seqs[0])
    tcands = [_record_candidates(g) for g in tc.graphs]
    tstats = _drive(tc, segs, driver)
    assert tstats == jstats
    assert tc.n_keyframes == jc.n_keyframes and tc.n_loops == jc.n_loops
    assert len(jc.graphs[0].loops) >= 2, [(lp["cur"], lp["old"]) for lp in jc.graphs[0].loops]
    assert (tc._dbs_stacked is None) == (retrieval == "per_sequence")
    for b, (tg, jg) in enumerate(zip(tc.graphs, jc.graphs)):
        assert len(tg.keyframes) == len(jg.keyframes) == N_FRAMES // 2
        assert tcands[b] == jcands[b]
        assert ([(lp["cur"], lp["old"], lp["n_inliers"]) for lp in tg.loops]
                == [(lp["cur"], lp["old"], lp["n_inliers"]) for lp in jg.loops])
        for a, c in zip(tg.loops, jg.loops):
            assert_close(a["rel_t"], c["rel_t"], 1e-4, what="rel_t")
            assert_close(a["rel_yaw"], c["rel_yaw"], 1e-3, what="rel_yaw")
        assert_close(np.stack([p[1] for p in tc.corrected_path(b)]),
                     np.stack([p[1] for p in jg.path()]), 1e-3, what="path")
        np.testing.assert_array_equal(tg.desc_db, jg.desc_db)
        np.testing.assert_array_equal(tg._db_index, jg._db_index)


def test_batched_closer_equals_sequential_pose_graph(segments):
    """The batched closer (merged retrieval, device verification, deferred
    appends) finds what the port's own ``PoseGraph.add_keyframe`` finds
    keyframe by keyframe (JAX's ``tests/test_batched_loop.py`` (b))."""
    seqs, segs = segments
    closer = _port_closer("merged", seqs[0])
    _drive(closer, segs, "split")
    for b, g in enumerate(closer.graphs):
        ref = tpg.PoseGraph(tpg.PoseGraphConfig(**CFG), PinholeCamera(**RIG), seqs[0].ric,
                            seqs[0].tic, "cpu", pnp_uniforms=_pnp_draws)
        for bt, so in segs:
            for k in np.nonzero(so.is_keyframe[:, b])[0]:
                ref.add_keyframe(tt(bt.imgs[k, b]), float(bt.ts[k, b]), so.P[k, b], so.Q[k, b],
                                 so.wp_world[k, b], so.wp_uv[k, b], so.wp_norm[k, b],
                                 so.wp_valid[k, b], depth=tt(bt.depths[k, b]))
        assert len(ref.keyframes) == len(g.keyframes)
        assert len(ref.loops) >= 2
        assert ([(lp["cur"], lp["old"], lp["n_inliers"]) for lp in ref.loops]
                == [(lp["cur"], lp["old"], lp["n_inliers"]) for lp in g.loops])
        for a, c in zip(ref.loops, g.loops):
            assert_close(a["rel_t"], c["rel_t"], 1e-4, what="rel_t")
        np.testing.assert_array_equal(ref.desc_db, g.desc_db)
        np.testing.assert_array_equal(ref._db_index, g._db_index)


def test_batched_optimize_4dof_matches_per_problem_and_jax():
    """Three perturbed copies of the square graph solved at once: each
    problem's own damping and accept/reject (the port's per-problem solves,
    JAX's ``jax.vmap`` of its solve)."""
    args, _ = _square_graph()
    K = args[0].shape[0]
    rng = np.random.default_rng(4)
    probs = []
    for _ in range(3):
        a = [x.copy() for x in args]
        a[0] = (a[0] + rng.normal(0, 2.0, a[0].shape)).astype(np.float32)
        a[1] = (a[1] + rng.normal(0, 0.1, a[1].shape)).astype(np.float32)
        a[8] = (a[8] + rng.normal(0, 0.05, a[8].shape)).astype(np.float32)
        probs.append(a)
    stacked = [np.stack([p[i] for p in probs]) for i in range(len(args))]
    for huber in (0.1, 1.0):
        out_b = tpg.optimize_4dof(*map(tt, stacked[:10] + stacked[11:]), iters=12, huber=huber)
        for i, p in enumerate(probs):
            out_1 = tpg.optimize_4dof(*map(tt, p[:10] + p[11:]), iters=12, huber=huber)
            for x, y, what in zip(out_b, out_1, ("yaw", "t", "cost0", "cost")):
                assert_close(tn(x[i]), tn(y), 1e-5, 1e-6, what=what)
        out_j = jax.vmap(lambda *a: jpg.optimize_4dof(*a, n_nodes_static=K, iters=12,
                                                      huber=huber))(*map(jnp.asarray, stacked))
        assert_close(tn(out_b[0]), out_j[0], 1e-4, what="yaw")
        assert_close(tn(out_b[1]), out_j[1], 1e-4, what="t")
        assert_close(tn(out_b[3]), out_j[3], 1e-6, 1e-3, what="cost")
        assert np.all(tn(out_b[3]) < tn(out_b[2]))


def test_scan_outputs_carry_the_window_points():
    """``BatchedVioRunner.run``'s ``ScanOutputs.wp_*`` are the per-frame
    ``StepOutput`` fields stacked (B = 2, 160×120), in JAX's field order."""
    assert tbp.ScanOutputs._fields == jbp.ScanOutputs._fields
    rig, tcfg, ecfg, cam = chip_smoke.slice_config(160, 120, 32)
    B, T = 2, 3
    seqs, rendered, bufs = chip_smoke.make_sequences(rig, B, 11 + T, "cpu")
    frames = ([r[1] for r in rendered], [r[2] for r in rendered], [r[0] for r in rendered], bufs)
    warm, run = tbp.stage_frames(*frames, 0, 11, "cpu"), tbp.stage_frames(*frames, 11, 11 + T, "cpu")
    runner = tbp.BatchedVioRunner(tcfg, cam, ecfg, "cpu", B)
    trk, st = runner.init_states(seqs[0].ric, seqs[0].tic)
    trk, st, _ = runner.warm(trk, st, warm)
    gen_states = [g.get_state() for g in runner.generators]
    _, _, outs = runner.run(trk, st, run)
    for g, s in zip(runner.generators, gen_states):
        g.set_state(s)
    steps = []
    for k in range(T):
        imu = tes.ImuInterval(run.imu_dts[k], run.imu_acc[k], run.imu_gyr[k])
        trk, st, sout = tbp.fused_frame_step(runner.tcfg, cam, ecfg, trk, st, run.imgs[k],
                                             run.depths[k], run.ts[k], imu,
                                             runner.ransac_uniforms())
        steps.append(sout)
    for f in ("P", "wp_world", "wp_uv", "wp_norm", "wp_valid", "wp_ids"):
        torch.testing.assert_close(getattr(outs, f), torch.stack([getattr(s, f) for s in steps]),
                                   rtol=0, atol=0)
    assert outs.wp_valid.shape == (T, B, ecfg.maxf) and bool(outs.wp_valid.any())


def test_threaded_closer_failure_surfaces_at_drain(segments):
    seqs, segs = segments
    closer = _port_closer("merged", seqs[0])
    gate_dispatch, calls = closer._gate_dispatch, []

    def fails_once(tok):
        calls.append(tok)
        if len(calls) == 1:
            raise RuntimeError("worker failed")
        return gate_dispatch(tok)

    closer._gate_dispatch = fails_once
    tc = tlc.ThreadedLoopCloser(closer)
    for bt, so in segs[:3]:
        tc.submit(bridge.to_torch(bt), bridge.to_torch(so))
    with pytest.raises(RuntimeError, match="worker failed"):
        tc.drain()
    tc.drain()  # reported once; the later segments went on
    assert closer.n_keyframes > 0
    tc.close()
    assert not tc._worker.is_alive()


def test_batched_loop_path_rehearsal():
    """Phase 10 of ``chip_smoke.py`` on the CPU at B = 2, 320×240: the runner
    self-warmed, one warm and eight timed segments of 12 frames through the
    threaded closer; loops found, finite costs, the clean sequence's ATE
    under its bound, the loop-corrected keyframes no worse than their VIO
    poses."""
    res = chip_smoke.run_batched_loop_path("cpu", B=2, n_frames=122, seg_len=12, W=W, H=H,
                                           max_cnt=64, max_kp=128, k_pad=8)
    chip_smoke.check_batched_loop_path(res, on_gpu=False)
    assert res["loops_found"] >= 1 and res["loop_kf"] >= 10
    assert all(np.isfinite(v) for v in res["stage_ms"].values())
