"""The batched runner over lanes warmed by the latency pipeline's own
initialization programs: the OpenLORIS rig (``static_init`` 0: one lane
through ``init_dynamic``, one with its depth withheld through
``init_mono``) and the RealSense rig (td estimated from 0 against IMU
stamps 5 ms ahead, rolling shutter, the extrinsic refined).

Each pair of port ``VinsPipeline``s is warmed until NON_LINEAR and fed on
to one common frame (``chip_smoke.stage_batched_rig_path``), stacked
(``stack_states``) and staged (``stage_frames_arrays``); the stacked states
are bridged to JAX, and both packages step 3 steady frames with the same
RANSAC draws: the port's ``fused_frame_step`` on B = 2, JAX's
``fused_frame_step`` per lane with its ``EstimatorConfig.from_vins``.

Tolerances: the newest position within 5e-3 m of JAX's per frame and lane
(``tests/test_torch_slice.py``'s); the window tables' feature ids equal;
finite costs; for the td lanes, run in float64 in both packages (the
freed extrinsic leaves float32 solves ill-conditioned,
``tests/test_torch_td_pipeline.py``), td within 1e-5 s of JAX's.  The
staged IMU intervals beside the lane's own pairing; JAX's own pipeline on
the one stream phase 20b lets miss its bound; and ``chip_smoke.py``'s
phases 20 and 20b rehearsed on the CPU at B = 2 and a small size, with
their gates."""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_backend import JAX_TYPES
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import tn, tt
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.config import EstimatorConfig
from vins_rgbd_fast_torch.io import synthetic as syn
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.frontend import feature_tracker as jft
from vins_rgbd_fast_tpu.parallel import batched_pipeline as jbp
from vins_rgbd_fast_tpu.pipeline import VinsPipeline as JPipeline

STEADY = 3
# the scenes of the parity tests: phase 20's at 424×240 (lane 1's depth
# withheld), phase 20b's at 320×240 in float64
SCENES = {"dyn-mono": dict(kind="dyn", W=424, H=240, dtype=torch.float32),
          "td": dict(kind="td", W=320, H=240, dtype=torch.float64)}


def _to_jax(tree, b):
    """Lane b of a port numpy NamedTuple tree -> the JAX classes."""
    if hasattr(tree, "_fields"):
        cls = jft.TrackerState if type(tree).__name__ == "TrackerState" \
            else JAX_TYPES[type(tree).__name__]
        return cls(*[_to_jax(v, b) for v in tree])
    if isinstance(tree, tuple):  # the tracker's pyramid levels
        return tuple(_to_jax(v, b) for v in tree)
    return jnp.asarray(tree[b])


def _jax_configs(cfg, runner):
    """JAX's tracker config as its pipeline builds it and its batched
    runner envelopes it, its camera, and its ``EstimatorConfig.from_vins``
    with the latency envelope's 2 LM iterations (the port's lanes run it)."""
    jv = jconfig.VinsConfig(**dataclasses.asdict(cfg))
    jcam = jv.camera()
    jecfg = dataclasses.replace(jest.EstimatorConfig.from_vins(jv), max_iters=2)
    jtcfg = jft.TrackerConfig(
        width=jv.image_width, height=jv.image_height, max_cnt=jv.max_cnt,
        capacity=jv.feature_capacity, min_dist=jv.min_dist, grid_rows=jv.num_grid_rows,
        grid_cols=jv.num_grid_cols, f_threshold=jv.f_threshold,
        fast_threshold=float(jv.fast_threshold), use_imu_prediction=jv.imu,
        lk_sampler="matmul", lk_max_iters=12, lk_coarse_iters=6)
    jtcfg = jbp.BatchedVioRunner(jtcfg, jcam, jecfg).tcfg
    assert dataclasses.asdict(jecfg) == dataclasses.asdict(runner.ecfg)
    return jtcfg, jcam, jecfg


def test_runner_takes_dynamic_init_and_warm_refuses_it():
    """The repaired fault: ``BatchedVioRunner`` takes the OpenLORIS rig's
    ``static_init`` 0 configuration (JAX's ``EstimatorConfig.from_vins``
    field for field); only its own ``warm``, static init by design,
    refuses it, naming the route through ``stack_states``."""
    rig, seq, cfg = chip_smoke.openloris_scene(2, 424, 240)
    ecfg = EstimatorConfig.from_vins(cfg)
    jecfg = jest.EstimatorConfig.from_vins(jconfig.VinsConfig(**dataclasses.asdict(cfg)))
    assert dataclasses.asdict(ecfg) == dataclasses.asdict(jecfg) and not ecfg.static_init
    _, tcfg, _, cam = chip_smoke.slice_config(424, 240)
    runner = tbp.BatchedVioRunner(tcfg, cam, ecfg, "cpu", 2)
    assert not runner.ecfg.static_init
    trk, st = runner.init_states(seq.ric, seq.tic)
    with pytest.raises(NotImplementedError, match="stack_states.*stage_frames_arrays"):
        runner.warm(trk, st, None)


def test_staged_intervals_continue_the_lanes_own_pairing():
    """A td lane's staged IMU intervals for frames [k_c, k_c + T) beside what
    the lane's own ``VinsPipeline`` pairs when it is fed those frames (at
    stamp + its host td, ``_td_cache``): the first starts where the
    pipeline left off (``prev_time``), and each is equal, sample for
    sample, until the pipeline's next td refresh moves its pairing by the
    refreshed td.  JAX's ``stage_frames_arrays`` pairs at the image stamps,
    td away from the lane's own pairing (ROADMAP.md section 3)."""
    T = 6
    rig, seq, cfg = chip_smoke.realsense_scene(32 + T, 160, 120)
    ts, imgs, deps = syn.render_sequence(seq, rig, "cpu")
    lane = chip_smoke.rig_lane("cpu", cfg, seq, imu_shift=chip_smoke.TD_TRUE,
                               failure_check_interval=4)
    chip_smoke.feed_lane(lane, ts, imgs, deps, 16, stop_at_init=True)
    pipe = lane["pipe"]
    e = pipe.estimator
    k_c = lane["init_frame"] + 1
    chip_smoke.feed_lane(lane, ts, imgs, deps, k_c)
    while abs(e._td_cache) < 1e-3 and k_c < 32:  # until a refresh reads td off 0
        k_c += 1
        chip_smoke.feed_lane(lane, ts, imgs, deps, k_c)
    td_c = e._td_cache
    assert abs(td_c) > 1e-3 and e.prev_time == float(ts[k_c - 1]) + td_c
    imu_before = copy.deepcopy(e._imu)  # staging consumes the lane's samples
    batch = tbp.stage_frames_arrays([pipe], [ts], [imgs], [deps], k_c, k_c + T)
    e._imu = imu_before
    # the lane's own pairing of the same frames
    rec = []
    collect = e._collect_interval_np

    def recorded(t0, t1):
        out = collect(t0, t1)
        rec.append((t0, t1, e._td_cache, out))
        return out

    e._collect_interval_np = recorded
    chip_smoke.feed_lane(lane, ts, imgs, deps, k_c + T)
    assert len(rec) == T and rec[0][0] == float(ts[k_c - 1]) + td_c
    same = [r[2] == td_c for r in rec]
    n_same = same.index(False) if False in same else T
    assert 1 <= n_same < T  # the refresh comes within the window
    for i, (t0, t1, td, (dts, acc, gyr)) in enumerate(rec):
        staged_iv = [tn(x[i, 0]) for x in (batch.imu_dts, batch.imu_acc, batch.imu_gyr)]
        if i < n_same:
            for got, ref in zip(staged_iv, (dts, acc, gyr)):
                np.testing.assert_array_equal(got, np.asarray(ref, np.float32))
        else:  # the pipeline's pairing moved by the refreshed td, the staging's did not
            assert t1 - (float(ts[k_c + i]) + td_c) == pytest.approx(td - td_c, abs=1e-12)
    # JAX's staging of the same frames pairs (t[k-1], t[k]]: not the lane's
    raw = tes.ImuIntervalBuffer(e.cfg.max_imu)
    for (t, a, g) in seq.imu:
        raw.push(t + chip_smoke.TD_TRUE, a, g)
    jax_style = jbp.stage_frames_arrays(
        [types.SimpleNamespace(estimator=types.SimpleNamespace(
            cfg=e.cfg, _collect_interval_np=raw.collect))],
        [ts], [tn(imgs)], [tn(deps)], k_c, k_c + T)
    assert not np.array_equal(np.asarray(jax_style.imu_dts[0, 0]), tn(batch.imu_dts[0, 0]))


def test_jax_pipeline_misses_the_bound_on_td_lane_2():
    """Phase 20b's lane 2 (seed 9, the RealSense rig with the extrinsic
    refined) misses its ATE bound in JAX's own latency pipeline: at 320×240
    on the CPU JAX's unaligned ATE is over max(0.05·travelled, 0.08 m),
    and the port's latency pipeline on the same stream (its draws, JAX's
    static init takes none) misses it too, within max(10 %, 0.01 m) of
    JAX's.  So phase 20b holds that lane (``chip_smoke.REFERENCE_MISSES``)
    to its own latency run."""
    n = 56
    rig, seq, cfg = chip_smoke.realsense_scene(n, 320, 240, seed=9)
    ts, imgs, deps = syn.render_sequence(seq, rig, "cpu")
    jp = JPipeline(jconfig.VinsConfig(**dataclasses.asdict(cfg)), fused_steady_state=True)
    # the port's latency envelope (chip_smoke.envelope)
    jp.estimator.cfg = dataclasses.replace(jp.estimator.cfg, max_iters=2)
    jp.tcfg = dataclasses.replace(jp.tcfg, lk_max_iters=12, lk_coarse_iters=6)
    for (t, a, g) in seq.imu:
        jp.push_imu(t + chip_smoke.TD_TRUE, a, g)
    np_imgs, np_deps = tn(imgs), tn(deps)
    for k in range(n):
        jp.push_image(ts[k], np_imgs[k])
        jp.push_depth(ts[k], np_deps[k])
        jp.spin_once()
    jt = jp.estimator.trajectory
    jacc = chip_smoke.lane_accuracy([r["t"] for r in jt], [np.asarray(r["P"]) for r in jt], seq,
                                    False, False)
    assert chip_smoke.REFERENCE_MISSES["td"] == (2,)
    assert jacc["err"] >= jacc["bound"], jacc
    lane = chip_smoke.rig_lane("cpu", cfg, seq, imu_shift=chip_smoke.TD_TRUE,
                               failure_check_interval=4)
    chip_smoke.feed_lane(lane, ts, imgs, deps, n)
    pt = lane["pipe"].estimator.trajectory
    pacc = chip_smoke.lane_accuracy([r["t"] for r in pt], [r["P"] for r in pt], seq, False, False)
    assert pacc["err"] >= pacc["bound"], pacc
    assert abs(pacc["err"] - jacc["err"]) < max(0.1 * jacc["err"], 0.01), (pacc, jacc)


@pytest.mark.parametrize("scene", list(SCENES))
def test_batched_step_on_warmed_lanes_matches_jax(scene):
    """(b) two OpenLORIS lanes, one initialized by ``init_dynamic`` and one
    by ``init_mono``; (c) two RealSense td lanes in float64: the port's
    batched step against JAX's per lane over 3 steady frames."""
    kw = SCENES[scene]
    res = chip_smoke.stage_batched_rig_path("cpu", kw["kind"], B=2, T=STEADY, W=kw["W"],
                                            H=kw["H"], mono_lanes=(1,), dtype=kw["dtype"])
    if kw["kind"] == "dyn":
        assert res["attempts"][0][-1] == ("init_dynamic", True)
        assert res["attempts"][1][-1] == ("init_mono", True)
    else:
        assert res["attempts"] == [[], []] and res["pipes"][0].estimator.cfg.estimate_td
    runner, batch = res["runner"], res["batch"]
    trk, st = res["state"]
    jtcfg, jcam, jecfg = _jax_configs(res["scenes"][0][2], runner)
    assert jecfg.static_init == (kw["kind"] == "td")
    np_trk, np_st = (tbp.map_tree(tn, x) for x in (trk, st))
    jtrk = [_to_jax(np_trk, b) for b in range(2)]
    jst = [_to_jax(np_st, b) for b in range(2)]
    frames = [tn(f) for f in batch]
    base_keys = jax.random.split(jax.random.PRNGKey(17), 2)
    for i in range(STEADY):
        us, jP, jtd = [], [], []
        for b in range(2):
            key = jax.random.fold_in(base_keys[b], i)
            img, dep, t, dts, acc, gyr = (jnp.asarray(f[i, b]) for f in frames)
            jtrk[b], jst[b], out = jbp.fused_frame_step(jtcfg, jcam, jecfg, jtrk[b], jst[b], img,
                                                        dep, t, jest.ImuInterval(dts, acc, gyr),
                                                        key)
            jP.append(np.asarray(out.P))
            jtd.append(float(jst[b].x.td))
            us.append(jax_ransac_uniforms(key, jtcfg.ransac_trials, jtcfg.maxc))
        imu = tes.ImuInterval(batch.imu_dts[i], batch.imu_acc[i], batch.imu_gyr[i])
        trk, st, sout = tbp.fused_frame_step(runner.tcfg, runner.cam, runner.ecfg, trk, st,
                                             batch.imgs[i], batch.depths[i], batch.ts[i], imu,
                                             tt(np.stack(us), kw["dtype"]))
        err = np.abs(tn(sout.P) - np.stack(jP)).max()
        assert err < 5e-3, (scene, i, err)
        assert np.all(np.isfinite(tn(sout.cost)))
        for b in range(2):
            np.testing.assert_array_equal(tn(st.table.ids[b]), np.asarray(jst[b].table.ids))
        if kw["kind"] == "td":
            assert np.abs(tn(st.x.td) - np.array(jtd)).max() < 1e-5, (i, tn(st.x.td), jtd)


@pytest.mark.parametrize("phase", ["20", "20b"])
def test_chip_smoke_batched_rig_phases_rehearse(phase):
    """``chip_smoke.py``'s phases 20 and 20b on the CPU at B = 2 (lane 1 of
    phase 20 with its depth withheld) and the phases' 40 steady frames,
    424×240 and 320×240: their gates hold (each lane's initialization
    program and frame, relative motion or ATE against the truth, td,
    finite costs, one configuration)."""
    if phase == "20":
        res = chip_smoke.run_batched_rig_path(chip_smoke.stage_batched_rig_path(
            "cpu", "dyn", B=2, T=40, W=424, H=240, mono_lanes=(1,)))
        assert [a[-1][0] for a in res["attempts"]] == ["init_dynamic", "init_mono"]
    else:
        res = chip_smoke.run_batched_rig_path(chip_smoke.stage_batched_rig_path(
            "cpu", "td", B=2, T=40, W=320, H=240))
        assert all(td != 0.0 for td in res["td"])
    chip_smoke.check_batched_rig_path(res, on_gpu=False)
    assert all(lane["outputs"] >= 40 + 1 and lane["latency_err"] is None
               for lane in res["lanes"])


@pytest.mark.parametrize("err, ref, lane, ok", [
    (0.05, None, 1, True),      # under the bound
    (0.12, None, 2, False),     # over it, no reference
    (0.12, 0.115, 2, True),     # a listed lane: its latency run misses too; within 10 %
    (0.12, 0.115, 1, False),    # ... but a lane not listed keeps the truth bound
    (0.14, 0.115, 2, False),    # not within 10 % (or 0.01 m) of the reference
    (0.09, 0.07, 2, False),     # the lane alone meets the bound: so must the runner
    (0.12, "other init", 2, False),  # the reference initialized otherwise
], ids=["under", "over", "as-reference", "unlisted-lane", "past-reference",
        "reference-meets-bound", "reference-initialized-otherwise"])
def test_batched_rig_gate_holds_a_missed_lane_to_its_latency_reference(err, ref, lane, ok):
    """``check_batched_rig_path``'s accuracy gate on one lane of phase 20b
    (bound 0.08 m): the truth bound, or, only for a lane of
    ``REFERENCE_MISSES`` (lane 2, whose stream JAX's own pipeline misses)
    where the same lane alone on the latency pipeline misses it too after
    the same initialization, that lane's error plus max(10 %, 0.01 m)."""
    init = (11, [])
    if ref == "other init":
        ref, init = 0.115, (12, [])
    lanes = [dict(err=0.01, bound=0.08, latency_err=None, latency_init=None) for _ in range(3)]
    lanes[lane] = dict(err=err, bound=0.08, latency_err=ref,
                       latency_init=None if ref is None else init)
    res = dict(kind="td", init_frames=[11] * 3, attempts=[[]] * 3, mono_lanes=[], T=1,
               tracked=1, lanes=lanes, cost=np.zeros((1, 3)), td=[-0.012] * 3,
               configs_equal=True)
    if ok:
        chip_smoke.check_batched_rig_path(res, on_gpu=False)
    else:
        with pytest.raises(RuntimeError, match="accuracy"):
            chip_smoke.check_batched_rig_path(res, on_gpu=False)
