"""The latency pipeline of the port with the RealSense rig's knobs
(``estimate_td`` from 0 against IMU stamps 5 ms ahead, rolling shutter, the
extrinsic refined online) against JAX's ``VinsPipeline`` on the CPU, fused
and unfused, at 160×120 with JAX's RANSAC draws injected; and the exact
resume of a checkpoint taken mid-calibration (``estimate_extrinsic`` 2)
and of one taken while dynamic initialization is still filling its window
(the OpenLORIS rig's knobs); and ``chip_smoke.py``'s phases 12, 13 and 13b
rehearsed on the CPU at a small size.

Tolerances: both pipelines run in float64, the newest position within
1e-6 m and td within 1e-8 s of JAX's per frame (in float32 the freed
extrinsic with the rolling-shutter rows leaves the first solve
ill-conditioned, and the two packages' float32 sums, taken in another
order, part there by more than the latency test's 5 mm); a resumed run
bit-equal to the uninterrupted one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_pipeline import _envelope
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import assert_close, tn
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.io import checkpoint as tck
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.pipeline import VinsPipeline as TPipeline
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.pipeline import VinsPipeline as JPipeline

W, H, MAX_CNT, FRAMES = 160, 120, 32, 20
TD_TRUE = 0.005  # the IMU clock runs 5 ms ahead of the image stamps


@pytest.fixture(scope="module")
def td_stream():
    """The latency test's stream (seed 7) with the RealSense rig's td and
    rolling-shutter knobs (``chip_smoke.td_config``)."""
    rig, _, _, _ = chip_smoke.slice_config(W, H, MAX_CNT)
    seq = tsyn.make_trajectory(FRAMES, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    return seq, ts, tn(imgs), tn(deps), chip_smoke.td_config(rig, seq, MAX_CNT), rig


def _drive(pipe, seq, ts, imgs, deps, k0=0, k1=FRAMES, imu=True):
    """Push IMU (stamps shifted by ``TD_TRUE``) and frames [k0, k1); per
    frame the newest position (None before NON_LINEAR) and td."""
    if imu:
        for (t, a, g) in seq.imu:
            pipe.push_imu(t + TD_TRUE, a, g)
    Ps, tds = [], []
    for k in range(k0, k1):
        pipe.push_image(ts[k], imgs[k])
        pipe.push_depth(ts[k], deps[k])
        out = pipe.spin_once()
        Ps.append(None if out is None else np.asarray(out["P"], np.float64))
        tds.append(float(np.asarray(pipe.estimator.state.x.td).reshape(-1)[0]))
    return Ps, tds


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_pipeline_with_td_and_rolling_shutter_matches_jax(td_stream, fused):
    seq, ts, imgs, deps, cfg, _ = td_stream
    assert cfg.estimate_td and cfg.rolling_shutter
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)

    def jax_draws(is_fused, i):  # the keys JAX's pipeline hands its tracker
        key = jax.random.fold_in(jax.random.PRNGKey(2), i) if is_fused else keys[i % 4096]
        return jax_ransac_uniforms(key, 64, cfg.feature_capacity)

    jpipe = _envelope(JPipeline(jconfig.VinsConfig(**dataclasses.asdict(cfg)),
                                dtype=jnp.float64, fused_steady_state=fused))
    tpipe = _envelope(TPipeline(cfg, "cpu", dtype=torch.float64, fused_steady_state=fused,
                                ransac_uniforms=jax_draws))
    jP, jtd = _drive(jpipe, seq, ts, imgs, deps)
    tP, ttd = _drive(tpipe, seq, ts, imgs, deps)
    assert [p is None for p in tP] == [p is None for p in jP]
    # the 20 Hz frontend gate drops the stream's second frame
    assert sum(p is not None for p in tP) == FRAMES - 11
    for k, (a, b) in enumerate(zip(tP, jP)):
        if a is not None:
            assert np.linalg.norm(a - b) < 1e-6, (k, a, b)
    assert_close(ttd, jtd, 1e-8, what="td")
    assert len(set(ttd)) > 1 and np.all(np.isfinite(ttd)) and max(abs(v) for v in ttd) < 0.05
    assert tpipe.estimator._td_cache == pytest.approx(jpipe.estimator._td_cache, abs=1e-8)
    if fused:
        assert tpipe._fused_step == FRAMES - 12


@pytest.mark.parametrize("case", ["mid-calibration", "dynamic-init-filling"])
def test_checkpoint_resume_is_exact(td_stream, tmp_path, case):
    """A checkpoint taken at frame 8 (still calibrating the extrinsic from
    a rotation 5° off, unfused; or still filling the window for dynamic
    initialization) resumes into the uninterrupted run's outputs, bit for
    bit, with the same calibration (or initialization) frame."""
    seq, ts, imgs, deps, cfg, _ = td_stream
    if case == "mid-calibration":
        cfg = chip_smoke.calib_config(cfg, seq)
    else:  # phase 13's rig and stream, scaled to 256×144
        rig, seq, cfg = chip_smoke.openloris_scene(FRAMES, 256, 144)
        ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
        imgs, deps = tn(imgs), tn(deps)
        cfg = dataclasses.replace(cfg, max_cnt=MAX_CNT)
    cut = 8

    def make():
        return _envelope(TPipeline(cfg, "cpu"))

    full = make()
    for (t, a, g) in seq.imu:
        full.push_imu(t + TD_TRUE, a, g)
    ref = _drive(full, seq, ts, imgs, deps, 0, FRAMES, imu=False)[0]
    part = make()
    for (t, a, g) in seq.imu:
        part.push_imu(t + TD_TRUE, a, g)
    head = _drive(part, seq, ts, imgs, deps, 0, cut, imu=False)[0]
    if case == "mid-calibration":
        assert part.estimator._ex_calibrating and len(part.estimator._ex_pairs) > 0
    else:
        assert part.estimator.solver_flag == tes.VinsEstimator.INITIAL
    path = str(tmp_path / "ck.npz")
    tck.save_pipeline(part, path)
    resumed = tck.load_pipeline(cfg, path, "cpu")
    _envelope(resumed)
    tail = _drive(resumed, seq, ts, imgs, deps, cut, FRAMES, imu=False)[0]
    got = head + tail
    assert [p is None for p in got] == [p is None for p in ref]
    assert sum(p is not None for p in ref) >= 5
    for a, b in zip(got, ref):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert resumed.estimator._ex_calibrating == full.estimator._ex_calibrating
    np.testing.assert_array_equal(tn(resumed.estimator.state.x.qic), tn(full.estimator.state.x.qic))


@pytest.mark.parametrize("phase", ["12", "13", "13b"])
def test_chip_smoke_rig_phases_rehearse(phase):
    """``chip_smoke.py``'s phases 12, 13 and 13b on the CPU at a small size
    (40 frames; 320×240 and 424×240): their gates hold (initialization
    frame and program, ATE or relative motion, td)."""
    if phase == "12":
        rig, seq, cfg = chip_smoke.realsense_scene(40, 320, 240)
        res = chip_smoke.run_rig_path("cpu", cfg, rig, seq, 40, failure_check_interval=4,
                                      imu_shift=chip_smoke.TD_TRUE)
        chip_smoke.check_rig_path(res, on_gpu=False)
        assert res["td"] != 0.0 and res["attempts"] == []
    else:
        rig, seq, cfg = chip_smoke.openloris_scene(40, 424, 240)
        mono = phase == "13b"
        res = chip_smoke.run_rig_path("cpu", cfg, rig, seq, 40, depthless=mono)
        chip_smoke.check_rig_path(res, init_by=24 if mono else 16, on_gpu=False)
        assert res["attempts"][-1] == ("init_mono" if mono else "init_dynamic", True)
