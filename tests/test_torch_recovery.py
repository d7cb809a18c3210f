"""The failure reboot of the port's latency pipeline against the JAX
package's on the CPU: ``bench.py`` ``run_recovery``'s black burst on
``tests/test_torch_pipeline.py``'s small stream (160×120 radtan rig,
max_cnt 32, the bench's latency envelope), long enough to re-initialize
(30 frames); three black frames from the third frame after NON_LINEAR;
``failure_check_interval=1`` and the fused steady state, with JAX's RANSAC
(and, in VO, PnP) draws injected; the IMU rig and the VO rig (no IMU, cold
LK on 4 levels, the PnP pose init).  The port's replayed steady frames are
held to its plain per-op frames (``replay=False``) across the reboot.

Tolerances: the same solver flag on every frame (so the same frame sees
the failure and the same frame is NON_LINEAR again), the same outputs
present, the newest position within 5 mm per frame (the bound of
``test_pipeline_matches_jax``); the VO rig runs in float64 and within
1e-6 m (its re-initialized window starts on black frames, and the float32
sums of the two packages part there by millimetres, as
``tests/test_torch_td_pipeline.py``'s do); replay against plain bit for
bit in every output, the end states and the generators."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_pipeline import _envelope
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import tn
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.pipeline import VinsPipeline as TPipeline
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.pipeline import VinsPipeline as JPipeline

W, H, MAX_CNT, FRAMES = 160, 120, 32, 30
INIT = 10  # the frame that initializes (static init: the window's 11th)
BURST = range(INIT + 3, INIT + 6)  # black frames
NL = tes.VinsEstimator.NON_LINEAR


@pytest.fixture(scope="module")
def stream():
    rig, _, _, _ = chip_smoke.slice_config(W, H, MAX_CNT)
    seq = tsyn.make_trajectory(FRAMES, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    return seq, ts, tn(imgs), tn(deps), chip_smoke.latency_config(rig, seq, MAX_CNT)


def _draws(tcfg):
    """JAX's RANSAC and PnP draws as the port's injected callables."""
    fkeys = jax.random.split(jax.random.PRNGKey(0), 4096)
    ekeys = jax.random.split(jax.random.PRNGKey(1), 4096)
    maxf = tcfg.feature_capacity

    def ransac(is_fused, i):
        key = jax.random.fold_in(jax.random.PRNGKey(2), i) if is_fused else fkeys[i % 4096]
        return jax_ransac_uniforms(key, 64, maxf)

    def pnp(is_fused, i):
        key = jax.random.fold_in(jax.random.PRNGKey(2), i) if is_fused else ekeys[i % 4096]
        return jax_ransac_uniforms(key, 32, maxf)

    return dict(ransac_uniforms=ransac, vo_pnp_uniforms=None if tcfg.imu else pnp)


def _burst(pipe, seq, ts, imgs, deps, on_reset=None):
    """The stream with the black burst; per frame the solver flag, the
    newest position (None without an output) and the output.
    ``on_reset(outs)`` runs just before each failure reset (the
    estimator's ``reset`` while NON_LINEAR) with the outputs so far."""
    flags, Ps, outs = [], [], []
    if on_reset is not None:
        reset = pipe.estimator.reset

        def hooked():
            if pipe.estimator.solver_flag == NL:
                on_reset(outs)
            reset()

        pipe.estimator.reset = hooked
    for (t, a, g) in (seq.imu if pipe.vcfg.imu else []):
        pipe.push_imu(t, a, g)
    for k in range(FRAMES):
        pipe.push_image(ts[k], np.zeros_like(imgs[k]) if k in BURST else imgs[k])
        pipe.push_depth(ts[k], deps[k])
        out = pipe.spin_once()
        flags.append(pipe.estimator.solver_flag)
        Ps.append(None if out is None else np.asarray(out["P"], np.float64))
        outs.append(out)
    return flags, Ps, outs


def _reboot(flags):
    """(the frame that saw the failure, the frame NON_LINEAR again)."""
    seen = next(k for k in BURST if flags[k] != NL)
    back = next(k for k in range(seen, FRAMES) if flags[k] == NL)
    return seen, back


# (JAX dtype, port dtype, position tolerance in m) per rig: in VO the
# re-initialized window starts on the two black frames after the failed one,
# its fixed oldest pose observes nothing, and the float32 sums of the two
# packages part there by millimetres (in float64 they agree to 1e-6 m)
RIGS = {"imu": (jnp.float32, torch.float32, 5e-3), "vo": (jnp.float64, torch.float64, 1e-6)}


@pytest.mark.parametrize("rig", ["imu", "vo"])
def test_black_burst_reboot_matches_jax(stream, rig):
    seq, ts, imgs, deps, tcfg = stream
    tcfg = dataclasses.replace(tcfg, imu=rig == "imu")
    jdtype, tdtype, tol = RIGS[rig]
    kw = dict(failure_check_interval=1, fused_steady_state=True)
    jpipe = _envelope(JPipeline(jconfig.VinsConfig(**dataclasses.asdict(tcfg)),
                                dtype=jdtype, **kw))
    jflags, jP, _ = _burst(jpipe, seq, ts, imgs, deps)
    runs = {}
    for replay in (True, False):
        tpipe = _envelope(TPipeline(tcfg, "cpu", dtype=tdtype, replay=replay, **kw,
                                    **_draws(tcfg)))
        flags, Ps, _ = _burst(tpipe, seq, ts, imgs, deps)
        runs[replay] = (flags, Ps, chip_smoke.frames_record(tpipe, ts[FRAMES - 1]), tpipe)
    tflags, tP, rec, tpipe = runs[True]
    assert tflags == jflags, (tflags, jflags)
    seen, back = _reboot(tflags)
    assert back < FRAMES - 2  # re-initialized, then steady frames again
    assert tpipe._fused_step > 0 and tpipe._prog is not None
    assert [p is None for p in tP] == [p is None for p in jP]
    assert all(p is None for p in tP[seen:back])
    for k, (a, b) in enumerate(zip(tP, jP)):
        if a is not None:
            assert np.linalg.norm(a - b) < tol, (k, a, b)
    plain_flags, plain_P, plain_rec, _ = runs[False]
    assert plain_flags == tflags
    cmp = chip_smoke.replay_against_plain(plain_rec, rec)
    assert cmp["bit_equal"], cmp
    assert cmp["outputs"] == sum(p is not None for p in tP)


def test_recovery_phase_rehearsal():
    """``chip_smoke.py``'s phase 22 (``run_recovery_path``, bench.py's
    80-frame stream with the burst at frames 40-42) at 160×120 on the CPU:
    the failure seen within the burst, NON_LINEAR again, bench.py's
    metrics, and the outputs before the burst under their bound."""
    res = chip_smoke.run_recovery_path("cpu", W=W, H=H, max_cnt=MAX_CNT)
    chip_smoke.check_recovery_path(res, on_gpu=False)
    seen, back = res["fail_seen_at"], res["nonlinear_again_at"]
    assert res["recovery_frames"] == back - seen and res["recovery_ms"] > 0
    assert res["recovery_steady_fps"] > 0 and res["captures"] == []
    assert res["flags"][:INIT] == [tes.VinsEstimator.INITIAL] * INIT
