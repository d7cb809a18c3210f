"""A relocalization constraint queued before a failure reset, on the CPU:
JAX's ``VinsEstimator.reset`` keeps it, and its first solve after the
re-initialization takes it, though the tracker restarted the feature ids it
binds and the window's world is new; the port drops it at the reset, and
refuses one that a worker thread made from a frame before the reset.  The
stream and the burst are ``tests/test_torch_recovery.py``'s, with fast
relocalization on and no pose graph."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from tests.test_torch_pipeline import _envelope
from tests.test_torch_recovery import FRAMES, MAX_CNT, H, W, _burst, _draws, _reboot
from tests.torch_parity import tn
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.pipeline import VinsPipeline as TPipeline
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.pipeline import VinsPipeline as JPipeline


def _first_relo_after_reboot(pipe, seq, ts, imgs, deps) -> bool:
    """The black burst with a constraint queued just before the failure
    reset, as a worker thread may queue one (onto the last output's own
    window points, the old keyframe at its pose); whether the first solve
    after the re-initialization took it."""
    def queue(outs):
        last = next(o for o in reversed(outs) if o is not None)
        pipe.estimator.set_relo_frame(last["wp_norm"], last["wp_valid"], last["wp_ids"],
                                      last["P"], last["Q"])

    flags, _, outs = _burst(pipe, seq, ts, imgs, deps, on_reset=queue)
    seen, back = _reboot(flags)
    assert not any(o["relo_used"] for o in outs[:seen] if o is not None)
    assert outs[back - 1] is None and outs[back] is not None  # the initialization's output
    return bool(outs[back + 1]["relo_used"])  # the first solve after it


def test_constraint_queued_before_a_reboot():
    """Fast relocalization on, no pose graph: a constraint queued just
    before the failure reset.  JAX's first solve after the
    re-initialization takes it; the port's does not."""
    rig, _, _, _ = chip_smoke.slice_config(W, H, MAX_CNT)
    seq = tsyn.make_trajectory(FRAMES, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    imgs, deps = tn(imgs), tn(deps)
    tcfg = dataclasses.replace(chip_smoke.latency_config(rig, seq, MAX_CNT),
                               fast_relocalization=True)
    kw = dict(failure_check_interval=1, fused_steady_state=True)
    jpipe = _envelope(JPipeline(jconfig.VinsConfig(**dataclasses.asdict(tcfg)),
                                dtype=jnp.float32, **kw))
    assert _first_relo_after_reboot(jpipe, seq, ts, imgs, deps)
    tpipe = _envelope(TPipeline(tcfg, "cpu", **kw, **_draws(tcfg)))
    assert not _first_relo_after_reboot(tpipe, seq, ts, imgs, deps)
    assert tpipe.estimator.take_relo() is None


def test_constraint_made_before_a_reset_is_refused():
    """A worker's constraint carries the estimator's epoch of its keyframe's
    frame: one made before a reset is refused, one made after is queued."""
    rig, _, _, _ = chip_smoke.slice_config(W, H, MAX_CNT)
    seq = tsyn.make_trajectory(2, rig, seed=7)
    tcfg = dataclasses.replace(chip_smoke.latency_config(rig, seq, MAX_CNT),
                               fast_relocalization=True)
    est = tes.VinsEstimator(tcfg, "cpu")
    maxf = est.cfg.maxf
    relo = (np.zeros((maxf, 2)), np.ones(maxf, bool), np.arange(maxf), np.zeros(3),
            np.array([1.0, 0, 0, 0]))
    before = est.epoch
    assert est.set_relo_frame(*relo, epoch=before)
    est.reset()
    assert est.take_relo() is None  # the reset dropped the queued one
    assert not est.set_relo_frame(*relo, epoch=before)
    assert est.take_relo() is None
    assert est.set_relo_frame(*relo, epoch=est.epoch) and est.set_relo_frame(*relo)
    got = est.take_relo()
    assert got is not None and np.array_equal(got["match_ids"], relo[2])
    assert torch.equal(torch.as_tensor(got["Q"]), torch.tensor([1.0, 0, 0, 0]))
