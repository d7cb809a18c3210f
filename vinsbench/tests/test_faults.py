"""A run whose timed path is broken underneath comes out not correct: the
drivers run on the CPU at a tiny size (the harness's look for a card
skipped), with one fault planted in the program's frame step each time:

* a step that returns its state unchanged (and its first answer again);
* half of the batch left out, the lanes after it given the first half's
  results (the fleet);
* an answer altered where it is produced: every tracked point moved by
  half a pixel in the tracker, or the pose moved by a metre in the step.

No cell runs on more than one card, so none can lose an exchange between
cards."""

import pytest
import torch

from vins_rgbd_fast_torch.frontend import feature_tracker as ft
from vins_rgbd_fast_torch.parallel import batched_pipeline as bp
from vinsbench import harness as H
from vinsbench.tests import tiny

REAL_STEP = bp.fused_frame_step
REAL_TRACK = ft.track_frame


def state_unchanged():
    first = {}

    def step(tcfg, cam, ecfg, trk, st, *args, **kw):
        if "out" not in first:
            first["out"] = REAL_STEP(tcfg, cam, ecfg, trk, st, *args, **kw)[2]
        return trk, st, first["out"]

    return dict(fused_frame_step=step)


def half_batch():
    def step(tcfg, cam, ecfg, trk, st, img, depth, t, imu, ransac_u, relo=None, pnp_u=None):
        B = img.shape[0]
        h = max(B // 2, 1)
        idx = torch.arange(B, device=img.device) % h

        def take(tree):
            return bp.map_tree(lambda a: a[idx] if a.dim() and a.shape[0] == h else a, tree)

        def half(tree):
            return bp.map_tree(lambda a: a[:h] if a.dim() and a.shape[0] == B else a, tree)

        trk2, st2, out = REAL_STEP(tcfg, cam, ecfg, half(trk), half(st), img[:h], depth[:h],
                                   t[:h], half(imu), ransac_u[:h], relo,
                                   None if pnp_u is None else pnp_u[:h])
        return take(trk2), take(st2), take(out)

    return dict(fused_frame_step=step)


def points_moved():
    def track(*args, **kw):
        state, out = REAL_TRACK(*args, **kw)
        live = (state.ids >= 0)[..., None]
        return state._replace(pts=torch.where(live, state.pts + 0.5, state.pts)), out

    return dict(track_frame=track)


def pose_moved():
    def step(*args, **kw):
        trk, st, out = REAL_STEP(*args, **kw)
        return trk, st, out._replace(P=out.P + 1.0)

    return dict(fused_frame_step=step)


FAULTS = {
    "fleet-tum-vo-b32": [state_unchanged, half_batch, points_moved],
    "robot-tum-vo-loop": [state_unchanged, points_moved],
    "robot-realsense": [state_unchanged, pose_moved],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    c, cfg, tr = tiny.shrink(cell, **tiny.cell_size(cell))
    for name, fn in fault().items():
        monkeypatch.setattr(bp if name == "fused_frame_step" else ft, name, fn)
    res = H.driver(tr["driver"]).run(tiny.ctx(c, cfg, tr, seconds=tiny.window_s(tr)))
    assert res.attempted > 0 and res.rec.get("poses", 1) > 0  # answers were there to judge
    assert not (H.passes(res.checks) and res.failed == 0), res.checks
