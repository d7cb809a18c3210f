"""The benchmark's frozen copies agree with their sources today: the
synthetic generator with the program's ``io/synthetic.py``, the kernel
bounds with ``chip_smoke.py``'s, and the reference's FAST, pyramid and LK
with the program's plain versions, bit for bit on the CPU."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from vins_rgbd_fast_torch.io import synthetic as prog_syn
from vins_rgbd_fast_torch.ops import fast as prog_fast
from vins_rgbd_fast_torch.ops import image as prog_image
from vins_rgbd_fast_torch.ops import lk as prog_lk
from vinsbench import bounds
from vinsbench.reference import frontend as ref
from vinsbench.traffic import synthetic as syn

RIG = dict(width=160, height=120, fx=115.0, fy=115.0, cx=80.0, cy=60.0, imu_rate=200.0,
           frame_rate=20.0, k1=0.13387871564774004, k2=-0.2731913133377051,
           p1=0.0020296263577681264, p2=-0.00044384544608203714)


def _same_seq(a, b):
    for f in ("times", "P", "Q", "V", "ric", "tic"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert len(a.imu) == len(b.imu)
    for (t1, a1, g1), (t2, a2, g2) in zip(a.imu, b.imu):
        assert t1 == t2 and np.array_equal(a1, a2) and np.array_equal(g1, g2)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_trajectory_matches_source(seed):
    mine = syn.make_trajectory(60, syn.SyntheticRig(**RIG), seed=seed, omega_scale=0.15,
                               acc_scale=0.3)
    src = prog_syn.make_trajectory(60, prog_syn.SyntheticRig(**RIG), seed=seed,
                                   omega_scale=0.15, acc_scale=0.3)
    _same_seq(mine, src)


def test_revisit_and_corruption_match_source():
    kw = dict(seed=207, accel=1.5, axis=(0.0, 1.0, 0.0), cycles=2)
    mine = syn.make_revisit_trajectory(80, syn.SyntheticRig(**RIG), **kw)
    src = prog_syn.make_revisit_trajectory(80, prog_syn.SyntheticRig(**RIG), **kw)
    _same_seq(mine, src)
    ck = dict(seed=307, gyr_noise=0.003, gyr_pulse=0.2, pulse_frac=(0.18, 0.3))
    _same_seq(syn.corrupt_imu(mine, **ck), prog_syn.corrupt_imu(src, **ck))


def test_render_matches_source():
    rig_m, rig_s = syn.SyntheticRig(**RIG), prog_syn.SyntheticRig(**RIG)
    seq = syn.make_trajectory(20, rig_m, seed=3, omega_scale=0.15, acc_scale=0.3)
    src = prog_syn.make_trajectory(20, rig_s, seed=3, omega_scale=0.15, acc_scale=0.3)
    for k in (0, 7, 19):
        t_m, q_m = syn.camera_poses(seq, k, k + 1)
        t_s, q_s = prog_syn.camera_pose(src, k)
        assert np.array_equal(t_m[0], t_s) and np.array_equal(q_m[0], q_s)
    assert torch.equal(syn.ray_grid(rig_m, "cpu"), prog_syn.ray_grid(rig_s, "cpu"))
    imgs = torch.empty((20, 120, 160))
    deps = torch.empty_like(imgs)
    syn.render_into(seq, rig_m, imgs, deps)
    _, im_s, dp_s = prog_syn.render_sequence(src, rig_s, "cpu")
    assert torch.equal(imgs, im_s) and torch.equal(deps, dp_s)


def _frames(n=2, seed=5):
    rig = syn.SyntheticRig(**RIG)
    seq = syn.make_trajectory(n + 1, rig, seed=seed, omega_scale=0.3, acc_scale=0.6)
    imgs = torch.empty((n + 1, 120, 160))
    syn.render_into(seq, rig, imgs, torch.empty_like(imgs))
    return imgs


def test_bounds_match_chip_smoke():
    imgs = _frames()
    assert bounds.fast_pairs(imgs[:2], 20.0) == cs.fast_pairs(imgs[:2], 20.0)
    g = torch.Generator().manual_seed(0)
    pts = torch.rand((2, 50, 2), generator=g) * torch.tensor([150.0, 110.0]) + 5
    ax, ay = ref.lk_level(imgs[:2], imgs[1:], pts, torch.zeros_like(pts),
                          torch.ones((2, 50), dtype=torch.bool), 3, True)[3:]
    assert bounds.k2_footprint(imgs[:2], pts, ax, ay) == cs.k2_footprint(imgs[:2], pts, ax, ay)
    for kw in ({}, dict(pairs=1234, footprint=(500, 900), steps=77)):
        assert bounds.kernel_bounds(8, 480, 640, 200, 12, **kw) == cs.kernel_bounds(
            8, 480, 640, 200, 12, **kw)
    assert (bounds.PEAK_BYTES_PER_S, bounds.PEAK_F32_PER_S) == (cs.PEAK_BYTES_PER_S,
                                                                cs.PEAK_F32_PER_S)


def test_reference_fast_matches_program_plain():
    imgs = _frames(3)
    assert torch.equal(ref.fast_nms(imgs, 20.0), prog_fast.fast_nms(imgs, 20.0))


def test_reference_lk_matches_program_plain():
    imgs = _frames()
    pp, cp = ref.pyramid(imgs[:1], 4), ref.pyramid(imgs[1:2], 4)
    for a, b in zip(pp, prog_image.build_pyramid(imgs[:1], 4)):
        assert torch.equal(a, b)
    score = ref.fast_nms(imgs[:1], 20.0)
    yx = torch.nonzero(score[0] > 0)[:80]
    pts = yx.flip(-1).float()[None]
    act = torch.ones(pts.shape[:2], dtype=torch.bool)
    mine, st, _ = ref.pyramidal_lk(pp, cp, pts, pts, act, 12, 6)
    prog = prog_lk.pyramidal_lk(pp, cp, pts, pts, act, max_iters=12, coarse_iters=6,
                                engine="xla")
    assert torch.equal(mine, prog.pts) and torch.equal(st, prog.status)
