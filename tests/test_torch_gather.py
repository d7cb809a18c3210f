"""The gather sampler of the port (``ops/image.bilinear_sample`` and the
plain gather LK level ``ops/lk.track_level_gather``) against JAX's
``bilinear_sample``, ``_track_level_gather`` and ``pyramidal_lk(sampler=
"gather")`` on the same numpy inputs, B = 2.

Tolerances: ``bilinear_sample`` within 1e-4 (float32 blends, clamped
taps); the level's and the pyramid's u within 1e-3 px and status equal on
at least 99.5 % of points (float32 sums over the 21×21 patch are taken in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_lk import H, W, _inputs
from tests.torch_parity import tn, tt
from vins_rgbd_fast_torch.ops import image as timage
from vins_rgbd_fast_torch.ops import lk as tlk
from vins_rgbd_fast_tpu.ops import image as jimage
from vins_rgbd_fast_tpu.ops import lk as jlk


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    # inside, on the last row and column, and outside on every side
    xy = np.concatenate([rng.uniform([-5, -5], [W + 5, H + 5], (500, 2)),
                         [[W - 1, H - 1], [0, 0], [W - 1.5, 3.25]]]).astype(np.float32)
    out = tn(timage.bilinear_sample(tt(img), tt(xy)))
    ref = np.asarray(jimage.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))
    assert out.shape == ref.shape == (xy.shape[0],)
    assert np.abs(out - ref).max() <= 1e-4 * 255


def _check(u, status, ref_u, ref_status):
    agree = np.asarray(status) == np.asarray(ref_status)
    assert agree.mean() >= 0.995, agree.mean()
    both = np.asarray(status) & np.asarray(ref_status) & agree
    assert both.sum() >= 15
    assert np.abs(np.asarray(u) - np.asarray(ref_u))[both].max() < 1e-3


@pytest.mark.parametrize("check_border", [False, True])
def test_track_level_gather_matches_jax(check_border):
    imgs0, imgs1, pts, act = _inputs()
    flow = np.full_like(pts, 0.5)
    u, status, err = tlk.track_level_gather(tt(imgs0), tt(imgs1), tt(pts), tt(flow), tt(act),
                                            21, 10, 0.01, 1e-4, check_border)
    for b in range(2):
        ru, rs, rerr = jlk._track_level_gather(jnp.asarray(imgs0[b]), jnp.asarray(imgs1[b]),
                                               jnp.asarray(pts[b]), jnp.asarray(flow[b]),
                                               jnp.asarray(act[b]), 21, 10, 0.01, 1e-4,
                                               check_border)
        _check(tn(u[b]), tn(status[b]), ru, rs)
        ok = tn(status[b]) & np.asarray(rs)
        assert np.abs(tn(err[b]) - np.asarray(rerr))[ok].max() < 1e-3


@pytest.mark.parametrize("levels", [2, 4])
def test_pyramidal_lk_gather_matches_jax(levels):
    """``track_level_gather`` run coarse→fine as JAX's ``pyramidal_lk``
    runs its gather sampler (flow halved per level, 6 coarse iterations)."""
    imgs0, imgs1, pts, act = _inputs()
    init = pts + np.float32(0.5)
    p0s, p1s = timage.build_pyramid(tt(imgs0), levels), timage.build_pyramid(tt(imgs1), levels)
    flow = (tt(init) - tt(pts)) / 2.0 ** (levels - 1)
    status = tt(act)
    for l in range(levels - 1, -1, -1):
        flow, status_l, _ = tlk.track_level_gather(p0s[l], p1s[l], tt(pts) / 2.0 ** l, flow,
                                                   tt(act), 21, 12 if l == 0 else 6, 0.01,
                                                   1e-4, check_border=(l == 0))
        status = status & status_l
        if l > 0:
            flow = flow * 2.0
    for b in range(2):
        p0 = tuple(jimage.build_pyramid(jnp.asarray(imgs0[b]), levels))
        p1 = tuple(jimage.build_pyramid(jnp.asarray(imgs1[b]), levels))
        ref = jlk.pyramidal_lk(p0, p1, jnp.asarray(pts[b]), jnp.asarray(init[b]),
                               jnp.asarray(act[b]), max_iters=12, coarse_iters=6,
                               sampler="gather")
        _check(tn(tt(pts[b]) + flow[b]), tn(status[b]), ref.pts, ref.status)
