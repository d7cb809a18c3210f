"""Parity of the port's FAST + NMS (plain version of kernel K1), grid top-k
and image pyramid with the JAX package.  Tolerance: exact — every step is
a float32 subtraction, min or max, or an argmax with a fixed tie order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, tn, tt
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.ops import fast as tfast
from vins_rgbd_fast_torch.ops import image as timage
from vins_rgbd_fast_tpu.ops import fast as jfast
from vins_rgbd_fast_tpu.ops import fast_pallas
from vins_rgbd_fast_tpu.ops import image as jimage


def _images(seed=3):
    """Two uniform-noise images and one rendered room frame, (3, 100, 128)."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0, 255, (2, 100, 128)).astype(np.float32)
    rig = tsyn.SyntheticRig(width=128, height=100, fx=92.0, fy=92.0, cx=64.0, cy=50.0)
    seq = tsyn.make_trajectory(2, rig, seed=seed)
    _, img, _ = tsyn.render_sequence(seq, rig, "cpu", 0, 1)
    return np.concatenate([noise, tn(img)], axis=0)


@pytest.mark.parametrize("threshold", [10.0, 20.0])
def test_fast_nms_plain_bit_exact_vs_xla(threshold):
    imgs = _images()
    out = tn(tfast.fast_nms(tt(imgs), threshold))  # CPU tensor -> plain version
    for b in range(imgs.shape[0]):
        ref = np.asarray(jfast.nms3(jfast.fast_score(jnp.asarray(imgs[b]), threshold)))
        assert np.array_equal(out[b], ref), b
    assert (out > 0).sum() > 50


def test_fast_nms_plain_bit_exact_vs_pallas_interpret():
    imgs = _images(seed=4)[:2]
    out = tn(tfast.fast_nms(tt(imgs), 20.0))
    for b in range(imgs.shape[0]):
        ref = np.asarray(fast_pallas.fast_score_nms(jnp.asarray(imgs[b]), 20.0, interpret=True))
        assert np.array_equal(out[b], ref), b


@pytest.mark.parametrize("per_grid", [3, 4, 8])
def test_grid_topk_exact_with_ties(per_grid):
    """Integer scores 0..4 make ties everywhere; the first index wins."""
    rng = np.random.default_rng(7)
    score = rng.integers(0, 5, (2, 61, 83)).astype(np.float32)
    score[0, :20, :20] = 2.0  # a whole cell of equal scores
    xy, vals = tfast.grid_topk(tt(score), 4, 5, per_grid)
    for b in range(2):
        jxy, jvals = jfast.grid_topk(jnp.asarray(score[b]), 4, 5, per_grid)
        assert np.array_equal(tn(xy[b]), np.asarray(jxy))
        assert np.array_equal(tn(vals[b]), np.asarray(jvals))


def test_build_pyramid_matches_jax():
    """4-level Gaussian pyramid; float32 sums in the same order (1e-4 gray
    levels allowed for a different fused evaluation order)."""
    imgs = _images(seed=5)
    pyr = timage.build_pyramid(tt(imgs), 4)
    for b in range(imgs.shape[0]):
        ref = jimage.build_pyramid(jnp.asarray(imgs[b]), 4)
        for l in range(4):
            assert_close(tn(pyr[l][b]), np.asarray(ref[l]), atol=1e-4, what=f"level {l}")


def test_fast_nms_rejects_unsupported_device():
    with pytest.raises(ValueError):
        tfast.fast_nms(torch.zeros((1, 8, 8), device="meta"))
