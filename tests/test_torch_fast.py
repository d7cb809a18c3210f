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


def _checkerboard(cell=5):
    """A high-contrast 0/255 checkerboard (1, 100, 128) with a bright and a
    dark blob, so both polarities score."""
    yy, xx = np.meshgrid(np.arange(100), np.arange(128), indexing="ij")
    img = np.where(((yy // cell) + (xx // cell)) % 2 == 0, 255.0, 0.0)
    img[36:45, 56:65] = 0.0
    img[39:42, 59:62] = 255.0  # bright blob on a dark square
    img[66:75, 16:25] = 255.0
    img[69:72, 19:22] = 0.0    # dark blob on a bright square
    return img[None].astype(np.float32)


def _k1_inputs():
    return tt(np.concatenate([_images(), _checkerboard()], axis=0))


def _doubled(d, lo):
    """Per start k, ``lo`` (min or max) over the contiguous 9-arc k..k+8 of
    the ring axis (0), by doubling: pairs, quads, eights, plus one."""
    def shift(x, s):
        return torch.roll(x, -s, dims=0)
    m2 = lo(d, shift(d, 1))
    m4 = lo(m2, shift(m2, 2))
    m8 = lo(m4, shift(m4, 4))
    return lo(m8, shift(d, 8))


def _pretest(d, beyond):
    """K1's compass pre-test: two cyclically adjacent points of {0, 4, 8,
    12} with ``beyond`` true."""
    p = beyond(d[[0, 4, 8, 12]])
    return (p[0] & p[1]) | (p[1] & p[2]) | (p[2] & p[3]) | (p[3] & p[0])


@pytest.mark.parametrize("threshold", [10.0, 20.0])
def test_compass_pretest_holds_wherever_fast_scores(threshold):
    """Every contiguous 9-arc holds two adjacent compass points, so a term
    beyond the threshold implies its polarity's pre-test (K1 skips the arc
    work of pixels that fail both)."""
    x = _k1_inputs()
    diff = tfast.ring_differences(x)
    bright, dark = tfast.arc_terms(diff)
    br = _pretest(diff, lambda d: d > threshold)
    dk = _pretest(diff, lambda d: d < -threshold)
    score = tfast.fast_score(x, threshold)
    assert bool(br[bright > threshold].all()) and bool(dk[dark > threshold].all())
    assert bool((br | dk)[score > 0].all())
    assert int((score[-1] > 0).sum()) > 50  # the checkerboard scores
    assert 0 < float((br | dk).float().mean()) < 1  # and the pre-test prunes


def test_doubled_arc_terms_bit_exact():
    """K1's arc arithmetic: the doubled 9-arc minimum gives the bright term
    and -(min over starts of the doubled 9-arc maximum) the dark one, bit
    for bit, as does the doubled minimum of the negated differences."""
    diff = tfast.ring_differences(_k1_inputs())
    bright, dark = tfast.arc_terms(diff)

    def bits(t):
        return t.view(torch.int32)

    assert torch.equal(bits(_doubled(diff, torch.minimum).amax(0)), bits(bright))
    assert torch.equal(bits(-_doubled(diff, torch.maximum).amin(0)), bits(dark))
    assert torch.equal(bits(_doubled(-diff, torch.minimum).amax(0)), bits(dark))


@pytest.mark.parametrize("threshold", [10.0, 20.0])
def test_k1_passes_in_plain_torch_are_bit_exact(threshold):
    """K1's three passes written in plain torch: scores start at 0; a
    polarity that passes its pre-test adds its doubled term where it beats
    the threshold (the two meet in a max); the border stays 0; the 3x3 NMS
    reads 0, not -inf, outside the image.  Equal to nms3(fast_score)."""
    x = _k1_inputs()
    diff = tfast.ring_differences(x)
    zero = torch.zeros_like(x)
    score = zero
    for beyond, d in ((lambda v: v > threshold, diff), (lambda v: v < -threshold, -diff)):
        term = _doubled(d, torch.minimum).amax(0)
        score = torch.maximum(score, torch.where(_pretest(diff, beyond) & (term > threshold),
                                                 term, zero))
    H, W = x.shape[-2:]
    yy = torch.arange(H)[:, None]
    xx = torch.arange(W)[None, :]
    score = torch.where((yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3), score, zero)
    m = torch.nn.functional.max_pool2d(torch.nn.functional.pad(score[:, None], (1, 1, 1, 1)),
                                       3, stride=1)[:, 0]
    out = torch.where((score >= m) & (score > 0), score, zero)
    assert torch.equal(out, tfast.nms3(tfast.fast_score(x, threshold)))
    assert int((out > 0).sum()) > 50


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
