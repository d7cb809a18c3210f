"""The port's intrinsic calibration (``vins_rgbd_fast_torch/calib``) against
the JAX package's on ``tests/test_calib.py``'s cases.

Tolerances: the corner candidates in the same order with uv within 1e-3 px
(float32 convolutions, summed in another order); the ordered board corners
within 1e-3 px; Zhang's closed form, the homographies and the view poses
(numpy copies) within 1e-9; the refined θ within 1e-6 relative of JAX's
from the same start (both LMs in float64), each model then held to
``tests/test_calib.py``'s truth bounds; the YAML text equal; the CLI round
trip on the CPU within 2 % of the true focal length, as JAX's own."""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_calib import (COLS, H, ROWS, SQ, TRUE, W, _ocam_project_exact, _project_true,
                              _render_view, _view_poses)
from vins_rgbd_fast_torch import calib as tcal
from vins_rgbd_fast_torch.config import load_config
from vins_rgbd_fast_tpu import calib as jcal
from vins_rgbd_fast_tpu.models import camera as jcm

# the modules (each package's ``calib.calibrate`` name is the function)
tcalib = importlib.import_module("vins_rgbd_fast_torch.calib.calibrate")
jcalib = importlib.import_module("vins_rgbd_fast_tpu.calib.calibrate")


@pytest.fixture(scope="module")
def board():
    R, t = _view_poses(1, seed=11)[0]
    return _render_view(R, t), R, t


def test_detect_corners_matches_jax(board):
    """The board's corners (the n strongest candidates) in JAX's order, but
    for swaps among responses equal within 1e-6 relative (a rendered
    board's corners tie to float32 rounding, which the two packages'
    convolutions sum in other orders), uv within 1e-3 px; the responses of
    all candidates within 1e-6 relative (the weaker tail, the board's outer
    edge, ties on plateaus whose twin pixels both pass the NMS)."""
    img = board[0]
    n = ROWS * COLS
    juv, jsc = (np.asarray(a)
                for a in jcal.detect_corners(jnp.asarray(img), max_corners=n + n // 2))
    tuv, tsc = (a.numpy() for a in tcal.detect_corners(torch.as_tensor(img), n + n // 2))
    np.testing.assert_allclose(tsc, jsc, rtol=1e-6)
    d = np.linalg.norm(tuv[:n, None] - juv[None, :n], axis=-1)
    j = d.argmin(axis=1)  # JAX's rank of each of the port's board corners
    assert sorted(j.tolist()) == list(range(n))
    np.testing.assert_allclose(tuv[:n], juv[j], atol=1e-3)
    np.testing.assert_allclose(jsc[j], jsc[:n], rtol=1e-6)
    assert (j != np.arange(n)).sum() < n // 2


def test_find_chessboard_matches_jax(board):
    img, R, t = board
    got_j = jcal.find_chessboard(img, rows=ROWS, cols=COLS)
    got_t = tcal.find_chessboard(img, rows=ROWS, cols=COLS, device="cpu")
    assert got_j is not None and got_t is not None
    np.testing.assert_allclose(got_t, got_j, atol=1e-3)
    # the corners against the truth, whatever the board's symmetric orientation
    truth = _project_true(R, t, tcal.board_points(ROWS, COLS, SQ))
    d = np.linalg.norm(got_t[:, None] - truth[None], axis=-1).min(axis=1)
    assert d.mean() < 0.35, d.mean()


def test_zhang_closed_form_equals_jax():
    obj = tcal.board_points(ROWS, COLS, SQ)
    np.testing.assert_array_equal(obj, jcal.board_points(ROWS, COLS, SQ))
    nodist = jcm.PinholeParams(fx=TRUE.fx, fy=TRUE.fy, cx=TRUE.cx, cy=TRUE.cy, width=W, height=H)
    Hj, Ht = [], []
    for R, t in _view_poses(6, seed=5):
        uv = np.asarray(jcm.pinhole_project(nodist, jnp.asarray(obj @ R.T + t)))
        Hj.append(jcal.homography(obj[:, :2], uv))
        Ht.append(tcal.homography(obj[:, :2], uv))
        np.testing.assert_allclose(Ht[-1], Hj[-1], rtol=1e-9, atol=1e-9)
    K_j, K_t = jcal.zhang_intrinsics(Hj), tcal.zhang_intrinsics(Ht)
    np.testing.assert_allclose(K_t, K_j, rtol=1e-9)
    np.testing.assert_allclose(K_t, [TRUE.fx, TRUE.fy, TRUE.cx, TRUE.cy], rtol=5e-3)
    for a, b in zip(tcalib.pose_from_homography(K_t, Ht[0]),
                    jcalib.pose_from_homography(K_j, Hj[0])):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def _views(model):
    """``tests/test_calib.py``'s views of each model (exact projections plus
    its noise)."""
    obj = tcal.board_points(ROWS, COLS, SQ)
    if model == "pinhole":
        rng = np.random.default_rng(0)
        return [_project_true(R, t, obj) + rng.normal(0, 0.03, (len(obj), 2))
                for R, t in _view_poses(16, seed=7, z=(0.3, 0.55), xy=(0.14, 0.1))]
    if model == "kannala-brandt":
        kb = jcm.EquidistantParams(mu=365.0, mv=363.0, u0=322.0, v0=238.0, k2=0.02, k3=-0.005,
                                   k4=0.002, k5=-0.0005, width=W, height=H)
        rng, proj, poses = np.random.default_rng(1), jcm.equidistant_project, \
            _view_poses(10, seed=9, z=(0.3, 0.55), xy=(0.14, 0.1))
        cam = kb
    elif model == "mei":
        cam = jcm.MeiParams(xi=0.9, gamma1=860.0, gamma2=856.0, u1=318.0, v1=242.0, k1=-0.05,
                            k2=0.01, width=W, height=H)
        rng, proj, poses = np.random.default_rng(2), jcm.mei_project, \
            _view_poses(12, seed=13, z=(0.3, 0.55), xy=(0.14, 0.1))
    else:
        rng = np.random.default_rng(4)
        out = []
        for R, t in _view_poses(12, seed=17, z=(0.25, 0.5), xy=(0.16, 0.12)):
            uv = _ocam_project_exact(OCAM_POLY, OCAM_AFFINE, OCAM_CENTER, obj @ R.T + t)
            out.append(uv + rng.normal(0, 0.05, uv.shape))
        return out
    out = []
    for R, t in poses:
        uv = np.asarray(proj(cam, jnp.asarray(obj @ R.T + t)))
        out.append(uv + rng.normal(0, 0.05, uv.shape))
    return out


OCAM_POLY = (-180.0, 0.0, 1.8e-3, -2.0e-6, 8.0e-9)
OCAM_AFFINE = (1.001, 1e-4, -2e-4)
OCAM_CENTER = (322.0, 238.0)
MODELS = ("pinhole", "kannala-brandt", "mei", "scaramuzza")


@pytest.fixture(scope="module")
def results():
    """Each model calibrated by both packages from the same views."""
    out = {}
    for m in MODELS:
        v = _views(m)
        out[m] = (jcal.calibrate(m, v, ROWS, COLS, SQ, W, H),
                  tcal.calibrate(m, v, ROWS, COLS, SQ, W, H, device="cpu"))
    return out


@pytest.mark.parametrize("model", MODELS)
def test_calibrate_matches_jax(model, results):
    jr, tr = results[model]
    np.testing.assert_allclose(tr.intrinsics, jr.intrinsics, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tr.rvecs, jr.rvecs, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tr.tvecs, jr.tvecs, rtol=1e-6, atol=1e-9)
    assert abs(tr.rms_px - jr.rms_px) <= 1e-6 * jr.rms_px
    p = tr.params
    if model == "pinhole":
        assert tr.rms_px < 0.08
        np.testing.assert_allclose([p.fx, p.fy, p.cx, p.cy], [TRUE.fx, TRUE.fy, TRUE.cx, TRUE.cy],
                                   rtol=5e-3)
        np.testing.assert_allclose([p.k1, p.k2], [TRUE.k1, TRUE.k2], atol=5e-3)
    elif model == "kannala-brandt":
        assert tr.rms_px < 0.08
        np.testing.assert_allclose([p.mu, p.mv, p.u0, p.v0], [365.0, 363.0, 322.0, 238.0],
                                   rtol=5e-3)
    elif model == "mei":
        assert tr.rms_px < 0.1
    else:
        assert tr.rms_px < 0.1
        np.testing.assert_allclose([p.center_x, p.center_y], OCAM_CENTER, atol=1.0)
        np.testing.assert_allclose(p.poly[0], OCAM_POLY[0], rtol=1e-2)
        np.testing.assert_allclose(p.inv_poly, jr.params.inv_poly, rtol=1e-6, atol=1e-9)


def test_refine_matches_jax_from_a_perturbed_start():
    """``refine`` alone, both packages from the same perturbed θ and poses."""
    v = np.asarray(_views("pinhole"))
    obj = tcal.board_points(ROWS, COLS, SQ)
    Hs = [tcal.homography(obj[:, :2], u) for u in v]
    K4 = tcal.zhang_intrinsics(Hs) * np.array([1.03, 0.98, 1.0, 1.0])
    rv, tv = map(np.asarray, zip(*(tcalib.pose_from_homography(K4, h) for h in Hs)))
    th0 = np.concatenate([K4, [0.01, 0.0, 0.0, 0.0]])
    jo = jcal.refine("pinhole", th0, rv, tv, obj, v)
    to = tcal.refine("pinhole", th0, rv, tv, obj, v, device="cpu")
    for a, b in zip(to[:3], jo[:3]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("model", MODELS)
def test_camera_yaml_text_equals_jax(model, results, tmp_path):
    jr, tr = results[model]
    # the same numbers through both writers (the port's refined θ)
    jsame = jcalib._params_from_theta(model, tr.intrinsics, W, H)
    jres = jcalib.CalibrationResult(model=model, intrinsics=tr.intrinsics, params=jsame,
                                    rms_px=tr.rms_px, per_view_rms_px=tr.per_view_rms_px,
                                    rvecs=tr.rvecs, tvecs=tr.tvecs)
    jcal.write_camera_yaml(str(tmp_path / "j.yaml"), jres, camera_name="cam0")
    tcal.write_camera_yaml(str(tmp_path / "t.yaml"), tr, camera_name="cam0")
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    assert load_config(str(tmp_path / "t.yaml")).model_type.upper() == {
        "pinhole": "PINHOLE", "kannala-brandt": "KANNALA_BRANDT", "mei": "MEI",
        "scaramuzza": "SCARAMUZZA"}[model]


def test_calib_cli_roundtrip_on_the_cpu(tmp_path):
    from vins_rgbd_fast_torch.calib.__main__ import main
    from vins_rgbd_fast_torch.io.writers import write_png

    d = tmp_path / "calibrationdata"
    d.mkdir()
    for i, (R, t) in enumerate(_view_poses(6, seed=21)):
        write_png(str(d / f"left-{i:02d}.png"), _render_view(R, t).astype(np.uint8))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main(["-w", str(COLS), "--bh", str(ROWS), "-s", str(SQ), "-i", str(d), "-p", "left-",
                   "--camera-model", "pinhole", "--camera-name", "testcam", "--device", "cpu"])
        assert rc == 0
        vc = load_config("testcam_camera_calib.yaml")
    finally:
        os.chdir(cwd)
    assert vc.model_type.upper() == "PINHOLE"
    fx = vc.camera().fx
    assert abs(fx - TRUE.fx) / TRUE.fx < 0.02, fx


def test_calib_cli_needs_cuda_or_the_cpu_flag(tmp_path):
    from vins_rgbd_fast_torch.calib.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(SystemExit) as e:
        main(["-i", str(tmp_path)])
    assert e.value.code == 2
