"""The port's four camera models (``vins_rgbd_fast_torch/models/camera.py``),
``VinsConfig.camera`` and the rig file's camera keys against the JAX
package on the same numpy inputs, and one ``track_frame`` with a
Kannala-Brandt camera against JAX's; then each non-pinhole rig file through
``VinsPipeline``, the Kannala-Brandt camera on ``BatchedVioRunner`` and a
Kannala-Brandt rig through ``run_vio``, each against the ground truth.

Tolerances, set from the dtype: in float64 rays within 1e-9 and pixels
within 1e-7 px of JAX's; in float32 rays within 2e-5 relative to their size
and pixels within 1e-3 px (atan2, sin and the Newton steps round in
float32 in both packages).  The round trip (project after lift) equals JAX's within 1e-7 px in
float64, and the pixel itself within 1e-6 px (Kannala-Brandt) or 1e-4 px
(OCAM, whose inverse polynomial is a least-squares fit).  Configs and rig
files equal field for field.  The tracker: ids and counts
exact, ``un`` within 1e-5, uv within 1e-3 px (the bound of
``tests/test_torch_tracker.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch import config as tconfig
from vins_rgbd_fast_torch.config import TrackerConfig
from vins_rgbd_fast_torch.frontend import feature_tracker as tft
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.models import camera as tcam
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.frontend import feature_tracker as jft
from vins_rgbd_fast_tpu.models import camera as jcam

W, H = 160, 120
MODELS = ("PINHOLE", "KANNALA_BRANDT", "MEI", "SCARAMUZZA")


def _params(model: str, stretch: bool = True) -> dict:
    """Parameters of each model at 160×120; the OCAM one with an affine
    stretch unless ``stretch`` is off."""
    if model == "PINHOLE":
        return dict(fx=115.0, fy=116.0, cx=80.5, cy=59.5, width=W, height=H,
                    **chip_smoke.DISTORTION)
    if model == "KANNALA_BRANDT":
        return dict(mu=75.0, mv=75.5, u0=80.5, v0=59.5, k2=-0.01, k3=0.002, k4=-3e-4,
                    k5=1e-5, width=W, height=H)
    if model == "MEI":
        return dict(xi=0.8, gamma1=100.0, gamma2=101.0, u1=80.5, v1=59.5, k1=-0.05,
                    k2=0.01, p1=1e-4, p2=-1e-4, width=W, height=H)
    poly, inv = chip_smoke.ocam_polys(W, H, 75.0, 1.6e-3)
    return dict(poly=poly, inv_poly=inv, C=1.001 if stretch else 1.0,
                D=5e-4 if stretch else 0.0, E=-3e-4 if stretch else 0.0,
                center_x=81.5, center_y=58.0, width=W, height=H)


def _pixels() -> np.ndarray:
    """Random pixels, the four corners and the centre pixel."""
    rng = np.random.default_rng(0)
    uv = rng.uniform([0, 0], [W - 1, H - 1], (200, 2))
    corners = [[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1], [W / 2, H / 2]]
    return np.concatenate([uv, np.asarray(corners, float)])


def _points() -> np.ndarray:
    rng = np.random.default_rng(1)
    P = rng.uniform([-2.0, -1.5, 0.3], [2.0, 1.5, 6.0], (200, 3))
    return np.concatenate([P, [[0.0, 0.0, 1.0], [1e-4, -1e-4, 2.0]]])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model", MODELS)
def test_lift_and_project_match_jax(model, dtype):
    kw = _params(model)
    t, j = tcam.make_camera(model, **kw), jcam.make_camera(model, **kw)
    uv, P = _pixels().astype(dtype), _points().astype(dtype)
    r_t, r_j = tn(t.lift(tt(uv))), np.asarray(j.lift(jnp.asarray(uv)))
    p_t, p_j = tn(t.project(tt(P))), np.asarray(j.project(jnp.asarray(P)))
    assert r_t.dtype == r_j.dtype == np.dtype(dtype) and p_t.dtype == np.dtype(dtype)
    assert np.all(np.isfinite(r_t)) and np.all(r_t[:, 2] == 1.0)
    ray_tol, px_tol = (1e-9, 1e-7) if dtype == "float64" else (2e-5, 1e-3)
    scale = np.maximum(1.0, np.abs(r_j))
    assert np.all(np.abs(r_t - r_j) <= ray_tol * scale), np.abs(r_t - r_j).max()
    assert np.abs(p_t - p_j).max() <= px_tol, np.abs(p_t - p_j).max()


@pytest.mark.parametrize("model", MODELS)
def test_project_after_lift_matches_jax(model):
    """In float64 at every pixel of the image: the round trip's pixels equal
    JAX's within 1e-7 px; with an exact inverse (the Kannala-Brandt Newton
    steps, the OCAM fit without its affine stretch: JAX's lift leaves the
    ray's xy stretched) they are the pixels themselves.  The radtan models'
    8-step fixed point is the reference's approximation at the corners."""
    kw = _params(model, stretch=False)
    cam, j = tcam.make_camera(model, **kw), jcam.make_camera(model, **kw)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    uv = np.stack([xx, yy], axis=-1)
    back = tn(cam.project(cam.lift(tt(uv))))
    assert np.abs(back - np.asarray(j.project(j.lift(jnp.asarray(uv))))).max() < 1e-7
    if model == "KANNALA_BRANDT":
        assert np.abs(back - uv).max() < 1e-6
    if model == "SCARAMUZZA":
        assert np.abs(back - uv).max() < 1e-4


@pytest.mark.parametrize("name", ["PINHOLE", "pinhole", "KANNALA_BRANDT", "EQUIDISTANT",
                                  "Mei", "SCARAMUZZA"])
def test_make_camera_matches_jax(name):
    model = {"EQUIDISTANT": "KANNALA_BRANDT"}.get(name.upper(), name.upper())
    kw = _params(model)
    t, j = tcam.make_camera(name, **kw), jcam.make_camera(name, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j.params)
    assert type(t).__name__.replace("Camera", "") == type(j.params).__name__.replace(
        "Params", "")
    assert (t.width, t.height) == (j.width, j.height) == (W, H)


def test_make_camera_refuses_what_jax_refuses():
    for mod in (tcam, jcam):
        with pytest.raises(ValueError, match="unsupported model_type"):
            mod.make_camera("OMNI", fx=1.0)
        with pytest.raises(TypeError):
            mod.make_camera("MEI", fx=1.0)


def _rig_configs():
    """A radtan pinhole config and the three other models through
    ``chip_smoke.camera_config`` at 320×240."""
    rig, seq, cfg = chip_smoke.realsense_scene(4, 320, 240)
    return [cfg] + [chip_smoke.camera_config(m, cfg) for m in MODELS[1:]]


@pytest.mark.parametrize("i", range(4), ids=list(MODELS))
def test_vins_config_camera_matches_jax(i):
    cfg = _rig_configs()[i]
    jc = jconfig.VinsConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    assert dataclasses.asdict(cfg.camera()) == dataclasses.asdict(jc.camera().params)


@pytest.mark.parametrize("i", range(1, 4), ids=list(MODELS[1:]))
def test_load_config_reads_each_model_as_jax(tmp_path, i):
    """``chip_smoke.rig_yaml``'s file of each non-pinhole rig reads back as
    its config in the port, and as the same fields in JAX."""
    cfg = _rig_configs()[i]
    path = tmp_path / "rig.yaml"
    path.write_text(chip_smoke.rig_yaml(cfg))
    t, j = tconfig.load_config(str(path)), jconfig.load_config(str(path))
    assert t == cfg
    for f in dataclasses.fields(t):
        assert getattr(j, f.name) == getattr(t, f.name), f.name
    assert dataclasses.asdict(t.camera()) == dataclasses.asdict(j.camera().params)


def test_unknown_model_type_raises_in_both():
    for mod in (tconfig, jconfig):
        with pytest.raises(NotImplementedError, match="unknown model_type"):
            mod.VinsConfig(model_type="OMNI").camera()


def test_kb_track_frame_matches_jax():
    """One IMU-predicted ``track_frame`` (B = 2) with a Kannala-Brandt camera
    on frames rendered through its own ray grid, from a bridged JAX state,
    JAX's RANSAC draws injected."""
    kw = _params("KANNALA_BRANDT")
    t_cam, j_cam = tcam.make_camera("KANNALA_BRANDT", **kw), jcam.make_camera(
        "KANNALA_BRANDT", **kw)
    cfg = dict(width=W, height=H, max_cnt=32, capacity=48, min_dist=8, grid_rows=3,
               grid_cols=4, fast_threshold=20.0, lk_max_iters=12, lk_coarse_iters=6)
    jcfg = jft.TrackerConfig(lk_sampler="matmul", lk_engine="xla", **cfg)
    tcfg = TrackerConfig(**cfg)
    rig = tsyn.SyntheticRig(width=W, height=H)
    imgs, ts, Rs, states, refs, us = [], [], [], [], [], []
    for b in range(2):
        seq = tsyn.make_trajectory(3, rig, seed=100 + b, omega_scale=0.15, acc_scale=0.3)
        times, im, _ = chip_smoke.render_camera(seq, t_cam, "cpu", 0, 2)
        im = tn(im)
        (_, q0), (_, q1) = tsyn.camera_pose(seq, 0), tsyn.camera_pose(seq, 1)
        R = (tsyn._q2R(q1).T @ tsyn._q2R(q0)).astype(np.float32)  # cam1 <- cam0
        s1, _ = jft.track_frame(jcfg, j_cam, jft.init_state(jcfg), jnp.asarray(im[0]),
                                jnp.float32(times[0]), jnp.eye(3, dtype=jnp.float32),
                                jax.random.PRNGKey(b))
        key = jax.random.PRNGKey(10 + b)
        refs.append(jax.device_get(jft.track_frame(jcfg, j_cam, s1, jnp.asarray(im[1]),
                                                   jnp.float32(times[1]), jnp.asarray(R),
                                                   key)))
        imgs.append(im[1])
        ts.append(np.float32(times[1]))
        Rs.append(R)
        states.append(jax.device_get(s1))
        us.append(jax_ransac_uniforms(key, jcfg.ransac_trials, jcfg.maxc))
    new, out = tft.track_frame(tcfg, t_cam, bridge.to_torch(bridge.stack(states)),
                               tt(np.stack(imgs)), tt(np.stack(ts)), tt(np.stack(Rs)),
                               tt(np.stack(us)))
    for b in range(2):
        js2, jout = refs[b]
        ids = np.asarray(jout.features.ids)
        assert (ids >= 0).sum() >= 20 and int(jout.n_tracked) >= 10
        assert np.array_equal(tn(out.features.ids[b]), ids), b
        assert np.array_equal(tn(new.track_cnt[b]), np.asarray(js2.track_cnt)), b
        assert int(out.n_tracked[b]) == int(jout.n_tracked)
        valid = ids >= 0
        assert np.abs(tn(out.features.uv[b]) - np.asarray(jout.features.uv))[valid].max() < 1e-3
        assert np.abs(tn(out.features.pts[b]) - np.asarray(jout.features.pts))[valid].max() < 1e-5


def test_run_vio_takes_a_kannala_brandt_rig(tmp_path, capsys):
    """``python3 -m vins_rgbd_fast_torch.run_vio --config <KB rig> --tum``
    on the CPU: a TUM directory rendered through the fisheye's rays with
    the VO rig's knobs, its output under the VO cell's ATE bound (0.08 m)."""
    from vins_rgbd_fast_torch import run_vio
    from vins_rgbd_fast_torch.io import stream as tstream

    n, W2, H2 = 20, 320, 240
    rig, _, _, _ = chip_smoke.slice_config(W2, H2, 64)
    seq = chip_smoke.revisit_scene(dataclasses.replace(rig, frame_rate=30.0), n)
    cfg, _ = chip_smoke.vo_config(rig, seq, 64)
    cfg = chip_smoke.camera_config("KANNALA_BRANDT", dataclasses.replace(cfg,
                                                                         loop_closure=False))
    ts, imgs, deps = chip_smoke.render_camera(seq, cfg.camera(), "cpu")
    chip_smoke.write_tum_dir(str(tmp_path / "tum"), seq, ts, imgs, deps)
    (tmp_path / "rig.yaml").write_text(chip_smoke.rig_yaml(cfg))
    out = tmp_path / "out"
    rc = run_vio.main(["--config", str(tmp_path / "rig.yaml"), "--tum", str(tmp_path / "tum"),
                       "--output", str(out), "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 0 and f"{n - 10} odometry outputs" in err
    est = np.loadtxt(str(out / "stamped_traj_estimate.txt"), ndmin=2)
    assert tstream.ate_rmse(est[:, 0], est[:, 1:4], seq.times, seq.P) < 0.08


@pytest.mark.parametrize("model", ["KANNALA_BRANDT", "MEI", "SCARAMUZZA"])
def test_latency_pipeline_runs_each_non_pinhole_rig_file(tmp_path, model):
    """Each non-pinhole rig file (``rig_yaml`` → ``load_config``) through
    ``VinsPipeline`` on the CPU (chip_smoke phases 16 and 16c at 160×120):
    16 warm-up and 8 timed frames of the latency stream rendered through
    the camera's rays, the ATE under max(0.05·travelled, 0.08 m)."""
    res = chip_smoke.run_latency_path("cpu", n_frames=24, warmup=16, W=W, H=H, max_cnt=32,
                                      camera=model, workdir=str(tmp_path))
    chip_smoke.check_latency_path(res, on_gpu=False)
    assert res["camera"] == type(chip_smoke.camera_config(
        model, tconfig.VinsConfig(image_width=W, image_height=H)).camera()).__name__


def test_batched_runner_tracks_with_a_kannala_brandt_camera():
    """``BatchedVioRunner`` with the Kannala-Brandt camera (chip_smoke phase
    16d at B = 2, 160×120): warm 11 + 6 steady frames rendered through its
    rays, each sequence's ATE under max(0.05·travelled, 0.08 m)."""
    res = chip_smoke.run_main_path("cpu", 2, 6, W=W, H=H, max_cnt=32, camera="KANNALA_BRANDT")
    chip_smoke.check_main_path(res, 2, 6, on_gpu=False)
    assert res["camera"] == "EquidistantCamera"
