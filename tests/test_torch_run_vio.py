"""The port's entry point ``python3 -m vins_rgbd_fast_torch.run_vio`` on the
CPU (``--device cpu``), on the formats users hold, written by chip_smoke's
phase 14 helpers at 320×240: a RealSense-style rosbag (``bgr8`` colour,
compressedDepth PNG depth, the IMU 5 ms ahead) with a rig file that turns
CLAHE on, and a TUM directory with a VO rig file and loop closure.

Exact: each run's trajectory equals the same pipeline's fed in memory
with the same quantized frames (the 8-bit grey level, depth in
millimetres or 1/5000 m), and its output files are the bytes JAX's
writers give for those rows.  The estimates are also held to the
phases' ATE bound.  Without CUDA the entry point exits non-zero unless
``--device cpu`` is given.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from vins_rgbd_fast_torch import run_vio
from vins_rgbd_fast_torch.config import load_config
from vins_rgbd_fast_torch.io import stream as tstream
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.io.rosbag import to_grayscale
from vins_rgbd_fast_torch.pipeline import VinsPipeline
from vins_rgbd_fast_tpu.io import stream as jstream

W, H = 320, 240
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _jax_files(tmp_path, traj, corrected):
    """What JAX's writers make of these rows."""
    out = {}
    for name, writer, rows in (("vins_result_no_loop.csv", jstream.write_trajectory_csv, traj),
                               ("stamped_traj_estimate.txt", jstream.write_tum_trajectory,
                                traj),
                               ("vins_result_loop.csv", jstream.write_trajectory_csv,
                                corrected)):
        if rows:
            writer(str(tmp_path / "jax.txt"), rows)
            out[name] = _read(tmp_path / "jax.txt")
    return out


def _run(args, capsys):
    rc = run_vio.main(args + ["--device", "cpu"])
    return rc, capsys.readouterr().err


def test_bag_replay_equals_in_memory_quantized_frames(tmp_path, capsys):
    n = 20
    rig, seq, cfg = chip_smoke.realsense_scene(n, W, H)
    img_t, dep_t, imu_t = chip_smoke.REALSENSE_TOPICS
    cfg = dataclasses.replace(cfg, equalize=True, image_topic=img_t, depth_topic=dep_t,
                              imu_topic=imu_t)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    chip_smoke.write_realsense_bag(str(tmp_path / "rs.bag"), seq, ts, imgs, deps,
                                   imu_shift=chip_smoke.TD_TRUE)
    (tmp_path / "rig.yaml").write_text(chip_smoke.rig_yaml(cfg))
    out = tmp_path / "out"
    rc, err = _run(["--config", str(tmp_path / "rig.yaml"), "--bag", str(tmp_path / "rs.bag"),
                    "--output", str(out)], capsys)
    assert rc == 0
    assert sorted(os.listdir(out)) == ["stamped_traj_estimate.txt", "vins_result_no_loop.csv"]

    pipe = VinsPipeline(load_config(str(tmp_path / "rig.yaml")), "cpu")
    assert pipe.tcfg.equalize
    for (t, a, g) in seq.imu:
        pipe.push_imu(t + chip_smoke.TD_TRUE, a, g)
    for k, t in enumerate(ts):
        gray = chip_smoke.quantize_frame(imgs[k])
        pipe.push_image(t, to_grayscale(np.repeat(gray[:, :, None], 3, axis=2), "bgr8"))
        pipe.push_depth(t, tstream.decode_depth(chip_smoke.depth_mm(deps[k]), "16UC1"))
        pipe.spin_once()
    traj = pipe.run()
    assert len(traj) >= n - 11 and f"{len(traj)} odometry outputs" in err
    ref = _jax_files(tmp_path, traj, [])
    for name, data in ref.items():
        assert _read(out / name) == data, name
    rows = chip_smoke.read_result_csv(str(out / "vins_result_no_loop.csv"))
    travelled = float(np.sum(np.linalg.norm(np.diff(seq.P, axis=0), axis=1)))
    ate = tstream.ate_rmse(rows[:, 0], rows[:, 1:4], seq.times, seq.P, align=False)
    assert np.isfinite(ate) and ate < max(0.05 * travelled, 0.08)


def test_tum_replay_equals_in_memory_quantized_frames(tmp_path, capsys):
    n, max_cnt = 24, 64
    rig, _, _, _ = chip_smoke.slice_config(W, H, max_cnt)
    rig = dataclasses.replace(rig, frame_rate=30.0)
    seq = chip_smoke.revisit_scene(rig, n)
    cfg, _ = chip_smoke.vo_config(rig, seq, max_cnt)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    chip_smoke.write_tum_dir(str(tmp_path / "tum"), seq, ts, imgs, deps)
    (tmp_path / "rig.yaml").write_text(chip_smoke.rig_yaml(cfg))
    out = tmp_path / "out"
    rc, err = _run(["--config", str(tmp_path / "rig.yaml"), "--tum", str(tmp_path / "tum"),
                    "--output", str(out)], capsys)
    assert rc == 0
    assert sorted(os.listdir(out)) == ["stamped_traj_estimate.txt", "vins_result_loop.csv",
                                       "vins_result_no_loop.csv"]

    pipe = VinsPipeline(load_config(str(tmp_path / "rig.yaml")), "cpu")
    assert pipe.pose_graph is not None and not pipe.vcfg.imu
    for k, t in enumerate(ts):  # what write_tum_sequence writes and TumSequence reads
        t6 = float(f"{t:.6f}")
        depth_u16 = np.clip(deps[k].numpy() * 5000.0, 0, 65535).astype(np.uint16)
        pipe.push_image(t6, chip_smoke.quantize_frame(imgs[k]).astype(np.float32))
        pipe.push_depth(t6, depth_u16.astype(np.float32) * (1.0 / 5000.0))
        pipe.spin_once()
    traj = pipe.run()
    corrected = pipe.corrected_trajectory()
    assert len(traj) >= n - 11 and len(corrected) >= 1
    ref = _jax_files(tmp_path, traj, corrected)
    assert len(ref) == 3
    for name, data in ref.items():
        assert _read(out / name) == data, name
    printed = float(err.split("ATE RMSE vs ground truth: ")[1].split(" m")[0])
    est = np.loadtxt(str(out / "stamped_traj_estimate.txt"), ndmin=2)
    ate = tstream.ate_rmse(est[:, 0], est[:, 1:4], seq.times, seq.P)
    assert abs(ate - printed) < 1e-4 and ate < 0.08


def test_synthetic_run_on_the_cpu(tmp_path, capsys):
    rc, err = _run(["--synthetic", "13", "--output", str(tmp_path)], capsys)
    assert rc == 0 and "ATE RMSE vs ground truth" in err and "3 odometry outputs" in err
    assert len(_read(tmp_path / "vins_result_no_loop.csv").splitlines()) == 3


def test_without_cuda_exits_nonzero(tmp_path, monkeypatch):
    """No quiet CPU run: without CUDA the default device is refused, in
    process and as ``python3 -m`` (CUDA hidden on a machine that has it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run_vio.main(["--synthetic", "5", "--output", str(tmp_path / "a")])
    assert e.value.code != 0
    res = subprocess.run([sys.executable, "-m", "vins_rgbd_fast_torch.run_vio", "--synthetic",
                          "5", "--output", str(tmp_path / "b")], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and "CUDA is not available" in res.stderr
    assert not os.path.exists(tmp_path / "a") and not os.path.exists(tmp_path / "b")
