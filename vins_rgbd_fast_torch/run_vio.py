"""Run the port's VIO pipeline on a dataset: the roslaunch-equivalent entry
point of the PyTorch/CUDA package (twin of ``scripts/run_vio.py``).

Examples:
  # a reference rig file + a rosbag (native parser, no ROS)
  python3 -m vins_rgbd_fast_torch.run_vio --config vio.yaml --bag handheld.bag \\
      --output out/

  # a TUM RGB-D sequence (VO mode per the tum_fr3 rig)
  python3 -m vins_rgbd_fast_torch.run_vio --config tum_fr3.yaml \\
      --tum rgbd_dataset_freiburg3_walking_xyz --output out/

  # the rendered self-test sequence (no dataset required)
  python3 -m vins_rgbd_fast_torch.run_vio --synthetic 100 --output out/

The pipeline runs on the GPU (``--device cuda``, the default) and the run
fails if CUDA is not available; ``--device cpu`` runs the kernels' plain
versions on the CPU instead, for a rehearsal.  Outputs:
``vins_result_no_loop.csv`` (the reference's format), the TUM-format
``stamped_traj_estimate.txt`` and, with loop closure, ``vins_result_loop.csv``.
The ATE against the ground truth (the TUM directory's or the rendered one)
and the stage timer's report go to standard error.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .config import VinsConfig, load_config
from .io import stream as io_stream
from .pipeline import VinsPipeline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vins_rgbd_fast_torch.run_vio")
    ap.add_argument("--config", help="reference-format YAML rig file")
    ap.add_argument("--bag", help="rosbag v2.0 file")
    ap.add_argument("--tum", help="TUM RGB-D sequence directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N frames of the rendered room instead")
    ap.add_argument("--output", default="output")
    ap.add_argument("--max-frames", type=int, default=10 ** 9)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a rehearsal on the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available: the pipeline runs on the GPU "
                 "(pass --device cpu to rehearse on the CPU)")
    if (args.bag or args.tum) and not args.config:
        ap.error("--bag and --tum need --config")
    os.makedirs(args.output, exist_ok=True)

    gt = None
    if args.synthetic:
        from .io import synthetic as syn

        rig = syn.SyntheticRig()
        seq = syn.make_trajectory(args.synthetic, rig, seed=7, omega_scale=0.15,
                                  acc_scale=0.3)
        cfg = VinsConfig(
            imu=True, static_init=True, image_width=rig.width, image_height=rig.height,
            intrinsics=(rig.fx, rig.fy, rig.cx, rig.cy),
            ric=tuple(seq.ric.ravel().tolist()), tic=tuple(seq.tic.tolist()),
            max_cnt=130, num_grid_rows=7, num_grid_cols=8,
            frontend_freq=0.0, freq=0.0, acc_n=0.1, gyr_n=0.01,
            acc_w=1e-4, gyr_w=1e-5, max_imu_per_frame=32, depth_max_dist=12.0)
        pipe = VinsPipeline(cfg, device)
        for (t, a, w) in seq.imu:
            pipe.push_imu(t, a, w)
        ts, imgs, deps = syn.render_sequence(seq, rig, device)
        for k, t in enumerate(ts):
            pipe.push_image(t, imgs[k])
            pipe.push_depth(t, deps[k])
        gt = (seq.times, seq.P)
    elif args.bag:
        from .io.rosbag import BagReader, replay_into_pipeline

        cfg = load_config(args.config)
        pipe = VinsPipeline(cfg, device)
        bag = BagReader(args.bag)
        print(f"bag topics: {bag.topics()}", file=sys.stderr)
        replay_into_pipeline(bag, pipe, cfg.image_topic, cfg.depth_topic, cfg.imu_topic)
    elif args.tum:
        from .io.tum import TumSequence

        cfg = load_config(args.config)
        pipe = VinsPipeline(cfg, device)
        seq = TumSequence(args.tum)
        print(f"TUM sequence: {len(seq)} paired frames", file=sys.stderr)
        for (t, img, depth) in seq.frames():
            pipe.push_image(t, img)
            pipe.push_depth(t, depth)
            pipe.spin_once()
        if seq.groundtruth is not None:
            gt = (seq.groundtruth[:, 0], seq.groundtruth[:, 1:4])
    else:
        ap.error("one of --bag / --tum / --synthetic is required")

    try:
        traj = pipe.run(max_frames=args.max_frames)
    finally:
        pipe.close()
    print(f"{len(traj)} odometry outputs", file=sys.stderr)

    io_stream.write_trajectory_csv(os.path.join(args.output, "vins_result_no_loop.csv"), traj)
    io_stream.write_tum_trajectory(os.path.join(args.output, "stamped_traj_estimate.txt"), traj)
    corrected = pipe.corrected_trajectory()
    if corrected:
        io_stream.write_trajectory_csv(os.path.join(args.output, "vins_result_loop.csv"),
                                       corrected)
    if gt is not None and traj:
        ate = io_stream.ate_rmse([r["t"] for r in traj], [np.asarray(r["P"]) for r in traj],
                                 gt[0], gt[1])
        print(f"ATE RMSE vs ground truth: {ate:.4f} m", file=sys.stderr)
    print(pipe.timer.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
