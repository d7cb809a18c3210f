"""A cell shrunk for a CPU test: the frames 4× smaller (the intrinsics and
min_dist with them), fewer lanes, frames and feature slots; everything else
as the cell's files have it."""

from __future__ import annotations

import copy

import torch

from vinsbench import harness as H


def shrink(cell_name: str, scale: int = 4, lanes: int = 2, pass_frames: int = 8,
           max_cnt: int = 0, seconds: float = 0.0):
    """(cell, config, traffic) of ``BENCHMARK.json``'s cell, made small."""
    bench = H.load_benchmark(H.BENCH_DIR + "/..")
    cell = H.find_cell(bench, cell_name)
    cfg = copy.deepcopy(H.config_file(cell["config"]))
    tr = copy.deepcopy(H.traffic_file(cell["traffic"]))
    v = cfg["vins"]
    v["image_width"] //= scale
    v["image_height"] //= scale
    v["intrinsics"] = [x / scale for x in v["intrinsics"]]
    v["min_dist"] = max(v["min_dist"] // scale, 4)
    if max_cnt:
        v["max_cnt"] = max_cnt
    if "lanes_per_card" in tr:
        tr["lanes_per_card"] = lanes
        tr["pass_frames"] = pass_frames
        tr["check_frames"] = 3
    else:
        tr["max_rate"] = 40
        tr["trace_frames"] = 3
        tr["check_rate"] = 2
        tr["check_frames"] = 3
    return cell, cfg, tr


def cell_size(cell_name: str) -> dict:
    """The shrink that keeps a cell's stream within its accuracy bound on
    the CPU: the IMU rig at half size, the VO rig at a quarter with 64
    features."""
    bench = H.load_benchmark(H.BENCH_DIR + "/..")
    imu = H.config_file(H.find_cell(bench, cell_name)["config"])["vins"]["imu"]
    return dict(scale=2) if imu else dict(scale=4, max_cnt=64)


def window_s(tr: dict) -> float:
    """A CPU window long enough to hold answers: a fleet's window ends on a
    whole call, a robot's on the frame that crosses it, and a robot's
    first poses on the CPU take about a second."""
    return 3.0 if tr["driver"] == "robot" else 1.0


def ctx(cell, cfg, tr, seed: int = 12345, seconds: float = 0.0, trace: bool = False,
        control: bool = False, log=lambda *_: None) -> H.Ctx:
    return H.Ctx(cell=cell, config=cfg, traffic=tr, seed=seed, seconds=seconds, trace=trace,
                 devices=[torch.device("cpu")] * cell["chips"], t_process=0.0,
                 out_dir="/nonexistent",
                 log=log, control=control)
