#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vins_rgbd_fast_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build of the hand-written kernels (``csrc/*.cu``, one nvcc per source,
     sm_90a, started together) and ptxas's registers, static shared memory
     and spills of each kernel (none may spill), K3's warps per point and
     its dynamic shared memory at WIN = 38;
  3. K1 (FAST + NMS) against its plain PyTorch version: bit-exact on 8
     and on 1 rendered 640×480 frames and uniform-noise images, on 32
     rendered frames (the batched closer's extraction chunk), and on one
     frame 638 wide and one whose rows do not start on 16 bytes (the
     kernel's scalar loads and stores);
  4. K2 (one LK level) against its plain version at the slice's shapes
     (B = 8, N = 200, both pyramid levels, tracks between two rendered
     frames): status agrees on ≥ 99.5 % of points, u and err within 1e-3
     where both versions say ok;
  4b. K3 (the LK iteration loop) against its plain version on the same
     tracks at B = 1 and B = 8, N = 200, both levels (the K2 bounds), and
     at the VO path's shapes: 1 × 376 cold tracks (the 376 strongest
     corners, started at their own positions) on 4 levels down to 80×60;
     and ``pyramidal_lk``'s K3 route against its K2 route on each;
  4c. the OpenLORIS rig's shapes: K1 bit-exact on one rendered 848×480
     frame (its last 64-wide output tile is 16 wide) and K3 at 1 × 200 on
     levels 1 and 0 of an 848×480 pyramid, with the K3 bounds;
  5. the main path: B = 8 sequences at 640×480 rendered on the device,
     ``BatchedVioRunner.warm`` (11 window-filling frames + static init) and
     ``run`` over T steady frames; finite costs, every kernel launched by
     the path, distinct sequences, per-sequence ATE under
     max(0.05·travelled, 0.08 m); prints frames per second (CUDA events);
  6. kernel timings at the path shapes (K1 at 8×480×640 on the rendered
     frames and on noise, at 1×480×640 and at 32×480×640, the extraction
     chunk; K2 per level at 8×200): device
     ms per launch over R launches between one pair of CUDA events, the
     wrapper's host µs per call, the bound from the work these inputs need
     (K1's pre-test survivors, K2's covered pixels, the GN steps taken) and
     the share of it; the plain versions' time per call (no yardstick); a
     per-stage split, and a profile of a few steady frames (chiprun_out/)
     that must show no host synchronisation inside ``run`` and gives each
     kernel's device ms per frame by name;
  7. the latency path: ``VinsPipeline`` over one 640×480 stream (the bench's
     ``run_latency`` with ``BENCH_LAT_LOOP=0``): 16 warm-up frames through
     ``spin_once``, then 48 timed frames (CUDA-synchronised wall time);
     NON_LINEAR after the warm-up, ATE under max(0.05·travelled, 0.08 m),
     K1 once and K3 twice per frame and K2 never, and a profile of a few
     more frames that must show no host wait inside ``spin_once``;
  8. K3 timings per level at 1×200 and 8×200, as in phase 6, at the
     VO shape 1×376 on levels 3..0 and at 1×200 on the 848×480 levels 1
     and 0; K1 at 1×480×848;
  9. the latency path with loop closure (the bench's default
     ``run_latency``): the revisit scene with a gyro pulse, ``VinsPipeline
     (loop_closure, fast_relocalization)`` with the pose graph on the
     ``AsyncLoopStager``'s worker thread; 16 warm-up frames, ``drain``, the
     stager's warm-up, then 96 timed frames ended by ``drain`` and a device
     synchronisation; NON_LINEAR after the warm-up, ATE under its bound, at
     least one loop, the loop-corrected keyframe ATE no worse than the
     keyframes' VIO ATE, K1 once per frame plus once per keyframe the worker
     extracts, K3 twice per frame, K2 never, and a profile of a few more
     frames, the worker busy meanwhile, with no host wait on the frame
     thread inside ``spin_once`` (the worker's own waits are allowed and
     counted apart); the worker's seconds by stage, beside
     phase 7's ms per frame; 9b. the same scene and configuration without
     the pose graph (the relo block in every solve, never active), and 9c.
     9b and 9 once more in the reverse order, for what the worker costs the
     frame thread; 9d. the loop cell with the pose graph inline
     (``eager_outputs``), with phase 9's checks but the profile.  Phase 9
     counts the relocalizations the worker consumes (the solver's relo pose
     fed back into the graph) and needs one when a loop was accepted in the
     timed frames;
 10. the batched path with loop closure (the bench's default ``run_batched``,
     ``BENCH_LOOP=1``): B = 8 at 640×480, four revisit sequences with a gyro
     pulse and four clean ones, ``BatchedVioRunner`` warmed on frames 0-10,
     frames 11-13 run unrecorded, then 11 segments of 18 frames: the first
     the warm one (``consume`` and the closer's warm-up), the other ten
     timed through ``ThreadedLoopCloser`` (``submit`` after each ``run``)
     to the end of ``drain()`` and a device synchronisation; finite costs,
     the clean sequences' ATE under its bound, at least one loop, the
     loop-corrected keyframe ATE no worse than the keyframes' VIO ATE, K1
     once per frame and once per extraction chunk, K2 twice per frame, K3
     never; drain-inclusive seq-frames/s and ms per lock-step frame beside
     phase 5's step; and a profile of 6 frames of one real segment (the
     last one again, ``run`` then ``submit``) while a threaded closer
     advances the earlier segments submitted to it, with no host wait on
     the frame thread inside the span (the worker's waits are counted
     apart);
 11. VO mode on the latency path (the TUM RGB-D rig's knobs: no IMU,
     ``max_cnt`` 250 = 376 slots): phase 9's scene and configuration with
     no IMU pushed, cold LK on 4 levels, the PnP pose init and the 6-DoF
     pose graph on the worker; 16 warm-up frames, then 96 timed frames;
     NON_LINEAR after the warm-up, ATE under its bound, at least one loop
     and one 6-DoF solve, the loop-corrected keyframe ATE at most 5 mm
     above the VO keyframes', K1 once per frame plus once per extracted
     keyframe, K3 four times per frame, K2 never, and a profile with no
     host wait on the frame thread; 11b. that run's map saved
     (``PoseGraph.save``) and loaded into a fresh VO pipeline that replays
     the last 48 frames from its own origin: at least one loop onto a
     loaded keyframe, and the map through the reference's directory format
     and back; 11c. a VO pipeline with the pose graph inline checkpointed
     mid-stream (``io/checkpoint.py``) and resumed in a fresh one: the
     resumed positions within 1e-4 m of the uninterrupted run's;
 12. the RealSense rig's knobs on the latency path (640×480, grid 5×6,
     ``max_cnt`` 30, static init, ``estimate_td`` from 0 against IMU
     stamps 5 ms ahead, rolling shutter with tr 0.033 (the renderer has a
     global shutter: the term is exercised, not matched), the extrinsic
     refined online), the failure check and td refresh every 4th frame;
     16 warm-up + 48 timed frames fused (96 before the replay phases
     14-14b took the script's time), 4 profiled: ATE under its bound, td
     finite within 50 ms, K1 once and K3 twice per frame, K2 never, and at
     most the td read and the failure check as host waits on the frame
     thread; 12b. the same stream calibrating the extrinsic rotation
     online from 5° off (unfused, where the calibration runs): the ATE
     bound, and an error under 4° if the calibration ends;
 13. the OpenLORIS rig's knobs (848×480 at 30 Hz, grid 7×8, ``max_cnt``
     130, ``static_init`` 0, depth to 3 m) over a stream moving from frame
     0, 16 + 48 frames (96 timed before phase 14): ``init_dynamic``
     initializes by frame 15, the relative motion from the first output to
     the last within max(0.1·d, 0.08 m) of the truth, K1 once and K3 twice
     per frame, K2 never, 3 profiled frames with no
     host wait on the frame thread; 13b. that stream with no depth over
     its first 12 frames: ``init_dynamic`` fails, ``init_mono`` runs, the
     window initializes by frame 23, the relative motion within
     max(0.15·d, 0.1 m);
 14. real-data formats through the port's entry point: phase 12's
     RealSense scene (16 warm-up + 48 frames, 640×480, 200 Hz IMU 5 ms
     ahead) written by the port's writers to a chunked rosbag v2.0 (colour
     as raw ``bgr8``, depth as "16UC1; compressedDepth png" millimetres,
     the IMU on ``/camera/imu``) with an OpenCV-FileStorage rig file of
     phase 12's knobs, ``equalize`` 1 and the three topics; ``python3 -m
     vins_rgbd_fast_torch.run_vio --config --bag --output`` in a child
     process must exit 0 with one CSV row per odometry output and the ATE
     under max(0.05·travelled, 0.08 m); the bag again in this process
     through ``replay_into_pipeline`` (phase 12's settings, 3 more frames
     profiled): td finite within 50 ms, the tracker's level 0 the CLAHE of
     the raw frame, K1 once and K3 twice per tracked frame, K2 never, at
     most phase 12's two host waits on the frame thread; ms per frame
     split into bag decode and ``spin_once``; 14b. phase 11's VO rig
     (``imu`` 0, ``loop_closure`` 1, ``max_cnt`` 250) on phase 9's revisit
     scene at 30 Hz, 64 frames written as a TUM directory with its ground
     truth; ``run_vio --tum`` must exit 0 with the ATE it prints and the
     one recomputed from ``stamped_traj_estimate.txt`` under the bound and
     a ``vins_result_loop.csv``; the first 32 frames in this process as
     run_vio reads them (2 more profiled): K3 four times per frame, K2
     never, no host wait on the frame thread; the PNG decode ms per frame,
     and of one 640×480 RGB PNG of Paeth rows; 14c. 8 frames of the
     latency tracker with ``fisheye`` on, with the analytic circle and with
     a mask file of a non-circular field of view: no live point outside
     the mask, read on the device.
Phases 5, 7, 9, 10, 11, 12, 13, 14 and 14b each zero the kernels' launch
counters just before their path and read them just after; the ``kernels``
line sums the nine.  A line before the card's lists each phase's wall seconds.
The last line is ``{"ok": true, "device": {...}}``.  Without CUDA it exits
non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vins_rgbd_fast_torch import native
from vins_rgbd_fast_torch.backend import estimator as est
from vins_rgbd_fast_torch.backend.estimator import ImuIntervalBuffer
from vins_rgbd_fast_torch.config import EstimatorConfig, TrackerConfig, VinsConfig
from vins_rgbd_fast_torch.frontend import feature_tracker as ft
from vins_rgbd_fast_torch.io import synthetic as syn
from vins_rgbd_fast_torch.io.stream import ate_rmse
from vins_rgbd_fast_torch.loop.pose_graph import (KeyframeGate, PoseGraphConfig,
                                                  extract_kf_device)
from vins_rgbd_fast_torch.models.camera import PinholeCamera
from vins_rgbd_fast_torch.ops import fast, image, lk
from vins_rgbd_fast_torch.parallel import batched_pipeline as bp
from vins_rgbd_fast_torch.parallel.loop_closer import BatchedLoopCloser, ThreadedLoopCloser
from vins_rgbd_fast_torch.pipeline import VinsPipeline

# radtan coefficients of the bench rig (reference realsense vio.yaml)
DISTORTION = dict(k1=0.13387871564774004, k2=-0.2731913133377051,
                  p1=0.0020296263577681264, p2=-0.00044384544608203714)
OUT_DIR = "chiprun_out"
RUN_SPAN = "chip_smoke::run"
SPIN_SPAN = "chip_smoke::spin_once"
TD_TRUE = 0.005  # phase 12's IMU clock runs 5 ms ahead of the image stamps
HOST_SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
                   "cudaMemcpy")
KERNELS = ("fast_nms", "lk_level", "lk_iterate")  # launch counters, and <name>_kernel on the card

# H100 SXM peaks (NVIDIA's data sheet): device memory, and float32 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# K1 per pixel: 16 ring differences; the compass pre-test's 8 comparisons
# (4 compass points against +thr and -thr); 9 for the 3×3 NMS; 5 for the
# polarity max, the threshold and border selects.  Per (pixel, polarity)
# that passes the pre-test: its 9-arc term by doubling, 4 × 16 min/max + 16
# for the best arc.
FAST_OPS_PER_PX = 16 + 8 + 9 + 5
FAST_OPS_PER_PAIR = 80
# one bilinear sample of a GN pass and its two products: 4 taps, 3 blends
# (2 flop each), the residual and the two multiply-adds
LK_FLOP_PER_SAMPLE = 16


def _bound(nbytes: float, ops: float) -> dict:
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_F32_PER_S
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(B: int, H: int, W: int, N: int, iters: int, win: int = 21,
                  search_margin: int = 8, pairs=None, footprint=None, steps=None) -> dict:
    """The least time one launch of each kernel can take on the card: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its operations over the float32 rate.  K1 on
    B×H×W images; K2 and K3 on B×N points at a level of at most ``iters``
    GN steps.

    Where the work depends on the data, the caller passes what its data
    needs: ``pairs``, the (pixel, polarity) pairs that pass K1's compass
    pre-test (``fast_pairs``); ``footprint``, the pixels of prev and of cur
    that K2's template tiles and search windows cover, each once however
    many tiles hold it (``k2_footprint``); ``steps``, the GN steps that the
    B×N points take in all (``gn_steps``).  Without them the counts are the
    most the shapes could need: both polarities of every pixel, one tile
    and one window per point but no more than the level images, ``iters``
    steps per point."""
    px = B * H * W
    P = B * N
    S, PS, WIN = win * win, win + 2, win + 1 + 2 * search_margin
    pairs = 2 * px if pairs is None else pairs
    if footprint is None:
        footprint = (min(P * (PS + 1) ** 2, px), min(P * WIN ** 2, px))
    # every point ends with one residual pass, done or not
    gn_ops = ((P * iters if steps is None else steps) + P) * S * LK_FLOP_PER_SAMPLE
    # K2: the covered pixels of prev and cur; pts, flow (2 f32 each), active
    # (1 B), anchors (2 i32) in; u (2 f32), ok (1 B), err (f32) out.
    # Template: two blends per tile pixel, gradients and the structure
    # tensor per sample.
    k2_bytes = 4 * sum(footprint) + P * (8 + 8 + 1 + 8 + 8 + 1 + 4)
    k2_ops = gn_ops + P * (8 * PS * PS + 8 * S)
    # K3: per point template, two gradients and the window; px, py, u0,
    # done0 (1 B), inv_det and the 3 structure terms in; u, err out
    k3_bytes = P * (4 * (3 * S + WIN ** 2) + 8 + 8 + 1 + 16 + 8 + 4)
    return {"fast_nms": _bound(2 * 4 * px, FAST_OPS_PER_PX * px + FAST_OPS_PER_PAIR * pairs),
            "lk_level": _bound(k2_bytes, k2_ops),
            "lk_iterate": _bound(k3_bytes, gn_ops)}


def ptxas_usage(log: str) -> dict:
    """Registers, static shared memory, stack and spills of each of the
    port's kernels, from the messages of ``nvcc -Xptxas -v`` (the log that
    ``native.build`` writes beside the library)."""
    usage = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        name = next((k for k in KERNELS if re.search(rf"\d{k}_kernel", mangled)), None)
        if name is None:
            continue

        def num(pattern):
            m = re.search(pattern, chunk)
            return int(m.group(1)) if m else 0

        usage[name] = dict(registers=num(r"Used (\d+) registers"),
                           smem_bytes=num(r"(\d+) bytes smem"),
                           stack_bytes=num(r"(\d+) bytes stack frame"),
                           spill_bytes=num(r"(\d+) bytes spill stores")
                           + num(r"(\d+) bytes spill loads"))
    return usage


def fast_pairs(img: torch.Tensor, thr: float) -> int:
    """The (pixel, polarity) pairs of (B, H, W) images, inside the 3-px
    border, that pass K1's compass pre-test: two cyclically adjacent points
    of the ring's {0, 4, 8, 12} beyond the threshold.  Only these need the
    arc work."""
    d = fast.ring_differences(img)[[0, 4, 8, 12]]
    H, W = img.shape[-2:]
    inner = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    inner[3:H - 3, 3:W - 3] = True

    def passes(beyond):
        return (beyond & beyond.roll(-1, 0)).any(0) & inner

    return int(passes(d > thr).sum() + passes(d < -thr).sum())


def k2_footprint(prev: torch.Tensor, pts_l, ax, ay, win: int = 21,
                 search_margin: int = 8):
    """The pixels of prev and of cur (each counted once) that K2 reads: the
    (win + 3)² template tiles at ``pts_l`` and the search windows at the
    anchors (ax, ay), with clamp-to-edge addresses as ``ops/lk.py`` takes
    them."""
    B, H, W = prev.shape
    WIN = win + 1 + 2 * search_margin
    pad, PS = WIN, win + 2
    half = (PS - 1) // 2
    x0 = torch.clamp(lk._floor_int(pts_l[..., 0]) + pad - half, 0, W + 2 * pad - PS - 1)
    y0 = torch.clamp(lk._floor_int(pts_l[..., 1]) + pad - half, 0, H + 2 * pad - PS - 1)
    ids = torch.arange(B * H * W, device=prev.device).reshape(B, H, W)

    def covered(y, x, n):
        return int(lk._gather_tiles(ids, y, x, n, n, pad).unique().numel())

    return covered(y0, x0, PS + 1), covered(ay, ax, WIN)


def gn_steps(u_at_cap, iters: int) -> list:
    """The points that take GN step k, for k = 1 .. ``iters``: those whose
    u moves when the iteration cap rises from k - 1 to k.  ``u_at_cap(k)``
    gives u (B, N, 2) at cap k."""
    u = [u_at_cap(k) for k in range(iters + 1)]
    return [int((u[k] != u[k - 1]).any(-1).sum()) for k in range(1, iters + 1)]


def slice_config(W: int = 640, H: int = 480, max_cnt: int = 130):
    """The bench's batched cell without loop closure (bench.py _rig/_cfg
    and the throughput envelope: LM 2 iterations, LK 12/6), scaled to
    W×H when W < 640 (focal length and min_dist scale with W)."""
    s = W / 640.0
    rig = syn.SyntheticRig(width=W, height=H, fx=460.0 * s, fy=460.0 * s,
                           cx=W / 2.0, cy=H / 2.0, imu_rate=200.0, frame_rate=20.0,
                           **DISTORTION)
    maxc = max(((int(max_cnt * 1.5) + 7) // 8) * 8, 32)
    tcfg = TrackerConfig(width=W, height=H, max_cnt=max_cnt, capacity=maxc,
                         min_dist=max(int(round(30 * s)), 4), grid_rows=7, grid_cols=8,
                         f_threshold=1.0, fast_threshold=20.0)
    ecfg = EstimatorConfig(maxf=maxc, max_imu=32, fix_depth=True, depth_min_dist=0.3,
                           depth_max_dist=12.0, min_parallax=10.0 / 460.0,
                           acc_n=0.1, gyr_n=0.01, acc_w=1e-4, gyr_w=1e-5, max_iters=2)
    cam = PinholeCamera(fx=rig.fx, fy=rig.fy, cx=rig.cx, cy=rig.cy, width=W, height=H,
                        **DISTORTION)
    return rig, tcfg, ecfg, cam


def make_sequences(rig, B: int, n_frames: int, device):
    """B synthetic sequences (seeds 100+b, the bench's), rendered on device,
    with per-sequence host IMU buffers."""
    seqs = [syn.make_trajectory(n_frames, rig, seed=100 + b, omega_scale=0.15,
                                acc_scale=0.3) for b in range(B)]
    rendered = [syn.render_sequence(s, rig, device) for s in seqs]
    bufs = []
    for s in seqs:
        buf = ImuIntervalBuffer(32)
        for (t, a, g) in s.imu:
            buf.push(t, a, g)
        bufs.append(buf)
    return seqs, rendered, bufs


def run_main_path(device, B: int, T: int, W: int = 640, H: int = 480, max_cnt: int = 130,
                  extra: int = 0, timer=None):
    """Self-warmed batched VIO over B sequences and T steady frames.
    Returns a dict of results (and the runner state for more frames)."""
    rig, tcfg, ecfg, cam = slice_config(W, H, max_cnt)
    n = bp.WINDOW_SIZE + 1 + T + extra
    seqs, rendered, bufs = make_sequences(rig, B, n, device)
    ts = [r[0] for r in rendered]
    imgs = [r[1] for r in rendered]
    deps = [r[2] for r in rendered]
    k_w = bp.WINDOW_SIZE + 1
    warm_batch = bp.stage_frames(imgs, deps, ts, bufs, 0, k_w, device)
    run_batch = bp.stage_frames(imgs, deps, ts, bufs, k_w, k_w + T, device)
    # extra steady frames for the stage breakdown and the profile, split in two
    k_e = k_w + T + extra // 2
    extra_batch = (bp.stage_frames(imgs, deps, ts, bufs, k_w + T, k_e, device),
                   bp.stage_frames(imgs, deps, ts, bufs, k_e, n, device)) if extra else None
    runner = bp.BatchedVioRunner(tcfg, cam, ecfg, device, B)
    trk, st = runner.init_states(seqs[0].ric, seqs[0].tic)

    reset_counts()
    t0 = time.perf_counter()
    trk, st, _ = runner.warm(trk, st, warm_batch)
    if timer is not None:
        timer.start()
    trk, st, outs = runner.run(trk, st, run_batch)
    run_ms = timer.stop() if timer is not None else None
    P = outs.P.cpu().numpy()  # the one read-back of the steady run
    wall = time.perf_counter() - t0
    counts = read_counts()

    cost = outs.cost.cpu().numpy()
    ates, bounds = [], []
    for b in range(B):
        ate = ate_rmse(ts[b][k_w:k_w + T], P[:, b], seqs[b].times, seqs[b].P, align=False)
        travelled = float(np.sum(np.linalg.norm(np.diff(seqs[b].P, axis=0), axis=1)))
        ates.append(ate)
        bounds.append(max(0.05 * travelled, 0.08))
    return dict(P=P, cost=cost, ates=ates, bounds=bounds, counts=counts, run_ms=run_ms,
                wall_s=wall, frames=k_w + T, runner=runner, state=(trk, st),
                extra_batch=extra_batch, n_features=outs.n_features.cpu().numpy())


def check_main_path(res, B: int, T: int, on_gpu: bool = True) -> None:
    require(np.all(np.isfinite(res["cost"])), "non-finite cost")
    frames = res["frames"]
    if on_gpu:  # K1 runs once per frame over all B images; K2 once per level
        require(res["counts"]["fast_nms"] == frames, res["counts"])
        require(res["counts"]["lk_level"] == 2 * frames, res["counts"])
        require(res["counts"]["lk_iterate"] == 0, res["counts"])
    for b in range(1, B):
        require(not np.allclose(res["P"][:, 0], res["P"][:, b], atol=1e-3),
                f"sequences 0 and {b} coincide")
    for b, (ate, bound) in enumerate(zip(res["ates"], res["bounds"])):
        require(np.isfinite(ate) and ate < bound, ("ATE", b, ate, bound))


def reset_counts() -> None:
    fast.launches = 0
    lk.level_launches = 0
    lk.iterate_launches = 0


def read_counts() -> dict:
    return dict(zip(KERNELS, (fast.launches, lk.level_launches, lk.iterate_launches)))


def latency_config(rig, seq, max_cnt: int = 130) -> VinsConfig:
    """bench.py _cfg for the latency cell on ``rig`` (min_dist scales with
    the width below 640)."""
    s = rig.width / 640.0
    return VinsConfig(
        imu=True, static_init=True, image_width=rig.width, image_height=rig.height,
        intrinsics=(rig.fx, rig.fy, rig.cx, rig.cy), distortion=(rig.k1, rig.k2, rig.p1, rig.p2),
        ric=tuple(seq.ric.ravel().tolist()), tic=tuple(seq.tic.tolist()),
        max_cnt=max_cnt, min_dist=max(int(round(30 * s)), 4), num_grid_rows=7,
        num_grid_cols=8, frontend_freq=0.0, freq=0.0, fix_depth=True, depth_max_dist=12.0,
        acc_n=0.1, gyr_n=0.01, acc_w=1e-4, gyr_w=1e-5, max_imu_per_frame=32,
        keyframe_parallax=10.0)


def envelope(pipe: VinsPipeline) -> VinsPipeline:
    """The bench's latency envelope on a pipeline: LM 2 iterations, LK 12
    fine / 6 coarse."""
    pipe.estimator.cfg = dataclasses.replace(pipe.estimator.cfg, max_iters=2)
    pipe.tcfg = dataclasses.replace(pipe.tcfg, lk_max_iters=12, lk_coarse_iters=6)
    return pipe


def run_latency_path(device, n_frames: int = 112, warmup: int = 16, W: int = 640,
                     H: int = 480, max_cnt: int = 130, profile: int = 0, path=None,
                     revisit: bool = False):
    """bench.py run_latency with BENCH_LAT_LOOP=0 on the port: one stream
    (make_trajectory seed 7), frames rendered on the device first, the
    fused steady state with no read-back per frame (eager_outputs off,
    failure check every 10**9 frames) and the envelope (LM 2 iterations,
    LK 12/6).  ``profile`` more frames run under the profiler afterwards.
    With ``revisit``, the loop cell's scene and configuration but no pose
    graph: fast relocalization on, its constraint never active."""
    rig, _, _, _ = slice_config(W, H, max_cnt)
    if revisit:
        seq = revisit_scene(rig, n_frames, profile)
        cfg = dataclasses.replace(loop_config(rig, seq, max_cnt)[0], loop_closure=False)
    else:
        seq = syn.make_trajectory(n_frames + profile, rig, seed=7, omega_scale=0.15,
                                  acc_scale=0.3)
        cfg = latency_config(rig, seq, max_cnt)
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    pipe = envelope(VinsPipeline(cfg, device, eager_outputs=False,
                                 failure_check_interval=10 ** 9, fused_steady_state=True))
    for (t, a, g) in seq.imu:
        pipe.push_imu(t, a, g)

    def feed(k0, k1):
        for k in range(k0, k1):
            pipe.push_image(ts[k], imgs[k])
            pipe.push_depth(ts[k], deps[k])
            pipe.spin_once()

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    reset_counts()
    feed(0, warmup)
    flag = pipe.estimator.solver_flag
    sync()
    t0 = time.perf_counter()
    feed(warmup, n_frames)
    sync()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    prof = None
    if profile:
        prof = profile_span(lambda: feed(n_frames, n_frames + profile), SPIN_SPAN, profile,
                            path, 1e3 * elapsed / (n_frames - warmup))
    traj = [r for r in pipe.estimator.trajectory if r["t"] <= ts[n_frames - 1]]
    ate = ate_rmse([r["t"] for r in traj], [r["P"] for r in traj], seq.times, seq.P,
                   align=False) if len(traj) >= 5 else float("nan")
    travelled = float(np.sum(np.linalg.norm(np.diff(seq.P[:n_frames], axis=0), axis=1)))
    n_timed = n_frames - warmup
    return dict(latency_fps=n_timed / elapsed, latency_ms_per_frame=1e3 * elapsed / n_timed,
                latency_ate_m=ate, bound=max(0.05 * travelled, 0.08), frames=n_frames,
                n_records=len(traj), solver_flag_after_warmup=flag, counts=counts,
                profile=prof, timer=pipe.timer.summary())


def check_latency_path(res, on_gpu: bool = True) -> None:
    require(res["solver_flag_after_warmup"] == est.VinsEstimator.NON_LINEAR,
            "NON_LINEAR after the warm-up")
    require(np.isfinite(res["latency_ate_m"]) and res["latency_ate_m"] < res["bound"],
            ("latency ATE", res["latency_ate_m"], res["bound"]))
    if on_gpu:  # K1 once per frame, K3 once per pyramid level, never K2
        n = res["frames"]
        require(res["counts"] == {"fast_nms": n, "lk_level": 0, "lk_iterate": 2 * n},
                ("latency launches", res["counts"]))
        require(res["profile"]["host_syncs"] == 0, "no host wait inside spin_once")


def loop_config(rig, seq, max_cnt: int = 130, max_kp: int = 192):
    """bench.py run_latency's loop-closure configuration (BENCH_LAT_LOOP=1):
    loop closure and fast relocalization on, and its pose-graph settings."""
    cfg = dataclasses.replace(latency_config(rig, seq, max_cnt), loop_closure=True,
                              fast_relocalization=True)
    pg = PoseGraphConfig(max_kp=max_kp, max_wp=cfg.feature_capacity, recency_exclusion=8,
                         score_best=0.08, score_second=0.02, pad_nodes_min=128,
                         pad_edges_min=1024)
    return cfg, pg


def vo_config(rig, seq, max_cnt: int = 250, max_kp: int = 192):
    """The loop cell with the TUM RGB-D rig's VO knobs (``imu`` 0,
    ``max_cnt`` 250: 376 feature slots) and the 6-DoF pose graph; the rest
    as ``loop_config``."""
    cfg, pg = loop_config(rig, seq, max_cnt, max_kp)
    return dataclasses.replace(cfg, imu=False), dataclasses.replace(pg, use_6dof=True)


def revisit_scene(rig, n_frames: int, extra: int = 0, seed: int = 207, imu_seed: int = 307):
    """The bench's loop scene: ``make_revisit_trajectory(n_frames, seed,
    accel 1.5, sideways, 2 cycles)`` with the gyro pulse of ``corrupt_imu
    (imu_seed)``; ``extra`` frames past it keep the scene of the first
    ``n_frames`` (the pulse is placed at the same times)."""
    n = n_frames + extra
    if n // 8 != n_frames // 8:
        raise ValueError("extra frames would change the revisit period")
    seq = syn.make_revisit_trajectory(n, rig, seed=seed, accel=1.5, axis=(0.0, 1.0, 0.0),
                                      cycles=2)
    s = (n_frames - 1) / (n - 1)  # the pulse fractions of the n_frames scene
    return syn.corrupt_imu(seq, seed=imu_seed, gyr_noise=0.003, gyr_pulse=0.2,
                           pulse_frac=(0.18 * s, 0.3 * s))


def run_loop_path(device, n_frames: int = 112, warmup: int = 16, W: int = 640, H: int = 480,
                  max_cnt: int = 130, max_kp: int = 192, profile: int = 0, path=None,
                  eager: bool = False, vo: bool = False):
    """bench.py run_latency with BENCH_LAT_LOOP=1 on the port: the revisit
    scene rendered on the device first, the fused steady state with no
    read-back per frame, the envelope, and the pose graph on the
    ``AsyncLoopStager``'s worker (with ``eager``, inline in each frame's
    ``spin_once``, every frame read back).  The launch counters are zeroed
    after the warm-up and the stager's warm-up, just before the timed
    frames; ``profile`` frames (async only) run under the profiler after.
    With ``vo``, VO mode (``vo_config``: no IMU pushed, cold LK on 4
    levels, PnP pose init, the 6-DoF graph).  The result keeps the pose
    graph (``graph``) and the scene (``scene``)."""
    rig, _, _, _ = slice_config(W, H, max_cnt)
    seq = revisit_scene(rig, n_frames, profile)
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    cfg, pg_cfg = (vo_config if vo else loop_config)(rig, seq, max_cnt, max_kp)
    pipe = envelope(VinsPipeline(cfg, device, eager_outputs=eager,
                                 failure_check_interval=10 ** 9, fused_steady_state=True,
                                 pose_graph_config=pg_cfg))
    graph = pipe.pose_graph
    stager = pipe._loop_stager  # None with eager
    consumed = []  # relocalizations the worker fed back to the graph
    if stager is not None:
        consume_relo = stager._consume_relo

        def counted(p):
            consumed.append(stager._relo_sent_kf)
            consume_relo(p)

        stager._consume_relo = counted
    for (t, a, g) in ([] if vo else seq.imu):
        pipe.push_imu(t, a, g)

    def feed(k0, k1):
        for k in range(k0, k1):
            pipe.push_image(ts[k], imgs[k])
            pipe.push_depth(ts[k], deps[k])
            pipe.spin_once()

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    try:
        feed(0, warmup)
        flag = pipe.estimator.solver_flag
        pipe.drain()
        if stager is not None:
            stager.compile_warmup(imgs[0])
            stager.stage_s = dict.fromkeys(stager.stage_s, 0.0)
        sync()
        kf0, relo0 = len(graph.keyframes), len(consumed)
        loops0 = stager.n_loops if stager is not None else None
        reset_counts()
        t0 = time.perf_counter()
        feed(warmup, n_frames)
        pipe.drain()
        sync()
        elapsed = time.perf_counter() - t0
        counts = read_counts()
        kf_timed = len(graph.keyframes) - kf0
        relo_timed = len(consumed) - relo0 if stager is not None else None
        loops_timed = stager.n_loops - loops0 if stager is not None else None
        stages = dict(stager.stage_s) if stager is not None else None
        prof = None
        if profile and stager is not None:
            def busy_feed():
                # the worker runs a loop check on a clone of the graph meanwhile
                # (extraction, a query, PnP, a PGO), so its waits overlap the span
                stager._worker.put(lambda: stager._warmup(imgs[0]))
                feed(n_frames, n_frames + profile)

            prof = profile_span(busy_feed, SPIN_SPAN, profile, path,
                                1e3 * elapsed / (n_frames - warmup))
            pipe.drain()
    finally:
        pipe.close()
    t_end = ts[n_frames - 1]
    traj = [r for r in pipe.estimator.trajectory if r["t"] <= t_end]
    kfs = [k for k in graph.keyframes if k.t <= t_end]
    path_c = [p for p in graph.path() if p[0] <= t_end]

    def ate(times, P):
        return (ate_rmse(times, P, seq.times, seq.P, align=False) if len(times) >= 5
                else float("nan"))

    travelled = float(np.sum(np.linalg.norm(np.diff(seq.P[:n_frames], axis=0), axis=1)))
    n_timed = n_frames - warmup
    return dict(latency_fps=n_timed / elapsed, latency_ms_per_frame=1e3 * elapsed / n_timed,
                latency_ate_m=ate([r["t"] for r in traj], [r["P"] for r in traj]),
                latency_loop_ate_m=ate([p[0] for p in path_c], [p[1] for p in path_c]),
                latency_vio_kf_ate_m=ate([k.t for k in kfs], [k.P_vio for k in kfs]),
                latency_kf=len(kfs), latency_loops=len([lp for lp in graph.loops
                                                        if lp["cur"] < len(kfs)]),
                loops=[(lp["cur"], lp["old"], lp["n_inliers"]) for lp in graph.loops],
                bound=max(0.05 * travelled, 0.08), frames=n_frames, timed=n_timed,
                kf_timed=kf_timed, solver_flag_after_warmup=flag, counts=counts,
                loops_timed=loops_timed, relo_consumed=relo_timed, relo_keyframes=consumed,
                worker_s=stages, profile=prof, timer=pipe.timer.summary(), vo=vo,
                lk_levels=pipe.tcfg.pyr_levels_cold if vo else pipe.tcfg.pyr_levels_predicted,
                solves_6dof=graph.n_solves_6dof, graph=graph,
                scene=(seq, ts, imgs, deps, cfg, pg_cfg))


def check_loop_path(res, on_gpu: bool = True) -> None:
    """Phase 9's checks, and phase 11's in VO mode: there at least one
    6-DoF solve, K3 on 4 levels, and the loop-corrected keyframe ATE within
    5 mm above the VO keyframes' (VO on clean frames may barely drift)."""
    require(res["solver_flag_after_warmup"] == est.VinsEstimator.NON_LINEAR,
            "NON_LINEAR after the warm-up")
    for k in ("latency_ate_m", "latency_loop_ate_m", "latency_vio_kf_ate_m"):
        require(np.isfinite(res[k]), (k, res[k]))
    require(res["latency_ate_m"] < res["bound"], ("latency ATE", res["latency_ate_m"],
                                                  res["bound"]))
    require(res["latency_loops"] >= 1, ("loops", res["loops"]))
    slack = 0.005 if res["vo"] else 0.0
    require(res["latency_loop_ate_m"] <= res["latency_vio_kf_ate_m"] + slack,
            ("loop-corrected keyframe ATE above the VIO one", res["latency_loop_ate_m"],
             res["latency_vio_kf_ate_m"]))
    if res["vo"]:
        require(res["solves_6dof"] >= 1, ("6-DoF solves", res["solves_6dof"]))
    if on_gpu and res["loops_timed"]:  # the loops come back from the solver as relocalizations
        require(res["relo_consumed"] >= 1, ("no relocalization consumed", res["loops_timed"],
                                            res["relo_consumed"]))
    if on_gpu:  # K1 per frame and per extracted keyframe, K3 per level, never K2
        n = res["timed"]
        require(res["counts"] == {"fast_nms": n + res["kf_timed"], "lk_level": 0,
                                  "lk_iterate": res["lk_levels"] * n},
                ("loop-path launches", res["counts"]))
    if res["profile"] is not None:
        require(res["profile"]["host_syncs"] == 0,
                ("no host wait on the frame thread", res["profile"]["host_sync_calls"]))


def run_map_roundtrip(device, vo_res, tail: int = 48, workdir: str = OUT_DIR):
    """Phase 11b: the pose graph of a VO loop run (``run_loop_path(vo=True)``)
    saved with ``PoseGraph.save``, loaded into a fresh VO pipeline (the pose
    graph inline), which replays the last ``tail`` frames of the scene from
    its own origin; then the graph, loaded map and new keyframes, through the
    reference's map directory (``save_reference_pose_graph`` into
    ``load_reference_pose_graph``)."""
    from vins_rgbd_fast_torch.loop.interop import (load_reference_pose_graph,
                                                   save_reference_pose_graph)
    from vins_rgbd_fast_torch.loop.pose_graph import PoseGraph

    seq, ts, imgs, deps, cfg, pg_cfg = vo_res["scene"]
    n = vo_res["frames"]
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        path = os.path.join(d, "map.npz")
        vo_res["graph"].save(path)
        pipe = envelope(VinsPipeline(cfg, device, eager_outputs=True,
                                     failure_check_interval=10 ** 9, fused_steady_state=True,
                                     pose_graph_config=pg_cfg))
        g = pipe.pose_graph
        g.load(path)
        n_map = len(g.keyframes)
        for k in range(n - tail, n):
            pipe.push_image(ts[k], imgs[k])
            pipe.push_depth(ts[k], deps[k])
            pipe.spin_once()
        pipe.close()
        on_map = [(lp["cur"], lp["old"], lp["n_inliers"]) for lp in g.loops
                  if lp["cur"] >= n_map and g.keyframes[lp["old"]].sequence == 0]
        ref_dir = os.path.join(d, "reference_map")
        save_reference_pose_graph(ref_dir, g)
        back = PoseGraph(g.cfg, g.cam, g.ric, g.tic, device)
        n_back = load_reference_pose_graph(ref_dir, back)
    kp_equal = all(  # the valid keypoints' descriptors, front-packed on the way back
        np.array_equal(b.kp_desc[:int(np.sum(b.kp_valid))],
                       torch.as_tensor(a.kp_desc).cpu().numpy()[np.asarray(a.kp_valid, bool)])
        for a, b in zip(g.keyframes, back.keyframes))
    corr = max(float(np.abs(np.asarray(back.corrected[b.index][0], np.float64)
                            - np.asarray(g.corrected.get(a.index, (a.P_vio, a.Q_vio))[0])).max())
               for a, b in zip(g.keyframes, back.keyframes))
    latest = {int(lp["cur"]): lp for lp in g.loops}
    return dict(map_keyframes=n_map, keyframes=len(g.keyframes), new_keyframes=len(g.keyframes)
                - n_map, loops_on_map=on_map, aligned=bool(g.sequence_aligned.get(g.sequence)),
                solves_6dof=g.n_solves_6dof, interop_keyframes=n_back,
                interop_desc_equal=kp_equal, interop_corrected_err=corr,
                interop_loops=[(lp["cur"], lp["old"]) for lp in back.loops],
                loops_by_cur=[(c, int(lp["old"])) for c, lp in sorted(latest.items())])


def check_map_roundtrip(res) -> None:
    require(res["new_keyframes"] >= 1, ("keyframes after the load", res))
    require(len(res["loops_on_map"]) >= 1, ("no loop against the loaded map", res))
    require(res["interop_keyframes"] == res["keyframes"], ("reference map keyframes", res))
    require(res["interop_desc_equal"], "reference map descriptors")
    require(res["interop_corrected_err"] < 1e-6, ("reference map poses", res))
    require(res["interop_loops"] == res["loops_by_cur"], ("reference map loops", res))


def run_checkpoint_resume(device, n_frames: int = 96, cut: int = 64, W: int = 640,
                          H: int = 480, max_cnt: int = 250, max_kp: int = 192,
                          workdir: str = OUT_DIR):
    """Phase 11c: a VO pipeline with the pose graph inline over the revisit
    scene, checkpointed (``io/checkpoint.save_pipeline``) after frame
    ``cut``, runs on to ``n_frames``; a fresh pipeline resumed from the
    checkpoint (``load_pipeline``) replays frames ``cut`` .. ``n_frames``.
    Returns the largest difference of the two runs' newest positions."""
    from vins_rgbd_fast_torch.io import checkpoint as ckpt

    rig, _, _, _ = slice_config(W, H, max_cnt)
    seq = revisit_scene(rig, n_frames)
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    cfg, pg_cfg = vo_config(rig, seq, max_cnt, max_kp)
    kw = dict(eager_outputs=True, failure_check_interval=10 ** 9, fused_steady_state=True,
              pose_graph_config=pg_cfg)

    def feed(pipe, k0, k1):
        out = []
        for k in range(k0, k1):
            pipe.push_image(ts[k], imgs[k])
            pipe.push_depth(ts[k], deps[k])
            o = pipe.spin_once()
            out.append(None if o is None else np.asarray(o["P"], np.float64))
        return out

    with tempfile.TemporaryDirectory(dir=workdir) as d:
        path = os.path.join(d, "pipeline.npz")
        ref = envelope(VinsPipeline(cfg, device, **kw))
        feed(ref, 0, cut)
        ckpt.save_pipeline(ref, path)
        tail_ref = feed(ref, cut, n_frames)
        ref.close()
        res = envelope(ckpt.load_pipeline(cfg, path, device, **kw))
        tail_res = feed(res, cut, n_frames)
        res.close()
    both = [(a, b) for a, b in zip(tail_ref, tail_res) if a is not None and b is not None]
    same_outputs = [a is None for a in tail_ref] == [b is None for b in tail_res]
    return dict(frames=n_frames, cut=cut, outputs=len(both), same_outputs=same_outputs,
                max_dP=max(float(np.abs(a - b).max()) for a, b in both) if both else float("nan"),
                keyframes=(len(ref.pose_graph.keyframes), len(res.pose_graph.keyframes)),
                loops=(len(ref.pose_graph.loops), len(res.pose_graph.loops)))


def check_checkpoint_resume(res) -> None:
    require(res["same_outputs"] and res["outputs"] == res["frames"] - res["cut"],
            ("resumed outputs", res))
    require(res["max_dP"] <= 1e-4, ("resumed trajectory", res))


def td_config(rig, seq, max_cnt: int = 30) -> VinsConfig:
    """The RealSense D435i rig's knobs (the reference's
    ``config/realsense/vio.yaml`` as ``tests/test_config.py:15-27`` reads
    it: grid 5×6, max_cnt 30, min_dist 30, a 20 Hz frontend, static init,
    ``estimate_td`` 1, rolling shutter with tr 0.033) on the latency cell's
    ``rig`` and noise; td starts at 0 and the extrinsic is refined online
    (``estimate_extrinsic`` 1)."""
    return dataclasses.replace(
        latency_config(rig, seq, max_cnt), num_grid_rows=5, num_grid_cols=6,
        frontend_freq=20.0, estimate_td=True, td=0.0, rolling_shutter=True,
        rolling_shutter_tr=0.033, estimate_extrinsic=1)


def calib_config(cfg: VinsConfig, seq, deg: float = 5.0) -> VinsConfig:
    """``cfg`` with the extrinsic rotation calibrated online
    (``estimate_extrinsic`` 2), started from the true ``ric`` turned by
    ``deg`` degrees about (1, 1, 1)."""
    axis = np.ones(3) / np.sqrt(3.0)
    turn = syn._q2R(syn._so3_exp(np.radians(deg) * axis))
    return dataclasses.replace(cfg, estimate_extrinsic=2,
                               ric=tuple((seq.ric @ turn).ravel().tolist()))


def openloris_rig(W: int = 848, H: int = 480):
    """The OpenLORIS rig's camera (848×480 at 30 Hz, the bench's focal
    length and no distortion), scaled to W×H for rehearsals."""
    s = W / 848.0
    return syn.SyntheticRig(width=W, height=H, fx=460.0 * s, fy=460.0 * s, cx=W / 2.0,
                            cy=H / 2.0, frame_rate=30.0)


def openloris_config(rig, seq, max_cnt: int = 130) -> VinsConfig:
    """The OpenLORIS rig's knobs (the reference's
    ``config/openloris/openloris_vio.yaml``, ``SURVEY.md`` §5.6 and §6:
    848×480, grid 7×8, max_cnt 130, a 30 Hz frontend, ``static_init`` 0,
    ``depth_max_dist`` 3) on ``rig`` (``openloris_rig``), min_dist 30 at
    full width, the latency cell's noise."""
    s = min(rig.width / 640.0, 1.0)
    return dataclasses.replace(
        latency_config(rig, seq, max_cnt), static_init=False, frontend_freq=30.0,
        min_dist=max(int(round(30 * s)), 4), depth_max_dist=3.0)


def realsense_scene(n_frames: int, W: int = 640, H: int = 480):
    """Phase 12's rig, stream (the latency cell's, seed 7) and knobs
    (``td_config``) at W×H: (rig, seq, cfg)."""
    rig, _, _, _ = slice_config(W, H, 30)
    seq = syn.make_trajectory(n_frames, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    return rig, seq, td_config(rig, seq)


def openloris_scene(n_frames: int, W: int = 848, H: int = 480):
    """Phase 13's rig, stream and knobs at W×H: (rig, seq, cfg).  The
    stream is ``make_trajectory`` (seed 7, moving from frame 0) with motion
    enough for the excitation check of dynamic initialization (the std of
    the window's accelerations above 0.25 m/s², which the latency cell's
    gentler motion fails)."""
    rig = openloris_rig(W, H)
    seq = syn.make_trajectory(n_frames, rig, seed=7, omega_scale=0.3, acc_scale=2.0)
    return rig, seq, openloris_config(rig, seq)


def angle_deg(R_a, R_b) -> float:
    """The angle of R_aᵀ·R_b in degrees."""
    c = (np.trace(np.asarray(R_a).T @ np.asarray(R_b)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def run_rig_path(device, cfg: VinsConfig, rig, seq, n_frames: int = 112, warmup: int = 16,
                 profile: int = 0, path=None, fused: bool = True,
                 failure_check_interval: int = 10 ** 9, imu_shift: float = 0.0,
                 depthless: int = 0):
    """One stream through ``VinsPipeline`` with a rig's knobs (phases 12,
    12b, 13 and 13b): frames rendered on the device first (the depth of the
    first ``depthless`` zeroed), IMU stamps shifted by ``imu_shift`` (a
    known td), ``warmup`` frames, then the timed ones (CUDA-synchronised
    wall time) with the launch counters zeroed before the warm-up, then
    ``profile`` frames under the profiler.  The envelope, no read-back per
    frame but the failure check every ``failure_check_interval`` frames
    and the td refresh.  Records the frame of initialization, which of
    ``init_dynamic``/``init_mono`` succeeded, and the frame the extrinsic
    calibration ended, if it did."""
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    if depthless:
        deps[:depthless] = 0.0
    pipe = envelope(VinsPipeline(cfg, device, eager_outputs=False,
                                 failure_check_interval=failure_check_interval,
                                 fused_steady_state=fused))
    for (t, a, g) in seq.imu:
        pipe.push_imu(t + imu_shift, a, g)
    e = pipe.estimator
    attempts = []  # (program, ok) of every initialization attempt
    progs = {name: getattr(est, name) for name in ("init_dynamic", "init_mono")}

    def recorded(name):
        def run(*args):
            res = progs[name](*args)
            attempts.append((name, res[2]))
            return res
        return run

    marks = dict(init_frame=None, calib_frame=None, calib_err_deg=None)

    def feed(k0, k1):
        for k in range(k0, k1):
            pipe.push_image(ts[k], imgs[k])
            pipe.push_depth(ts[k], deps[k])
            pipe.spin_once()
            if marks["init_frame"] is None and e.solver_flag == e.NON_LINEAR:
                marks["init_frame"] = k
            if cfg.estimate_extrinsic == 2 and marks["calib_frame"] is None \
                    and not e._ex_calibrating:
                marks["calib_frame"] = k
                marks["calib_err_deg"] = angle_deg(quat_np_R(e.state.x.qic[0]), seq.ric)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    for name in progs:
        setattr(est, name, recorded(name))
    try:
        reset_counts()
        feed(0, warmup)
        flag = e.solver_flag
        sync()
        t0 = time.perf_counter()
        feed(warmup, n_frames)
        sync()
        elapsed = time.perf_counter() - t0
        counts = read_counts()
        tracked = pipe._frame_idx  # the frames the pairer's rate gate let through
        prof = None
        if profile:
            prof = profile_span(lambda: feed(n_frames, n_frames + profile), SPIN_SPAN, profile,
                                path, 1e3 * elapsed / (n_frames - warmup))
    finally:
        for name, fn in progs.items():
            setattr(est, name, fn)
    traj = [r for r in e.trajectory if r["t"] <= ts[n_frames - 1]]
    times, P = [r["t"] for r in traj], [r["P"] for r in traj]
    travelled = float(np.sum(np.linalg.norm(np.diff(seq.P[:n_frames], axis=0), axis=1)))
    # the relative motion from the first output to the last (a dynamic
    # initialization anchors its world at the window's first frame)
    k_first = int(np.argmin(np.abs(seq.times - times[0]))) if traj else 0
    k_last = int(np.argmin(np.abs(seq.times - times[-1]))) if traj else 0
    d_gt = float(np.linalg.norm(seq.P[k_last] - seq.P[k_first]))
    d_est = float(np.linalg.norm(P[-1] - P[0])) if traj else float("nan")
    ric = quat_np_R(e.state.x.qic[0])
    n_timed = n_frames - warmup
    return dict(latency_fps=n_timed / elapsed, latency_ms_per_frame=1e3 * elapsed / n_timed,
                latency_ate_m=(ate_rmse(times, P, seq.times, seq.P, align=False)
                               if len(traj) >= 5 else float("nan")),
                aligned_ate_m=(ate_rmse(times, P, seq.times, seq.P, align=True)
                               if len(traj) >= 5 else float("nan")),
                bound=max(0.05 * travelled, 0.08), d_est=d_est, d_gt=d_gt,
                frames=n_frames, tracked=tracked, timed=n_timed, n_records=len(traj),
                solver_flag_after_warmup=flag, init_frame=marks["init_frame"],
                attempts=[(name, bool(ok[0])) for name, ok in attempts],
                calib_frame=marks["calib_frame"], calib_err_deg=marks["calib_err_deg"],
                calibrating=e._ex_calibrating,
                ric_err_deg=angle_deg(ric, seq.ric), td=float(e.state.x.td[0]),
                td_cache=e._td_cache, counts=counts, profile=prof, timer=pipe.timer.summary())


def quat_np_R(q: torch.Tensor) -> np.ndarray:
    """A (4,) wxyz quaternion tensor -> its rotation matrix (numpy float64)."""
    return syn._q2R(q.detach().cpu().double().numpy())


def check_rig_path(res, dynamic: bool, rel_frac: float = 0.1, rel_min: float = 0.08,
                   init_by: int = 16, on_gpu: bool = True, waits: int = 0) -> None:
    """Phases 12-13b: initialized by frame ``init_by`` - 1 (dynamic: by
    ``init_dynamic`` or its fallback), finite td within 50 ms; static: the
    ATE bound; dynamic: the relative motion from the first output to the
    last within max(``rel_frac``·d, ``rel_min``) of the truth.  On the
    card: K1 once and K3 twice per tracked frame (the rig's frontend rate
    gate drops the stream's second frame), K2 never, and at most ``waits``
    host waits on the frame thread in the profile."""
    require(res["init_frame"] is not None and res["init_frame"] < init_by,
            ("initialized", res["init_frame"], res["attempts"]))
    require(np.isfinite(res["td"]) and abs(res["td"]) < 0.05, ("td", res["td"]))
    if dynamic:
        require(abs(res["d_est"] - res["d_gt"]) < max(rel_frac * res["d_gt"], rel_min),
                ("relative motion", res["d_est"], res["d_gt"]))
    else:
        require(np.isfinite(res["latency_ate_m"]) and res["latency_ate_m"] < res["bound"],
                ("latency ATE", res["latency_ate_m"], res["bound"]))
    if on_gpu:
        n = res["tracked"]
        require(n >= res["frames"] - 1 and res["counts"] == {
            "fast_nms": n, "lk_level": 0, "lk_iterate": 2 * n}, ("launches", res["counts"], n))
        if res["profile"] is not None:
            require(res["profile"]["host_syncs"] <= waits,
                    ("host waits on the frame thread", res["profile"]))


def batched_loop_scene(rig, B: int, n_frames: int, n_revisit: int):
    """bench.py run_batched's scene with BENCH_LOOP=1: sequences b <
    ``n_revisit`` are ``make_revisit_trajectory(seed 200+b, accel 1.5,
    sideways, 2 cycles)`` with ``corrupt_imu(seed 300+b, gyr_noise 0.003,
    gyr_pulse 0.2, pulse over 18-30 %)``, the others ``make_trajectory(seed
    100+b, ω 0.15, a 0.3)``."""
    return [revisit_scene(rig, n_frames, seed=200 + b, imu_seed=300 + b)
            if b < n_revisit else
            syn.make_trajectory(n_frames, rig, seed=100 + b, omega_scale=0.15, acc_scale=0.3)
            for b in range(B)]


def run_batched_loop_path(device, B: int = 8, n_frames: int = 212, seg_len: int = 18,
                          W: int = 640, H: int = 480, max_cnt: int = 130, max_kp: int = 192,
                          k_pad: int = 32, profile: int = 0, path=None,
                          mode: str = "threaded"):
    """bench.py run_batched with BENCH_LOOP=1 on the port: B sequences (half
    of them revisits with a gyro pulse) rendered on the device, the runner's
    warm-up on frames 0-10, an unrecorded run of frames 11-13, then segments
    of ``seg_len`` frames from frame 14; the first is the warm segment
    (``consume`` and the closer's warm-up), the others are timed through
    ``ThreadedLoopCloser`` (``submit`` after each ``run``) up to the end of
    ``drain()`` and a device synchronisation.  The launch counters are
    zeroed just before the timed segments.  With ``profile`` n > 0, the
    first n frames of the last segment run again under the profiler after
    (from the runner state it started from), ``run`` then ``submit``, while
    a second threaded closer (a clone of the first, fresh gates) advances
    the earlier segments submitted to it just before.  ``mode`` exists for the reproducibility
    probe (``batched_loop_repro.py``): "inline" runs the closer's serial
    ``consume`` after each ``run`` on the frame thread, "none" runs no
    closer (no loop metrics)."""
    rig, tcfg, ecfg, cam = slice_config(W, H, max_cnt)
    n_revisit = B // 2
    seqs = batched_loop_scene(rig, B, n_frames, n_revisit)
    rendered = [syn.render_sequence(s, rig, device) for s in seqs]
    ts = [r[0] for r in rendered]
    imgs = [r[1] for r in rendered]
    deps = [r[2] for r in rendered]
    bufs = []
    for s in seqs:
        buf = ImuIntervalBuffer(32)
        for (t, a, g) in s.imu:
            buf.push(t, a, g)
        bufs.append(buf)
    warmup, k_w = 14, bp.WINDOW_SIZE + 1
    n_seg = (n_frames - warmup) // seg_len

    def stage(k0, k1):
        return bp.stage_frames(imgs, deps, ts, bufs, k0, k1, device)

    warm_batch, pre_batch = stage(0, k_w), stage(k_w, warmup)
    batches = [stage(warmup + i * seg_len, warmup + (i + 1) * seg_len) for i in range(n_seg)]
    t_end = warmup + n_seg * seg_len
    del rendered, imgs, deps  # the staged batches hold the frames
    runner = bp.BatchedVioRunner(tcfg, cam, ecfg, device, B)
    trk, st = runner.init_states(np.stack([s.ric for s in seqs]), np.stack([s.tic for s in seqs]))
    pg_cfg = PoseGraphConfig(max_kp=max_kp, max_wp=ecfg.maxf, recency_exclusion=8,
                             score_best=0.08, score_second=0.02, pad_nodes_min=128,
                             pad_edges_min=1024)
    closer = BatchedLoopCloser(cam, seqs[0].ric, seqs[0].tic, B, device, pg_cfg, skip_dis=0.0,
                               k_pad=k_pad, seq_pad=32, db_capacity=128, pgo_period=2.0)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    trk, st, _ = runner.warm(trk, st, warm_batch)
    trk, st, _ = runner.run(trk, st, pre_batch)
    trk, st, outs_w = runner.run(trk, st, batches[0])
    if mode != "none":
        closer.consume(batches[0], outs_w)
    tc = ThreadedLoopCloser(closer) if mode == "threaded" else None
    try:
        if tc is not None:
            tc.compile_warmup(batches[0], outs_w)
        elif mode == "inline":
            closer.compile_warmup(batches[0], outs_w)
        sync()
        kf0, loops0, chunks0 = closer.n_keyframes, closer.n_loops, closer.n_chunks
        reset_counts()
        t0 = time.perf_counter()
        outs_all, stats = [outs_w], []
        for k in range(1, n_seg):
            last_state = (trk, st)  # run returns new states: the profile reruns the last segment
            trk, st, outs = runner.run(trk, st, batches[k])
            if tc is not None:
                tc.submit(batches[k], outs)
            elif mode == "inline":
                stats.append(closer.consume(batches[k], outs))
            outs_all.append(outs)
        sync()  # every segment's frames done
        t_drain = time.perf_counter()
        if tc is not None:
            stats = tc.drain()
        elif mode == "inline":
            closer.pipeline_drain()  # the deferred appends, the last PGO wake-up
            stats = [s for s in stats if s["n_keyframes"]]
        sync()
        t1 = time.perf_counter()
        counts = read_counts()
        chunks = closer.n_chunks - chunks0
    finally:
        if tc is not None:
            tc.close()
    n_timed = (n_seg - 1) * seg_len
    elapsed = t1 - t0
    prof = None
    if profile and tc is not None:
        ghost = closer.clone()
        ghost.gates = [KeyframeGate(closer.skip_cnt, closer.skip_dis) for _ in range(B)]
        busy = ThreadedLoopCloser(ghost)
        try:
            for k in range(1, n_seg - 1):
                busy.submit(batches[k], outs_all[k])

            part = bp.FrameBatch(*(a[:profile] for a in batches[-1]))

            def segment():
                busy.submit(part, runner.run(*last_state, part)[2])

            prof = profile_span(segment, RUN_SPAN, profile, path, 1e3 * elapsed / n_timed)
        finally:
            busy.close()
    cost = torch.stack([o.cost for o in outs_all]).cpu().numpy()
    P_last = outs_all[-1].P.cpu().numpy()
    ates, bounds = [], []
    for b in range(n_revisit, B):
        k0 = warmup + (n_seg - 1) * seg_len
        ates.append(ate_rmse(ts[b][k0:k0 + seg_len], P_last[:, b], seqs[b].times, seqs[b].P,
                             align=False))
        travelled = float(np.sum(np.linalg.norm(np.diff(seqs[b].P[:n_frames], axis=0), axis=1)))
        bounds.append(max(0.05 * travelled, 0.08))
    lates, vlates = [], []
    for b in range(n_revisit):
        g = closer.graphs[b]
        path_c = [p for p in g.path() if p[0] <= ts[b][t_end - 1]]
        kfs = [k for k in g.keyframes if k.t <= ts[b][t_end - 1]]
        if len(path_c) >= 5:
            lates.append(ate_rmse([p[0] for p in path_c], [p[1] for p in path_c],
                                  seqs[b].times, seqs[b].P, align=False))
            vlates.append(ate_rmse([k.t for k in kfs], [k.P_vio for k in kfs], seqs[b].times,
                                   seqs[b].P, align=False))
    stage_ms = {k: sum(s[k] for s in stats) for k in
                ("ms_sync1", "ms_dispatch", "ms_sync2", "ms_vdisp", "ms_accept", "ms_pgo")}
    return dict(B=B, n_timed=n_timed, n_revisit=n_revisit, seq_frames_per_s=B * n_timed / elapsed,
                ms_per_frame=1e3 * elapsed / n_timed, drain_tail_ms=1e3 * (t1 - t_drain),
                loop_kf=closer.n_keyframes - kf0, loops_found=closer.n_loops - loops0,
                loop_ate_m=float(np.mean(lates)) if lates else float("nan"),
                loop_vio_ate_m=float(np.mean(vlates)) if vlates else float("nan"),
                ates=ates, bounds=bounds, ate_m=float(np.mean(ates)), ate_max_m=float(np.max(ates)),
                cost=cost, counts=counts, chunks=chunks, stage_ms=stage_ms,
                segments_with_keyframes=len(stats),
                loops=[[(lp["cur"], lp["old"], lp["n_inliers"]) for lp in g.loops]
                       for g in closer.graphs],
                keyframes=[len(g.keyframes) for g in closer.graphs], profile=prof)


def check_batched_loop_path(res, on_gpu: bool = True) -> None:
    require(np.all(np.isfinite(res["cost"])), "non-finite cost")
    for b, (ate, bound) in enumerate(zip(res["ates"], res["bounds"])):
        require(np.isfinite(ate) and ate < bound, ("clean-sequence ATE", b, ate, bound))
    require(res["loops_found"] >= 1, ("loops found in the timed segments", res["loops"]))
    for k in ("loop_ate_m", "loop_vio_ate_m"):
        require(np.isfinite(res[k]), (k, res[k]))
    require(res["loop_ate_m"] <= res["loop_vio_ate_m"],
            ("loop-corrected keyframe ATE above the VIO one", res["loop_ate_m"],
             res["loop_vio_ate_m"]))
    if on_gpu:  # K1 per frame and per extraction chunk, K2 per level, never K3
        n = res["n_timed"]
        require(res["counts"] == {"fast_nms": n + res["chunks"], "lk_level": 2 * n,
                                  "lk_iterate": 0}, ("batched-loop launches", res["counts"],
                                                     res["chunks"]))
    if res["profile"] is not None:
        require(res["profile"]["host_syncs"] == 0,
                ("no host wait on the frame thread", res["profile"]["host_sync_calls"]))


# ---------------------------------------------------------------------------
# phases 14-14c: real-data formats through the port's run_vio entry point
# ---------------------------------------------------------------------------

# the RealSense D435i bag's topics (colour, the depth aligned to it, the IMU)
REALSENSE_TOPICS = ("/camera/color/image_raw", "/camera/aligned_depth_to_color/image_raw",
                    "/camera/imu")


def rig_yaml(cfg: VinsConfig) -> str:
    """The OpenCV-FileStorage rig file that ``load_config`` reads back as
    ``cfg`` (every field a rig file carries; ``cfg`` keeps the defaults of
    the others: ``focal_length``, ``max_features``, ``max_imu_per_frame``)."""
    def b(v):
        return str(int(bool(v)))

    f = repr
    keys = [("imu", b(cfg.imu)), ("static_init", b(cfg.static_init)),
            ("image_topic", f'"{cfg.image_topic}"'), ("depth_topic", f'"{cfg.depth_topic}"'),
            ("imu_topic", f'"{cfg.imu_topic}"'), ("model_type", cfg.model_type),
            ("image_width", str(cfg.image_width)), ("image_height", str(cfg.image_height)),
            ("depth_min_dist", f(cfg.depth_min_dist)), ("depth_max_dist", f(cfg.depth_max_dist)),
            ("fix_depth", b(cfg.fix_depth)), ("frontend_freq", f(cfg.frontend_freq)),
            ("freq", f(cfg.freq)), ("num_grid_rows", str(cfg.num_grid_rows)),
            ("num_grid_cols", str(cfg.num_grid_cols)), ("max_cnt", str(cfg.max_cnt)),
            ("min_dist", str(cfg.min_dist)), ("F_threshold", f(cfg.f_threshold)),
            ("equalize", b(cfg.equalize)), ("fisheye", b(cfg.fisheye)),
            ("max_num_iterations", str(cfg.max_num_iterations)),
            ("keyframe_parallax", f(cfg.keyframe_parallax)), ("acc_n", f(cfg.acc_n)),
            ("gyr_n", f(cfg.gyr_n)), ("acc_w", f(cfg.acc_w)), ("gyr_w", f(cfg.gyr_w)),
            ("g_norm", f(cfg.g_norm)), ("estimate_extrinsic", str(cfg.estimate_extrinsic)),
            ("estimate_td", b(cfg.estimate_td)), ("td", f(cfg.td)),
            ("rolling_shutter", b(cfg.rolling_shutter)),
            ("rolling_shutter_tr", f(cfg.rolling_shutter_tr)),
            ("fast_threshold", str(cfg.fast_threshold)), ("loop_closure", b(cfg.loop_closure)),
            ("fast_relocalization", b(cfg.fast_relocalization)), ("skip_dis", f(cfg.skip_dis)),
            ("skip_cnt", str(cfg.skip_cnt))]
    if cfg.fisheye_mask:
        keys.append(("fisheye_mask", f'"{cfg.fisheye_mask}"'))
    lines = ["%YAML:1.0", "---"] + [f"{k}: {v}" for k, v in keys]
    fx, fy, cx, cy = cfg.intrinsics
    k1, k2, p1, p2 = cfg.distortion
    lines += ["distortion_parameters:"] + [f"   {k}: {f(v)}" for k, v in
                                           (("k1", k1), ("k2", k2), ("p1", p1), ("p2", p2))]
    lines += ["projection_parameters:"] + [f"   {k}: {f(v)}" for k, v in
                                           (("fx", fx), ("fy", fy), ("cx", cx), ("cy", cy))]
    for name, vals, rows in (("extrinsicRotation", cfg.ric, 3),
                             ("extrinsicTranslation", cfg.tic, 3)):
        lines += [f"{name}: !!opencv-matrix", f"   rows: {rows}",
                  f"   cols: {len(vals) // rows}", "   dt: d",
                  "   data: [" + ", ".join(f(v) for v in vals) + "]"]
    return "\n".join(lines) + "\n"


def quantize_frame(img) -> np.ndarray:
    """A rendered grey frame (float in [0, 255]) as the 8-bit image a camera gives."""
    return np.clip(np.round(np.asarray(img, np.float64)), 0, 255).astype(np.uint8)


def depth_mm(depth) -> np.ndarray:
    """A rendered depth map (metres) as 16UC1 millimetres."""
    return np.clip(np.round(np.asarray(depth, np.float64) * 1000.0), 0, 65535).astype(np.uint16)


def write_realsense_bag(path: str, seq, ts, imgs, deps, imu_shift: float = 0.0,
                        topics=REALSENSE_TOPICS) -> int:
    """Phase 14's bag, written by the port's writers: each frame as raw
    ``bgr8`` (the 8-bit grey level in three channels), its depth as
    ``sensor_msgs/CompressedImage`` "16UC1; compressedDepth png" in
    millimetres on ``<depth topic>/compressedDepth``, the IMU at its stamps
    shifted by ``imu_shift``; time-ordered (a stable sort: at one stamp the
    IMU, then the image, then the depth).  Returns the bag's bytes."""
    from vins_rgbd_fast_torch.io import writers

    img_topic, dep_topic, imu_topic = topics
    msgs = [(imu_topic, "sensor_msgs/Imu", t + imu_shift,
             writers.serialize_imu(t + imu_shift, a, g, j)) for j, (t, a, g) in enumerate(seq.imu)]
    for k, t in enumerate(ts):
        gray = quantize_frame(imgs[k].cpu())
        msgs.append((img_topic, "sensor_msgs/Image", float(t), writers.serialize_image(
            float(t), np.repeat(gray[:, :, None], 3, axis=2), "bgr8", k)))
        msgs.append((dep_topic + "/compressedDepth", "sensor_msgs/CompressedImage", float(t),
                     writers.serialize_compressed_image(float(t), depth_mm(deps[k].cpu()), k,
                                                        depth_transport=True)))
    msgs.sort(key=lambda m: m[2])
    writers.write_rosbag(path, msgs)
    return os.path.getsize(path)


def write_tum_dir(root: str, seq, ts, imgs, deps) -> None:
    """Phase 14b's TUM directory (the port's ``write_tum_sequence``):
    8-bit grey PNGs, 16-bit depth PNGs at 1/5000 m and the ground truth."""
    from vins_rgbd_fast_torch.io import writers

    writers.write_tum_sequence(
        root, ((float(t), quantize_frame(imgs[k].cpu()), deps[k].cpu().numpy())
               for k, t in enumerate(ts)),
        gt=[(float(seq.times[k]), seq.P[k], seq.Q[k]) for k in range(len(ts))])


class BagWindow:
    """The messages of a ``BagReader`` whose stamps lie in [t0, t1): a bag
    replayed in parts (warm-up, timed, profiled) through
    ``replay_into_pipeline``."""

    def __init__(self, bag, t0: float, t1: float):
        self.bag, self.t0, self.t1 = bag, t0, t1

    def topics(self):
        return self.bag.topics()

    def messages(self):
        return (m for m in self.bag.messages() if self.t0 <= m[1] < self.t1)


def run_entry_point(args, timeout: int = 600) -> dict:
    """``python3 -m vins_rgbd_fast_torch.run_vio <args>`` in a child process
    started in this checkout: its exit code, standard error, the odometry
    count and the ATE it printed."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "vins_rgbd_fast_torch.run_vio", *args],
                         cwd=root, capture_output=True, text=True, timeout=timeout)
    n = re.search(r"(\d+) odometry outputs", res.stderr)
    ate = re.search(r"ATE RMSE vs ground truth: ([0-9.naninf]+) m", res.stderr)
    return dict(rc=res.returncode, wall_s=time.perf_counter() - t0, stderr=res.stderr[-4000:],
                n_outputs=int(n.group(1)) if n else None,
                printed_ate_m=float(ate.group(1)) if ate else None)


def read_result_csv(path: str) -> np.ndarray:
    """``vins_result_*.csv`` rows as (t, x, y, z, qw, qx, qy, qz, vx, vy, vz)."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.strip().rstrip(",").split(",")]
            rows.append([vals[0] * 1e-9] + vals[1:])
    return np.asarray(rows).reshape(-1, 11)


def run_bag_path(device, n_frames: int = 64, warmup: int = 16, W: int = 640, H: int = 480,
                 profile: int = 3, workdir: str = OUT_DIR, imu_shift: float = TD_TRUE):
    """Phase 14: phase 12's RealSense scene written to a rosbag
    (``write_realsense_bag``) with its rig file (``rig_yaml`` of phase 12's
    knobs with ``equalize`` 1 and the bag's topics), then (a) ``python3 -m
    vins_rgbd_fast_torch.run_vio --config --bag --output`` in a child
    process and (b) the bag replayed in this process through
    ``replay_into_pipeline`` into a ``VinsPipeline`` with phase 12's
    settings (fused, no read-back but the failure check and td refresh
    every 4th frame, the envelope), in three windows: the warm-up, the
    timed frames (launch counters from the start of the warm-up, ``decode``
    and ``spin_once`` host time) and ``profile`` frames under the profiler.
    The bag and rig file go to ``workdir/replay`` and are deleted after."""
    from vins_rgbd_fast_torch.config import load_config
    from vins_rgbd_fast_torch.io.rosbag import BagReader, replay_into_pipeline

    rig, seq, cfg = realsense_scene(n_frames + profile, W, H)
    img_t, dep_t, imu_t = REALSENSE_TOPICS
    cfg = dataclasses.replace(cfg, equalize=True, image_topic=img_t, depth_topic=dep_t,
                              imu_topic=imu_t)
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    work = os.path.join(workdir, "replay")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bag_path, yaml_path = os.path.join(work, "realsense.bag"), os.path.join(work, "rig.yaml")
    t0 = time.perf_counter()
    bag_bytes = write_realsense_bag(bag_path, seq, ts, imgs, deps, imu_shift=imu_shift)
    write_s = time.perf_counter() - t0
    with open(yaml_path, "w") as f:
        f.write(rig_yaml(cfg))
    require(load_config(yaml_path) == cfg, "the rig file reads back as phase 14's config")
    out_dir = os.path.join(workdir, "run_vio_bag")
    try:
        entry = run_entry_point(["--config", yaml_path, "--bag", bag_path, "--output", out_dir,
                                 "--device", torch.device(device).type])
        csv = (read_result_csv(os.path.join(out_dir, "vins_result_no_loop.csv"))
               if entry["rc"] == 0 else np.zeros((0, 11)))

        pipe = envelope(VinsPipeline(load_config(yaml_path), device, eager_outputs=False,
                                     failure_check_interval=4, fused_steady_state=True))
        spin = pipe.spin_once
        spin_s = [0.0]

        def timed_spin():
            t = time.perf_counter()
            out = spin()
            spin_s[0] += time.perf_counter() - t
            return out

        pipe.spin_once = timed_spin
        bag = BagReader(bag_path)
        edge = [-np.inf] + [(ts[k - 1] + ts[k]) / 2 for k in range(1, len(ts))] + [np.inf]

        def replay(k0, k1):
            replay_into_pipeline(BagWindow(bag, edge[k0], edge[k1]), pipe, cfg.image_topic,
                                 cfg.depth_topic, cfg.imu_topic)

        def sync():
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()

        reset_counts()
        replay(0, warmup)
        flag = pipe.estimator.solver_flag
        sync()
        dec0, spin_s[0], tracked0 = pipe.timer.total["decode"], 0.0, pipe._frame_idx
        t0 = time.perf_counter()
        replay(warmup, n_frames)
        sync()
        elapsed = time.perf_counter() - t0
        counts, tracked = read_counts(), pipe._frame_idx
        n_timed = tracked - tracked0
        decode_ms = 1e3 * (pipe.timer.total["decode"] - dec0) / n_timed
        spin_ms = 1e3 * spin_s[0] / n_timed
        prof = None
        if profile:
            prof = profile_span(lambda: replay(n_frames, n_frames + profile), SPIN_SPAN, profile,
                                os.path.join(workdir, "profile_bag.txt"), 1e3 * elapsed / n_timed)
        pipe.run()
        pipe.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the tracker's stored level-0 image against the raw frame it tracked last
    k_last = int(np.argmin(np.abs(ts - float(pipe.tracker_state.prev_time[0]))))
    raw = torch.as_tensor(quantize_frame(imgs[k_last].cpu()), dtype=torch.float32,
                          device=device)[None]
    level0 = pipe.tracker_state.pyramid[0]
    e = pipe.estimator
    travelled = float(np.sum(np.linalg.norm(np.diff(seq.P[:n_frames], axis=0), axis=1)))
    csv_in = csv[csv[:, 0] <= ts[n_frames - 1] + 1e-6] if len(csv) else csv
    return dict(
        frames=n_frames, warmup=warmup, bag_mb=bag_bytes / 1e6, write_s=write_s, entry=entry,
        csv_rows=len(csv), run_vio_ate_m=(ate_rmse(csv_in[:, 0], csv_in[:, 1:4], seq.times,
                                                   seq.P, align=False)
                                          if len(csv_in) >= 5 else float("nan")),
        bound=max(0.05 * travelled, 0.08), solver_flag_after_warmup=flag, counts=counts,
        tracked=tracked, timed=n_timed, latency_ms_per_frame=1e3 * elapsed / n_timed,
        decode_ms_per_frame=decode_ms, spin_ms_per_frame=spin_ms,
        td=float(e.state.x.td[0]), clahe_changed=not torch.equal(level0, raw),
        clahe_err=float((level0 - image.clahe(raw)).abs().max()), profile=prof,
        timer=pipe.timer.summary())


def check_bag_path(res, on_gpu: bool = True) -> None:
    """Phase 14's checks: run_vio exits 0 with one CSV row per odometry
    output and the ATE bound; the in-process replay initialized in the
    warm-up with td finite within 50 ms, the tracker's level 0 is the
    CLAHE of the raw frame (and not the raw frame); on the card K1 once and
    K3 twice per tracked frame, K2 never, and at most phase 12's two host
    waits (the failure check and the td read) on the frame thread."""
    ent = res["entry"]
    require(ent["rc"] == 0, ("run_vio --bag exit code", ent["rc"], ent["stderr"]))
    require(ent["n_outputs"] is not None and res["csv_rows"] == ent["n_outputs"] > 0,
            ("one CSV row per odometry output", res["csv_rows"], ent["n_outputs"]))
    require(np.isfinite(res["run_vio_ate_m"]) and res["run_vio_ate_m"] < res["bound"],
            ("run_vio bag ATE", res["run_vio_ate_m"], res["bound"]))
    require(res["solver_flag_after_warmup"] == est.VinsEstimator.NON_LINEAR,
            "NON_LINEAR after the warm-up")
    require(np.isfinite(res["td"]) and abs(res["td"]) < 0.05, ("td", res["td"]))
    require(res["clahe_changed"] and res["clahe_err"] <= 1e-3,
            ("CLAHE ran on the tracked frame", res["clahe_changed"], res["clahe_err"]))
    if on_gpu:
        n = res["tracked"]
        require(n >= res["frames"] - 2 and res["counts"] == {
            "fast_nms": n, "lk_level": 0, "lk_iterate": 2 * n}, ("launches", res["counts"], n))
        require(res["profile"]["host_syncs"] <= 2,
                ("host waits on the frame thread", res["profile"]))


def run_tum_path(device, n_frames: int = 64, warmup: int = 16, W: int = 640, H: int = 480,
                 max_cnt: int = 250, inproc_frames: int = 32, profile: int = 2,
                 workdir: str = OUT_DIR):
    """Phase 14b: phase 11's VO rig (``vo_config``: ``imu`` 0, ``loop_closure``
    1) on phase 9's revisit scene at 30 Hz, written as a TUM directory
    (``write_tum_dir``) with its rig file, then (a) ``python3 -m
    vins_rgbd_fast_torch.run_vio --config --tum --output`` in a child
    process and (b) the directory's first ``inproc_frames`` frames in this
    process as run_vio feeds them (``TumSequence.frames``), into a
    ``VinsPipeline`` with phase 11's settings (fused, no read-back, the pose
    graph on the worker): ``warmup`` frames, the rest timed with the launch
    counters zeroed before the first frame and the PNG decode timed apart,
    then ``profile`` more frames under the profiler.  The directory goes to
    ``workdir/replay`` and is deleted after."""
    from vins_rgbd_fast_torch.config import load_config
    from vins_rgbd_fast_torch.io.tum import TumSequence

    rig, _, _, _ = slice_config(W, H, max_cnt)
    rig = dataclasses.replace(rig, frame_rate=30.0)
    seq = revisit_scene(rig, n_frames)
    cfg, pg_cfg = vo_config(rig, seq, max_cnt)
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    work = os.path.join(workdir, "replay")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    root, yaml_path = os.path.join(work, "tum"), os.path.join(work, "rig.yaml")
    t0 = time.perf_counter()
    write_tum_dir(root, seq, ts, imgs, deps)
    write_s = time.perf_counter() - t0
    with open(yaml_path, "w") as f:
        f.write(rig_yaml(cfg))
    require(load_config(yaml_path) == cfg, "the rig file reads back as phase 14b's config")
    out_dir = os.path.join(workdir, "run_vio_tum")
    try:
        entry = run_entry_point(["--config", yaml_path, "--tum", root, "--output", out_dir,
                                 "--device", torch.device(device).type])
        est_rows = (np.loadtxt(os.path.join(out_dir, "stamped_traj_estimate.txt"), ndmin=2)
                    if entry["rc"] == 0 else np.zeros((0, 8)))
        loop_csv = os.path.join(out_dir, "vins_result_loop.csv")
        loop_rows = len(read_result_csv(loop_csv)) if os.path.exists(loop_csv) else 0
        tum = TumSequence(root)
        gt = tum.groundtruth

        pipe = envelope(VinsPipeline(load_config(yaml_path), device, eager_outputs=False,
                                     failure_check_interval=10 ** 9, fused_steady_state=True,
                                     pose_graph_config=pg_cfg))
        frames = tum.frames()
        decode_s = [0.0]

        def feed(n):
            for _ in range(n):
                t = time.perf_counter()
                ti, img, depth = next(frames)
                decode_s[0] += time.perf_counter() - t
                pipe.push_image(ti, img)
                pipe.push_depth(ti, depth)
                pipe.spin_once()

        def sync():
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()

        reset_counts()
        feed(warmup)
        flag = pipe.estimator.solver_flag
        pipe.drain()
        sync()
        decode_s[0] = 0.0
        t0 = time.perf_counter()
        feed(inproc_frames - warmup)
        pipe.drain()
        sync()
        elapsed = time.perf_counter() - t0
        counts, tracked = read_counts(), pipe._frame_idx
        n_timed = inproc_frames - warmup
        decode_ms = 1e3 * decode_s[0] / n_timed
        prof = None
        if profile:
            prof = profile_span(lambda: feed(profile), SPIN_SPAN, profile,
                                os.path.join(workdir, "profile_tum.txt"), 1e3 * elapsed / n_timed)
        pipe.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    travelled = float(np.sum(np.linalg.norm(np.diff(seq.P[:n_frames], axis=0), axis=1)))
    return dict(
        frames=n_frames, inproc_frames=inproc_frames, warmup=warmup, write_s=write_s,
        entry=entry, est_rows=len(est_rows),
        file_ate_m=(ate_rmse(est_rows[:, 0], est_rows[:, 1:4], gt[:, 0], gt[:, 1:4])
                    if len(est_rows) >= 5 else float("nan")),
        loop_rows=loop_rows, bound=max(0.05 * travelled, 0.08),
        solver_flag_after_warmup=flag, counts=counts, tracked=tracked, timed=n_timed,
        latency_ms_per_frame=1e3 * elapsed / n_timed, decode_ms_per_frame=decode_ms,
        profile=prof, timer=pipe.timer.summary())


def check_tum_path(res, on_gpu: bool = True) -> None:
    """Phase 14b's checks: run_vio exits 0; the ATE it printed and the one
    recomputed from ``stamped_traj_estimate.txt`` (both aligned, as run_vio
    prints it) under the bound; ``vins_result_loop.csv`` has a row or more;
    the in-process run initialized in the warm-up; on the card K3 four
    times per frame, K1 at least once per frame (and once per keyframe the
    worker extracts), K2 never, no host wait on the frame thread."""
    ent = res["entry"]
    require(ent["rc"] == 0, ("run_vio --tum exit code", ent["rc"], ent["stderr"]))
    for k, v in (("printed", ent["printed_ate_m"]), ("from the file", res["file_ate_m"])):
        require(v is not None and np.isfinite(v) and v < res["bound"],
                (f"run_vio TUM ATE {k}", v, res["bound"]))
    require(res["loop_rows"] >= 1, ("vins_result_loop.csv rows", res["loop_rows"]))
    require(res["solver_flag_after_warmup"] == est.VinsEstimator.NON_LINEAR,
            "NON_LINEAR after the warm-up")
    if on_gpu:
        n = res["tracked"]
        c = res["counts"]
        require(n == res["inproc_frames"] and c["lk_iterate"] == 4 * n and c["lk_level"] == 0
                and c["fast_nms"] >= n, ("launches", c, n))
        require(res["profile"]["host_syncs"] == 0,
                ("host waits on the frame thread", res["profile"]))


def run_fisheye(device, n_frames: int = 8, W: int = 640, H: int = 480, max_cnt: int = 130,
                workdir: str = OUT_DIR):
    """Phase 14c: the latency tracker (B = 1, K1, K3) over ``n_frames``
    rendered frames of the latency stream with ``fisheye`` on, once with
    the analytic circle and once with a mask file (``write_png``: a
    non-circular field of view, a diamond cut by a bar); after every frame
    the mask is read on the device at each live point's rounded position.
    Returns per mask the live points per frame and how many lay outside."""
    from vins_rgbd_fast_torch.io.writers import write_png

    rig, tcfg, _, cam = slice_config(W, H, max_cnt)
    seq = syn.make_trajectory(n_frames, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    ts, imgs, _ = syn.render_sequence(seq, rig, device)
    yy, xx = np.mgrid[0:H, 0:W]
    hole = ((np.abs(xx - W / 2) / W + np.abs(yy - H / 2) / H < 0.45)
            & ~((yy > 0.45 * H) & (yy < 0.55 * H) & (xx > 0.5 * W)))
    os.makedirs(workdir, exist_ok=True)
    mask_path = os.path.join(workdir, "fisheye_mask.png")
    write_png(mask_path, np.where(hole, 255, 0).astype(np.uint8))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {}
    for name, path in (("circle", ""), ("file", mask_path)):
        cfg = dataclasses.replace(tcfg, fisheye=True, fisheye_mask_path=path,
                                  fisheye_radius_frac=0.45)
        mask = ft.fisheye_mask(cfg, device)
        st = ft.init_state(cfg, 1, device)
        eye = torch.eye(3, device=device)[None]
        live, outside = [], 0
        for k in range(n_frames):
            u = torch.rand((1, cfg.ransac_trials, cfg.maxc), generator=gen, device=device)
            st, _ = ft.track_frame(cfg, cam, st, imgs[k:k + 1].contiguous(),
                                   torch.tensor([float(ts[k])], device=device), eye, u)
            ok = st.ids[0] >= 0
            px = torch.clamp(torch.round(st.pts[0, :, 0]).long(), 0, W - 1)
            py = torch.clamp(torch.round(st.pts[0, :, 1]).long(), 0, H - 1)
            outside += int((ok & ~mask[py, px]).sum())
            live.append(int(ok.sum()))
        out[name] = dict(live=live, outside=outside, fov_share=float(mask.float().mean()))
    return out


def check_fisheye(res) -> None:
    for name, r in res.items():
        require(r["outside"] == 0, (f"points outside the {name} mask", r))
        require(min(r["live"][1:]) >= 20, (f"points tracked inside the {name} mask", r))


def encode_png_rows(img: np.ndarray, filt: int) -> bytes:
    """An 8-bit grey or RGB (or 16-bit grey) PNG whose every row uses PNG
    filter type ``filt`` (0-4), or the types 0-4 in turn when ``filt`` is
    -1: test data for a decoder (the port's writers use type 0 only)."""
    import struct
    import zlib

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype == np.uint16:
        rows = img.astype(">u2").view(np.uint8).reshape(h, -1).astype(np.int32)
        depth, bpp = 16, 2 * ch
    else:
        rows = img.astype(np.uint8).reshape(h, -1).astype(np.int32)
        depth, bpp = 8, ch
    out = []
    prev = np.zeros_like(rows[0])
    for y in range(h):
        cur = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = (y % 5) if filt < 0 else filt
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                               0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out), 6)) + chunk(b"IEND", b""))


def png_decode_ms(decode=None, H: int = 480, W: int = 640, filt: int = 4, reps: int = 5) -> dict:
    """Host ms to decode one H×W RGB PNG of ``filt`` rows (Paeth by
    default; the median of ``reps``), by ``decode`` (bytes -> array; the
    port's ``decode_png`` by default)."""
    from vins_rgbd_fast_torch.io.images import decode_png

    decode = decode or decode_png
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([(127 + 100 * np.sin(xx / (17.0 + 5 * c)) * np.cos(yy / 23.0)
                     + rng.normal(0, 6, (H, W))) for c in range(3)], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    data = encode_png_rows(img, filt)
    require(np.array_equal(decode(data), img), "the PNG decodes to its image")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        decode(data)
        times.append(1e3 * (time.perf_counter() - t0))
    return dict(ms=statistics.median(times), bytes=len(data), shape=(H, W, 3), filter=filt)


def jsonable(res) -> dict:
    """A loop-path result without its pose graph and scene."""
    return {k: v for k, v in res.items() if k not in ("graph", "scene")}


def require(ok, what) -> None:
    """A check of this script's results (raises even under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class CudaTimer:
    def start(self):
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e1 = torch.cuda.Event(enable_timing=True)
        self.e0.record()

    def stop(self) -> float:
        self.e1.record()
        self.e1.synchronize()
        return self.e0.elapsed_time(self.e1)


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median ms of one call between a pair of CUDA events recorded on an
    idle stream: host and device time together (the plain versions, whose
    many small launches are host-bound)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        tm = CudaTimer()
        tm.start()
        fn()
        times.append(tm.stop())
    return statistics.median(times)


class LaunchTimer:
    """Device ms per launch and host µs per call of a kernel's wrapper.

    ``reps`` calls go between one pair of CUDA events, queued behind a
    spin kernel (``torch.cuda._sleep``) that lasts longer than the host
    takes to enqueue them, so the device runs them back to back and the
    events bracket device work alone; if no spin outlasted the enqueue, it
    raises rather than return a time with host time in it.  A host clock
    around the same calls, before any synchronisation, gives the wrapper's
    cost per call.  The inputs stay the same across calls (they stay in the
    50 MB L2, as on the path, where the previous kernel has just touched
    them)."""

    def __init__(self, reps: int = 100, warmup: int = 5):
        self.reps, self.warmup = reps, warmup
        cycles = 10 ** 7
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)  # first call loads the spin kernel
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        e1.synchronize()
        self.cycles_per_ms = cycles / e0.elapsed_time(e1)

    def __call__(self, fn) -> dict:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(self.warmup):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0) / self.warmup
        torch.cuda.synchronize()
        # the spin must outlast the enqueue of all reps: 3× the warm-up's
        # host time per call, doubled until the queue was ahead throughout
        for margin in (3, 6, 12, 24):
            es, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            es.record()
            torch.cuda._sleep(int(self.cycles_per_ms * max(margin * self.reps * host_ms, 1.0)))
            e0.record()
            t0 = time.perf_counter()
            for _ in range(self.reps):
                fn()
            host_s = time.perf_counter() - t0
            e1.record()
            e1.synchronize()
            if 1e3 * host_s < es.elapsed_time(e0):
                return dict(device_ms=e0.elapsed_time(e1) / self.reps,
                            host_us=1e6 * host_s / self.reps, reps=self.reps)
        raise RuntimeError(f"LaunchTimer: the host took {1e3 * host_s:.3f} ms to enqueue "
                           f"{self.reps} calls, longer than every spin; no device time")


def k3_vo_inputs(prev_img, cur_img, thr: float, N: int, levels: int = 4):
    """Cold tracks between two frames at the VO path's shapes: the N
    strongest FAST corners of prev (a stable descending sort, the keyframe
    extraction's order), started at their own positions, on ``levels``
    pyramid levels (4: the TUM rig's cold LK)."""
    score = fast.nms3(fast.fast_score(prev_img, thr))
    vals, idx = torch.sort(score.reshape(score.shape[0], -1), dim=1, descending=True,
                           stable=True)
    vals, idx = vals[:, :N], idx[:, :N]
    W = prev_img.shape[-1]
    pts = torch.stack([idx % W, idx // W], dim=-1).to(prev_img.dtype).contiguous()
    return (image.build_pyramid(prev_img, levels), image.build_pyramid(cur_img, levels),
            pts, pts.clone(), (vals > 0).contiguous())


def k2_inputs(prev_img, cur_img, tcfg, N: int, gen):
    """Tracks between two frames at the slice's shapes: the N strongest
    FAST corners of prev, warm-started with a noisy flow (a few are pushed
    towards the border or far off, where window clamping matters)."""
    score = fast.nms3(fast.fast_score(prev_img, tcfg.fast_threshold))
    xy, resp = fast.grid_topk(score, tcfg.grid_rows, tcfg.grid_cols, tcfg.cand_per_grid)
    order = torch.argsort(-resp, dim=1, stable=True)[:, :N]
    pts = torch.gather(xy, 1, order[..., None].expand(-1, -1, 2)).contiguous()
    active = (torch.gather(resp, 1, order) > 0).contiguous()
    noise = torch.randn(pts.shape, generator=gen, device=pts.device) * 1.5
    far = torch.rand(pts.shape[:2], generator=gen, device=pts.device) < 0.03
    noise = torch.where(far[..., None], noise * 10.0, noise)
    init = pts + noise
    init[:, :4, 0] = 2.0  # near the left border
    return (image.build_pyramid(prev_img, 2), image.build_pyramid(cur_img, 2),
            pts, init, active)


LK = dict(win=21, sm=8, eps=0.01, min_eig=1e-4)


def parity(label, st_k, st_p, u_k, u_p, err_k, err_p) -> dict:
    """Status agreement, and the largest |du| and |derr| where both say ok
    (the K2/K3 bounds: ≥ 99.5 %, 1e-3), with the points that miss them."""
    both = st_k & st_p
    du = torch.where(both[..., None], (u_k - u_p).abs(), torch.zeros_like(u_k)).amax()
    de = torch.where(both, (err_k - err_p).abs(), torch.zeros_like(err_k)).amax()
    bad = torch.nonzero((st_k != st_p) | (both & (((u_k - u_p).abs().amax(-1) > 1e-3)
                                                  | ((err_k - err_p).abs() > 1e-3))))
    return dict(label, agree=(st_k == st_p).float().mean().item(), max_du=du.item(),
                max_derr=de.item(), n_ok=int(both.sum()), mismatches=[
                    dict(b=int(b), n=int(n), st_k=bool(st_k[b, n]), st_p=bool(st_p[b, n]),
                         u_k=u_k[b, n].tolist(), u_p=u_p[b, n].tolist(),
                         err_k=float(err_k[b, n]), err_p=float(err_p[b, n]))
                    for b, n in bad.tolist()])


def level_inputs(prev_pyr, cur_pyr, pts, flow, l: int):
    pts_l = (pts / 2.0 ** l).contiguous()
    prev, cur = prev_pyr[l], cur_pyr[l]
    H, W = prev.shape[-2:]
    ax, ay = lk.window_anchor(pts_l, flow, H, W, LK["win"], LK["sm"])
    return prev, cur, pts_l, flow.contiguous(), ax, ay


def compare_k2(prev_pyr, cur_pyr, pts, init, active, tcfg):
    """Both levels, kernel and plain version on identical inputs."""
    win, sm, eps, min_eig = LK["win"], LK["sm"], LK["eps"], LK["min_eig"]
    report = []
    flow = (init - pts) / 2.0
    for l in (1, 0):
        iters = tcfg.lk_max_iters if l == 0 else tcfg.lk_coarse_iters
        prev, cur, pts_l, flow, ax, ay = level_inputs(prev_pyr, cur_pyr, pts, flow, l)
        H, W = prev.shape[-2:]
        # the wrapper (CUDA tensors: the kernel) against the plain version
        u_k, st_k, err_k = lk.lk_level(prev, cur, pts_l, flow, active, win, iters, eps,
                                       min_eig, check_border=(l == 0), search_margin=sm)
        u_p, ok_p, err_p = lk.lk_level_plain(prev, cur, pts_l, flow, active, ax, ay, win,
                                             sm, iters, eps, min_eig)
        st_p = lk.level_status(pts_l, u_p, ok_p, active, ax, ay, H, W, win, sm, l == 0)
        report.append(parity(dict(level=l, iters=iters), st_k, st_p, u_k, u_p, err_k, err_p))
        flow = 2.0 * u_p
    return report


def k3_args(prev_pyr, cur_pyr, pts, flow, active, l: int, iters: int):
    """K3's inputs at level l (``level_patches`` on the tracks), with what
    ``level_status`` needs."""
    prev, cur, pts_l, flow, ax, ay = level_inputs(prev_pyr, cur_pyr, pts, flow, l)
    p = lk.level_patches(prev, cur, pts_l, ax, ay, LK["win"], LK["sm"], LK["min_eig"])
    args = (p.tmpl, p.Ix, p.Iy, p.win_img, p.px, p.py, flow, ~(active & p.ok_eig), p.inv_det,
            p.Gxx, p.Gxy, p.Gyy, iters, LK["eps"])
    H, W = prev.shape[-2:]
    return args, (pts_l, p.ok_eig, active, ax, ay, H, W, LK["win"], LK["sm"], l == 0)


def compare_k3(prev_pyr, cur_pyr, pts, init, active, tcfg):
    """Every level of the pyramids, coarse to fine, K3 and
    ``lk_iterate_plain`` on identical inputs, then the K3 route of
    ``pyramidal_lk`` against its K2 route."""
    report = []
    levels = len(prev_pyr)
    flow = (init - pts) / 2.0 ** (levels - 1)
    for l in range(levels - 1, -1, -1):
        iters = tcfg.lk_max_iters if l == 0 else tcfg.lk_coarse_iters
        args, st_args = k3_args(prev_pyr, cur_pyr, pts, flow, active, l, iters)
        u_k, err_k = lk.lk_iterate(*args)  # CUDA tensors: the kernel
        u_p, err_p = lk.lk_iterate_plain(*args)
        st_k = lk.level_status(st_args[0], u_k, *st_args[1:])
        st_p = lk.level_status(st_args[0], u_p, *st_args[1:])
        report.append(parity(dict(level=l, iters=iters), st_k, st_p, u_k, u_p, err_k, err_p))
        flow = 2.0 * u_p
    routes = {eng: lk.pyramidal_lk(prev_pyr, cur_pyr, pts, init, active,
                                   max_iters=tcfg.lk_max_iters,
                                   coarse_iters=tcfg.lk_coarse_iters, engine=eng)
              for eng in ("pallas", "pallas3")}
    k3, k2 = routes["pallas"], routes["pallas3"]
    report.append(parity(dict(level="pyramidal_lk K3 route vs K2 route"), k3.status,
                         k2.status, k3.pts - pts, k2.pts - pts, k3.err, k2.err))
    return report


def check_parity(name: str, rep) -> float:
    """Print mismatches and one line; require the bounds; returns the
    largest error."""
    for r in rep:
        for m in r["mismatches"]:
            print(f"  {name} mismatch level {r['level']}: {m}", flush=True)
    for r in rep:
        require(r["agree"] >= 0.995, (name, r))
        require(r["max_du"] <= 1e-3 and r["max_derr"] <= 1e-3, (name, r))
    return max(max(r["max_du"], r["max_derr"]) for r in rep)


def summary(rep) -> str:
    return "; ".join(
        f"level {r['level']}" + (f" ({r['iters']} it)" if "iters" in r else "")
        + f": status agree {100 * r['agree']:.2f}%, {r['n_ok']} ok, "
        f"max|du| {r['max_du']:.2e}, max|derr| {r['max_derr']:.2e}" for r in rep)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def stage_breakdown(res, batch):
    """Host wall time of the three stages of a steady frame, each ended by
    a device synchronisation (so each includes its own device drain); the
    runner state advances through ``batch``."""
    runner = res["runner"]
    trk, st = res["state"]
    t = {"gyro+tracker": 0.0, "depth lookup": 0.0, "vio_step": 0.0}
    for k in range(batch.ts.shape[0]):
        imu = est.ImuInterval(batch.imu_dts[k], batch.imu_acc[k], batch.imu_gyr[k])
        u = runner.ransac_uniforms()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        relR = bp.gyro_relative_R(imu.dts, imu.gyr, st.x.Bg[:, bp.WINDOW_SIZE], st.x.qic)
        trk, tout = ft.track_frame(runner.tcfg, runner.cam, trk, batch.imgs[k],
                                      batch.ts[k], relR, u)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        feats = tout.features
        feats = feats._replace(depth=ft.lookup_depth(batch.depths[k], feats.uv,
                                                         feats.ids >= 0))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        st, _ = est.vio_step(runner.ecfg, st, feats, imu)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        t["gyro+tracker"] += t1 - t0
        t["depth lookup"] += t2 - t1
        t["vio_step"] += t3 - t2
    res["state"] = (trk, st)
    n = batch.ts.shape[0]
    return {k: round(v * 1e3 / n, 3) for k, v in t.items()}


def profile_frames(res, path: str, step_ms: float):
    """torch.profiler over the extra steady frames of the batched run."""
    trk, st = res["state"]
    batch = res["extra_batch"][1]
    return profile_span(lambda: res["runner"].run(trk, st, batch), RUN_SPAN,
                        int(batch.ts.shape[0]), path, step_ms)


def host_waits(prof, name: str):
    """Host waits (``HOST_SYNC_CALLS``) that start and end inside the span
    ``name``, on the span's own OS thread and on others (a worker thread
    may wait; the frame thread may not), with the names of the former.
    Read from the exported trace, whose events carry the OS thread id of
    their caller (the profiler's event list gives CUDA runtime calls no
    usable thread)."""
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("name") == name and e.get("cat") == "user_annotation")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    waits = [e for e in events if e.get("cat") == "cuda_runtime"
             and e.get("name") in HOST_SYNC_CALLS and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1]
    own = [e["name"] for e in waits if e.get("tid") == span.get("tid")]
    return own, len(waits) - len(own)


def profile_span(fn, name: str, frames: int, path: str, step_ms: float):
    """torch.profiler over ``fn`` (``frames`` frames) inside a span
    ``name``: host waits inside the span (``host_waits``), kernel launches
    and device kernel time per frame, the device's busy share against the
    unprofiled step time, and the heaviest kernels (table in ``path``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(name):
            fn()
        torch.cuda.synchronize()
    own, other_syncs = host_waits(prof, name)
    events = prof.key_averages()
    # the span also shows as a device-side annotation; it is not a kernel
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key != name]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=50))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    dev_ms = dev_us / 1e3 / frames
    # the port's kernels by name (demangled "(anonymous namespace)::<name>_kernel(...)")
    ours = {}
    for k in KERNELS:
        hits = [e for e in kernels if re.search(rf"(^|\W){k}_kernel(\W|$)", e.key)]
        us = sum(e.self_device_time_total for e in hits)
        n = sum(e.count for e in hits)
        ours[k] = dict(device_ms_per_frame=us / 1e3 / frames, launches_per_frame=n / frames,
                       device_ms_per_launch=us / 1e3 / n if n else "not launched")
    return dict(frames=frames, kernels_per_frame=n_kernels / frames, host_syncs=len(own),
                host_sync_calls=sorted(set(own)), other_thread_syncs=other_syncs,
                device_ms_per_frame=round(dev_ms, 3),
                busy_share=round(dev_ms / step_ms, 4) if dev_ms > 0 else "not measured",
                top_ms_per_frame=[(e.key[:50], round(e.self_device_time_total / 1e3 / frames, 3))
                                  for e in top], by_kernel=ours)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_run = time.perf_counter()
    phase_s = {}

    def done(phase):  # wall seconds of each phase: the script's time budget
        phase_s[phase] = round(time.perf_counter() - t_run - sum(phase_s.values()), 1)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "TF32 is off")
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = nvidia_smi_line()
    print(f"[1 card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    path = native.build(verbose=True)
    native.lib()
    build_s = time.perf_counter() - t0
    with open(path + ".log") as f:
        usage = ptxas_usage(f.read())
    require(set(usage) == set(KERNELS), ("ptxas report", usage))
    require(all(u["spill_bytes"] == 0 for u in usage.values()), ("spills", usage))
    nw = lk.K3_WARPS
    print(f"[2 build] {build_s:.2f} s ({path}); ptxas {usage}; K3 {nw} warps per point, "
          f"{4 * (38 * 53 + 4 * nw)} B dynamic shared memory at WIN = 38", flush=True)

    B, N, T, EXTRA = 8, 200, 40, 10
    rig, tcfg, ecfg, cam = slice_config()
    tcfg_run = bp.BatchedVioRunner(tcfg, cam, ecfg, dev, 1).tcfg  # LK 12/6 envelope
    seqs, rendered, _ = make_sequences(rig, B, 4, dev)
    frame0 = torch.stack([r[1][0] for r in rendered]).contiguous()
    frame1 = torch.stack([r[1][1] for r in rendered]).contiguous()
    KP = 32  # the batched closer's extraction chunk (k_pad)
    chunk32 = torch.stack([r[1][k] for k in range(4) for r in rendered]).contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    done("1-2")

    # 3. K1 bit-exactness at both path shapes (noise defeats the pre-test)
    noise = torch.rand((B, 480, 640), generator=gen, device=dev) * 255.0
    k1_err, corners = 0.0, {}
    for name, imgs in (("rendered", frame0), ("noise", noise), ("rendered", chunk32)):
        for b in ((B, 1) if imgs.shape[0] == B else (KP,)):
            x = imgs[:b].contiguous()
            out_k = fast.fast_nms(x, tcfg.fast_threshold)
            out_p = fast.nms3(fast.fast_score(x, tcfg.fast_threshold))
            torch.cuda.synchronize()
            k1_err = max(k1_err, float((out_k - out_p).abs().max()))
            require(torch.equal(out_k, out_p), f"K1 bit-exact on {b} {name} images")
            corners[f"{b}x {name}"] = int((out_k > 0).sum())
    # the scalar staging and stores: a width that is not a multiple of 4, and
    # rows that do not start on 16 bytes (an image one float into its storage)
    shifted = torch.empty(480 * 640 + 1, device=dev)[1:].view(1, 480, 640)
    shifted.copy_(frame0[:1])
    for name, x in (("1x480x638", frame0[:1, :, :638].contiguous()),
                    ("1x480x640 unaligned", shifted)):
        out_k = fast.fast_nms(x, tcfg.fast_threshold)
        out_p = fast.nms3(fast.fast_score(x, tcfg.fast_threshold))
        k1_err = max(k1_err, float((out_k - out_p).abs().max()))
        require(torch.equal(out_k, out_p), f"K1 bit-exact on {name}")
        corners[name] = int((out_k > 0).sum())
    print(f"[3 K1] bit-exact on {B} and 1 rendered and noise images of 480x640, on {KP} "
          f"rendered (the extraction chunk), and on 1x480x638 and an unaligned 1x480x640 "
          f"(scalar path); corners {corners}",
          flush=True)

    done("3")

    # 4. K2 vs plain at the slice's shapes
    k2_in = k2_inputs(frame0, frame1, tcfg_run, N, gen)
    rep = compare_k2(*k2_in, tcfg_run)
    print("[4 K2] " + summary(rep), flush=True)
    k2_err = check_parity("K2", rep)

    done("4")

    # 4b. K3 vs plain at the latency shape (B = 1) and the batched one
    k3_in = {1: tuple(([x[:1].contiguous() for x in a] if isinstance(a, list)
                       else a[:1].contiguous()) for a in k2_in), B: k2_in}
    rep3 = {b: compare_k3(*k3_in[b], tcfg_run) for b in k3_in}
    for b, r in rep3.items():
        print(f"[4b K3] B={b}: " + summary(r), flush=True)
    # ... and at the VO path's shapes: 1 x 376 cold tracks on 4 levels
    NV = 376
    k3_vo = k3_vo_inputs(frame0[:1].contiguous(), frame1[:1].contiguous(), tcfg.fast_threshold,
                         NV)
    rep3["vo"] = compare_k3(*k3_vo, tcfg_run)
    print(f"[4b K3] VO 1x{NV}, {len(k3_vo[0])} levels, cold: " + summary(rep3["vo"]), flush=True)
    k3_err = max(check_parity("K3", r) for r in rep3.values())

    done("4b")

    # 4c. the OpenLORIS rig's shapes: K1 at 1x480x848 (its last 64-wide
    # output tile 16 wide) and K3 on levels 1 and 0 of an 848x480 pyramid
    rig_o, seq_o, _ = openloris_scene(2)
    _, frames_o, _ = syn.render_sequence(seq_o, rig_o, dev)
    f0_o, f1_o = frames_o[:1].contiguous(), frames_o[1:2].contiguous()
    out_k = fast.fast_nms(f0_o, tcfg.fast_threshold)
    out_p = fast.nms3(fast.fast_score(f0_o, tcfg.fast_threshold))
    k1_err = max(k1_err, float((out_k - out_p).abs().max()))
    require(torch.equal(out_k, out_p), "K1 bit-exact on 1x480x848")
    tcfg_o = dataclasses.replace(tcfg_run, width=848, height=480)
    k3_o = k2_inputs(f0_o, f1_o, tcfg_o, N, gen)
    rep3["openloris"] = compare_k3(*k3_o, tcfg_o)
    k3_err = max(k3_err, check_parity("K3", rep3["openloris"]))
    print(f"[4c 848x480] K1 bit-exact on 1x480x848 ({int((out_k > 0).sum())} corners); K3 "
          f"1x{N}: " + summary(rep3["openloris"]), flush=True)

    done("4c")

    # 5. the main path
    res = run_main_path(dev, B, T, extra=EXTRA, timer=CudaTimer())
    check_main_path(res, B, T)
    run_s = res["run_ms"] / 1e3
    print(f"[5 main] B={B} 640x480, warm 11 + {T} steady frames: "
          f"{T / run_s:.2f} steps/s = {B * T / run_s:.2f} sequence-frames/s "
          f"({res['run_ms'] / T:.2f} ms/step, CUDA events); launches {res['counts']}; "
          f"ATE m {[round(a, 4) for a in res['ates']]} (bounds "
          f"{[round(b, 3) for b in res['bounds']]}); features/seq "
          f"{res['n_features'][-1].tolist()}", flush=True)

    done("5")

    # 6. timings and profile
    timer = LaunchTimer()
    timings = []

    def timing(kernel, shape, fn, plain, bound, phase=None):
        t = dict(kernel=kernel, shape=shape, **timer(fn), plain_ms=median_ms(plain), **bound)
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        timings.append(t)
        phase = phase or (6 if kernel != "lk_iterate" else 8)
        print(f"[{phase} timing] {kernel} {shape}: "
              f"{t['device_ms']:.5f} ms per launch on the device ({t['reps']} per event "
              f"pair), wrapper {t['host_us']:.1f} us per call on the host; bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {t['bytes'] / 1e6:.3f} MB, "
              f"{t['ops'] / 1e6:.1f} M ops), {100 * t['share_of_bound']:.1f} % of it; plain "
              f"{t['plain_ms']:.4f} ms per call (no yardstick)", flush=True)

    thr = tcfg.fast_threshold
    for b, name, imgs in ((B, "rendered", frame0), (B, "noise", noise),
                          (1, "rendered", frame0[:1].contiguous()), (KP, "rendered", chunk32)):
        timing("fast_nms", f"{b}x480x640 {name}", lambda: fast.fast_nms(imgs, thr),
               lambda: fast.nms3(fast.fast_score(imgs, thr)),
               kernel_bounds(b, 480, 640, N, 0, pairs=fast_pairs(imgs, thr))["fast_nms"])
    # the batched closer's extraction of one 32-image chunk (K1 once, the
    # stable top-k, BRIEF per real keyframe): its launches, with 1 and with
    # 32 real keyframes
    deps32 = torch.stack([r[2][k] for k in range(4) for r in rendered]).contiguous()
    pg = PoseGraphConfig(max_kp=192, max_wp=ecfg.maxf)
    uv32 = (torch.rand((KP, ecfg.maxf, 2), generator=gen, device=dev)
            * torch.tensor([639.0, 479.0], device=dev))
    ok32 = torch.ones((KP, ecfg.maxf), dtype=torch.bool, device=dev)
    ext = {n: profile_span(lambda: extract_kf_device(pg, cam, chunk32, uv32, ok32, deps32,
                                                     n_real=n),
                           "chip_smoke::extract", 1,
                           os.path.join(OUT_DIR, f"profile_extract_{n}.txt"), 1.0)
           for n in (1, KP)}
    brief_per_kf = (ext[KP]["kernels_per_frame"] - ext[1]["kernels_per_frame"]) / (KP - 1)
    print(f"[6 extraction] one chunk of {KP} images: {ext[1]['kernels_per_frame']:.0f} "
          f"launches with 1 real keyframe, {ext[KP]['kernels_per_frame']:.0f} with {KP} "
          f"({brief_per_kf:.1f} per keyframe for BRIEF); device ms "
          f"{ext[1]['device_ms_per_frame']} / {ext[KP]['device_ms_per_frame']}", flush=True)
    prev_pyr, cur_pyr, pts, init, active = k2_in
    for l in (1, 0):
        iters = tcfg_run.lk_max_iters if l == 0 else tcfg_run.lk_coarse_iters
        prev, cur, pts_l, flow, ax, ay = level_inputs(prev_pyr, cur_pyr, pts,
                                                      (init - pts) / 2.0, l)
        args = (prev, cur, pts_l, flow, active, ax, ay, LK["win"], LK["sm"], iters,
                LK["eps"], LK["min_eig"])
        steps = gn_steps(lambda k: lk.lk_level_plain(*args[:9], k, *args[10:])[0], iters)
        timing("lk_level", f"{B}x{N} level {l}", lambda: lk._lk_level_cuda(*args),
               lambda: lk.lk_level_plain(*args),
               kernel_bounds(B, *prev.shape[-2:], N, iters, footprint=k2_footprint(
                   prev, pts_l, ax, ay), steps=sum(steps))["lk_level"])
        timings[-1]["points_by_step"] = steps
    stages = stage_breakdown(res, res["extra_batch"][0])
    print(f"[6 stages] ms per steady frame, synchronised per stage: {stages}", flush=True)
    prof = profile_frames(res, os.path.join(OUT_DIR, "profile_steady.txt"), res["run_ms"] / T)
    print(f"[6 profile] {prof}", flush=True)
    require(prof["host_syncs"] == 0, "no host synchronisation inside run()")

    done("6")

    # 7. the latency path (its own launch counts, zeroed just before it), at a
    # depth of 16 + 48 frames and 3 profiled (each profiled frame's trace
    # takes seconds to export and read): the script's time goes to the later
    # phases
    lat = run_latency_path(dev, n_frames=64, profile=3,
                           path=os.path.join(OUT_DIR, "profile_latency.txt"))
    check_latency_path(lat)
    print(f"[7 latency] 1 stream 640x480, warm 16 + {lat['frames'] - 16} timed frames: "
          f"latency_fps {lat['latency_fps']:.2f}, latency_ms_per_frame "
          f"{lat['latency_ms_per_frame']:.3f} (CUDA-synchronised wall), latency_ate_m "
          f"{lat['latency_ate_m']:.4f} (bound {lat['bound']:.3f}); launches {lat['counts']}; "
          f"profile {lat['profile']}", flush=True)

    done("7")

    # 8. K3 timing per level at the three shapes (VO: at each level the flow
    # the plain version carried down from the coarser levels; the others
    # start every level at the coarse flow)
    timing("fast_nms", "1x480x848 rendered", lambda: fast.fast_nms(f0_o, thr),
           lambda: fast.nms3(fast.fast_score(f0_o, thr)),
           kernel_bounds(1, 480, 848, N, 0, pairs=fast_pairs(f0_o, thr))["fast_nms"], phase=8)
    for b, (prev_pyr, cur_pyr, pts, init, active) in (list(k3_in.items()) + [("vo", k3_vo)]
                                                      + [("848", k3_o)]):
        L = len(prev_pyr)
        flow = (init - pts) / 2.0 ** (L - 1)
        n = pts.shape[1]
        for l in range(L - 1, -1, -1):
            iters = tcfg_run.lk_max_iters if l == 0 else tcfg_run.lk_coarse_iters
            args, _ = k3_args(prev_pyr, cur_pyr, pts, flow, active, l, iters)
            steps = gn_steps(lambda k: lk.lk_iterate_plain(*args[:12], k, args[13])[0], iters)
            shape = (f"1x{n} level {l} VO" if b == "vo" else f"848x480 1x{n} level {l}"
                     if b == "848" else f"{b}x{n} level {l}")
            timing("lk_iterate", shape, lambda: lk._lk_iterate_cuda(*args),
                   lambda: lk.lk_iterate_plain(*args),
                   kernel_bounds(pts.shape[0], 0, 0, n, iters, steps=sum(steps))["lk_iterate"])
            timings[-1]["points_by_step"] = steps
            if b == "vo":
                flow = 2.0 * lk.lk_iterate_plain(*args)[0]

    done("8")

    # 9. the latency path with loop closure (its own launch counts)
    loop = run_loop_path(dev, profile=3, path=os.path.join(OUT_DIR, "profile_loop.txt"))
    require(loop["profile"] is not None, "phase 9 profiled")
    check_loop_path(loop)
    print(f"[9 loop] 1 stream 640x480 revisit scene, warm 16 + {loop['timed']} timed frames, "
          f"pose graph on the worker thread: latency_ms_per_frame "
          f"{loop['latency_ms_per_frame']:.3f} (phase 7 in this run: "
          f"{lat['latency_ms_per_frame']:.3f}), latency_fps {loop['latency_fps']:.2f}, "
          f"latency_ate_m {loop['latency_ate_m']:.4f} (bound {loop['bound']:.3f}), "
          f"latency_loop_ate_m {loop['latency_loop_ate_m']:.4f}, latency_vio_kf_ate_m "
          f"{loop['latency_vio_kf_ate_m']:.4f}, latency_kf {loop['latency_kf']}, "
          f"latency_loops {loop['latency_loops']} {loop['loops']}; launches {loop['counts']} "
          f"({loop['kf_timed']} keyframes extracted in the timed frames); "
          f"{loop['loops_timed']} loops accepted and {loop['relo_consumed']} relocalizations "
          f"consumed by the worker in the timed frames (keyframes {loop['relo_keyframes']}); "
          f"worker seconds by stage {loop['worker_s']}; profile {loop['profile']}", flush=True)

    done("9")

    # 9b. the same scene and configuration with no pose graph (the relo
    # block in the solve, never active): what the worker costs the frame thread
    alone = run_latency_path(dev, profile=3, revisit=True,
                             path=os.path.join(OUT_DIR, "profile_loop_no_graph.txt"))
    check_latency_path(alone, on_gpu=False)
    print(f"[9b no graph] the loop cell without the pose graph: latency_ms_per_frame "
          f"{alone['latency_ms_per_frame']:.3f} (phase 9: {loop['latency_ms_per_frame']:.3f}, "
          f"phase 7: {lat['latency_ms_per_frame']:.3f}), latency_ate_m "
          f"{alone['latency_ate_m']:.4f}; launches {alone['counts']}; profile: "
          f"{alone['profile']['kernels_per_frame']:.1f} launches and "
          f"{alone['profile']['device_ms_per_frame']} device ms per frame, busy "
          f"{alone['profile']['busy_share']}, {alone['profile']['host_syncs']} host waits",
          flush=True)

    done("9b")

    # 9c. 9b and 9 again in the reverse order (9, 9b, 9b, 9): the host's
    # speed drifts within a call, and the pairs' mean cancels a linear drift
    alone2 = run_latency_path(dev, revisit=True)
    check_latency_path(alone2, on_gpu=False)
    loop2 = run_loop_path(dev)
    check_loop_path(loop2)
    order = [loop, alone, alone2, loop2]
    ms = [r["latency_ms_per_frame"] for r in order]
    worker_cost = (ms[0] + ms[3]) / (ms[1] + ms[2]) - 1.0
    print(f"[9c 9/9b/9b/9] latency_ms_per_frame {[round(m, 3) for m in ms]}: the pose graph's "
          f"worker costs the frame thread {100 * worker_cost:.1f} % (pair means); "
          f"latency_loops of the second 9: {loop2['latency_loops']}", flush=True)

    done("9c")

    # 9d. the pose graph inline (eager outputs: every frame read back)
    eager = run_loop_path(dev, eager=True)
    check_loop_path(eager)
    print(f"[9d eager] the loop cell with the pose graph inline: latency_ms_per_frame "
          f"{eager['latency_ms_per_frame']:.3f}, latency_loop_ate_m "
          f"{eager['latency_loop_ate_m']:.4f}, latency_vio_kf_ate_m "
          f"{eager['latency_vio_kf_ate_m']:.4f}, latency_kf {eager['latency_kf']}, "
          f"latency_loops {eager['latency_loops']} {eager['loops']}; launches {eager['counts']} "
          f"({eager['kf_timed']} keyframes extracted in the timed frames)", flush=True)

    done("9d")

    # 10. the batched path with loop closure (its own launch counts)
    # the profile covers 6 frames of a segment: a profiled frame's trace
    # takes seconds to export and read, and the script's time goes to the
    # later phases
    bl = run_batched_loop_path(dev, profile=6,
                               path=os.path.join(OUT_DIR, "profile_batched_loop.txt"))
    require(bl["profile"] is not None, "phase 10 profiled")
    check_batched_loop_path(bl)
    step5 = res["run_ms"] / T
    print(f"[10 batched loop] B={bl['B']} 640x480, {bl['n_revisit']} revisit sequences, "
          f"{bl['n_timed']} timed lock-step frames through the threaded closer: "
          f"{bl['seq_frames_per_s']:.2f} seq-frames/s drain-inclusive, "
          f"{bl['ms_per_frame']:.3f} ms per lock-step frame (phase 5 in this run: {step5:.3f} "
          f"ms per step, ratio {bl['ms_per_frame'] / step5:.3f}); drain tail "
          f"{bl['drain_tail_ms']:.1f} ms; loop_kf {bl['loop_kf']}, loops_found "
          f"{bl['loops_found']}; loop_ate_m {bl['loop_ate_m']:.4f}, loop_vio_ate_m "
          f"{bl['loop_vio_ate_m']:.4f}; ate_m {bl['ate_m']:.4f}, ate_max_m {bl['ate_max_m']:.4f} "
          f"(bounds {[round(b, 3) for b in bl['bounds']]}); closer stage ms summed over the "
          f"segments and the drain {bl['stage_ms']} ({bl['segments_with_keyframes']} segments "
          f"with keyframes, {bl['chunks']} extraction chunks); launches {bl['counts']}; "
          f"keyframes per graph {bl['keyframes']}; loops per graph "
          f"{[len(x) for x in bl['loops']]}; profile {bl['profile']}", flush=True)

    done("10")

    # 11. VO mode: the loop cell with the TUM rig's knobs, no IMU, the 6-DoF
    # graph on the worker (its own launch counts)
    vo = run_loop_path(dev, max_cnt=250, profile=6, vo=True,
                       path=os.path.join(OUT_DIR, "profile_vo.txt"))
    require(vo["profile"] is not None, "phase 11 profiled")
    check_loop_path(vo)
    print(f"[11 VO loop] 1 stream 640x480 revisit scene, no IMU, max_cnt 250 "
          f"({vo['graph'].cfg.max_wp} slots), warm 16 + {vo['timed']} timed frames, 6-DoF pose "
          f"graph on the worker thread: latency_ms_per_frame {vo['latency_ms_per_frame']:.3f} "
          f"(phase 9 in this run: {loop['latency_ms_per_frame']:.3f}), latency_fps "
          f"{vo['latency_fps']:.2f}, latency_ate_m {vo['latency_ate_m']:.4f} (bound "
          f"{vo['bound']:.3f}), latency_loop_ate_m {vo['latency_loop_ate_m']:.4f}, "
          f"latency_vio_kf_ate_m {vo['latency_vio_kf_ate_m']:.4f}, latency_kf "
          f"{vo['latency_kf']}, latency_loops {vo['latency_loops']} {vo['loops']}, 6-DoF solves "
          f"{vo['solves_6dof']}; launches {vo['counts']} ({vo['kf_timed']} keyframes extracted "
          f"in the timed frames); {vo['relo_consumed']} relocalizations consumed; worker "
          f"seconds by stage {vo['worker_s']}; profile {vo['profile']}", flush=True)

    done("11")

    # 11b. the map: saved, loaded into a fresh VO pipeline that replays the
    # revisit part, and through the reference's map directory
    mp = run_map_roundtrip(dev, vo)
    check_map_roundtrip(mp)
    print(f"[11b map] {mp}", flush=True)

    done("11b")

    # 11c. checkpoint and resume mid-stream
    ck = run_checkpoint_resume(dev)
    check_checkpoint_resume(ck)
    print(f"[11c checkpoint] resumed after frame {ck['cut']} of {ck['frames']}: {ck['outputs']} "
          f"outputs, largest position difference {ck['max_dP']:.3e} m (bound 1e-4); keyframes "
          f"{ck['keyframes']}, loops {ck['loops']} (uninterrupted, resumed)", flush=True)

    done("11c")

    # 12. the RealSense rig on the latency path: td estimated online from 0
    # against IMU stamps 5 ms ahead, rolling shutter (the renderer's global
    # shutter: the term is exercised, not matched), the extrinsic refined;
    # the failure check and the td refresh every 4th frame
    rig_r, seq_r, cfg_r = realsense_scene(64 + 4)
    td = run_rig_path(dev, cfg_r, rig_r, seq_r, n_frames=64, profile=4, failure_check_interval=4,
                      imu_shift=TD_TRUE, path=os.path.join(OUT_DIR, "profile_td.txt"))
    check_rig_path(td, dynamic=False, waits=2)
    print(f"[12 td] RealSense rig 640x480, max_cnt 30 ({cfg_r.feature_capacity} slots), td "
          f"estimated (truth {TD_TRUE} s), rolling shutter, extrinsic refined; warm 16 + "
          f"{td['timed']} timed frames, fused: latency_ms_per_frame "
          f"{td['latency_ms_per_frame']:.3f} (phase 7 in this run: "
          f"{lat['latency_ms_per_frame']:.3f}), latency_ate_m {td['latency_ate_m']:.4f} (bound "
          f"{td['bound']:.3f}); final td {td['td']:.5f} s (host pairing td "
          f"{td['td_cache']:.5f}); extrinsic drift {td['ric_err_deg']:.3f} deg; launches "
          f"{td['counts']} over {td['tracked']} tracked frames; profile "
          f"{td['profile']}", flush=True)

    done("12")

    # 12b. the same stream calibrating the extrinsic rotation online from
    # 5 degrees off (unfused: JAX's fused steady state does not calibrate)
    cal = run_rig_path(dev, calib_config(cfg_r, seq_r), rig_r, seq_r, n_frames=64, fused=False,
                       failure_check_interval=4, imu_shift=TD_TRUE)
    check_rig_path(cal, dynamic=False)
    if cal["calib_frame"] is not None:
        require(cal["calib_err_deg"] < 4.0, ("calibrated ric", cal["calib_err_deg"]))
    print(f"[12b extrinsic calibration] from 5 deg off, unfused: calibration "
          + (f"ended at frame {cal['calib_frame']}, error {cal['calib_err_deg']:.3f} deg"
             if cal["calib_frame"] is not None else "did not end (the rendered motion excites "
             "too little rotation)")
          + f"; final extrinsic error {cal['ric_err_deg']:.3f} deg; latency_ms_per_frame "
          f"{cal['latency_ms_per_frame']:.3f}, latency_ate_m {cal['latency_ate_m']:.4f} (bound "
          f"{cal['bound']:.3f}); launches {cal['counts']}", flush=True)

    done("12b")

    # 13. the OpenLORIS rig (848x480, 30 Hz, max_cnt 130) initializing in
    # motion (static_init 0)
    rig_o, seq_o, cfg_o = openloris_scene(64 + 3)
    dyn = run_rig_path(dev, cfg_o, rig_o, seq_o, n_frames=64, profile=3,
                       path=os.path.join(OUT_DIR, "profile_dyn.txt"))
    check_rig_path(dyn, dynamic=True)
    require(("init_dynamic", True) in dyn["attempts"], ("init_dynamic", dyn["attempts"]))
    print(f"[13 dynamic init] OpenLORIS rig 848x480 30 Hz, max_cnt 130 "
          f"({cfg_o.feature_capacity} slots), depth to 3 m; warm 16 + {dyn['timed']} timed "
          f"frames, fused: initialized at frame {dyn['init_frame']} by {dyn['attempts']}; "
          f"latency_ms_per_frame {dyn['latency_ms_per_frame']:.3f}; relative motion "
          f"{dyn['d_est']:.4f} m against {dyn['d_gt']:.4f} m; aligned ATE "
          f"{dyn['aligned_ate_m']:.4f} m; launches {dyn['counts']}; profile {dyn['profile']}",
          flush=True)

    done("13")

    # 13b. the same stream with no depth over its first 12 frames: dynamic
    # initialization fails, the monocular one runs
    mono = run_rig_path(dev, cfg_o, rig_o, seq_o, n_frames=64, depthless=12)
    check_rig_path(mono, dynamic=True, rel_frac=0.15, rel_min=0.1, init_by=24)
    require(any(name == "init_mono" for name, _ in mono["attempts"]), ("init_mono ran",
                                                                       mono["attempts"]))
    print(f"[13b monocular init] phase 13's stream, depth zeroed over frames 0-11: initialized "
          f"at frame {mono['init_frame']} by {mono['attempts']}; relative motion "
          f"{mono['d_est']:.4f} m against {mono['d_gt']:.4f} m; aligned ATE "
          f"{mono['aligned_ate_m']:.4f} m; latency_ms_per_frame "
          f"{mono['latency_ms_per_frame']:.3f}", flush=True)

    done("13b")

    # 14. a RealSense bag (bgr8 colour, compressedDepth PNG depth, the IMU)
    # and a rig file with equalize 1 through run_vio in a child process, then
    # replayed in this process through replay_into_pipeline (its own launch
    # counts, zeroed just before it)
    bagr = run_bag_path(dev, profile=3)
    check_bag_path(bagr)
    ent = bagr["entry"]
    print(f"[14 bag] RealSense rig 640x480 with CLAHE, {bagr['frames']} frames in a "
          f"{bagr['bag_mb']:.1f} MB rosbag (written in {bagr['write_s']:.1f} s): run_vio exit "
          f"{ent['rc']} in {ent['wall_s']:.1f} s, {ent['n_outputs']} odometry outputs = "
          f"{bagr['csv_rows']} CSV rows, ATE {bagr['run_vio_ate_m']:.4f} m (bound "
          f"{bagr['bound']:.3f}); in-process replay, warm {bagr['warmup']} + {bagr['timed']} "
          f"timed tracked frames, fused: latency_ms_per_frame "
          f"{bagr['latency_ms_per_frame']:.3f} = bag decode {bagr['decode_ms_per_frame']:.3f} "
          f"+ spin_once {bagr['spin_ms_per_frame']:.3f} + the rest (phase 12 in this run: "
          f"{td['latency_ms_per_frame']:.3f}); td {bagr['td']:.5f} s; CLAHE on level 0 "
          f"(max |level 0 - clahe(raw)| {bagr['clahe_err']:.2e}); launches {bagr['counts']} "
          f"over {bagr['tracked']} tracked frames; profile {bagr['profile']}", flush=True)

    done("14")

    # 14b. a TUM directory (VO rig, loop closure) through run_vio in a child
    # process, then its first frames in this process as run_vio feeds them
    tumr = run_tum_path(dev)
    check_tum_path(tumr)
    ent = tumr["entry"]
    png = png_decode_ms()
    print(f"[14b TUM] VO rig 640x480 30 Hz, loop closure, {tumr['frames']} frames written in "
          f"{tumr['write_s']:.1f} s: run_vio exit {ent['rc']} in {ent['wall_s']:.1f} s, "
          f"{ent['n_outputs']} odometry outputs, printed ATE {ent['printed_ate_m']:.4f} m, from "
          f"stamped_traj_estimate.txt {tumr['file_ate_m']:.4f} m (bound {tumr['bound']:.3f}), "
          f"{tumr['loop_rows']} rows in vins_result_loop.csv; in-process, warm "
          f"{tumr['warmup']} + {tumr['timed']} timed frames, fused, the pose graph on the "
          f"worker: latency_ms_per_frame {tumr['latency_ms_per_frame']:.3f} (phase 11 in this "
          f"run: {vo['latency_ms_per_frame']:.3f}), PNG decode {tumr['decode_ms_per_frame']:.3f} "
          f"ms per frame (grey + depth); launches {tumr['counts']} over {tumr['tracked']} "
          f"frames; profile {tumr['profile']}; one 640x480 RGB PNG of Paeth rows decodes in "
          f"{png['ms']:.2f} ms on the host", flush=True)

    done("14b")

    # 14c. the fisheye mask: the analytic circle and a mask file
    fish = run_fisheye(dev)
    check_fisheye(fish)
    print(f"[14c fisheye] 8 frames of the latency tracker 640x480, live points per frame and "
          f"points outside the mask (read on the device): {fish}", flush=True)

    done("14c")

    # the kernels line: per launch at the main path's shapes (K1 8x480x640,
    # K2 8x200 averaged over its two levels) and K3 at the latency path's
    # 1x200 (it never runs on the main path)
    paths = {"batched": res, "latency": lat, "latency_loop": loop, "batched_loop": bl,
             "latency_vo": vo, "latency_td": td, "latency_dyn": dyn, "bag_replay": bagr,
             "tum_replay": tumr}
    counts = {k: sum(r["counts"][k] for r in paths.values()) for k in KERNELS}
    errs = {"fast_nms": k1_err, "lk_level": k2_err, "lk_iterate": k3_err}
    main_shape = {"fast_nms": f"{B}x480x640 rendered", "lk_level": f"{B}x{N} level",
                  "lk_iterate": f"1x{N} level"}
    sources = {"fast_nms": ("fast_nms.cu", "vins_rgbd_fast_tpu/ops/fast_pallas.py:99"),
               "lk_level": ("lk_level.cu", "vins_rgbd_fast_tpu/ops/lk_pallas3.py:273"),
               "lk_iterate": ("lk_level.cu", "vins_rgbd_fast_tpu/ops/lk_pallas2.py:120")}
    kernels = []
    for name in KERNELS:
        rows = [t for t in timings if t["kernel"] == name and t["shape"].startswith(
            main_shape[name])]

        def mean(key):
            return statistics.fmean(t[key] for t in rows)

        kernels.append(dict(
            name=name, route="cuda", source="vins_rgbd_fast_torch/csrc/" + sources[name][0],
            replaces=sources[name][1], launches=counts[name], max_abs_err=errs[name],
            ms=mean("device_ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by=rows[0]["bound_by"], library_ms=None,
            launches_by_path={p: r["counts"][name] for p, r in paths.items()},
            host_us=mean("host_us"), profile_ms_per_frame={
                p: (prof if p == "batched" else r["profile"])["by_kernel"][name][
                    "device_ms_per_frame"] for p, r in paths.items()}))
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels, timings=timings, k2=rep, k3=rep3, main={
            k: res[k] for k in ("ates", "bounds", "counts", "run_ms", "wall_s", "frames")},
            stages=stages, profile=prof, extraction=ext, latency=lat,
            latency_loop=jsonable(loop), latency_loop_no_graph=alone, abba_ms=ms,
            worker_cost=worker_cost, latency_loop_eager=jsonable(eager),
            batched_loop={k: v for k, v in bl.items() if k != "cost"}, latency_vo=jsonable(vo),
            vo_map=mp, vo_checkpoint=ck, latency_td=td, latency_td_calib=cal,
            latency_dyn=dyn, latency_mono=mono, bag_replay=bagr, tum_replay=tumr,
            png_decode=png, fisheye=fish, phase_s=phase_s), f, indent=1, default=float)
    print(f"[phases] wall seconds {phase_s}, {sum(phase_s.values()):.1f} in all", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
