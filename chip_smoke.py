#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vins_rgbd_fast_torch``) on the GPU.

    python3 chip_smoke.py [--phases 21|22|23|24]

One card is enough; phase 21 shards over every card present.

Phases (each prints one line; any failure raises and exits non-zero):
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build of the hand-written kernels (``csrc/*.cu``, one nvcc per source,
     sm_90a, started together) and ptxas's registers, static shared memory
     and spills of each kernel (none may spill), K3's warps per point and
     its dynamic shared memory at WIN = 38; the tracer's stage marks
     (``check_stage_marks``) captured in a graph and replayed;
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
  4d. K2 at the batched VO path's shapes: B = 8 × 376 cold tracks (each
     frame's 376 strongest corners, started at their own positions) on 4
     levels, 80×60 to 640×480 (at 80×60 the 38-wide search window clamps),
     with the K2 bounds;
  5. the main path: B = 8 sequences at 640×480 rendered on the device,
     ``BatchedVioRunner.warm`` (11 window-filling frames + static init) and
     ``run`` over T steady frames: the first alone (run eagerly on the
     capture stream, then the frame captured as a CUDA graph), the other
     T - 1 replayed; finite costs, every kernel launched by the path (K1
     once and K2 twice per frame, counted under replay), distinct
     sequences, per-sequence ATE under max(0.05·travelled, 0.08 m); prints
     frames per second over the replayed frames (CUDA events) and the
     first frame's host seconds; before it, ``run_eager`` over the same
     frames from the same states and generator states (the per-op
     dispatch), timed, and ``run`` held to it bit for bit (or else within
     JAX's tolerances, the first differing leaf named);
  6. kernel timings at the path shapes (K1 at 8×480×640 on the rendered
     frames and on noise, at 1×480×640 and at 32×480×640, the extraction
     chunk; K2 per level at 8×200): device
     ms per launch over R launches between one pair of CUDA events, the
     wrapper's host µs per call, the bound from the work these inputs need
     (K1's pre-test survivors, K2's covered pixels, the GN steps taken) and
     the share of it; the plain versions' time per call (no yardstick); a
     per-stage split of the eager step, and a profile of a few replayed
     frames (in the output directory) that must show no host synchronisation inside
     ``run`` and K1 and K2 by name as often as the counters count them,
     and gives each kernel's device ms per frame by name;
  7. the latency path: ``VinsPipeline`` over one 640×480 stream (the bench's
     ``run_latency`` with ``BENCH_LAT_LOOP=0``): 16 warm-up frames through
     ``spin_once``, then 48 timed frames (CUDA-synchronised wall time),
     first dispatched op by op (``replay=False``, the plain version), then
     replayed (the first steady frame of the pipeline runs eagerly and is
     captured as a CUDA graph; its seconds are kept apart, ``capture_s``);
     the replayed frames equal the plain ones bit for bit in every output,
     end state and generator (else the first differing leaf is named);
     NON_LINEAR after the warm-up, ATE under max(0.05·travelled, 0.08 m),
     K1 once and K3 twice per frame and K2 never, and a profile of a few
     more frames of each that must show no host wait inside ``spin_once``
     and K1 once and K3 twice per frame by name (host CUDA API calls per
     frame and the busy share beside);
  8. K3 timings per level at 1×200 and 8×200, as in phase 6, at the
     VO shape 1×376 on levels 3..0 and at 1×200 on the 848×480 levels 1
     and 0; K1 at 1×480×848; K2 per level at phase 4d's 8×376 cold tracks;
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
     counted apart), beside phase 7's ms per frame; 9b. the same scene and configuration without
     the pose graph (the relo block in every solve, never active), plain
     and replayed, held bit for bit as in phase 7, and 9c.
     9b and 9 once more in the reverse order, for what the worker costs the
     frame thread; 9d. the loop cell with the pose graph inline
     (``eager_outputs``), with phase 9's checks but the profile; 9e. phase
     9 again with the port's tracer on, for the worker's seconds by span
     and the ms per frame that tracing costs.  Phase 9
     counts the relocalizations the worker consumes (the solver's relo pose
     fed back into the graph) and needs one when a loop was accepted in the
     timed frames, and holds its last loop's check, replayed from a captured
     graph as the worker runs it, to the same check dispatched op by op,
     bit for bit;
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
     host wait on the frame thread; before it, the same cell plain and
     replayed with the frame thread waiting for the worker after each
     hand-over (a loop's relocalization then reaches the solve at a fixed
     frame), held bit for bit as in phase 7 and to the same gates, the
     replayed one traced (its graph holds the stage marks; the worker's
     seconds by span);
     11b. that run's map saved
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
     the mask, read on the device; and phase 7's stream through the latency
     pipeline with the circle and CLAHE, plain and replayed, bit for bit;
 15. batched VO (the TUM RGB-D rig's knobs on ``BatchedVioRunner``: no IMU,
     ``max_cnt`` 250 = 376 slots, cold LK on 4 levels through K2, the PnP
     pose init from each sequence's own draws): phase 5's B = 8 sequences,
     warm 11 + 40 steady frames; finite costs, per-sequence ATE under
     max(0.05·travelled, 0.08 m), K1 once and K2 four times per frame, K3
     never; step ms beside phase 5's and sequence-frames/s (CUDA events);
     a profile of 3 more frames with no host wait inside ``run``;
     15b. phase 10's scene with phase 15's rig and 6-DoF graphs through
     ``ThreadedLoopCloser``: 14 warm-up frames, the warm segment and 5
     timed segments of 18, drain-inclusive; the clean sequences' ATE under
     its bound, at least one loop and one 6-DoF solve, the loop-corrected
     keyframe ATE at most 5 mm above the VO keyframes', K1 per frame and
     per extraction chunk, K2 four times per frame;
 16. a Kannala-Brandt rig (mu = mv = 300, u0 = 320, v0 = 240, k2..k5 =
     -0.01, 0.002, 0, 0) written by ``rig_yaml`` and read back by
     ``load_config`` as its config, through phase 7's latency path on
     frames rendered through the fisheye's rays (``camera_ray_grid``):
     16 + 48 frames, ATE under its bound, K1 once and K3 twice per frame,
     K2 never, 2 profiled frames with no host wait; 16b. 8 frames of the
     latency tracker with a Mei and a Scaramuzza camera on frames rendered
     through their own rays: at least 20 live points per frame; each
     non-pinhole model's ``lift`` and ``project`` at 10k pixels on the card
     within 1e-5 of the CPU's (rays relative to their size, pixels to the
     image width); 16c. a Mei and a Scaramuzza rig file (``camera_config``)
     each through phase 16's path: 16 + 12 frames, ATE under its bound, K1
     once and K3 twice per frame, K2 never, 1 profiled frame with no host
     wait; 16d. phase 5's batched VIO with phase 16's Kannala-Brandt camera
     on frames rendered through its rays: B = 8, warm 11 + 16 steady
     frames, per-sequence ATE under its bound, K1 once and K2 twice per
     frame, K3 never;
 17. phase 7's stream through ``frames_degraded`` with ``bench.py``'s harsh
     preset (the moving sphere, depth noise, block and edge holes, exposure
     drift, read noise, a rolling-shutter shear): 16 + 48 frames, ATE under
     max(0.08·travelled, 0.12 m) (``tests/test_dynamic_scene.py``'s bound),
     a feature flagged dynamic on at least one frame, K1 once and K3 twice
     per frame, 2 profiled frames with no host wait;
 18. intrinsic calibration (rendered boards, the four models, the CLI);
 19. the runner's chained API, ``run_eager`` and ``run_sharded`` over two
     shards of the card against ``run``, ``stack_states``, the graft
     twins' dry runs over eight shards of the card;
 20. the OpenLORIS rig (848×480, ``static_init`` 0, grid 7×8, 200
     slots, depth to 3 m, 30 Hz) on ``BatchedVioRunner``: 8 lanes
     (``make_trajectory`` seeds 7-14, each moving from frame 0; lanes 6
     and 7 with their depth withheld until initialization), each warmed in
     its own ``VinsPipeline`` until NON_LINEAR and fed on to one common
     frame past the last lane's initialization, then ``stack_states``,
     ``stage_frames_arrays`` and 40 steady frames of ``run``: each lane
     initialized by its own program (``init_dynamic`` by frame 15,
     ``init_mono`` by frame 23), its relative motion from its first output
     to its last within max(0.1·d, 0.08 m) (0.15·d, 0.1 m monocular),
     finite costs, K1 once and K2 twice per steady frame, K1 once and K3
     twice per tracked warm-up frame, 3 profiled frames with no host wait
     inside ``run``; step ms beside phase 5's and sequence-frames/s (CUDA
     events); K1 bit-exact at 8×480×848 and K2 against its plain version
     at 8×200 on the 848×480 levels 1 and 0, both timed;
 20b. the RealSense rig (phase 12's knobs: 640×480, grid 5×6, 48 slots,
     td from 0 against IMU stamps 5 ms ahead, rolling shutter, the
     extrinsic refined) on the runner: 8 lanes (seeds 7-14) warmed by
     static init in their own pipelines, one configuration for all, 40
     steady frames: each lane's ATE under max(0.05·travelled, 0.08 m) or,
     where the lane alone on the latency pipeline misses that bound too,
     within its latency ATE plus max(10 %, 0.01 m); td finite within 50 ms
     on every lane; K1 once and K2 twice per frame, 2 profiled frames with
     no host wait inside ``run``; K2 against its plain version at 8×48,
     timed.
 21. the batched runner sharded by lane over a mesh of cards (every card
     present; phase 5's rig, 8 lanes per card, self-warmed by
     ``BatchedVioRunner.warm`` on card 0 and placed by ``put_states``):
     (a) on every card, from the main thread (its current device stays 0),
     K1 bit-exact at 8×480×640, K2 at 8×200 and K3 at 1×200 on both levels
     against their plain versions, then each timed on its card;
     (b) 40 steady frames of ``run_sharded`` over two shards of card 0
     (B = 8) and over every card (B = 8 per card), each against ``run`` on
     card 0 over the same lanes from the same generator states, within
     JAX's tolerances (P 5e-4 m, cost rtol 5e-3, keyframes equal): every
     lane under its truth bound, finite costs, K1 once and K2 twice per
     frame for each shard on each card, each card's peak memory;
     and ``run_eager`` at B = 8 on card 0 against ``run`` (bit for bit,
     or else within the same tolerances);
     (c) ``run`` at B = 8 (A) and at every lane (B) on card 0, both sharded
     runs (C, D; every shard replayed in turn from the main thread) and
     ``run_eager`` at B = 8 (E, the per-op dispatch), 20 frames each,
     three turns (A B C D E E D C B A A B C D E), host clock ended by a
     synchronisation of every card used: ms per step, seq-frames/s and the
     ratios to A; a profile of 2 frames of each way: host CUDA API calls
     per frame, no host wait, and each card's kernels (K1 once and K2
     twice per shard per frame by name), device ms and busy share per
     frame; (d) both dry runs over every card (on one card phase 19's
     eight shards of it, already run).
 22. the failure reboot (bench.py's ``run_recovery``): phase 7's rig on
     ``make_trajectory(80, seed 7)``, ``VinsPipeline`` with the failure
     check on every frame, the fused steady state replayed and the
     envelope, black frames at frames 40-42, each frame ended by a device
     synchronisation: ``recovery_steady_fps``, ``recovery_triggered``,
     ``recovery_frames`` and ``recovery_ms`` as bench.py computes them;
     the failure seen within the burst, NON_LINEAR again before the last
     frame and steady after, one capture (before the burst) whose graph
     serves the frames after the reboot too (the reset's states loaded into
     its buffers), the outputs before the burst under their truth bound,
     the relative motion after the reboot printed (not gated), K1 once and
     K3 twice per frame (the unfused frames through K3 too), K2 never, and
     3 profiled frames with at most the failure check's host wait per
     frame; the same run dispatched op by op (``replay=False``): the same
     solver flag on every frame and bit-equal outputs, end states and
     generators; 22b. the same burst with the TUM rig's VO knobs (376
     slots, cold LK on 4 levels, the PnP pose init; K3 four times per
     frame), the same gates; 22c. phase 9's loop cell on a three-cycle
     revisit scene (168 frames) with the failure check on every frame and
     the burst from the first frame after the worker accepted a loop: the
     failure seen within the burst, NON_LINEAR again, the stager drained
     without an exception, and every relocalization constraint a solve
     took made in the estimator's epoch of that solve (none from before
     the reboot after it);
 23. phase 10's batched-8-loop cell staged once (B = 8, 4 revisits, 212
     frames, segments of 18) and run three times from the same states and
     generator states, its closer driven as bench.py drives it: threaded
     (``ThreadedLoopCloser``), pipelined (``BENCH_THREAD=0``:
     ``pack_dispatch`` and ``pipeline_advance_packed`` after each ``run``,
     ``pipeline_drain`` at the end) and inline (``BENCH_OVERLAP=0``: the
     serial ``consume``); each with phase 10's gates, and per lane the same
     keyframes, the same loops as (cur, old) pairs and ``rel_t`` within
     5e-5 m of the threaded closer's; each segment's ``ScanOutputs`` of the
     pipelined run its own memory and unchanged by the later segments;
     drain-inclusive seq-frames/s, the drain tail and, pipelined, the
     closer's host reads on the frame thread that waited for the device;
 24. K4 (the solve's projection assembly): the fleet's batched VO (B = 32,
     376 slots) replayed bit-equal to ``run_eager``, the VO loop robot's
     replayed frames bit-equal to its plain ones, the RealSense robot (td,
     rolling shutter); then K4 against its plain version (in float64, no
     worse than 4x the plain float32 version's own error), two launches
     bit-equal and Hpp mirrored, at every (B, M, NXP) whose inputs were
     tapped from phase 5 on (``ProjSchurTap``), covering its tiles of 8,
     16 and 32 features, each timed beside its bound.
Phases 5, 7, 9, 10, 11, 12, 13, 14, 14b, 15, 15b, 16, 16c (once per
camera), 16d, 16e (once per camera), 16f, 17, 20, 20b, 21 (each
sharded run of 21b), 22 and 22b (each run), 22c and 23 (each mode) each
zero the kernels' launch counters (K4's among them) just before their
path and read them just after; the ``kernels`` line sums them.  The
batched paths want K4 max_iters + 2 times per replayed frame.
Every latency-pipeline phase replays its steady frames; its first steady
frame (eager warm-up and capture) is timed apart, and a capture inside
the timed frames fails the phase.  A
line before the card's lists each phase's wall seconds.
``python3 chip_smoke.py --phases 21`` runs phases 1-2 and 21 alone (the
call on several cards); its ``kernels`` line holds card 0's timings and
phase 21's launches.  ``--phases 22`` runs phases 1-2, the three kernels
against their plain versions and timed on card 0 (22a), then 22-22c;
``--phases 23`` the same with phase 23 (23a, 23).  ``--phases 24`` runs
phases 1-2, the main path's batched VIO and VO at B = 8 (8 steady frames
each, tapped), then 24.
The last line is ``{"ok": true, "device": {...}}``.  Without CUDA it exits
non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from vins_rgbd_fast_torch import native
from vins_rgbd_fast_torch.backend import estimator as est
from vins_rgbd_fast_torch.backend.estimator import ImuIntervalBuffer
from vins_rgbd_fast_torch.config import EstimatorConfig, TrackerConfig, VinsConfig, load_config
from vins_rgbd_fast_torch.frontend import feature_tracker as ft
from vins_rgbd_fast_torch.io import synthetic as syn
from vins_rgbd_fast_torch.io.stream import ate_rmse
from vins_rgbd_fast_torch.loop import pose_graph as pg
from vins_rgbd_fast_torch.loop.pose_graph import (KeyframeGate, PoseGraphConfig,
                                                  extract_kf_device)
from vins_rgbd_fast_torch.models.camera import PinholeCamera
from vins_rgbd_fast_torch.ops import fast, image, lk
from vins_rgbd_fast_torch.ops import solver as slv
from vins_rgbd_fast_torch.parallel import batched_pipeline as bp
from vins_rgbd_fast_torch.parallel.loop_closer import (BatchedLoopCloser, HostCopy,
                                                       ThreadedLoopCloser)
from vins_rgbd_fast_torch.parallel.throughput import make_mesh
from vins_rgbd_fast_torch.pipeline import VinsPipeline
from vins_rgbd_fast_torch.utils import timing
from vins_rgbd_fast_torch.utils.timing import TRACER

# radtan coefficients of the bench rig (reference realsense vio.yaml)
DISTORTION = dict(k1=0.13387871564774004, k2=-0.2731913133377051,
                  p1=0.0020296263577681264, p2=-0.00044384544608203714)
OUT_DIR = "chiprun_out"
RUN_SPAN = "chip_smoke::run"
SPIN_SPAN = "chip_smoke::spin_once"
SHARDED_SPAN = "chip_smoke::run_sharded"
TD_TRUE = 0.005  # phase 12's IMU clock runs 5 ms ahead of the image stamps
HOST_SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
                   "cudaMemcpy")
KERNELS = ("fast_nms", "lk_level", "lk_iterate")  # launch counters, and <name>_kernel on the card
# the launch counters every path reads: K1-K3's and K4's (``solver.launches``,
# the solve's projection assembly); K4's two kernels (the assembly and the
# finishing sum) are reported by ptxas beside K1-K3's
COUNTED = KERNELS + ("proj_schur",)
PTXAS_NAMES = COUNTED + ("proj_schur_finish",)
# bench.py's BENCH_DEGRADE=harsh preset (phase 17)
HARSH = syn.SensorDegradation(depth_sigma=0.006, hole_p=0.10, edge_hole=True, exposure_amp=0.3,
                              read_noise=3.0, rs_shear_px=2.0, dyn_radius=0.5)

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
# K4 per live projection factor (csrc/proj_schur.cuh): the residual and
# the 2 x 20 Jacobian (~815 flop: four rotations, three rotation matrices,
# their products, the 3 x 20 J3 and its 2 x 3 reduction, the Cauchy
# weight), the feature's common Gram (120 entries, two rows, a multiply-add
# each: 480) and the frame's items (111 entries: 444), rounded up
PROJ_FLOP_PER_FACTOR = 1750
# K4 against the plain version in float64 (``compare_k4``, ``k4_within``):
# each output's largest error over its entry's scale at most this many
# times the plain float32 version's own, or under the floor
PROJ_SCHUR_RATIO = 4.0
PROJ_SCHUR_FLOOR = 1e-6


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


def proj_schur_bound(B: int, M: int, nxp: int, live: int) -> dict:
    """The least time one K4 launch can take: the window (P, Q, tic, qic,
    td: 85 floats a sequence), the grid (284 bytes a feature: start,
    inverse depth and valid, and 11 frames of pts, vel, td_obs, row_scaled
    and obs) and the system it adds to (Hpp, Hpl, dl, gp, gl) read once,
    the system and Σ r² written once; ``PROJ_FLOP_PER_FACTOR`` for each of
    the ``live`` factors (valid, seen at start and at j, j != start)."""
    system = 4 * (nxp * nxp + nxp * M + 2 * M + nxp)
    return _bound(B * (4 * 85 + 284 * M + 2 * system + 4), PROJ_FLOP_PER_FACTOR * live)


def live_factors(vis) -> int:
    """The projection factors of a grid that K4 folds in (``_proj_grid``'s
    mask)."""
    s = vis.start.to(torch.int64)
    at_start = torch.gather(vis.obs_mask, 2, s[..., None])
    j = torch.arange(vis.obs_mask.shape[-1], device=s.device)
    return int((vis.valid[..., None] & at_start & vis.obs_mask & (j != s[..., None])).sum())


class ProjSchurTap:
    """Within: copies of the inputs of ``solver.proj_schur``'s calls on the
    card outside a graph capture, taken on the caller's stream with no
    synchronisation: for each (B, M, NXP), its 1st, 2nd, 4th, 8th, ... call
    (the last ``KEEP`` of those).  ``shapes`` gives each (B, M, NXP)'s kept
    call with the most live factors (a solve's rather than a
    marginalization's)."""

    KEEP = 4

    def __init__(self):
        self.calls, self.kept = {}, {}
        self.lock = threading.Lock()

    def __enter__(self):
        self.orig = orig = slv.proj_schur

        def tapped(x, vis, s):
            if x.P.is_cuda and not torch.cuda.is_current_stream_capturing():
                key = (*vis.start.shape, s.Hpp.shape[-1])
                with self.lock:
                    n = self.calls[key] = self.calls.get(key, 0) + 1
                if n & (n - 1) == 0:
                    copy = tuple(type(t)(*[a.clone() for a in t]) for t in (x, vis, s))
                    with self.lock:
                        kept = self.kept.setdefault(key, [])
                        kept.append(copy)
                        del kept[:-self.KEEP]
            return orig(x, vis, s)

        slv.proj_schur = tapped
        return self

    def __exit__(self, *exc):
        slv.proj_schur = self.orig

    def shapes(self, device) -> dict:
        """(B, M, NXP) -> (live factors, x, vis, s) of its kept call with the
        most live factors (the later of equals), on ``device``."""
        torch.cuda.synchronize()
        out = {}
        for key, cands in self.kept.items():
            for c in cands:
                c = tuple(type(t)(*[a.to(device) for a in t]) for t in c)
                live = live_factors(c[1])
                if live >= out.get(key, (-1,))[0]:
                    out[key] = (live,) + c
        return out


def compare_k4(x, vis, s) -> dict:
    """K4 and its plain version, each against the plain version in float64
    on the card: each output's largest error over its entry's scale
    (``err_k4``, ``err_plain``), and K4 against the plain float32 version
    (``rel``); two launches bit-equal; Hpp mirrored bit for bit.  An
    entry's scale bounds the sum it rounds (Cauchy-Schwarz over its
    factors, from the float64 factors alone: sqrt(H_aa H_bb) for Hpp and
    Hpl, dl, sqrt(H_aa Σ r²) for gp and gl) plus the magnitude of the input
    entry it is added to: near an optimum the gradient's terms cancel, so
    its largest entry is no scale.  A factor of a landmark near a camera's
    plane is as ill-conditioned in either float32 version, so K4 is held to
    the plain version's own error (``PROJ_SCHUR_RATIO``)."""
    k1, c1 = slv.proj_schur(x, vis, s)
    k2, c2 = slv.proj_schur(x, vis, s)
    p, cp = slv.proj_schur_plain(x, vis, s)

    def f64(t):
        return type(t)(*[a.double() if a.is_floating_point() else a for a in t])

    r, cr = slv.proj_schur_plain(f64(x), f64(vis), f64(s))
    z, cz = slv.proj_schur_plain(f64(x), f64(vis),
                                 slv.StructuredSystem(*[torch.zeros_like(t) for t in f64(s)]))
    d = torch.diagonal(z.Hpp, dim1=1, dim2=2)
    s64 = f64(s)
    scale = dict(Hpp=torch.sqrt(d[:, :, None] * d[:, None, :]) + s64.Hpp.abs(),
                 Hpl=torch.sqrt(d[:, :, None] * z.dl[:, None, :]) + s64.Hpl.abs(),
                 dl=z.dl + s64.dl.abs(), gp=torch.sqrt(d * cz[:, None]) + s64.gp.abs(),
                 gl=torch.sqrt(z.dl * cz[:, None]) + s64.gl.abs(), cost=cz)

    def err(a, b, name):
        diff = (a.double() - b).abs()
        return float(torch.where(diff > 0, diff / scale[name], torch.zeros_like(diff)).max())

    names = k1._fields + ("cost",)
    ks, ps, rs = list(k1) + [c1], list(p) + [cp], list(r) + [cr]
    return dict(err_k4={n: err(a, b, n) for n, a, b in zip(names, ks, rs)},
                err_plain={n: err(a, b, n) for n, a, b in zip(names, ps, rs)},
                rel={n: err(a, b.double(), n) for n, a, b in zip(names, ks, ps)},
                repeat_bit_equal=all(torch.equal(a, b) for a, b in zip(
                    list(k1) + [c1], list(k2) + [c2])),
                mirrored=torch.equal(k1.Hpp, k1.Hpp.transpose(1, 2)))


def k4_within(c: dict) -> bool:
    """``compare_k4``'s gate: every output of K4 within ``PROJ_SCHUR_RATIO``
    times the plain float32 version's own error against float64, or within
    ``PROJ_SCHUR_FLOOR`` of its scale."""
    return all(c["err_k4"][n] <= max(PROJ_SCHUR_RATIO * c["err_plain"][n], PROJ_SCHUR_FLOOR)
               for n in c["err_k4"])


def ptxas_usage(log: str) -> dict:
    """Registers, static shared memory, stack and spills of each of the
    port's kernels, from the messages of ``nvcc -Xptxas -v`` (the log that
    ``native.build`` writes beside the library)."""
    usage = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        name = next((k for k in PTXAS_NAMES if re.search(rf"\d{k}_kernel", mangled)), None)
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


def vo_batched_config(W: int = 640, H: int = 480, max_cnt: int = 250):
    """``slice_config`` with the TUM RGB-D rig's VO knobs: no IMU (the
    estimator's and the tracker's prediction), ``max_cnt`` 250 (376 feature
    slots), cold LK on ``pyr_levels_cold`` = 4 levels."""
    rig, tcfg, ecfg, cam = slice_config(W, H, max_cnt)
    return (rig, dataclasses.replace(tcfg, use_imu_prediction=False),
            dataclasses.replace(ecfg, use_imu=False), cam)


def camera_ray_grid(cam, W: int, H: int, device="cpu") -> torch.Tensor:
    """(H, W, 3) z = 1 rays of a camera model: its ``lift`` of the pixel grid
    (the renderer's own grid is the pinhole rig's)."""
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return cam.lift(torch.stack([xx, yy], dim=-1))


def render_camera(seq, cam, device, k0: int = 0, k1=None):
    """``seq``'s frames [k0, k1) rendered through ``cam``'s ray grid:
    (times, images (T, H, W), depths (T, H, W)) on ``device``."""
    rig = syn.SyntheticRig(width=cam.width, height=cam.height)
    return syn.render_sequence(seq, rig, device, k0, k1,
                               rays=camera_ray_grid(cam, cam.width, cam.height, device))


def ocam_polys(W: int, H: int, f: float, curve: float = 4e-4, deg: int = 9):
    """A Scaramuzza (OCAM) forward polynomial z(φ) = -f + curve·φ² over the
    W×H image, and its inverse polynomial ρ(θ) fitted to it by least squares
    (θ = atan2(-z_ray, r), as ``project`` reads it)."""
    poly = (-f, 0.0, curve, 0.0, 0.0)
    phi = np.linspace(0.0, 1.1 * np.hypot(W / 2.0, H / 2.0), 400)
    theta = np.arctan2(-(f - curve * phi ** 2), phi)
    inv = np.polynomial.polynomial.polyfit(theta, phi, deg)
    return poly, tuple(float(c) for c in inv)


OCAM_STRETCH = (1.001, 1e-4, -2e-4)  # C, D, E: tests/test_calib.py's affine stretch


def camera_config(model_type: str, cfg: VinsConfig) -> VinsConfig:
    """``cfg`` with one of the three non-pinhole cameras at its size: a
    Kannala-Brandt fisheye (mu = mv = 300 at 640 wide, k2..k5 = (-0.01,
    0.002, 0, 0)), a Mei camera (xi 0.8, gamma 400 at 640 wide, a small
    radtan) or a Scaramuzza camera (``ocam_polys``, f 300 at 640 wide, the
    centre off the image's; no affine stretch: JAX's OCAM lift un-stretches
    only the radius it evaluates the polynomial at, so with a stretch
    ``project`` does not invert ``lift`` exactly).  "SCARAMUZZA_AFFINE" is
    that Scaramuzza camera with ``OCAM_STRETCH`` (phase 16f)."""
    W, H = cfg.image_width, cfg.image_height
    s = W / 640.0
    mt = model_type.upper()
    if mt == "KANNALA_BRANDT":
        return dataclasses.replace(cfg, model_type=mt, intrinsics=(300.0 * s, 300.0 * s,
                                                                   W / 2.0, H / 2.0),
                                   kb_distortion=(-0.01, 0.002, 0.0, 0.0))
    if mt == "MEI":
        return dataclasses.replace(cfg, model_type=mt, mirror_xi=0.8,
                                   intrinsics=(400.0 * s, 400.0 * s, W / 2.0, H / 2.0),
                                   distortion=(-0.05, 0.01, 1e-4, -1e-4))
    if mt in ("SCARAMUZZA", "SCARAMUZZA_AFFINE"):
        poly, inv = ocam_polys(W, H, 300.0 * s, 4e-4 / s)
        stretch = OCAM_STRETCH if mt == "SCARAMUZZA_AFFINE" else (1.0, 0.0, 0.0)
        return dataclasses.replace(cfg, model_type="SCARAMUZZA", ocam_poly=poly,
                                   ocam_inv_poly=inv,
                                   ocam_affine=stretch + (W / 2.0 + 1.5, H / 2.0 - 2.0))
    raise ValueError(f"camera_config: {model_type!r} is not a non-pinhole model")


def make_sequences(rig, B: int, n_frames: int, device, cam=None):
    """B synthetic sequences (seeds 100+b, the bench's), rendered on device
    (through ``cam``'s ray grid when given), with per-sequence host IMU
    buffers."""
    seqs = [syn.make_trajectory(n_frames, rig, seed=100 + b, omega_scale=0.15,
                                acc_scale=0.3) for b in range(B)]
    rendered = [syn.render_sequence(s, rig, device) if cam is None
                else render_camera(s, cam, device) for s in seqs]
    bufs = []
    for s in seqs:
        buf = ImuIntervalBuffer(32)
        for (t, a, g) in s.imu:
            buf.push(t, a, g)
        bufs.append(buf)
    return seqs, rendered, bufs


def run_main_path(device, B: int, T: int, W: int = 640, H: int = 480, max_cnt: int = 130,
                  extra: int = 0, timer=None, vo: bool = False, camera: str = "",
                  eager: bool = False):
    """Self-warmed batched VIO over B sequences and T steady frames (with
    ``vo``, batched VO with ``vo_batched_config``: no IMU interval staged;
    with ``camera``, a non-pinhole model type, the runner takes that camera
    of ``camera_config`` and the frames are rendered through its rays).
    ``run`` takes the first steady frame alone (on the card it runs it
    eagerly and captures the frame) and the other T - 1 in a second call,
    replayed: ``timer`` times that call (``step_ms`` per frame) and
    ``capture_s`` is the first's host time.  With ``eager``, ``run_eager``
    first runs the T frames from the same states and generator states
    (timed too), and ``eager`` holds its step and how ``run``'s outputs
    and end states compare (``sharded_diff``).  The launches are counted
    over the warm-up and ``run``'s two calls.  Returns a dict of results
    (and the runner state for more frames)."""
    rig, tcfg, ecfg, cam = (vo_batched_config if vo else slice_config)(W, H, max_cnt)
    if camera:
        cam = camera_config(camera, VinsConfig(image_width=W, image_height=H)).camera()
    n = bp.WINDOW_SIZE + 1 + T + extra
    seqs, rendered, bufs = make_sequences(rig, B, n, device, cam if camera else None)
    if vo:
        bufs = None
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
    warm_counts = read_counts()
    ref = None
    if eager:
        gens = generator_states(runner)
        synchronize([device])
        tm = CudaTimer() if torch.device(device).type == "cuda" else None
        t1 = time.perf_counter()
        if tm is not None:
            tm.start()
        ref = runner.run_eager(trk, st, run_batch)
        eager_ms = tm.stop() if tm is not None else 1e3 * (time.perf_counter() - t1)
        set_generator_states(runner, gens)
    reset_counts()
    trk, st, outs, timing = run_replayed(runner, trk, st, run_batch, timer)
    P = outs.P.cpu().numpy()  # the one read-back of the steady run
    wall = time.perf_counter() - t0
    counts = {k: warm_counts[k] + v for k, v in read_counts().items()}
    if ref is not None:
        ref = dict(eager_step_ms=eager_ms / T, **sharded_diff(ref[2], outs),
                   states_equal=_equal_trees(ref[:2], (trk, st)),
                   first_difference=first_difference(ref, (trk, st, outs)))

    cost = outs.cost.cpu().numpy()
    ates, bounds = [], []
    for b in range(B):
        ate = ate_rmse(ts[b][k_w:k_w + T], P[:, b], seqs[b].times, seqs[b].P, align=False)
        travelled = float(np.sum(np.linalg.norm(np.diff(seqs[b].P, axis=0), axis=1)))
        ates.append(ate)
        bounds.append(max(0.05 * travelled, 0.08))
    return dict(P=P, cost=cost, ates=ates, bounds=bounds, counts=counts, **timing, eager=ref,
                wall_s=wall, frames=k_w + T, runner=runner, state=(trk, st),
                extra_batch=extra_batch, n_features=outs.n_features.cpu().numpy(),
                camera=type(cam).__name__,
                levels=runner.tcfg.pyr_levels_cold if vo else runner.tcfg.pyr_levels_predicted)


def run_replayed(runner, trk, st, batch, timer=None):
    """``runner.run`` over ``batch`` in two calls: the first frame alone
    (on the card, the warm-up and capture of a runner that has no frame
    captured for this layout; ``capture_s`` its host time) and the other
    frames replayed, timed by ``timer`` (``step_ms`` per frame, None with
    one frame or no timer); returns (trk, st, the outputs of both calls
    joined, the times and ``k4_per_replayed_frame``, K4's launches per frame
    of the second call, counted by replay)."""
    synchronize([runner.device])
    t0 = time.perf_counter()
    trk, st, outs = runner.run(trk, st, first_frames(batch, 1))
    synchronize([runner.device])
    capture_s = time.perf_counter() - t0
    T, step_ms, k4 = batch.ts.shape[0], None, None
    if T > 1:
        k0 = slv.launches.total
        if timer is not None:
            timer.start()
        trk, st, rest = runner.run(trk, st, bp.FrameBatch(*(a[1:] for a in batch)))
        if timer is not None:
            step_ms = timer.stop() / (T - 1)
        k4 = (slv.launches.total - k0) / (T - 1)
        outs = bp.ScanOutputs(*(torch.cat(f) for f in zip(outs, rest)))
    return trk, st, outs, dict(step_ms=step_ms, capture_s=capture_s, k4_per_replayed_frame=k4)


def check_main_path(res, B: int, T: int, on_gpu: bool = True) -> None:
    """The main path's gates, and with ``eager`` the replay against
    ``run_eager``: bit for bit, or else within JAX's tolerances
    (``within_jax_tolerances``) with the first differing leaf named."""
    require(np.all(np.isfinite(res["cost"])), "non-finite cost")
    frames = res["frames"]
    if on_gpu:  # K1 runs once per frame over all B images; K2 once per level
        require(res["counts"]["fast_nms"] == frames, res["counts"])
        require(res["counts"]["lk_level"] == res["levels"] * frames, res["counts"])
        require(res["counts"]["lk_iterate"] == 0, res["counts"])
        # K4 once per assembly: the solve's max_iters + 1 and the marginalization's
        want = res["runner"].ecfg.solver.max_iters + 2
        require(res["k4_per_replayed_frame"] in (None, want),
                ("K4 launches per replayed frame", res["k4_per_replayed_frame"], want))
    for b in range(1, B):
        require(not np.allclose(res["P"][:, 0], res["P"][:, b], atol=1e-3),
                f"sequences 0 and {b} coincide")
    for b, (ate, bound) in enumerate(zip(res["ates"], res["bounds"])):
        require(np.isfinite(ate) and ate < bound, ("ATE", b, ate, bound))
    e = res["eager"]
    if e is not None:
        require((e["bit_equal"] and e["states_equal"]) or within_jax_tolerances(e),
                ("run against run_eager", e))


def generator_states(runner) -> list:
    """The states of the runner's lane generators (RANSAC, then PnP)."""
    return [g.get_state() for g in runner.generators + (runner.pnp_generators or [])]


def set_generator_states(runner, states) -> None:
    for g, s_ in zip(runner.generators + (runner.pnp_generators or []), states):
        g.set_state(s_)


def first_difference(a, b):
    """The index and shape of the first leaf where trees ``a`` and ``b``
    differ (``bp.leaves`` order), or None."""
    for i, (x, y) in enumerate(zip(bp.leaves(a), bp.leaves(b))):
        if not torch.equal(x, y):
            return dict(leaf=i, shape=list(x.shape), max_abs=float((x.double() - y.double()
                                                                    ).abs().max()))
    return None


def launch_counts() -> tuple:
    """The kernels' launch counters, in ``COUNTED`` order."""
    return fast.launches, lk.level_launches, lk.iterate_launches, slv.launches


def reset_counts() -> None:
    for c in launch_counts():
        c.reset()


def read_counts() -> dict:
    return dict(zip(COUNTED, (c.total for c in launch_counts())))


def k1_k3(counts: dict) -> dict:
    """K1-K3's launches of a ``read_counts`` dict (K4's follow the solve,
    which a path's frames may or may not reach)."""
    return {k: counts[k] for k in KERNELS}


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


def graph_of(pipe: VinsPipeline):
    """The CUDA graph of a latency pipeline's steady-frame program, or None."""
    return getattr(pipe._prog, "graph", None)


def capture_clock(pipe: VinsPipeline) -> list:
    """Time a latency pipeline's capture frames apart: on CUDA, with
    ``replay``, wraps ``pipe.spin_once`` so that a frame that may capture
    (the estimator NON_LINEAR and no graph yet) runs between two
    synchronisations; if it captured, its seconds (its eager warm-up frame
    and the capture) go to the returned list (``timed_ms``)."""
    caps: list = []
    if pipe.device.type != "cuda" or not (pipe.replay and pipe._fused_enabled):
        return caps
    spin = pipe.spin_once

    def spin_once():
        if graph_of(pipe) is not None or \
                pipe.estimator.solver_flag != est.VinsEstimator.NON_LINEAR:
            return spin()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = spin()
        torch.cuda.synchronize()
        if graph_of(pipe) is not None:
            caps.append(time.perf_counter() - t0)
        return out

    pipe.spin_once = spin_once
    return caps


@contextlib.contextmanager
def traced():
    """The port's tracer on within (as it was after); yields its snapshot
    at entry."""
    was = TRACER.on
    TRACER.enable()
    try:
        yield TRACER.snapshot()
    finally:
        if not was:
            TRACER.disable()


def timed_ms(elapsed: float, n: int, caps: list, k0: int) -> float:
    """ms per frame of a timed window of ``n`` frames that took ``elapsed``
    s; ``caps[k0:]``, the capture frames inside it, must be none."""
    require(len(caps) == k0, ("a capture inside the timed frames", caps[k0:]))
    return 1e3 * elapsed / n


def replay_note(res, plain=None) -> str:
    """A latency cell's replay figures: the seconds of its capture frames
    (the first steady frame's eager warm-up and capture); host CUDA API
    calls per frame, busy share and device ms per frame of its profile, and
    of the plain run's if given."""
    parts = [f"capture s {[round(c, 3) for c in res.get('capture_s', [])]}"]
    for what, r in (("", res), ("plain: ", plain)):
        p = r.get("profile") if r else None
        if p:
            parts.append(f"{what}host CUDA API calls per frame {p['api_calls_per_frame']:.1f}, "
                         f"busy {p['busy_share']}, device ms per frame "
                         f"{p['device_ms_per_frame']}")
    return "; ".join(parts)


def frames_record(pipe: VinsPipeline, t_end: float) -> dict:
    """What ``replay_against_plain`` compares, up to the frame at
    ``t_end``: the steady outputs (every ``StepOutput``), the states and the
    generators' states (RANSAC, VO PnP)."""
    return dict(steps=[o for t, o in pipe.estimator._pending if t <= t_end],
                end_state=bp.map_tree(torch.clone, (pipe.tracker_state, pipe.estimator.state)),
                generators=[pipe._generator.get_state(),
                            pipe.estimator.pnp_generator.get_state()])


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal dtype, shape and bytes (NaN payloads included)."""
    def bits(a):
        return a.detach().reshape(-1).contiguous().view(torch.uint8)
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))


def replay_against_plain(plain: dict, replay: dict) -> dict:
    """The replayed frames against the plain per-op frames of the same
    stream (``frames_record`` of each): every field of every output, the
    end states and the generators, bit for bit, with the first differing
    leaf named (the output's frame and field, or the state leaf)."""
    def max_abs(u, v):
        return float((u.double() - v.double()).abs().max()) if u.shape == v.shape else None

    a, b = plain["steps"], replay["steps"]
    out_diff = dict(outputs=(len(a), len(b))) if len(a) != len(b) else next(
        (dict(output=k, field=f, max_abs=max_abs(getattr(x, f), getattr(y, f)))
         for k, (x, y) in enumerate(zip(a, b)) for f in est.StepOutput._fields
         if not same_bits(getattr(x, f), getattr(y, f))), None)
    state_diff = next((dict(state_leaf=i, shape=list(u.shape), max_abs=max_abs(u, v))
                       for i, (u, v) in enumerate(zip(bp.leaves(plain["end_state"]),
                                                      bp.leaves(replay["end_state"])))
                       if not same_bits(u, v)), None)
    gens = all(torch.equal(g, h) for g, h in zip(plain["generators"], replay["generators"]))
    return dict(outputs=len(b), outputs_equal=out_diff is None, states_equal=state_diff is None,
                generators_equal=gens,
                bit_equal=out_diff is None and state_diff is None and gens,
                first_difference=out_diff or state_diff)


def run_latency_path(device, n_frames: int = 112, warmup: int = 16, W: int = 640,
                     H: int = 480, max_cnt: int = 130, profile: int = 0, path=None,
                     revisit: bool = False, camera: str = "", degrade=None,
                     workdir: str = OUT_DIR, replay: bool = True, record: bool = False):
    """bench.py run_latency with BENCH_LAT_LOOP=0 on the port: one stream
    (make_trajectory seed 7), frames rendered on the device first, the
    fused steady state with no read-back per frame (eager_outputs off,
    failure check every 10**9 frames) and the envelope (LM 2 iterations,
    LK 12/6), its steady frames replayed (``replay=False``: dispatched op
    by op, the plain version).  The first steady frame (its warm-up and
    capture) is timed apart (``capture_s``) and must fall before the timed
    frames.  ``profile`` more frames run under the
    profiler afterwards.  With ``record``, the result's ``record`` is what
    ``replay_against_plain`` compares, up to the last timed frame.
    With ``revisit``, the loop cell's scene and configuration but no pose
    graph: fast relocalization on, its constraint never active.  With
    ``camera`` (a non-pinhole model type), the rig of ``camera_config``
    written to a rig file by ``rig_yaml`` and read back by ``load_config``,
    the frames rendered through its ray grid.  With ``degrade`` (a
    ``SensorDegradation``), the frames of ``frames_degraded`` (seed 1), the
    bound of ``tests/test_dynamic_scene.py`` (max(0.08·travelled, 0.12 m))
    and the features flagged dynamic after each frame (``n_dynamic``: the
    estimator's own per-step count, read once at the end, so the timed
    frames run what phase 7's run)."""
    rig, _, _, _ = slice_config(W, H, max_cnt)
    if revisit:
        seq = revisit_scene(rig, n_frames, profile)
        cfg = dataclasses.replace(loop_config(rig, seq, max_cnt)[0], loop_closure=False)
    else:
        seq = syn.make_trajectory(n_frames + profile, rig, seed=7, omega_scale=0.15,
                                  acc_scale=0.3)
        cfg = latency_config(rig, seq, max_cnt)
    rig_file = None
    if camera:
        cfg = camera_config(camera, cfg)
        os.makedirs(workdir, exist_ok=True)
        rig_file = os.path.join(workdir, f"rig_{camera.lower()}.yaml")
        with open(rig_file, "w") as f:
            f.write(rig_yaml(cfg))
        loaded = load_config(rig_file)
        require(loaded == cfg, ("the rig file reads back as its config", loaded, cfg))
        cfg = loaded
        ts, imgs, deps = render_camera(seq, cfg.camera(), device)
    elif degrade is not None:
        frames = list(syn.frames_degraded(seq, rig, degrade, device, seed=1))
        ts = np.asarray([f[0] for f in frames])
        imgs = torch.stack([f[1] for f in frames])
        deps = torch.stack([f[2] for f in frames])
        del frames
    else:
        ts, imgs, deps = syn.render_sequence(seq, rig, device)
    pipe = envelope(VinsPipeline(cfg, device, eager_outputs=False,
                                 failure_check_interval=10 ** 9, fused_steady_state=True,
                                 replay=replay))
    caps = capture_clock(pipe)
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
    k_cap = len(caps)
    t0 = time.perf_counter()
    feed(warmup, n_frames)
    sync()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    n_timed = n_frames - warmup
    ms = timed_ms(elapsed, n_timed, caps, k_cap)
    kept = frames_record(pipe, ts[n_frames - 1]) if record else None
    prof = None
    if profile:
        prof = profile_span(lambda: feed(n_frames, n_frames + profile), SPIN_SPAN, profile,
                            path, ms)
    pipe.close()
    traj = [r for r in pipe.estimator.trajectory if r["t"] <= ts[n_frames - 1]]
    ate = ate_rmse([r["t"] for r in traj], [r["P"] for r in traj], seq.times, seq.P,
                   align=False) if len(traj) >= 5 else float("nan")
    travelled = float(np.sum(np.linalg.norm(np.diff(seq.P[:n_frames], axis=0), axis=1)))
    bound = max(0.08 * travelled, 0.12) if degrade is not None else max(0.05 * travelled, 0.08)
    n_dyn = ([o.n_dynamic[0] for _, o in pipe.estimator._pending] if degrade is not None
             else None)
    return dict(latency_fps=1e3 / ms, latency_ms_per_frame=ms, capture_s=caps,
                replay=replay, record=kept,
                latency_ate_m=ate, bound=bound, frames=n_frames,
                n_records=len(traj), solver_flag_after_warmup=flag, counts=counts,
                profile=prof, rig_file=rig_file,
                camera=type(pipe.cam).__name__,
                n_dynamic=torch.stack(n_dyn).cpu().tolist() if n_dyn else None)


def check_latency_path(res, on_gpu: bool = True) -> None:
    require(res["solver_flag_after_warmup"] == est.VinsEstimator.NON_LINEAR,
            "NON_LINEAR after the warm-up")
    require(np.isfinite(res["latency_ate_m"]) and res["latency_ate_m"] < res["bound"],
            ("latency ATE", res["latency_ate_m"], res["bound"]))
    if on_gpu:  # K1 once per frame, K3 once per pyramid level, never K2
        n = res["frames"]
        require(k1_k3(res["counts"]) == {"fast_nms": n, "lk_level": 0, "lk_iterate": 2 * n},
                ("latency launches", res["counts"]))
        require(res["profile"]["host_syncs"] == 0, "no host wait inside spin_once")
        check_replay_profile(res["profile"], {"fast_nms": 1, "lk_iterate": 2},
                             "the latency path's profile")


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


def revisit_scene(rig, n_frames: int, extra: int = 0, seed: int = 207, imu_seed: int = 307,
                  cycles: int = 2):
    """The bench's loop scene: ``make_revisit_trajectory(n_frames, seed,
    accel 1.5, sideways, 2 cycles)`` with the gyro pulse of ``corrupt_imu
    (imu_seed)``; ``extra`` frames past it keep the scene of the first
    ``n_frames`` (the pulse is placed at the same times); ``cycles`` more
    out-and-back cycles over ``n_frames`` make a longer stream of the same
    period when ``n_frames`` grows with them."""
    n = n_frames + extra
    if n // (4 * cycles) != n_frames // (4 * cycles):
        raise ValueError("extra frames would change the revisit period")
    seq = syn.make_revisit_trajectory(n, rig, seed=seed, accel=1.5, axis=(0.0, 1.0, 0.0),
                                      cycles=cycles)
    s = (n_frames - 1) / (n - 1)  # the pulse fractions of the n_frames scene
    return syn.corrupt_imu(seq, seed=imu_seed, gyr_noise=0.003, gyr_pulse=0.2,
                           pulse_frac=(0.18 * s, 0.3 * s))


def run_loop_path(device, n_frames: int = 112, warmup: int = 16, W: int = 640, H: int = 480,
                  max_cnt: int = 130, max_kp: int = 192, profile: int = 0, path=None,
                  eager: bool = False, vo: bool = False, lockstep: bool = False,
                  replay: bool = True, record: bool = False, trace: bool = False):
    """bench.py run_latency with BENCH_LAT_LOOP=1 on the port: the revisit
    scene rendered on the device first, the fused steady state with no
    read-back per frame, the envelope, and the pose graph on the
    ``AsyncLoopStager``'s worker (with ``eager``, inline in each frame's
    ``spin_once``, every frame read back).  The launch counters are zeroed
    after the warm-up and the stager's warm-up, just before the timed
    frames; ``profile`` frames (async only) run under the profiler after.
    ``relo_consumed`` counts the relocalizations the worker fed back to
    the graph by the end of the timed frames' drain.
    With ``vo``, VO mode (``vo_config``: no IMU pushed, cold LK on 4
    levels, PnP pose init, the 6-DoF graph).  With ``lockstep`` the frame
    thread waits for the worker after each hand-over (then one per frame),
    so a loop's relocalization reaches the estimator at a fixed frame and
    the run does not depend on thread timing (the CPU rehearsals, and the
    card's comparison of replayed and plain frames).  The steady frames are
    replayed (``replay=False``: dispatched op by op); the first (its
    warm-up and capture) is timed apart and must fall before the timed
    frames.
    The result keeps the pose graph (``graph``), the scene (``scene``) and,
    with ``record``, what ``replay_against_plain`` compares (``record``).
    With ``trace`` the timed frames run with the port's tracer on, and
    ``worker_s`` holds the worker's seconds by ``loop::`` span."""
    rig, _, _, _ = slice_config(W, H, max_cnt)
    seq = revisit_scene(rig, n_frames, profile)
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    cfg, pg_cfg = (vo_config if vo else loop_config)(rig, seq, max_cnt, max_kp)
    pipe = envelope(VinsPipeline(cfg, device, eager_outputs=eager,
                                 failure_check_interval=10 ** 9, fused_steady_state=True,
                                 pose_graph_config=pg_cfg, replay=replay))
    caps = capture_clock(pipe)
    graph = pipe.pose_graph
    stager = pipe._loop_stager  # None with eager
    consumed = []  # relocalizations the worker fed back to the graph
    if stager is not None:
        consume_relo = stager._consume_relo

        def counted(p, prev):
            consumed.append(stager._relo_sent_kf)
            consume_relo(p, prev)

        stager._consume_relo = counted
    for (t, a, g) in ([] if vo else seq.imu):
        pipe.push_imu(t, a, g)

    def feed(k0, k1):
        for k in range(k0, k1):
            pipe.push_image(ts[k], imgs[k])
            pipe.push_depth(ts[k], deps[k])
            pipe.spin_once()
            if lockstep and stager is not None and not stager.pending:
                stager.drain()  # a batch was just handed over: wait for it

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    try:
        feed(0, warmup)
        flag = pipe.estimator.solver_flag
        pipe.drain()
        if stager is not None:
            stager.compile_warmup(imgs[0])
        sync()
        kf0, relo0 = len(graph.keyframes), len(consumed)
        loops0 = stager.n_loops if stager is not None else None
        reset_counts()
        k_cap = len(caps)
        with traced() if trace else contextlib.nullcontext() as snap:
            t0 = time.perf_counter()
            feed(warmup, n_frames)
            pipe.drain()
            sync()
            elapsed = time.perf_counter() - t0
        counts = read_counts()
        n_timed = n_frames - warmup
        ms = timed_ms(elapsed, n_timed, caps, k_cap)
        kept = frames_record(pipe, ts[n_frames - 1]) if record else None
        kf_timed = len(graph.keyframes) - kf0
        relo_timed = len(consumed) - relo0 if stager is not None else None
        loops_timed = stager.n_loops - loops0 if stager is not None else None
        stages = ({k: v[0] for k, v in TRACER.delta(snap)["spans"].items()
                   if k.startswith("loop::")} if trace and stager is not None else None)
        prof = None
        if profile and stager is not None:
            def busy_feed():
                # the worker runs a loop check on a clone of the graph meanwhile
                # (extraction, a query, PnP, a PGO), so its waits overlap the span
                stager._worker.put(lambda: stager._warmup(imgs[0]))
                feed(n_frames, n_frames + profile)

            prof = profile_span(busy_feed, SPIN_SPAN, profile, path, ms)
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
    return dict(latency_fps=1e3 / ms, latency_ms_per_frame=ms, capture_s=caps,
                replay=replay, record=kept,
                latency_ate_m=ate([r["t"] for r in traj], [r["P"] for r in traj]),
                latency_loop_ate_m=ate([p[0] for p in path_c], [p[1] for p in path_c]),
                latency_vio_kf_ate_m=ate([k.t for k in kfs], [k.P_vio for k in kfs]),
                latency_kf=len(kfs), latency_loops=len([lp for lp in graph.loops
                                                        if lp["cur"] < len(kfs)]),
                loops=[(lp["cur"], lp["old"], lp["n_inliers"]) for lp in graph.loops],
                bound=max(0.05 * travelled, 0.08), frames=n_frames, timed=n_timed,
                kf_timed=kf_timed, solver_flag_after_warmup=flag, counts=counts,
                loops_timed=loops_timed, relo_consumed=relo_timed, relo_keyframes=consumed,
                max_round=stager.max_round if stager is not None else None, worker_s=stages, profile=prof, vo=vo,
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
        require(k1_k3(res["counts"]) == {"fast_nms": n + res["kf_timed"], "lk_level": 0,
                                         "lk_iterate": res["lk_levels"] * n},
                ("loop-path launches", res["counts"]))
    if res["profile"] is not None:
        require(res["profile"]["host_syncs"] == 0,
                ("no host wait on the frame thread", res["profile"]["host_sync_calls"]))


def verify_replay_against_plain(graph) -> dict:
    """The loop check (``pose_graph.verify_row``) of the graph's last loop,
    replayed from a graph captured here, against the same check dispatched
    op by op on the same inputs, bit for bit."""
    lp = graph.loops[-1]
    inputs = graph._verify_inputs(graph.keyframes[lp["cur"]], graph.keyframes[lp["old"]])
    gates = (float(graph.cfg.match_thresh), int(graph.cfg.min_loop_num))
    replayed = pg.verify_row(inputs, *gates, {}).clone()
    plain = pg._verify_row(*inputs, *gates)
    return dict(bit_equal=same_bits(replayed, plain),
                max_abs=float((replayed.double() - plain.double()).abs().max()))


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


def realsense_scene(n_frames: int, W: int = 640, H: int = 480, seed: int = 7):
    """Phase 12's rig, stream (the latency cell's, seed 7; phase 20b's lanes
    take seeds 7-14) and knobs (``td_config``) at W×H: (rig, seq, cfg)."""
    rig, _, _, _ = slice_config(W, H, 30)
    seq = syn.make_trajectory(n_frames, rig, seed=seed, omega_scale=0.15, acc_scale=0.3)
    return rig, seq, td_config(rig, seq)


def openloris_scene(n_frames: int, W: int = 848, H: int = 480, seed: int = 7):
    """Phase 13's rig, stream and knobs at W×H: (rig, seq, cfg).  The
    stream is ``make_trajectory`` (seed 7, moving from frame 0; phase 20's
    lanes take seeds 7-14) with motion enough for the excitation check of
    dynamic initialization (the std of the window's accelerations above
    0.25 m/s², which the latency cell's gentler motion fails)."""
    rig = openloris_rig(W, H)
    seq = syn.make_trajectory(n_frames, rig, seed=seed, omega_scale=0.3, acc_scale=2.0)
    return rig, seq, openloris_config(rig, seq)


def angle_deg(R_a, R_b) -> float:
    """The angle of R_aᵀ·R_b in degrees."""
    c = (np.trace(np.asarray(R_a).T @ np.asarray(R_b)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@contextlib.contextmanager
def recorded_inits(attempts: list):
    """While inside, every ``init_dynamic``/``init_mono`` attempt of a
    B = 1 estimator appends (program name, ok) to ``attempts``."""
    progs = {name: getattr(est, name) for name in ("init_dynamic", "init_mono")}

    def recorded(name):
        def run(*args):
            res = progs[name](*args)
            attempts.append((name, bool(res[2][0])))  # the estimator reads it next
            return res
        return run

    for name in progs:
        setattr(est, name, recorded(name))
    try:
        yield attempts
    finally:
        for name, fn in progs.items():
            setattr(est, name, fn)


def truth_bound(dynamic: bool, mono: bool, d_gt: float, travelled: float) -> float:
    """What a rig's stream is held to against the truth (phases 12-13b, 20,
    20b): after a dynamic initialization the relative motion from the first
    output to the last within max(0.1·d, 0.08 m) of the truth's d (after
    ``init_mono``, max(0.15·d, 0.1 m)); after the static one the unaligned
    ATE under max(0.05·travelled, 0.08 m)."""
    if dynamic:
        return max(0.15 * d_gt, 0.1) if mono else max(0.1 * d_gt, 0.08)
    return max(0.05 * travelled, 0.08)


def lane_accuracy(times, Ps, seq, dynamic: bool, mono: bool) -> dict:
    """A stream's outputs (``times``, positions ``Ps``) against the truth:
    the relative motion from the first output to the last (a dynamic
    initialization anchors its world at the window's first frame), the
    unaligned and aligned ATE, and the error ``truth_bound`` reads (the
    relative motion's or the ATE) beside that bound."""
    Ps = np.asarray(Ps, np.float64).reshape(-1, 3)
    n = len(times)
    k_first = int(np.argmin(np.abs(seq.times - times[0]))) if n else 0
    k_last = int(np.argmin(np.abs(seq.times - times[-1]))) if n else 0
    d_gt = float(np.linalg.norm(seq.P[k_last] - seq.P[k_first]))
    d_est = float(np.linalg.norm(Ps[-1] - Ps[0])) if n else float("nan")
    ate, aligned = ((ate_rmse(times, Ps, seq.times, seq.P, align=a) for a in (False, True))
                    if n >= 5 else (float("nan"), float("nan")))
    travelled = float(np.sum(np.linalg.norm(np.diff(seq.P[:k_last + 1], axis=0), axis=1)))
    err = abs(d_est - d_gt) if dynamic else ate
    return dict(d_est=d_est, d_gt=d_gt, ate_m=ate, aligned_ate_m=aligned, err=float(err),
                bound=truth_bound(dynamic, mono, d_gt, travelled))


def rig_lane(device, cfg: VinsConfig, seq, depthless: bool = False, imu_shift: float = 0.0,
             failure_check_interval: int = 10 ** 9, fused: bool = True,
             dtype=torch.float32, replay: bool = True) -> dict:
    """One stream's ``VinsPipeline`` with a rig's knobs (phases 12-13b and
    the lanes of 20 and 20b): the envelope, no read-back per frame but the
    failure check every ``failure_check_interval`` frames and the td
    refresh, its IMU stamps shifted by ``imu_shift`` (a known td); with
    ``depthless`` every depth image before the estimator initializes is
    withheld as zeros, so only the monocular program can; ``replay=False``
    dispatches the steady frames op by op.  ``feed_lane`` feeds it."""
    pipe = envelope(VinsPipeline(cfg, device, dtype, eager_outputs=False,
                                 failure_check_interval=failure_check_interval,
                                 fused_steady_state=fused, replay=replay))
    for (t, a, g) in seq.imu:
        pipe.push_imu(t + imu_shift, a, g)
    return dict(pipe=pipe, ric=seq.ric, depthless=depthless, fed=0, attempts=[],
                init_frame=None, calib_frame=None, calib_err_deg=None)


def feed_lane(lane: dict, ts, imgs, deps, k1: int, stop_at_init: bool = False) -> None:
    """Frames [``lane['fed']``, k1) into the lane's pipeline (``rig_lane``),
    recording every initialization attempt (program, ok), the frame of
    initialization and the frame the extrinsic calibration ended, if it
    did; with ``stop_at_init`` up to the frame of initialization."""
    pipe = lane["pipe"]
    e = pipe.estimator
    no_depth = torch.zeros_like(deps[0])
    with recorded_inits(lane["attempts"]):
        for k in range(lane["fed"], k1):
            withheld = lane["depthless"] and e.solver_flag != e.NON_LINEAR
            pipe.push_image(float(ts[k]), imgs[k])
            pipe.push_depth(float(ts[k]), no_depth if withheld else deps[k])
            pipe.spin_once()
            lane["fed"] = k + 1
            if e.vcfg.estimate_extrinsic == 2 and lane["calib_frame"] is None \
                    and not e._ex_calibrating:
                lane["calib_frame"] = k
                lane["calib_err_deg"] = angle_deg(quat_np_R(e.state.x.qic[0]), lane["ric"])
            if lane["init_frame"] is None and e.solver_flag == e.NON_LINEAR:
                lane["init_frame"] = k
                if stop_at_init:
                    return


def run_rig_path(device, cfg: VinsConfig, rig, seq, n_frames: int = 112, warmup: int = 16,
                 profile: int = 0, path=None, fused: bool = True,
                 failure_check_interval: int = 10 ** 9, imu_shift: float = 0.0,
                 depthless: bool = False, replay: bool = True):
    """One stream through ``VinsPipeline`` with a rig's knobs (phases 12,
    12b, 13 and 13b; ``rig_lane``): frames rendered on the device first,
    ``warmup`` frames, then the timed ones (CUDA-synchronised wall time)
    with the launch counters zeroed before the warm-up, then ``profile``
    frames under the profiler.  The first steady frame (its warm-up and
    capture) is timed apart (``capture_s``) and must fall before the timed
    frames.  Returns what ``feed_lane`` records and the
    stream's accuracy (``lane_accuracy``)."""
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    lane = rig_lane(device, cfg, seq, depthless, imu_shift, failure_check_interval, fused,
                    replay=replay)
    pipe = lane["pipe"]
    caps = capture_clock(pipe)
    e = pipe.estimator

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    reset_counts()
    feed_lane(lane, ts, imgs, deps, warmup)
    flag = e.solver_flag
    sync()
    k_cap = len(caps)
    t0 = time.perf_counter()
    feed_lane(lane, ts, imgs, deps, n_frames)
    sync()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    tracked = pipe._frame_idx  # the frames the pairer's rate gate let through
    prof = None
    n_timed = n_frames - warmup
    ms = timed_ms(elapsed, n_timed, caps, k_cap)
    if profile:
        prof = profile_span(lambda: feed_lane(lane, ts, imgs, deps, n_frames + profile),
                            SPIN_SPAN, profile, path, ms)
    pipe.close()
    traj = [r for r in e.trajectory if r["t"] <= ts[n_frames - 1]]
    acc = lane_accuracy([r["t"] for r in traj], [r["P"] for r in traj], seq,
                        not cfg.static_init, depthless)
    return dict(latency_fps=1e3 / ms, latency_ms_per_frame=ms, capture_s=caps,
                latency_ate_m=acc.pop("ate_m"), **acc, frames=n_frames, tracked=tracked,
                timed=n_timed, n_records=len(traj), solver_flag_after_warmup=flag,
                init_frame=lane["init_frame"], attempts=lane["attempts"],
                calib_frame=lane["calib_frame"], calib_err_deg=lane["calib_err_deg"],
                calibrating=e._ex_calibrating,
                ric_err_deg=angle_deg(quat_np_R(e.state.x.qic[0]), seq.ric),
                td=float(e.state.x.td[0]), td_cache=e._td_cache, counts=counts, profile=prof)


def quat_np_R(q: torch.Tensor) -> np.ndarray:
    """A (4,) wxyz quaternion tensor -> its rotation matrix (numpy float64)."""
    return syn._q2R(q.detach().cpu().double().numpy())


def check_rig_path(res, init_by: int = 16, on_gpu: bool = True, waits: int = 0) -> None:
    """Phases 12-13b: initialized by frame ``init_by`` - 1, finite td within
    50 ms, the stream's error against the truth under ``truth_bound``'s
    bound.  On the card: K1 once and K3 twice per tracked frame (the rig's
    frontend rate gate drops the stream's second frame), K2 never, and at
    most ``waits`` host waits on the frame thread in the profile."""
    require(res["init_frame"] is not None and res["init_frame"] < init_by,
            ("initialized", res["init_frame"], res["attempts"]))
    require(np.isfinite(res["td"]) and abs(res["td"]) < 0.05, ("td", res["td"]))
    require(np.isfinite(res["err"]) and res["err"] < res["bound"],
            ("accuracy against the truth", res["err"], res["bound"], res["d_est"], res["d_gt"],
             res["latency_ate_m"]))
    if on_gpu:
        n = res["tracked"]
        require(n >= res["frames"] - 1 and k1_k3(res["counts"]) == {
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


def stage_batched_loop_path(device, B: int = 8, n_frames: int = 212, seg_len: int = 18,
                            W: int = 640, H: int = 480, max_cnt: int = 130, max_kp: int = 192,
                            k_pad: int = 32, vo: bool = False) -> dict:
    """bench.py run_batched with BENCH_LOOP=1 up to its timed segments: B
    sequences (half of them revisits with a gyro pulse) rendered on the
    device, frames 0-10 through the runner's warm-up, an unrecorded run of
    frames 11-13, then segments of ``seg_len`` frames from frame 14 staged
    and the first of them (the warm one) run.  What ``run_batched_loop_path``
    starts each of its modes from: the runner (its frame captured), the
    states and the lane generators' states after the warm segment, and its
    outputs.  With ``vo`` batched VO (``vo_batched_config``: no IMU staged,
    cold LK on 4 levels) and 6-DoF graphs."""
    rig, tcfg, ecfg, cam = (vo_batched_config if vo else slice_config)(W, H, max_cnt)
    n_revisit = B // 2
    seqs = batched_loop_scene(rig, B, n_frames, n_revisit)
    rendered = [syn.render_sequence(s, rig, device) for s in seqs]
    ts = [r[0] for r in rendered]
    imgs = [r[1] for r in rendered]
    deps = [r[2] for r in rendered]
    bufs = None  # VO: empty intervals
    if not vo:
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
    del rendered, imgs, deps  # the staged batches hold the frames
    runner = bp.BatchedVioRunner(tcfg, cam, ecfg, device, B)
    trk, st = runner.init_states(np.stack([s.ric for s in seqs]), np.stack([s.tic for s in seqs]))
    pg_cfg = PoseGraphConfig(max_kp=max_kp, max_wp=ecfg.maxf, recency_exclusion=8,
                             score_best=0.08, score_second=0.02, pad_nodes_min=128,
                             pad_edges_min=1024, use_6dof=vo)
    trk, st, _ = runner.warm(trk, st, warm_batch)
    trk, st, _ = runner.run(trk, st, pre_batch)
    trk, st, outs_w = runner.run(trk, st, batches[0])
    return dict(B=B, seqs=seqs, ts=ts, batches=batches, runner=runner, start=(trk, st),
                generators=generator_states(runner), outs_w=outs_w, cam=cam, pg_cfg=pg_cfg,
                k_pad=k_pad, n_revisit=n_revisit, n_frames=n_frames, seg_len=seg_len,
                warmup=warmup, n_seg=n_seg, vo=vo)


@contextlib.contextmanager
def closer_reads():
    """Within it, the reads of ``HostCopy`` on the calling thread are
    counted (``reads``), with those that found their copy still running on
    the device (``waited``) and the seconds they waited (``wait_s``)."""
    tally = dict(reads=0, waited=0, wait_s=0.0)
    get, thread = HostCopy.get, threading.get_ident()

    def counted(self):
        if threading.get_ident() != thread:
            return get(self)
        tally["reads"] += 1
        if self._event is None or self._event.query():
            return get(self)
        t0 = time.perf_counter()
        out = get(self)
        tally["waited"] += 1
        tally["wait_s"] += time.perf_counter() - t0
        return out

    HostCopy.get = counted
    try:
        yield tally
    finally:
        HostCopy.get = get


def disjoint_outputs(outs, others) -> bool:
    """Whether no leaf of the ``ScanOutputs`` ``outs`` shares memory with a
    tensor of the trees ``others``."""
    held = {a.untyped_storage().data_ptr() for a in bp.leaves(others)}
    return not held & {a.untyped_storage().data_ptr() for a in bp.leaves(outs)}


def run_batched_loop_path(device, B: int = 8, n_frames: int = 212, seg_len: int = 18,
                          W: int = 640, H: int = 480, max_cnt: int = 130, max_kp: int = 192,
                          k_pad: int = 32, profile: int = 0, path=None,
                          mode: str = "threaded", vo: bool = False,
                          keep_segments: bool = False, staged=None):
    """bench.py run_batched with BENCH_LOOP=1 on the port: from
    ``stage_batched_loop_path`` (or ``staged``, its result: the runner's
    generators are set back to their states after the warm segment, so
    every mode sees the same frames), a fresh closer takes the warm
    segment (``consume`` and the closer's warm-up), then the other segments
    are timed to the end of the closer's drain and a device
    synchronisation, driven by ``mode`` as bench.py drives them:
    "threaded" ``ThreadedLoopCloser`` (``submit`` after each ``run``),
    "pipelined" (``BENCH_THREAD=0``) ``pack_dispatch`` and
    ``pipeline_advance_packed`` after each ``run`` and ``pipeline_drain``
    at the end, "inline" (``BENCH_OVERLAP=0``) the serial ``consume`` after
    each ``run``; "none" runs no closer (no loop metrics).  The launch
    counters are zeroed just before the timed segments.  "pipelined" counts
    the closer's host reads on the frame thread that waited for the device
    (``closer_reads``) and holds each segment's ``ScanOutputs`` to be its
    own: no memory shared with the runner's buffers or the next segment's,
    and unchanged by the later segments.  With ``profile`` n > 0
    ("threaded"), the first n frames of the last segment run again under
    the profiler after (from the runner state it started from), ``run``
    then ``submit``, while a second threaded closer (a clone of the first,
    fresh gates) advances the earlier segments submitted to it just before.
    ``keep_segments`` returns every segment's (FrameBatch, ScanOutputs) too,
    the warm one first."""
    if staged is None:
        staged = stage_batched_loop_path(device, B, n_frames, seg_len, W, H, max_cnt, max_kp,
                                         k_pad, vo)
    B, seqs, ts, batches = staged["B"], staged["seqs"], staged["ts"], staged["batches"]
    runner, n_seg, seg_len = staged["runner"], staged["n_seg"], staged["seg_len"]
    n_revisit, warmup, n_frames, vo = (staged[k] for k in ("n_revisit", "warmup", "n_frames",
                                                            "vo"))
    t_end = warmup + n_seg * seg_len
    set_generator_states(runner, staged["generators"])
    trk, st = staged["start"]
    outs_w = staged["outs_w"]
    closer = BatchedLoopCloser(staged["cam"], seqs[0].ric, seqs[0].tic, B, device,
                               staged["pg_cfg"], skip_dis=0.0, k_pad=staged["k_pad"], seq_pad=32,
                               db_capacity=128, pgo_period=2.0)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    if mode != "none":
        closer.consume(batches[0], outs_w)
    tc = ThreadedLoopCloser(closer) if mode == "threaded" else None
    reads, own_outputs = None, None
    try:
        if tc is not None:
            tc.compile_warmup(batches[0], outs_w)
        elif mode in ("inline", "pipelined"):
            closer.compile_warmup(batches[0], outs_w)
        sync()
        kf0, loops0, chunks0 = closer.n_keyframes, closer.n_loops, closer.n_chunks
        reset_counts()
        snaps, disjoint = [], []
        with (closer_reads() if mode == "pipelined" else contextlib.nullcontext()) as reads:
            t0 = time.perf_counter()
            outs_all, stats = [outs_w], []
            for k in range(1, n_seg):
                last_state = (trk, st)  # the profile reruns the last segment from here
                trk, st, outs = runner.run(trk, st, batches[k])
                if tc is not None:
                    tc.submit(batches[k], outs)
                elif mode == "inline":
                    stats.append(closer.consume(batches[k], outs))
                elif mode == "pipelined":
                    # the gating read of segment k waits until k + 1 is dispatched
                    stats.append(closer.pipeline_advance_packed(closer.pack_dispatch(batches[k],
                                                                                     outs)))
                    prog = runner._prog
                    disjoint.append(disjoint_outputs(outs, (outs_all[-1], prog.out, prog.trk,
                                                            prog.st, prog.inp)))
                    snaps.append((outs.P.clone(), outs.is_keyframe.clone()))
                outs_all.append(outs)
            if mode != "pipelined":
                sync()  # every segment's frames done (bench.py's drain follows a block)
            t_drain = time.perf_counter()
            if tc is not None:
                stats = tc.drain()
            elif mode in ("inline", "pipelined"):
                # the deferred appends and the last PGO wake-up; the stages in flight
                stats += closer.pipeline_drain()
                stats = [s for s in stats if s is not None and s["n_keyframes"]]
            sync()
            t1 = time.perf_counter()
        counts = read_counts()
        chunks = closer.n_chunks - chunks0
        if mode == "pipelined":  # each segment's outputs are its own and stay as they were
            own_outputs = all(disjoint) and all(
                torch.equal(P, o.P) and torch.equal(kf, o.is_keyframe)
                for (P, kf), o in zip(snaps, outs_all[1:]))
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
    return dict(B=B, mode=mode, n_timed=n_timed, n_revisit=n_revisit,
                seq_frames_per_s=B * n_timed / elapsed,
                ms_per_frame=1e3 * elapsed / n_timed, drain_tail_ms=1e3 * (t1 - t_drain),
                loop_kf=closer.n_keyframes - kf0, loops_found=closer.n_loops - loops0,
                loop_ate_m=float(np.mean(lates)) if lates else float("nan"),
                loop_vio_ate_m=float(np.mean(vlates)) if vlates else float("nan"),
                ates=ates, bounds=bounds, ate_m=float(np.mean(ates)), ate_max_m=float(np.max(ates)),
                cost=cost, counts=counts, chunks=chunks, stage_ms=stage_ms,
                segments_with_keyframes=len(stats),
                loops=[[(lp["cur"], lp["old"], lp["n_inliers"]) for lp in g.loops]
                       for g in closer.graphs],
                rel_t=[[[float(v) for v in lp["rel_t"]] for lp in g.loops]
                       for g in closer.graphs],
                keyframes=[len(g.keyframes) for g in closer.graphs],
                keyframe_times=[[k.t for k in g.keyframes] for g in closer.graphs],
                closer_reads=reads, own_outputs=own_outputs, profile=prof, vo=vo,
                levels=runner.tcfg.pyr_levels_cold if vo else runner.tcfg.pyr_levels_predicted,
                solves_6dof=sum(g.n_solves_6dof for g in closer.graphs),
                segments=list(zip(batches, outs_all)) if keep_segments else None)


def check_batched_loop_path(res, on_gpu: bool = True) -> None:
    """Phase 10's checks, and phase 15b's with VO: there the loop-corrected
    keyframe ATE within 5 mm above the VO keyframes' (VO on clean frames
    barely drifts), at least one 6-DoF solve and K2 on 4 levels."""
    require(np.all(np.isfinite(res["cost"])), "non-finite cost")
    for b, (ate, bound) in enumerate(zip(res["ates"], res["bounds"])):
        require(np.isfinite(ate) and ate < bound, ("clean-sequence ATE", b, ate, bound))
    require(res["loops_found"] >= 1, ("loops found in the timed segments", res["loops"]))
    for k in ("loop_ate_m", "loop_vio_ate_m"):
        require(np.isfinite(res[k]), (k, res[k]))
    slack = 0.005 if res["vo"] else 0.0
    require(res["loop_ate_m"] <= res["loop_vio_ate_m"] + slack,
            ("loop-corrected keyframe ATE above the VIO one", res["loop_ate_m"],
             res["loop_vio_ate_m"]))
    if res["vo"]:
        require(res["solves_6dof"] >= 1, ("6-DoF solves", res["solves_6dof"]))
    if on_gpu:  # K1 per frame and per extraction chunk, K2 per level, never K3
        n = res["n_timed"]
        require(k1_k3(res["counts"]) == {"fast_nms": n + res["chunks"],
                                         "lk_level": res["levels"] * n, "lk_iterate": 0},
                ("batched-loop launches", res["counts"], res["chunks"]))
    if res["profile"] is not None:
        prof = res["profile"]
        require(prof["host_syncs"] == 0,
                ("no host wait on the frame thread", prof["host_sync_calls"]))
        # replayed frames: K2 per level as counted; K1 once per frame, and
        # again per extraction chunk on the closers' worker
        seen = {k: prof["by_kernel"][k]["launches_per_frame"] for k in KERNELS}
        require(seen["lk_level"] == res["levels"] and seen["fast_nms"] >= 1
                and seen["lk_iterate"] == 0, ("kernels traced per replayed frame", seen))


def compare_closer_modes(runs: dict) -> dict:
    """Phase 23: each mode's closer against the first mode's, per lane:
    the same keyframes (by stamp), the same loops as (cur, old) pairs and
    each loop's ``rel_t`` within 5e-5 m (JAX's tolerances between its
    modes, ``tests/test_batched_loop.py:126-131,145-146``), and whether
    the VIO costs are the same bits."""
    ref = next(iter(runs.values()))

    def pairs(r):
        return [[(c, o) for c, o, _ in lane] for lane in r["loops"]]

    out = {}
    for mode, r in runs.items():
        diffs = [float(np.max(np.abs(np.subtract(a, b))))
                 for la, lb in zip(r["rel_t"], ref["rel_t"]) for a, b in zip(la, lb)]
        out[mode] = dict(keyframes_equal=r["keyframe_times"] == ref["keyframe_times"],
                         loops_equal=pairs(r) == pairs(ref),
                         rel_t_max_diff=max(diffs, default=0.0),
                         vio_cost_bits_equal=bool(np.array_equal(r["cost"], ref["cost"])))
    return out


# ---------------------------------------------------------------------------
# phases 22-22c: the failure reboot of the latency pipeline (bench.py
# run_recovery)
# ---------------------------------------------------------------------------

RECOVERY_AT, RECOVERY_N = 40, 3  # bench.py run_recovery's burst of black frames


def recovery_config(rig, seq, max_cnt: int = 0, vo: bool = False) -> VinsConfig:
    """bench.py run_recovery's configuration (``_cfg``: the latency
    cell's); with ``vo`` the TUM rig's VO knobs (``vo_config``) without the
    pose graph."""
    if vo:
        return dataclasses.replace(vo_config(rig, seq, max_cnt or 250)[0], loop_closure=False,
                                   fast_relocalization=False)
    return latency_config(rig, seq, max_cnt or 130)


@contextlib.contextmanager
def counted_captures(frame: list):
    """Within it, each ``native.capture`` (a steady frame's program, or the
    pose graph's loop check) adds the frame ``frame[0]`` to the yielded
    list."""
    caps, capture = [], native.capture

    def counted(*args, **kwargs):
        caps.append(frame[0])
        return capture(*args, **kwargs)

    native.capture = counted
    try:
        yield caps
    finally:
        native.capture = capture


def reboot_frames(flags: list, burst_at: int):
    """(the frame that saw the failure: the first from ``burst_at`` whose
    solver flag is not NON_LINEAR, the first frame after it that is
    NON_LINEAR again); None where there is none."""
    nl = est.VinsEstimator.NON_LINEAR
    seen = next((k for k in range(burst_at, len(flags)) if flags[k] != nl), None)
    back = None if seen is None else next(
        (k for k in range(seen, len(flags)) if flags[k] == nl), None)
    return seen, back


def run_recovery_path(device, n_frames: int = 80, W: int = 640, H: int = 480,
                      max_cnt: int = 0, vo: bool = False, replay: bool = True,
                      record: bool = False, profile: int = 0, path=None) -> dict:
    """bench.py run_recovery on the port: ``make_trajectory(80, seed 7,
    omega 0.15, acc 0.3)`` on ``slice_config``'s rig rendered on the device,
    ``VinsPipeline(eager_outputs=False, failure_check_interval=1,
    fused_steady_state=True)`` with the envelope, black frames
    (``torch.zeros_like``) at frames 40-42; each frame ended by a device
    synchronisation and read as bench.py reads it: the steady fps over the
    NON_LINEAR frames 16-39, the frame that sees the failure, and the
    frames and ms from it until NON_LINEAR again.  With ``vo`` the TUM rig's
    VO knobs (``recovery_config``); ``replay=False`` dispatches the steady
    frames op by op.  Per frame the solver flag and the steady frame's
    graph (``graph_of``), the frame of each capture (``counted_captures``);
    the outputs before the burst against the truth (``lane_accuracy``: the
    unaligned ATE and ``truth_bound``) and those after the reboot (the
    relative motion from the first to the last: printed, not gated, as the
    re-initialization is static on a moving stream); ``profile`` more
    frames under the profiler after the run (its host waits on the frame
    thread: the failure check reads a value back every frame, as JAX's
    does); with ``record``, what ``replay_against_plain`` compares."""
    rig, _, _, _ = slice_config(W, H, max_cnt or 130)
    seq = syn.make_trajectory(n_frames + profile, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    cfg = recovery_config(rig, seq, max_cnt, vo)
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    black = torch.zeros_like(imgs[0])
    pipe = envelope(VinsPipeline(cfg, device, eager_outputs=False, failure_check_interval=1,
                                 fused_steady_state=True, replay=replay))
    for (t, a, g) in (seq.imu if cfg.imu else []):
        pipe.push_imu(t, a, g)
    e = pipe.estimator
    on_cuda = torch.device(device).type == "cuda"
    nl = est.VinsEstimator.NON_LINEAR

    def feed(k, img):
        pipe.push_image(ts[k], img)
        pipe.push_depth(ts[k], deps[k])
        pipe.spin_once()

    frame, flags, graphs = [0], [], []
    steady_t, steady_n = 0.0, 0
    fail_seen_at = recover_t0 = recover_ms = None
    recover_frames = 0
    reset_counts()
    with counted_captures(frame) as caps:
        for k in range(n_frames):
            frame[0] = k
            t0 = time.perf_counter()
            feed(k, black if RECOVERY_AT <= k < RECOVERY_AT + RECOVERY_N else imgs[k])
            if on_cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            flags.append(e.solver_flag)
            graphs.append(graph_of(pipe))
            if fail_seen_at is None:  # bench.py:648-665
                if 16 <= k < RECOVERY_AT and e.solver_flag == nl:
                    steady_t += dt
                    steady_n += 1
                if k >= RECOVERY_AT and e.solver_flag != nl:
                    fail_seen_at = k
                    recover_t0 = time.perf_counter() - dt
            elif recover_ms is None:
                recover_frames += 1
                if e.solver_flag == nl:
                    recover_ms = 1e3 * (time.perf_counter() - recover_t0)
    counts = read_counts()
    kept = frames_record(pipe, ts[n_frames - 1]) if record else None
    prof = None
    if profile:
        prof = profile_span(lambda: [feed(k, imgs[k]) for k in range(n_frames, n_frames + profile)],
                            SPIN_SPAN, profile, path, 1e3 * steady_t / max(steady_n, 1))
    pipe.close()
    seen, back = reboot_frames(flags, RECOVERY_AT)
    traj = [r for r in e.trajectory if r["t"] <= ts[n_frames - 1]]
    pre = [r for r in traj if r["t"] < ts[RECOVERY_AT]]
    post = [r for r in traj if seen is not None and r["t"] > ts[seen]]
    acc_pre = lane_accuracy([r["t"] for r in pre], [r["P"] for r in pre], seq, False, False)
    acc_post = lane_accuracy([r["t"] for r in post], [r["P"] for r in post], seq, True, False)
    return dict(recovery_steady_fps=steady_n / steady_t if steady_t else None,
                recovery_triggered=fail_seen_at is not None,
                recovery_frames=recover_frames if recover_ms is not None else None,
                recovery_ms=recover_ms, fail_seen_at=seen, nonlinear_again_at=back,
                flags=flags, captures=caps, graphs=len({id(g) for g in graphs if g is not None}),
                graph_kept=(back is None or graphs[back + 1:] == [graphs[RECOVERY_AT - 1]]
                            * (n_frames - back - 1)),
                pre_burst=acc_pre, post_reboot=acc_post, frames=n_frames, vo=vo, replay=replay,
                levels=pipe.tcfg.pyr_levels_cold if vo else pipe.tcfg.pyr_levels_predicted,
                counts=counts, profile=prof, record=kept)


def check_recovery_path(res, on_gpu: bool = True) -> None:
    """Phases 22 and 22b: the failure seen within the burst, the estimator
    NON_LINEAR again before the last frame and steady after it, the outputs
    before the burst under their truth bound; replayed: one capture, before
    the burst, and the same graph after the reboot as before it (the reset's
    states loaded into its buffers); plain: none.  On the card K1 once and
    K3 once per pyramid level per frame (the black ones too), K2 never, and
    at most the failure check's one host wait per profiled frame."""
    seen, back = res["fail_seen_at"], res["nonlinear_again_at"]
    require(res["recovery_triggered"] and seen is not None
            and RECOVERY_AT <= seen < RECOVERY_AT + RECOVERY_N,
            ("the failure seen within the burst", seen, res["flags"]))
    require(back is not None and back < res["frames"] - 1
            and res["recovery_frames"] == back - seen,
            ("NON_LINEAR again before the last frame", back, res["flags"]))
    nl = est.VinsEstimator.NON_LINEAR
    require(all(f == nl for f in res["flags"][back:]), ("steady after the reboot", res["flags"]))
    pre = res["pre_burst"]
    require(np.isfinite(pre["err"]) and pre["err"] < pre["bound"],
            ("the outputs before the burst against the truth", pre))
    if on_gpu and res["replay"]:
        require(len(res["captures"]) == 1 and res["captures"][0] < RECOVERY_AT
                and res["graphs"] == 1 and res["graph_kept"],
                ("one capture, kept across the reboot", res["captures"], res["graphs"]))
    if not res["replay"]:
        require(res["captures"] == [] and res["graphs"] == 0, ("plain: no capture",
                                                              res["captures"]))
    if on_gpu:
        n = res["frames"]
        require(k1_k3(res["counts"]) == {"fast_nms": n, "lk_level": 0,
                                         "lk_iterate": res["levels"] * n},
                ("recovery launches", res["counts"]))
    if res["profile"] is not None:
        require(res["profile"]["host_syncs"] <= res["profile"]["frames"],
                ("at most the failure check's host wait per frame",
                 res["profile"]["host_sync_calls"]))


def run_loop_recovery_path(device, n_frames: int = 168, warmup: int = 16, W: int = 640,
                           H: int = 480, max_cnt: int = 130, max_kp: int = 192) -> dict:
    """Phase 9's loop cell (the latency-1-loop knobs: loop closure and fast
    relocalization, the pose graph on the ``AsyncLoopStager``'s worker
    thread, the envelope) with the failure check on every frame and
    bench.py's burst of three black frames from the first frame after the
    worker accepted its first loop, on the revisit scene with three cycles
    (phase 9's period, one cycle longer) so the stream goes on past the
    re-initialization.  Records each relocalization constraint a solve took
    (the frame, the estimator's epoch the constraint was made in and the
    one at the solve), the frames where the reset dropped a queued one, and
    those the estimator refused (made from a frame before the reset).  The
    launch counters are zeroed after the warm-up and the stager's warm-up."""
    rig, _, _, _ = slice_config(W, H, max_cnt)
    seq = revisit_scene(rig, n_frames, cycles=3)
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    cfg, pg_cfg = loop_config(rig, seq, max_cnt, max_kp)
    pipe = envelope(VinsPipeline(cfg, device, eager_outputs=False, failure_check_interval=1,
                                 fused_steady_state=True, pose_graph_config=pg_cfg))
    stager, e = pipe._loop_stager, pipe.estimator
    frame, taken, dropped, refused = [0], [], [], []
    take, reset, set_relo = e.take_relo, e.reset, e.set_relo_frame

    def take_relo():
        r = take()
        if r is not None:
            taken.append((frame[0], r["epoch"], e.epoch))
        return r

    def reset_():
        with e._relo_lock:
            pending = e._pending_relo is not None
        if pending:
            dropped.append(frame[0])
        reset()

    def set_relo_frame(*args, **kwargs):
        ok = set_relo(*args, **kwargs)
        if not ok:
            refused.append(frame[0])
        return ok

    e.take_relo, e.reset, e.set_relo_frame = take_relo, reset_, set_relo_frame
    for (t, a, g) in seq.imu:
        pipe.push_imu(t, a, g)
    black = torch.zeros_like(imgs[0])
    flags, burst_at = [], None
    try:
        for k in range(n_frames):
            frame[0] = k
            if k == warmup:
                pipe.drain()
                stager.compile_warmup(imgs[0])
                kf0 = stager.n_keyframes
                reset_counts()
            if burst_at is None and k > warmup and stager.n_loops >= 1:
                burst_at = k
            burst = burst_at is not None and k < burst_at + RECOVERY_N
            pipe.push_image(ts[k], black if burst else imgs[k])
            pipe.push_depth(ts[k], deps[k])
            pipe.spin_once()
            flags.append(e.solver_flag)
        pipe.drain()  # raises the worker's exception, if any
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        counts = read_counts()
    finally:
        pipe.close()
    seen, back = reboot_frames(flags, burst_at) if burst_at is not None else (None, None)
    graph = pipe.pose_graph
    return dict(frames=n_frames, timed=n_frames - warmup, burst_at=burst_at, fail_seen_at=seen,
                nonlinear_again_at=back, flags=flags, taken=taken, dropped=dropped,
                refused=refused, epoch=e.epoch, loops=[(lp["cur"], lp["old"]) for lp in
                                                       graph.loops],
                keyframes=len(graph.keyframes), kf_timed=stager.n_keyframes - kf0,
                n_loops=stager.n_loops, max_round=stager.max_round, counts=counts,
                lk_levels=pipe.tcfg.pyr_levels_predicted)


def check_loop_recovery_path(res, on_gpu: bool = True) -> None:
    """Phase 22c: a loop accepted before the burst, the failure seen within
    it, NON_LINEAR again before the last frame, the stager drained without
    an exception (``run_loop_recovery_path`` raises it), and no
    relocalization constraint made before the reboot taken by a solve after
    it (every constraint taken in the epoch it was made in).  On the card K1
    per frame and per keyframe the worker extracted, K3 per level, K2
    never."""
    require(res["burst_at"] is not None, ("a loop accepted before the burst", res["loops"]))
    seen, back = res["fail_seen_at"], res["nonlinear_again_at"]
    require(seen is not None and res["burst_at"] <= seen < res["burst_at"] + RECOVERY_N,
            ("the failure seen within the burst", res["burst_at"], res["flags"]))
    require(back is not None and back < res["frames"] - 1,
            ("NON_LINEAR again before the last frame", res["flags"]))
    require(all(made == at for _, made, at in res["taken"]),
            ("a constraint from before the reboot taken after it", res["taken"]))
    if on_gpu:
        n = res["timed"]
        require(k1_k3(res["counts"]) == {"fast_nms": n + res["kf_timed"], "lk_level": 0,
                                         "lk_iterate": res["lk_levels"] * n},
                ("loop-recovery launches", res["counts"]))


# ---------------------------------------------------------------------------
# phases 14-14c: real-data formats through the port's run_vio entry point
# ---------------------------------------------------------------------------

# the RealSense D435i bag's topics (colour, the depth aligned to it, the IMU)
REALSENSE_TOPICS = ("/camera/color/image_raw", "/camera/aligned_depth_to_color/image_raw",
                    "/camera/imu")


def rig_yaml(cfg: VinsConfig) -> str:
    """The OpenCV-FileStorage rig file that ``load_config`` reads back as
    ``cfg`` (every field a rig file carries, the camera's in its model's
    keys; ``cfg`` keeps the defaults of the others: ``focal_length``,
    ``max_features``, ``max_imu_per_frame``)."""
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

    def node(name, items):
        return [f"{name}:"] + [f"   {k}: {f(v)}" for k, v in items]

    mt = cfg.model_type.upper()
    lines += node("distortion_parameters", zip(("k1", "k2", "p1", "p2"), cfg.distortion))
    if mt == "PINHOLE":
        lines += node("projection_parameters", zip(("fx", "fy", "cx", "cy"), cfg.intrinsics))
    elif mt in ("KANNALA_BRANDT", "EQUIDISTANT"):
        lines += node("projection_parameters",
                      list(zip(("k2", "k3", "k4", "k5"), cfg.kb_distortion))
                      + list(zip(("mu", "mv", "u0", "v0"), cfg.intrinsics)))
    elif mt == "MEI":
        lines += node("mirror_parameters", [("xi", cfg.mirror_xi)])
        lines += node("projection_parameters",
                      zip(("gamma1", "gamma2", "u0", "v0"), cfg.intrinsics))
    elif mt == "SCARAMUZZA":  # the config's unused pinhole intrinsics too, to read back
        lines += node("projection_parameters", zip(("fx", "fy", "cx", "cy"), cfg.intrinsics))
        lines += node("poly_parameters", ((f"p{i}", v) for i, v in enumerate(cfg.ocam_poly)))
        lines += node("inv_poly_parameters",
                      ((f"p{i}", v) for i, v in enumerate(cfg.ocam_inv_poly)))
        lines += node("affine_parameters", zip(("ac", "ad", "ae", "cx", "cy"),
                                               cfg.ocam_affine))
    else:
        raise ValueError(f"rig_yaml: unknown model_type {cfg.model_type!r}")
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
    timed frames (launch counters from the start of the warm-up and
    ``spin_once`` host time) and ``profile`` frames under the profiler; the
    timed frames' messages are then decoded again alone, traced, for the
    ``io::decode`` time (``decode_ms_per_frame``).
    The bag and rig file go to ``workdir/replay`` and are deleted after."""
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
        caps = capture_clock(pipe)
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
        spin_s[0], tracked0 = 0.0, pipe._frame_idx
        k_cap = len(caps)
        t0 = time.perf_counter()
        replay(warmup, n_frames)
        sync()
        elapsed = time.perf_counter() - t0
        counts, tracked = read_counts(), pipe._frame_idx
        n_timed = tracked - tracked0
        # the timed frames' messages again, decoded alone with the tracer on
        sink = types.SimpleNamespace(push_imu=lambda *a: None, push_image=lambda *a: None,
                                     push_depth=lambda *a: None, spin_once=lambda: None)
        with traced() as snap:
            replay_into_pipeline(BagWindow(bag, edge[warmup], edge[n_frames]), sink,
                                 cfg.image_topic, cfg.depth_topic, cfg.imu_topic)
        decode_ms = 1e3 * TRACER.delta(snap)["spans"].get("io::decode", [0.0])[0] / n_timed
        spin_ms = timed_ms(spin_s[0], n_timed, caps, k_cap)
        ms = timed_ms(elapsed, n_timed, caps, k_cap)
        prof = None
        if profile:
            prof = profile_span(lambda: replay(n_frames, n_frames + profile), SPIN_SPAN, profile,
                                os.path.join(workdir, "profile_bag.txt"), ms)
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
        tracked=tracked, timed=n_timed, latency_ms_per_frame=ms, capture_s=caps,
        decode_ms_per_frame=decode_ms, spin_ms_per_frame=spin_ms,
        td=float(e.state.x.td[0]), clahe_changed=not torch.equal(level0, raw),
        clahe_err=float((level0 - image.clahe(raw)).abs().max()), profile=prof)


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
        require(n >= res["frames"] - 2 and k1_k3(res["counts"]) == {
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
        caps = capture_clock(pipe)
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
        k_cap = len(caps)
        t0 = time.perf_counter()
        feed(inproc_frames - warmup)
        pipe.drain()
        sync()
        elapsed = time.perf_counter() - t0
        counts, tracked = read_counts(), pipe._frame_idx
        n_timed = inproc_frames - warmup
        decode_ms = 1e3 * decode_s[0] / n_timed
        ms = timed_ms(elapsed, n_timed, caps, k_cap)
        prof = None
        if profile:
            prof = profile_span(lambda: feed(profile), SPIN_SPAN, profile,
                                os.path.join(workdir, "profile_tum.txt"), ms)
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
        latency_ms_per_frame=ms, capture_s=caps,
        decode_ms_per_frame=decode_ms,
        profile=prof)


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


def run_fisheye_pipeline(device, n_frames: int = 28, W: int = 640, H: int = 480,
                         max_cnt: int = 130) -> dict:
    """Phase 14c's pipeline: phase 7's stream with ``fisheye`` (the analytic
    circle) and ``equalize`` (CLAHE) on, through ``VinsPipeline`` fused,
    dispatched op by op and then replayed (the mask built and CLAHE run in
    the warm-up frames before the capture); what ``replay_against_plain``
    compares, the replayed run's launches and whether it captured."""
    rig, _, _, _ = slice_config(W, H, max_cnt)
    seq = syn.make_trajectory(n_frames, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    cfg = dataclasses.replace(latency_config(rig, seq, max_cnt), fisheye=True, equalize=True)
    ts, imgs, deps = syn.render_sequence(seq, rig, device)
    runs = {}
    for rp in (False, True):
        pipe = envelope(VinsPipeline(cfg, device, eager_outputs=False,
                                     failure_check_interval=10 ** 9, fused_steady_state=True,
                                     replay=rp))
        for (t, a, g) in seq.imu:
            pipe.push_imu(t, a, g)
        reset_counts()
        for k in range(n_frames):
            pipe.push_image(ts[k], imgs[k])
            pipe.push_depth(ts[k], deps[k])
            pipe.spin_once()
        runs[rp] = (frames_record(pipe, ts[n_frames - 1]), read_counts(),
                    graph_of(pipe) is not None)
        pipe.close()
    return dict(frames=n_frames, compare=replay_against_plain(runs[False][0], runs[True][0]),
                counts=runs[True][1], captured=runs[True][2])


def check_fisheye_pipeline(res, on_gpu: bool = True) -> None:
    require(res["compare"]["bit_equal"], ("fisheye and CLAHE: replay against plain", res))
    if on_gpu:
        n = res["frames"]
        require(res["captured"] and k1_k3(res["counts"]) == {"fast_nms": n, "lk_level": 0,
                                                             "lk_iterate": 2 * n},
                ("fisheye and CLAHE: captured, and its launches", res))


def check_fisheye(res) -> None:
    for name, r in res.items():
        require(r["outside"] == 0, (f"points outside the {name} mask", r))
        require(min(r["live"][1:]) >= 20, (f"points tracked inside the {name} mask", r))


# ---------------------------------------------------------------------------
# phases 16-17: the other camera models and the degraded stream
# ---------------------------------------------------------------------------

def run_cameras(device, models=("MEI", "SCARAMUZZA"), n_frames: int = 8, W: int = 640,
                H: int = 480, max_cnt: int = 130, n_px: int = 10000):
    """Phase 16b: the latency tracker (B = 1, K1, K3, LK 12/6) with each
    camera of ``camera_config`` over ``n_frames`` frames of the latency
    stream rendered through that camera's ray grid, the true relative
    rotation as the IMU prediction (``lift``, rotate, ``project``); and each
    non-pinhole model's ``lift`` and ``project`` at ``n_px`` pixels on
    ``device`` against the CPU.  Returns per model the live points per frame
    and the largest relative differences (rays relative to their size, at
    least 1; pixels relative to the larger of their value and the image
    width: a pixel near 0 is a difference of two numbers near the centre)."""
    rig, _, _, _ = slice_config(W, H, max_cnt)
    seq = syn.make_trajectory(n_frames, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    base = latency_config(rig, seq, max_cnt)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    uv = torch.rand((n_px, 2), generator=torch.Generator().manual_seed(1)) * torch.tensor(
        [W - 1.0, H - 1.0])
    out = {}
    for m in ("KANNALA_BRANDT",) + tuple(models):
        cam = camera_config(m, base).camera()
        rays = {d: cam.lift(uv.to(d)) for d in ("cpu", device)}
        back = {d: cam.project(rays["cpu"].to(d)) for d in ("cpu", device)}

        def rel(a, b, scale):  # relative to max(|b|, scale)
            return float(((a.cpu() - b) / torch.clamp(b.abs(), min=scale)).abs().max())

        # rays relative to their size (at least 1), pixels to the image width
        r = dict(lift_rel_err=rel(rays[device], rays["cpu"], 1.0),
                 project_rel_err=rel(back[device], back["cpu"], float(W)))
        if m in models:
            tcfg = envelope(VinsPipeline(camera_config(m, base), device)).tcfg
            ts, imgs, _ = render_camera(seq, cam, device)
            st = ft.init_state(tcfg, 1, device)
            live = []
            for k in range(n_frames):
                (_, q0), (_, q1) = syn.camera_pose(seq, max(k - 1, 0)), syn.camera_pose(seq, k)
                R = torch.as_tensor(syn._q2R(q1).T @ syn._q2R(q0), dtype=torch.float32)
                u = torch.rand((1, tcfg.ransac_trials, tcfg.maxc), generator=gen, device=device)
                st, _ = ft.track_frame(tcfg, cam, st, imgs[k:k + 1].contiguous(),
                                       torch.tensor([float(ts[k])], device=device),
                                       R.to(device)[None], u)
                live.append(st.ids[0] >= 0)
            r["live"] = torch.stack(live).sum(1).cpu().tolist()
        out[type(cam).__name__] = r
    return out


def check_cameras(res) -> None:
    for name, r in res.items():
        require(r["lift_rel_err"] <= 1e-5 and r["project_rel_err"] <= 1e-5,
                (f"{name} lift/project on the card against the CPU", r))
        if "live" in r:
            require(min(r["live"]) >= 20, (f"{name}: live points per frame", r))


def check_degraded_path(res, on_gpu: bool = True) -> None:
    """Phase 17: phase 7's checks under the degraded stream's bound, and a
    feature flagged dynamic on at least one frame."""
    check_latency_path(res, on_gpu)
    require(max(res["n_dynamic"]) > 0, ("no feature ever flagged dynamic", res["n_dynamic"]))


def lift_project_px(cam, device, step: int = 8, margin: int = 40) -> float:
    """The largest |project(lift(uv)) - uv| in pixels over a grid of the
    camera's pixels ``margin`` inside its border (phase 16f: under an OCAM
    affine stretch the two do not invert each other exactly, in JAX too)."""
    vs, us = torch.meshgrid(torch.arange(margin, cam.height - margin, step, device=device),
                            torch.arange(margin, cam.width - margin, step, device=device),
                            indexing="ij")
    uv = torch.stack([us, vs], dim=-1).reshape(-1, 2).to(torch.float64)
    return float((cam.project(cam.lift(uv)) - uv).abs().max())


def run_camera_entry(device, camera: str = "KANNALA_BRANDT", n_frames: int = 32,
                     W: int = 640, H: int = 480, max_cnt: int = 130, workdir: str = OUT_DIR):
    """Phase 14d: phase 16's rig file (the latency stream's knobs with the
    ``camera_config`` camera) with the RealSense topics, its frames rendered
    through the camera's rays and written to a rosbag by the port's writers
    (``write_realsense_bag``), then ``python3 -m vins_rgbd_fast_torch.run_vio
    --config --bag --output`` in a child process.  The bag and rig file go
    to ``workdir/replay_<camera>`` and are deleted after."""
    rig, _, _, _ = slice_config(W, H, max_cnt)
    seq = syn.make_trajectory(n_frames, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    img_t, dep_t, imu_t = REALSENSE_TOPICS
    cfg = dataclasses.replace(camera_config(camera, latency_config(rig, seq, max_cnt)),
                              image_topic=img_t, depth_topic=dep_t, imu_topic=imu_t)
    ts, imgs, deps = render_camera(seq, cfg.camera(), device)
    work = os.path.join(workdir, f"replay_{camera.lower()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bag_path, yaml_path = os.path.join(work, "rig.bag"), os.path.join(work, "rig.yaml")
    out_dir = os.path.join(work, "out")
    try:
        bag_bytes = write_realsense_bag(bag_path, seq, ts, imgs, deps)
        with open(yaml_path, "w") as f:
            f.write(rig_yaml(cfg))
        require(load_config(yaml_path) == cfg, "the rig file reads back as its config")
        entry = run_entry_point(["--config", yaml_path, "--bag", bag_path, "--output", out_dir,
                                 "--device", torch.device(device).type])
        csv = (read_result_csv(os.path.join(out_dir, "vins_result_no_loop.csv"))
               if entry["rc"] == 0 else np.zeros((0, 11)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    travelled = float(np.sum(np.linalg.norm(np.diff(seq.P, axis=0), axis=1)))
    return dict(frames=n_frames, camera=type(cfg.camera()).__name__, bag_mb=bag_bytes / 1e6,
                entry=entry, csv_rows=len(csv),
                run_vio_ate_m=(ate_rmse(csv[:, 0], csv[:, 1:4], seq.times, seq.P, align=False)
                               if len(csv) >= 5 else float("nan")),
                bound=max(0.05 * travelled, 0.08))


def check_camera_entry(res) -> None:
    """Phase 14d's checks: run_vio exits 0 with one CSV row per odometry
    output and the ATE bound."""
    ent = res["entry"]
    require(ent["rc"] == 0, ("run_vio exit code", ent["rc"], ent["stderr"]))
    require(ent["n_outputs"] is not None and res["csv_rows"] == ent["n_outputs"] > 0,
            ("one CSV row per odometry output", res["csv_rows"], ent["n_outputs"]))
    require(np.isfinite(res["run_vio_ate_m"]) and res["run_vio_ate_m"] < res["bound"],
            ("run_vio ATE", res["run_vio_ate_m"], res["bound"]))


# ---------------------------------------------------------------------------
# phase 18: intrinsic calibration (tests/test_calib.py's boards and bounds)
# ---------------------------------------------------------------------------

BOARD = (6, 8, 0.03)  # inner corner rows, columns, square (m)


def board_view_poses(n: int = 8, seed: int = 3, z=(0.45, 0.7), xy=(0.04, 0.03),
                     tilt: float = 0.5):
    """Board-to-camera poses (R, t) of ``tests/test_calib.py``'s
    ``_view_poses``: the board centred, tilted and turned at random."""
    rows, cols, sq = BOARD

    def rot(i, j, a, sign=1.0):  # the rotation by a in the (i, j) plane
        R = np.eye(3)
        c, s_ = np.cos(a), sign * np.sin(a)
        R[i, i], R[i, j], R[j, i], R[j, j] = c, -s_, s_, c
        return R

    rng = np.random.default_rng(seed)
    centre = np.array([(cols - 1) * sq / 2, (rows - 1) * sq / 2, 0.0])
    poses = []
    for _ in range(n):
        R = (rot(1, 2, rng.uniform(-tilt, tilt)) @ rot(0, 2, rng.uniform(-tilt, tilt), -1.0)
             @ rot(0, 1, rng.uniform(-0.4, 0.4)))
        zc = rng.uniform(*z)
        t = np.array([rng.uniform(-xy[0], xy[0]), rng.uniform(-xy[1], xy[1]), zc])
        poses.append((R, t - R @ centre))
    return poses


def render_board(cam, R, t, device, ss: int = 2) -> torch.Tensor:
    """``tests/test_calib.py``'s analytic chessboard view through ``cam`` on
    ``device``: every supersampled pixel lifted, intersected with the board
    plane and checker-coloured (235/25 on a 128 background), then averaged
    ``ss``×``ss`` -> (H, W) float64."""
    rows, cols, sq = BOARD
    W, H = cam.width, cam.height
    f64 = torch.float64
    us = (torch.arange(W * ss, dtype=f64, device=device) + 0.5) / ss - 0.5
    vs = (torch.arange(H * ss, dtype=f64, device=device) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    rays = cam.lift(torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1))
    Rt = torch.as_tensor(R, dtype=f64, device=device)
    d_b = rays @ Rt
    o_b = -torch.as_tensor(t, dtype=f64, device=device) @ Rt
    dz = torch.where(torch.abs(d_b[:, 2]) > 1e-9, d_b[:, 2], torch.full_like(d_b[:, 2], 1e-9))
    lam = -o_b[2] / dz
    xb = o_b[0] + lam * d_b[:, 0]
    yb = o_b[1] + lam * d_b[:, 1]
    on = (lam > 0) & (xb > -sq) & (xb < cols * sq) & (yb > -sq) & (yb < rows * sq)
    par = torch.remainder(torch.floor(xb / sq) + torch.floor(yb / sq), 2)
    img = torch.where(on, torch.where(par > 0.5, 235.0, 25.0), torch.full_like(xb, 128.0))
    return img.reshape(H, ss, W, ss).mean(dim=(1, 3))


def ocam_project_exact(poly, affine, center, Pc) -> np.ndarray:
    """``tests/test_calib.py``'s ground-truth OCAM projection: per point the
    exact quartic root of f(ρ) + (z/r)·ρ = 0 (``np.roots``), then the
    affine stretch [[C, D], [E, 1]] and the centre."""
    C, D, E = affine
    out = np.zeros((len(Pc), 2))
    for i, (x, y, z) in enumerate(Pc):
        r = np.hypot(x, y)
        roots = np.roots([poly[4], poly[3], poly[2], z / r, poly[0]])
        rho = min((float(rt.real) for rt in roots if abs(rt.imag) < 1e-9 and rt.real > 0),
                  default=np.nan)
        u, v = x / r * rho, y / r * rho
        out[i] = (C * u + D * v + center[0], E * u + v + center[1])
    return out


def run_calibration(device, W: int = 640, H: int = 480, n_views: int = 8,
                    workdir: str = OUT_DIR):
    """Phase 18: (a) ``n_views`` 6×8 boards rendered on ``device`` through a
    radtan pinhole (``tests/test_calib.py``'s truth), ``find_chessboard``
    and ``calibrate("pinhole")`` on ``device``; (b) ``calibrate`` for the
    Kannala-Brandt, Mei and stretched Scaramuzza truths of
    ``tests/test_calib.py`` on exact projections with its noise; (c) the
    CLI (``python3 -m vins_rgbd_fast_torch.calib``) in a child on the
    views written as PNGs, its YAML read by ``load_config``."""
    from vins_rgbd_fast_torch.calib import board_points, calibrate, find_chessboard
    from vins_rgbd_fast_torch.io import writers
    from vins_rgbd_fast_torch.models.camera import EquidistantCamera, MeiCamera

    rows, cols, sq = BOARD
    truth = PinholeCamera(fx=462.0, fy=458.5, cx=316.0, cy=243.5, k1=-0.12, k2=0.04, p1=5e-4,
                          p2=-3e-4, width=W, height=H)
    obj = board_points(rows, cols, sq)
    out = {}
    t0 = time.perf_counter()
    imgs = [render_board(truth, R, t, device) for R, t in board_view_poses(n_views, seed=21)]
    views = [find_chessboard(im, rows, cols, device=device) for im in imgs]
    out["found"] = sum(v is not None for v in views)
    res = calibrate("pinhole", [v for v in views if v is not None], rows, cols, sq, W, H,
                    device=device)
    out["pinhole"] = dict(rms_px=res.rms_px, fx=res.params.fx, fy=res.params.fy,
                          fx_err=abs(res.params.fx - truth.fx) / truth.fx)
    out["detect_s"] = time.perf_counter() - t0

    def noisy(project, poses, rng):
        return [project(obj @ R.T + t) + rng.normal(0, 0.05, (len(obj), 2)) for R, t in poses]

    def cam_project(cam):
        return lambda Pc: cam.project(torch.as_tensor(Pc)).numpy()

    kb = EquidistantCamera(mu=365.0, mv=363.0, u0=322.0, v0=238.0, k2=0.02, k3=-0.005,
                           k4=0.002, k5=-0.0005, width=W, height=H)
    mei = MeiCamera(xi=0.9, gamma1=860.0, gamma2=856.0, u1=318.0, v1=242.0, k1=-0.05, k2=0.01,
                    width=W, height=H)
    ocam = ((-180.0, 0.0, 1.8e-3, -2.0e-6, 8.0e-9), OCAM_STRETCH, (322.0, 238.0))
    cases = {
        "kannala-brandt": (cam_project(kb), board_view_poses(10, 9, (0.3, 0.55), (0.14, 0.1)), 1),
        "mei": (cam_project(mei), board_view_poses(12, 13, (0.3, 0.55), (0.14, 0.1)), 2),
        "scaramuzza": (lambda Pc: ocam_project_exact(*ocam, Pc),
                       board_view_poses(12, 17, (0.25, 0.5), (0.16, 0.12)), 4)}
    for model, (project, poses, seed) in cases.items():
        t1 = time.perf_counter()
        r = calibrate(model, noisy(project, poses, np.random.default_rng(seed)), rows, cols, sq,
                      W, H, device=device)
        p = r.params
        row = dict(rms_px=r.rms_px, s=time.perf_counter() - t1)
        if model == "kannala-brandt":
            row["rel_err"] = float(np.max(np.abs(np.array([p.mu, p.mv, p.u0, p.v0])
                                                 / np.array([kb.mu, kb.mv, kb.u0, kb.v0]) - 1)))
        if model == "scaramuzza":
            row["center_err_px"] = float(np.max(np.abs(np.array([p.center_x, p.center_y])
                                                       - np.array(ocam[2]))))
            row["a0_rel_err"] = abs(p.poly[0] / ocam[0][0] - 1)
        out[model] = row

    work = os.path.abspath(os.path.join(workdir, "calib"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "views"))
    try:
        for i, im in enumerate(imgs):
            writers.write_png(os.path.join(work, "views", f"left-{i:02d}.png"),
                              im.cpu().numpy().astype(np.uint8))
        t1 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "vins_rgbd_fast_torch.calib", "-w", str(cols), "--bh",
             str(rows), "-s", str(sq), "-i", os.path.join(work, "views"), "-p", "left-",
             "--camera-model", "pinhole", "--camera-name", "cam0", "--device",
             torch.device(device).type],
            cwd=work, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))))
        yml = os.path.join(work, "cam0_camera_calib.yaml")
        cam = load_config(yml).camera() if child.returncode == 0 else None
        out["cli"] = dict(rc=child.returncode, s=time.perf_counter() - t1,
                          stderr=child.stderr[-2000:],
                          fx=None if cam is None else cam.fx)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["truth_fx"] = truth.fx
    return out


def check_calibration(res, n_views: int = 8) -> None:
    """Phase 18's checks: at least all but two of the rendered boards found
    (on the CPU 7 of 8: one steep view does not order into the grid); the
    pinhole rms below 0.1 px and fx within 2 %; ``tests/test_calib.py``'s
    bounds for the other three models; the CLI exits 0 and its YAML loads,
    fx within 2 %."""
    require(res["found"] >= n_views - 2, ("boards found", res["found"]))
    ph = res["pinhole"]
    require(ph["rms_px"] < 0.1 and ph["fx_err"] < 0.02, ("pinhole calibration", ph))
    kb, mei, oc = res["kannala-brandt"], res["mei"], res["scaramuzza"]
    require(kb["rms_px"] < 0.08 and kb["rel_err"] < 5e-3, ("kannala-brandt calibration", kb))
    require(mei["rms_px"] < 0.1, ("mei calibration", mei))
    require(oc["rms_px"] < 0.1 and oc["center_err_px"] <= 1.0 and oc["a0_rel_err"] <= 1e-2,
            ("scaramuzza calibration", oc))
    cli = res["cli"]
    require(cli["rc"] == 0 and cli["fx"] is not None
            and abs(cli["fx"] - res["truth_fx"]) / res["truth_fx"] < 0.02, ("calib CLI", cli))


# ---------------------------------------------------------------------------
# phase 19: the runner's sharded and chained API, stack_states, the graft twins
# ---------------------------------------------------------------------------

def _equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(bp.leaves(a), bp.leaves(b)))


def run_runner_api(device, B: int = 2, T: int = 4, W: int = 640, H: int = 480,
                   max_cnt: int = 130):
    """Phase 19 (a): the main path warmed (``run_main_path``, B sequences),
    then T more frames through ``run``, ``run_chained`` and, on a runner
    over two shards of ``device`` with the same lanes, ``run_sharded``
    (after ``put_states``/``put_batch``), from the same states and the same
    RANSAC generator states: ``run_chained``'s outputs and end states
    equal ``run``'s bit for bit, ``run_sharded``'s gathered ones within
    JAX's tolerances (``SHARDED_P_ATOL``, ``SHARDED_COST_RTOL``, keyframes
    equal), ``run_eager``'s bit for bit or within the same tolerances.
    Inputs not split over the mesh, or a shard on the wrong device, are
    refused."""
    res = run_main_path(device, B, 1, W=W, H=H, max_cnt=max_cnt, extra=2 * T)
    runner, (trk, st) = res["runner"], res["state"]
    batch = res["extra_batch"][0]
    gens = [g.get_state() for g in runner.generators]
    sharded = bp.BatchedVioRunner(runner.tcfg, runner.cam, runner.ecfg, None, B,
                                  mesh=[runner.device] * 2)

    def from_start(r, fn, *args):
        for g, s_ in zip(r.generators, gens):
            g.set_state(s_)
        return fn(*args)

    a = from_start(runner, runner.run, trk, st, batch)
    b = from_start(runner, runner.run_chained, trk, st, batch)
    eager = sharded_diff(a[2], from_start(runner, runner.run_eager, trk, st, batch)[2])
    placed = (sharded.put_states(trk), sharded.put_states(st), sharded.put_batch(batch))
    c = tuple(x.gather(runner.device)
              for x in from_start(sharded, sharded.run_sharded, *placed))
    misplaced = bp.Sharded(placed[2].mesh, [placed[2].parts[0], bp.map_tree(
        lambda x: x.to("meta"), placed[2].parts[1])], 1)
    refused = []
    for args in ((trk, st, batch), (*placed[:2], misplaced)):
        try:
            sharded.run_sharded(*args)
            refused.append(False)
        except ValueError:
            refused.append(True)
    diff = sharded_diff(a[2], c[2])
    return dict(chained_equal=_equal_trees(a, b), sharded_equal=within_jax_tolerances(diff),
                eager_equal=eager["bit_equal"] or within_jax_tolerances(eager),
                eager_bit_equal=eager["bit_equal"],
                sharded_bit_equal=_equal_trees(a, c), sharded_diff=diff,
                misplaced_refused=all(refused), frames=batch.ts.shape[0],
                cost_finite=bool(torch.isfinite(a[2].cost).all()))


def run_stack_states(device, W: int = 640, H: int = 480, max_cnt: int = 130,
                     n_frames: int = 14):
    """Phase 19 (b): two ``VinsPipeline``s warmed on two sequences of the
    latency stream (seeds 7 and 8, static initialization) and
    ``stack_states``: lane b holds pipeline b's tracker and estimator state
    exactly; the batched runner then takes one more frame of each.  The
    result keeps the pipelines (``pipes``)."""
    rig, _, _, _ = slice_config(W, H, max_cnt)
    seqs = [syn.make_trajectory(n_frames + 1, rig, seed=7 + b, omega_scale=0.15,
                                acc_scale=0.3) for b in range(2)]
    pipes, rendered = [], []
    for s_ in seqs:
        cfg = latency_config(rig, s_, max_cnt)
        ts, imgs, deps = syn.render_sequence(s_, rig, device)
        pipe = VinsPipeline(cfg, device, eager_outputs=False, failure_check_interval=10 ** 9)
        for (t, a, g) in s_.imu:
            pipe.push_imu(t, a, g)
        for k in range(n_frames):
            pipe.push_image(float(ts[k]), imgs[k])
            pipe.push_depth(float(ts[k]), deps[k])
            pipe.spin_once()
        pipe.close()
        pipes.append(pipe)
        rendered.append((ts, imgs, deps))
    trk, st = bp.stack_states(pipes)
    lanes_equal = all(
        _equal_trees(bp.map_tree(lambda x: x[b:b + 1], tree), own)
        for b, p in enumerate(pipes)
        for tree, own in ((trk, p.tracker_state), (st, p.estimator.state)))
    runner = bp.BatchedVioRunner(pipes[0].tcfg, pipes[0].cam, pipes[0].estimator.cfg, device, 2)
    batch = bp.stage_frames_arrays(pipes, [r[0] for r in rendered], [r[1] for r in rendered],
                                   [r[2] for r in rendered], n_frames, n_frames + 1)
    _, _, outs = runner.run(trk, st, batch)
    P = outs.P[0].cpu().numpy()
    err = [float(np.linalg.norm(P[b] - seqs[b].P[n_frames])) for b in range(2)]
    return dict(initialized=[p.estimator.solver_flag == est.VinsEstimator.NON_LINEAR
                             for p in pipes], lanes_equal=lanes_equal, next_frame_err_m=err,
                pipes=pipes)


def check_runner_api(api, stacked) -> None:
    require(api["chained_equal"] and api["sharded_equal"] and api["eager_equal"],
            ("run_chained, run_sharded and run_eager against run", api))
    require(api["misplaced_refused"] and api["cost_finite"], ("run_sharded checks", api))
    require(all(stacked["initialized"]) and stacked["lanes_equal"], ("stack_states", stacked))
    require(max(stacked["next_frame_err_m"]) < 0.08, ("the stacked lanes track", stacked))


# ---------------------------------------------------------------------------
# phases 20-20b: the batched runner over lanes warmed by the rigs' own
# initialization programs
# ---------------------------------------------------------------------------

# the lanes of phases 20 and 20b on whose stream JAX's own latency
# pipeline misses the truth bound too (phase 20b's lane 2, seed 9:
# tests/test_torch_batched_rigs.py::test_jax_pipeline_misses_the_bound_on_td_lane_2)
REFERENCE_MISSES = {"dyn": (), "td": (2,)}


def stage_batched_rig_path(device, kind: str, B: int = 8, T: int = 40, W: int = 0, H: int = 0,
                           mono_lanes=(6, 7), profile: int = 0, dtype=torch.float32) -> dict:
    """Phase 20 (``kind`` "dyn": the OpenLORIS rig, ``static_init`` 0,
    848×480) or 20b ("td": the RealSense rig, td estimated from 0 against
    IMU stamps ``TD_TRUE`` ahead, rolling shutter, the extrinsic refined,
    640×480) up to the runner: B lanes (``make_trajectory`` seeds 7..,
    each moving from frame 0; with "dyn" the lanes in ``mono_lanes`` have
    their depth withheld until initialization, so only ``init_mono`` can),
    each warmed in its own ``VinsPipeline`` until NON_LINEAR (``rig_lane``,
    ``feed_lane``), then all fed on to one common frame k_c, one past the
    last lane's initialization; ``stack_states``, and
    ``stage_frames_arrays`` (each lane's IMU at its own host td) of frames
    [k_c, k_c + T) and of ``profile`` frames after them.  Launches are
    counted from the first warm-up frame."""
    dyn = kind == "dyn"
    W = W or (848 if dyn else 640)
    H = H or 480
    mono = [b for b in range(B) if dyn and b in mono_lanes]
    init_by = 24 if mono else 16
    n = init_by + T + profile
    scenes = [(openloris_scene if dyn else realsense_scene)(n, W, H, seed=7 + b)
              for b in range(B)]
    rendered = [syn.render_sequence(seq, rig, device) for rig, seq, _ in scenes]
    lane_kw = dict(imu_shift=0.0 if dyn else TD_TRUE, failure_check_interval=10 ** 9 if dyn else 4,
                   dtype=dtype)
    reset_counts()
    t0 = time.perf_counter()
    lanes = []
    for b, (_, seq, cfg) in enumerate(scenes):
        lanes.append(rig_lane(device, cfg, seq, b in mono, **lane_kw))
        feed_lane(lanes[-1], *rendered[b], init_by, stop_at_init=True)
    inits = [lane["init_frame"] for lane in lanes]
    require(all(k is not None for k in inits),
            ("every lane initialized", inits, [lane["attempts"] for lane in lanes]))
    k_c = max(inits) + 1
    for b, lane in enumerate(lanes):
        feed_lane(lane, *rendered[b], k_c)
    pipes = [lane["pipe"] for lane in lanes]
    require(all(p.estimator.solver_flag == est.VinsEstimator.NON_LINEAR for p in pipes),
            ("every lane NON_LINEAR at the common frame", k_c))
    warm_s = time.perf_counter() - t0
    configs_equal = all(p.estimator.cfg == pipes[0].estimator.cfg and p.tcfg == pipes[0].tcfg
                        for p in pipes)
    require(configs_equal, "one configuration for every lane")
    stacks = [[r[i] for r in rendered] for i in range(3)]
    return dict(kind=kind, B=B, W=W, H=H, T=T, common_frame=k_c, init_frames=inits,
                attempts=[lane["attempts"] for lane in lanes], mono_lanes=mono,
                configs_equal=configs_equal, warm_s=warm_s, warm_counts=read_counts(),
                tracked=sum(p._frame_idx for p in pipes), pipes=pipes, lane_kw=lane_kw,
                runner=bp.BatchedVioRunner(pipes[0].tcfg, pipes[0].cam,
                                           pipes[0].estimator.cfg, device, B),
                state=bp.stack_states(pipes), scenes=scenes, rendered=rendered,
                batch=bp.stage_frames_arrays(pipes, *stacks, k_c, k_c + T, dtype=dtype),
                extra=bp.stage_frames_arrays(pipes, *stacks, k_c + T, k_c + T + profile,
                                             dtype=dtype) if profile else None)


def run_batched_rig_path(staged: dict, path=None, timer=None) -> dict:
    """Phases 20 and 20b on the runner: ``run`` over the staged T frames
    (``run_replayed``: the replayed frames timed by ``timer``), then the
    staged profile frames, replayed, under the
    profiler (``stage_batched_rig_path``); each lane's accuracy over its
    pipeline's outputs and the run's (``lane_accuracy``); a lane of
    ``REFERENCE_MISSES`` that misses its bound is re-run alone on the
    latency pipeline to the run's last frame, the reference it is held to.
    Launches: the run's apart from the warm-up's, and both together."""
    res = {k: v for k, v in staged.items() if k not in ("batch", "extra")}
    kind, T, k_c = staged["kind"], staged["T"], staged["common_frame"]
    trk, st = staged["state"]
    runner = staged["runner"]
    reset_counts()
    trk2, st2, outs, timing = run_replayed(runner, trk, st, staged["batch"], timer)
    run_counts = read_counts()
    P = outs.P.cpu().numpy()
    prof = None
    if staged["extra"] is not None:
        prof = profile_span(lambda: runner.run(trk2, st2, staged["extra"]), RUN_SPAN,
                            staged["extra"].ts.shape[0], path, timing["step_ms"] or 1.0)
    dyn = kind == "dyn"
    lane_res = []
    for b, ((_, seq, cfg), pipe) in enumerate(zip(staged["scenes"], staged["pipes"])):
        ts = staged["rendered"][b][0]
        mono = b in staged["mono_lanes"]
        traj = pipe.estimator.trajectory
        times = [r["t"] for r in traj] + [float(t) for t in ts[k_c:k_c + T]]
        Ps = np.concatenate([np.reshape([r["P"] for r in traj], (-1, 3)), P[:, b]])
        acc = lane_accuracy(times, Ps, seq, dyn, mono)
        acc.update(outputs=len(times), latency_err=None, latency_init=None)
        if not acc["err"] < acc["bound"] and b in REFERENCE_MISSES[kind]:
            ref = rig_lane(pipe.device, cfg, seq, mono, **staged["lane_kw"])
            feed_lane(ref, *staged["rendered"][b], k_c + T)
            rt = ref["pipe"].estimator.trajectory
            acc["latency_err"] = lane_accuracy([r["t"] for r in rt], [r["P"] for r in rt], seq,
                                               dyn, mono)["err"]
            acc["latency_init"] = (ref["init_frame"], ref["attempts"])
        lane_res.append(acc)
    res.update(**timing, run_counts=run_counts, profile=prof, lanes=lane_res,
               counts={k: staged["warm_counts"][k] + run_counts[k] for k in COUNTED},
               cost=outs.cost.cpu().numpy(), td=st2.x.td.cpu().tolist(), state=(trk2, st2))
    return res


def check_batched_rig_path(res, on_gpu: bool = True) -> None:
    """Phases 20 and 20b: every lane initialized by its own program within
    ``check_rig_path``'s frames (a lane with depth by frame 15 through
    ``init_dynamic`` or its monocular fallback; a lane with its depth
    withheld by frame 23 through ``init_mono``; static by frame 15 with no
    attempt); each lane's error against the truth
    under ``truth_bound``'s bound, or, for a lane of ``REFERENCE_MISSES``
    only, under its latency run's error plus max(10 %, 0.01 m) where that
    run, initialized at the same frame by the same attempts, misses the
    bound too; finite costs, finite td within 50 ms, one configuration for
    all lanes; on the card K1 once and K2 twice per steady frame (K3
    never), K1 once and K3 twice per tracked warm-up frame (K2 never), and
    in the profile of replayed frames no host wait and the same kernels by
    name (``check_replay_profile``)."""
    dyn = res["kind"] == "dyn"
    for b, (k, att, lane) in enumerate(zip(res["init_frames"], res["attempts"], res["lanes"])):
        mono = b in res["mono_lanes"]
        require(k is not None and k < (24 if mono else 16), ("lane initialized", b, k, att))
        if not dyn:
            require(att == [], ("static init has no attempts", b, att))
        elif mono:
            require(att and att[-1] == ("init_mono", True), ("init_mono", b, att))
        else:  # check_rig_path's program: init_dynamic or its monocular fallback
            require(att and att[-1][1], ("init_dynamic or its fallback", b, att))
        ref = lane["latency_err"] if b in REFERENCE_MISSES[res["kind"]] else None
        require(np.isfinite(lane["err"]) and (lane["err"] < lane["bound"] or (
            ref is not None and ref >= lane["bound"] and lane["latency_init"] == (k, att)
            and lane["err"] < ref + max(0.1 * ref, 0.01))), ("accuracy", b, lane))
    require(np.all(np.isfinite(res["cost"])), ("finite costs", res["cost"]))
    require(all(np.isfinite(td) and abs(td) < 0.05 for td in res["td"]), ("td", res["td"]))
    require(res["configs_equal"], "one configuration for every lane")
    if on_gpu:
        T, n = res["T"], res["tracked"]
        require(k1_k3(res["run_counts"]) == {"fast_nms": T, "lk_level": 2 * T, "lk_iterate": 0},
                ("steady launches", res["run_counts"]))
        require(k1_k3(res["warm_counts"]) == {"fast_nms": n, "lk_level": 0, "lk_iterate": 2 * n},
                ("warm-up launches", res["warm_counts"], n))
        if res["profile"] is not None:
            check_replay_profile(res["profile"], {"fast_nms": 1, "lk_level": 2},
                                 ("phase 20", res["kind"]))


def lane_refs(res) -> dict:
    """Lane -> its latency reference's error, for the lanes of
    ``REFERENCE_MISSES`` that missed their bound."""
    return {b: round(x["latency_err"], 4) for b, x in enumerate(res["lanes"])
            if x["latency_err"] is not None}


def batched_rig_summary(res) -> dict:
    """What phases 20 and 20b keep in ``chip_smoke.json``."""
    return {k: v for k, v in res.items()
            if k not in ("pipes", "runner", "state", "scenes", "rendered", "lane_kw", "cost")}


# ---------------------------------------------------------------------------
# phase 21: the batched runner sharded by lane over a mesh of cards
# ---------------------------------------------------------------------------

# JAX's tolerances for the sharded run against the unsharded one
# (tests/test_sharded_runner.py): positions, costs (relative), keyframes equal
SHARDED_P_ATOL = 5e-4
SHARDED_COST_RTOL = 5e-3
def sharded_diff(ref, got) -> dict:
    """A sharded run's ``ScanOutputs`` (gathered) against ``run``'s: the
    largest position and relative cost differences, and whether the
    keyframe flags, and every output, agree."""
    return dict(max_dP_m=float((got.P - ref.P).abs().max()),
                max_cost_rel=float(((got.cost - ref.cost).abs() / ref.cost.abs()).max()),
                keyframes_equal=bool(torch.equal(got.is_keyframe, ref.is_keyframe)),
                bit_equal=_equal_trees(ref, got))


def within_jax_tolerances(diff: dict) -> bool:
    return (diff["max_dP_m"] <= SHARDED_P_ATOL and diff["max_cost_rel"] <= SHARDED_COST_RTOL
            and diff["keyframes_equal"])


SHARDED_LABELS = {"A": "run on one card", "B": "run, every lane on one card",
                  "C": "run_sharded over two shards of one card",
                  "D": "run_sharded over every card",
                  "E": "run_eager on one card (A's lanes dispatched op by op: the before)"}


def stage_sharded_path(device, n_lanes: int, T: int, W: int = 640, H: int = 480,
                       max_cnt: int = 130) -> dict:
    """Phase 21's lanes: phase 5's rig and sequences (seeds 100 + b),
    ``n_lanes`` of them, self-warmed together by ``BatchedVioRunner.warm``
    on ``device`` (11 frames and the static initialization), the next T
    frames staged there, the lanes' RANSAC generator states after the
    warm-up, and frames 0 and 1 of every lane (the kernels' inputs)."""
    rig, tcfg, ecfg, cam = slice_config(W, H, max_cnt)
    k_w = bp.WINDOW_SIZE + 1
    seqs, rendered, bufs = make_sequences(rig, n_lanes, k_w + T, device)
    ts, imgs, deps = ([r[i] for r in rendered] for i in range(3))
    runner = bp.BatchedVioRunner(tcfg, cam, ecfg, device, n_lanes)
    trk, st = runner.init_states(seqs[0].ric, seqs[0].tic)
    trk, st, _ = runner.warm(trk, st, bp.stage_frames(imgs, deps, ts, bufs, 0, k_w, device))
    return dict(cfg=(tcfg, cam, ecfg), state=(trk, st), T=T, seqs=seqs,
                times=[t[k_w:k_w + T] for t in ts],
                gens=[g.get_state() for g in runner.generators],
                batch=bp.stage_frames(imgs, deps, ts, bufs, k_w, k_w + T, device),
                frames=tuple(torch.stack([im[k] for im in imgs]).contiguous() for k in (0, 1)))


def first_frames(batch, T: int):
    """The first T frames of a (T, B, ...) batch, plain or ``Sharded``."""
    if isinstance(batch, bp.Sharded):
        return bp.Sharded(batch.mesh, [first_frames(p, T) for p in batch.parts], batch.axis)
    return bp.FrameBatch(*(a[:T] for a in batch))


def sharded_cases(staged: dict, device, mesh, per_card: int) -> dict:
    """Phase 21's five ways over the staged lanes, each a runner and its
    inputs (placed by ``put_states``/``put_batch`` where sharded): A
    ``run`` at B = ``per_card`` on ``device``; B ``run`` at every lane
    (``per_card`` per entry of ``mesh``) on ``device``; C ``run_sharded``
    over [device, device] at B = ``per_card``; D ``run_sharded`` over
    ``mesh`` at every lane; E ``run_eager`` on A's runner and lanes."""
    tcfg, cam, ecfg = staged["cfg"]
    trk, st = staged["state"]
    n_all = per_card * len(mesh)

    def lanes(tree, n):
        return bp.map_tree(lambda a: a[:n], tree)

    cases = {}
    for name, n, shards in (("A", per_card, None), ("B", n_all, None),
                            ("C", per_card, [device, device]), ("D", n_all, list(mesh))):
        runner = bp.BatchedVioRunner(tcfg, cam, ecfg, None if shards else device, n,
                                     mesh=shards)
        batch = bp.FrameBatch(*(a[:, :n] for a in staged["batch"]))
        ins = (lanes(trk, n), lanes(st, n), batch)
        if shards:
            ins = (runner.put_states(ins[0]), runner.put_states(ins[1]), runner.put_batch(batch))
        cases[name] = dict(runner=runner, ins=ins, B=n, devices=sorted(set(runner.mesh), key=str),
                           shards=len(runner.mesh),
                           shards_on={str(d): runner.mesh.count(d) for d in set(runner.mesh)})
    cases["E"] = dict(cases["A"], eager=True)
    return cases


def run_case(case: dict, staged: dict, T: int):
    """T frames of one of ``sharded_cases``'s ways, from the warmed states
    and the lanes' generator states after the warm-up."""
    trk, st, batch = case["ins"]
    runner = case["runner"]
    for g, s_ in zip(runner.generators, staged["gens"]):
        g.set_state(s_)
    if case.get("eager"):
        return runner.run_eager(trk, st, first_frames(batch, T))
    run = runner.run_sharded if isinstance(trk, bp.Sharded) else runner.run
    return run(trk, st, first_frames(batch, T))


def synchronize(devices) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def read_counts_by_device() -> dict:
    """The kernels' launches by CUDA device index since ``reset_counts``."""
    return {k: dict(c.by_device) for k, c in zip(KERNELS, launch_counts())}


def profile_sharded(fn, frames: int, step_ms: float, devices) -> dict:
    """torch.profiler over ``fn`` (``frames`` frames) inside a span:
    host waits (``HOST_SYNC_CALLS``) and CUDA API calls (``cu*``) that
    start and end inside it (per frame), and per card the kernels and
    device ms per frame, and the busy share against the unprofiled
    ``step_ms`` ("not measured" where the profiler shows no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    synchronize(devices)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SHARDED_SPAN):
            fn()
        synchronize(devices)
    events = prof.events()
    span = next(e for e in events if e.name == SHARDED_SPAN and e.device_type == DeviceType.CPU)
    t0, t1 = span.time_range.start, span.time_range.end
    inside = [e for e in events if e.device_type == DeviceType.CPU
              and t0 <= e.time_range.start and e.time_range.end <= t1]
    waits = sorted(e.name for e in inside if e.name in HOST_SYNC_CALLS)
    api = {}  # the CUDA API calls the host made
    for e in inside:
        if e.name.startswith("cu"):
            api[e.name] = api.get(e.name, 0) + 1
    by_card = {}
    for d in devices:
        idx = torch.device(d).index
        ks = [e for e in events if e.device_type == DeviceType.CUDA and e.device_index == idx
              and e.name != SHARDED_SPAN]
        ms = sum(e.self_device_time_total for e in ks) / 1e3 / frames
        ours = {k: sum(1 for e in ks if re.search(rf"(^|\W){k}_kernel(\W|$)", e.name)) / frames
                for k in KERNELS}
        by_card[str(d)] = dict(kernels_per_frame=len(ks) / frames, device_ms_per_frame=round(ms, 3),
                               busy_share=round(ms / step_ms, 4) if ms > 0 else "not measured",
                               ours_per_frame=ours)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name != SHARDED_SPAN]
    by_kernel = {}
    for k in KERNELS:
        hits = [e for e in kernels if re.search(rf"(^|\W){k}_kernel(\W|$)", e.name)]
        by_kernel[k] = dict(
            device_ms_per_frame=sum(e.self_device_time_total for e in hits) / 1e3 / frames,
            launches_per_frame=len(hits) / frames)
    return dict(frames=frames, host_syncs=len(waits), host_sync_calls=sorted(set(waits)),
                api_calls_per_frame=sum(api.values()) / frames,
                api_calls=dict(sorted(api.items(), key=lambda kv: -kv[1])[:6]),
                by_card=by_card, by_kernel=by_kernel)


def run_sharded_path(staged: dict, device, mesh, per_card: int = 8, time_frames: int = 0,
                     turns: int = 3, profile: int = 0) -> dict:
    """Phase 21 (b) and (c) over ``stage_sharded_path``'s lanes.

    (b) C against A and D against B (``sharded_cases``) over the staged T
    frames: the largest position and relative cost differences and whether
    the keyframe flags agree, every lane of the sharded run against the
    truth (``lane_accuracy``), finite costs, and on the card the launches
    of each kernel by card and each card's peak memory in the sharded
    runs; and E (``run_eager``) against A, the replay against the per-op
    dispatch.  (c) with ``time_frames``: each way ``turns`` times over that
    many frames in turns (A B C D E E D C B A ...; B left out where it is
    A), host clock ended by a synchronisation of every device the way
    uses; ms per step, seq-frames/s, and their ratios to A.  With
    ``profile``, every way profiled over that many frames
    (``profile_sharded``: host API calls per frame, each card's kernels
    and busy share)."""
    T = staged["T"]
    cases = sharded_cases(staged, device, mesh, per_card)
    on_gpu = torch.device(device).type == "cuda"
    same = cases["B"]["B"] == cases["A"]["B"]
    res = dict(per_card=per_card, mesh=[str(d) for d in bp.mesh_of(mesh)], T=T, compare={})
    outs_by = {}
    for ref, case in (("A", "C"), ("B", "D")):
        if ref not in outs_by:
            outs_by[ref] = (outs_by["A"] if ref == "B" and same
                            else run_case(cases[ref], staged, T)[2])
        c = cases[case]
        if on_gpu:
            for d in c["devices"]:
                torch.cuda.reset_peak_memory_stats(d)
        reset_counts()
        outs = run_case(c, staged, T)[2]
        synchronize(c["devices"])
        counts = read_counts_by_device()
        on_mesh = [{a.device for a in bp.leaves(p)} == {d}
                   for d, p in zip(c["runner"].mesh, outs.parts)]
        outs = outs.gather(device)
        P_s = outs.P.cpu().numpy()
        lanes = [lane_accuracy([float(t) for t in staged["times"][b]], P_s[:, b],
                               staged["seqs"][b], False, False) for b in range(c["B"])]
        res["compare"][case] = dict(
            against=ref, B=c["B"], shards=c["shards"], on_mesh=all(on_mesh),
            **sharded_diff(outs_by[ref], outs),
            cost_finite=bool(torch.isfinite(outs.cost).all()),
            lanes=[dict(err=round(x["err"], 5), bound=round(x["bound"], 4)) for x in lanes],
            counts=counts, shards_on=c["shards_on"],
            peak_mem_gb={str(d): round(torch.cuda.max_memory_allocated(d) / 2 ** 30, 3)
                         for d in c["devices"]} if on_gpu else None)
    res["eager_vs_run"] = sharded_diff(outs_by["A"], run_case(cases["E"], staged, T)[2])
    if time_frames:
        order = [k for k in "ABCDE" if not (k == "B" and same)]
        turns_ms = {k: [] for k in order}
        for i in range(turns):
            for k in (order if i % 2 == 0 else order[::-1]):
                c = cases[k]
                devs = sorted(set(c["devices"]) | {torch.device(device)}, key=str)
                synchronize(devs)
                t0 = time.perf_counter()
                run_case(c, staged, time_frames)
                synchronize(devs)
                turns_ms[k].append(1e3 * (time.perf_counter() - t0) / time_frames)
        base = statistics.fmean(turns_ms["A"])
        res["timing"] = {k: dict(B=cases[k]["B"], shards=cases[k]["shards"], turns_ms=v,
                                 ms_per_step=statistics.fmean(v),
                                 seq_frames_per_s=1e3 * cases[k]["B"] / statistics.fmean(v),
                                 step_ratio=statistics.fmean(v) / base,
                                 throughput_ratio=(cases[k]["B"] / statistics.fmean(v))
                                 / (cases["A"]["B"] / base))
                         for k, v in turns_ms.items()}
        res["timing_frames"] = time_frames
    if profile:
        res["profile"] = {}
        for k in [k for k in "ABCDE" if not (k == "B" and same)]:
            step = res["timing"][k]["ms_per_step"] if time_frames else 1.0
            res["profile"][k] = dict(profile_sharded(
                lambda: run_case(cases[k], staged, profile), profile, step, cases[k]["devices"]),
                shards_on=cases[k]["shards_on"])
    return res


def check_sharded_path(res, on_gpu: bool = True) -> None:
    """Phase 21 (b): each sharded run within JAX's tolerances of ``run``
    on the same lanes (P within 5e-4 m, cost within rtol 5e-3, keyframe
    flags equal), its outputs on its mesh, every lane under its truth
    bound, finite costs; ``run`` against ``run_eager`` bit for bit or
    within the same tolerances; on the card K1 once and K2 twice per frame
    for each shard on each card (K3 never), counted under replay and
    traced by name in every way's profile, and no host wait in the
    profiles."""
    T = res["T"]
    for case, c in res["compare"].items():
        require(c["on_mesh"], (case, "outputs on the mesh"))
        require(within_jax_tolerances(c) and c["cost_finite"], (case, "against run", c))
        for b, lane in enumerate(c["lanes"]):
            require(np.isfinite(lane["err"]) and lane["err"] < lane["bound"], (case, b, lane))
        if on_gpu:
            n = {torch.device(d).index: k for d, k in c["shards_on"].items()}
            require(c["counts"]["fast_nms"] == {i: k * T for i, k in n.items()},
                    (case, c["counts"]))
            require(c["counts"]["lk_level"] == {i: 2 * k * T for i, k in n.items()},
                    (case, c["counts"]))
            require(not c["counts"]["lk_iterate"], (case, c["counts"]))
    e = res["eager_vs_run"]
    require(e["bit_equal"] or within_jax_tolerances(e), ("run against run_eager", e))
    for case, p in res.get("profile", {}).items():
        require(p["host_syncs"] == 0, (case, "host waits inside the run", p))
        for card, k in p["shards_on"].items():
            seen = p["by_card"][card]["ours_per_frame"]
            require(seen == {"fast_nms": k, "lk_level": 2 * k, "lk_iterate": 0},
                    (case, card, "kernels traced per frame", seen))


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
    return {k: v for k, v in res.items() if k not in ("graph", "scene", "record")}


def check_stage_marks(device, reps: int = 20, cycles=(2, 1, 4, 1, 3)) -> dict:
    """The tracer's stage-mark kernel (``csrc/stage_mark.cu``) in a captured
    graph of five stages, each a ``torch.cuda._sleep`` of ``cycles[i]``
    million cycles, replayed ``reps`` times between two CUDA events: one
    mark per stage and replay, the five sums within 3 % of the events'
    time, and each stage's share that of its cycles within 3 points."""
    was = TRACER.on
    TRACER.enable()
    try:
        def step():
            with TRACER.marking(device):
                for name, c in zip(timing.STAGES, cycles):
                    torch.cuda._sleep(c * 1_000_000)
                    if name != timing.STAGES[-1]:
                        TRACER.mark(name)

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = native.capture(step, side)
        torch.cuda.synchronize(device)
        s0 = TRACER.snapshot()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            graph.replay()
        e1.record()
        torch.cuda.synchronize(device)
        stages = TRACER.delta(s0)["stages"]
        graph.reset()
    finally:
        if not was:
            TRACER.disable()
    event_s = 1e-3 * e0.elapsed_time(e1)
    marked_s = sum(v[0] for v in stages.values())
    shares = {k: v[0] / marked_s for k, v in stages.items()}
    res = dict(stages=stages, event_s=event_s, marked_s=marked_s, shares=shares)
    require(all(v[1] == reps for v in stages.values()), ("one mark per stage and replay", res))
    require(abs(marked_s / event_s - 1) < 0.03, ("the marks' sum against the events", res))
    require(all(abs(shares[k] - c / sum(cycles)) < 0.03 for k, c in zip(timing.STAGES, cycles)),
            ("each stage's share", res))
    return res


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
    """Every level of the pyramids, coarse to fine, kernel and plain version
    on identical inputs (each level starts at the flow the plain version
    carried down)."""
    win, sm, eps, min_eig = LK["win"], LK["sm"], LK["eps"], LK["min_eig"]
    report = []
    levels = len(prev_pyr)
    flow = (init - pts) / 2.0 ** (levels - 1)
    for l in range(levels - 1, -1, -1):
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


def nvidia_smi_lines() -> list:
    """Each card's name and power limit, one line per card, as ``nvidia-smi``
    gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines() if res.returncode == 0 else ["nvidia-smi failed"]


def nvidia_smi_line() -> str:
    """Card 0's name and power limit."""
    return nvidia_smi_lines()[0]


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


def check_replay_profile(prof: dict, per_frame: dict, what: str) -> None:
    """A profile of replayed frames (``profile_span``): no host wait on the
    frame thread, and the kernels traced by name per frame as the launch
    counters count them under replay (``per_frame``: kernel -> launches
    per frame; any other kernel of ``KERNELS`` none)."""
    require(prof["host_syncs"] == 0, (what, "host waits inside run", prof["host_sync_calls"]))
    seen = {k: prof["by_kernel"][k]["launches_per_frame"] for k in KERNELS}
    require(seen == {k: per_frame.get(k, 0) for k in KERNELS},
            (what, "kernels traced per replayed frame", seen, per_frame))


def host_waits(prof, name: str):
    """Host waits (``HOST_SYNC_CALLS``) that start and end inside the span
    ``name``, on the span's own OS thread and on others (a worker thread
    may wait; the frame thread may not), with the names of the former
    (``span_trace``)."""
    t = span_trace(prof, name)
    return t["own_waits"], t["other_waits"]


def span_trace(prof, name: str) -> dict:
    """What the exported trace shows inside the span ``name``: the host
    waits (``HOST_SYNC_CALLS``) of the span's own OS thread (``own_waits``,
    by name) and of others (``other_waits``, counted), and the CUDA API
    calls of its own thread (the trace's ``cuda_*`` categories; ``own_api``,
    name -> count).  Read from the exported trace, whose events carry the
    OS thread id of their caller (the profiler's event list gives CUDA
    runtime calls no usable thread)."""
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("name") == name and e.get("cat") == "user_annotation")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    inside = [e for e in events if str(e.get("cat", "")).startswith("cuda_")
              and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1]
    waits = [e for e in inside if e.get("name") in HOST_SYNC_CALLS]
    own = [e["name"] for e in waits if e.get("tid") == span.get("tid")]
    api = {}
    for e in inside:
        if e.get("tid") == span.get("tid"):
            api[e["name"]] = api.get(e["name"], 0) + 1
    return dict(own_waits=own, other_waits=len(waits) - len(own), own_api=api)


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
    trace = span_trace(prof, name)
    own, other_syncs, api = trace["own_waits"], trace["other_waits"], trace["own_api"]
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
                api_calls_per_frame=sum(api.values()) / frames,
                api_calls=dict(sorted(api.items(), key=lambda kv: -kv[1])[:6]),
                device_ms_per_frame=round(dev_ms, 3),
                busy_share=round(dev_ms / step_ms, 4) if dev_ms > 0 else "not measured",
                top_ms_per_frame=[(e.key[:50], round(e.self_device_time_total / 1e3 / frames, 3))
                                  for e in top], by_kernel=ours)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on the GPU")
    ap.add_argument("--phases", choices=("all", "21", "22", "23", "24"), default="all",
                    help="'21': phases 1-2 and 21 alone (the kernels and the runner sharded "
                         "over every card present); '22': phases 1-2, the kernels against "
                         "their plain versions on card 0, and 22-22c (the failure reboot); "
                         "'23': the same with phase 23 (the batched closer's three modes); "
                         "'24': phases 1-2, the main path's batched VIO and VO at B = 8, "
                         "and 24 (K4, the solve's projection assembly, at every shape)")
    phases = ap.parse_args(argv).phases
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
    smi_cards = nvidia_smi_lines()
    smi = smi_cards[0]
    print(f"[1 card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | every card: "
          f"{smi_cards}", flush=True)

    t0 = time.perf_counter()
    path = native.build(verbose=True)
    native.lib()
    build_s = time.perf_counter() - t0
    with open(path + ".log") as f:
        usage = ptxas_usage(f.read())
    require(set(usage) == set(PTXAS_NAMES), ("ptxas report", usage))
    require(all(u["spill_bytes"] == 0 for u in usage.values()), ("spills", usage))
    nw = lk.K3_WARPS
    # K1's static and K3's largest dynamic shared memory stay under the 48 KB
    # a block gets without the per-device opt-in that K2 makes
    require(usage["fast_nms"]["smem_bytes"] < 48 * 1024
            and 4 * (lk.MAX_WIN * 53 + 4 * nw) < 48 * 1024, ("K1, K3 under 48 KB", usage))
    print(f"[2 build] {build_s:.2f} s ({path}); ptxas {usage}; K3 {nw} warps per point, "
          f"{4 * (38 * 53 + 4 * nw)} B dynamic shared memory at WIN = 38", flush=True)
    marks = check_stage_marks(dev)
    print(f"[2 stage marks] {marks['marked_s']:.6f} s marked against {marks['event_s']:.6f} s "
          f"between events; shares {marks['shares']}", flush=True)

    B, N, T, EXTRA = 8, 200, 40, 10
    rig, tcfg, ecfg, cam = slice_config()
    tcfg_run = bp.BatchedVioRunner(tcfg, cam, ecfg, dev, 1).tcfg  # LK 12/6 envelope
    thr = tcfg.fast_threshold
    timer = LaunchTimer()
    timings = []

    def timing(kernel, shape, fn, plain, bound, phase=None, launch_timer=None):
        t = dict(kernel=kernel, shape=shape, **(launch_timer or timer)(fn),
                 plain_ms=median_ms(plain), **bound)
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        timings.append(t)
        phase = phase or (6 if kernel != "lk_iterate" else 8)
        print(f"[{phase} timing] {kernel} {shape}: "
              f"{t['device_ms']:.5f} ms per launch on the device ({t['reps']} per event "
              f"pair), wrapper {t['host_us']:.1f} us per call on the host; bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {t['bytes'] / 1e6:.3f} MB, "
              f"{t['ops'] / 1e6:.1f} M ops), {100 * t['share_of_bound']:.1f} % of it; plain "
              f"{t['plain_ms']:.4f} ms per call (no yardstick)", flush=True)

    def time_k2(k2_in_, tcfg_, label, phase=None, launch_timer=None):
        """K2 per level of two-level tracks, each level started at the
        coarse flow."""
        prev_pyr, cur_pyr, pts, init, active = k2_in_
        b, n = pts.shape[:2]
        for l in (1, 0):
            iters = tcfg_.lk_max_iters if l == 0 else tcfg_.lk_coarse_iters
            prev, cur, pts_l, flow, ax, ay = level_inputs(prev_pyr, cur_pyr, pts,
                                                          (init - pts) / 2.0, l)
            args = (prev, cur, pts_l, flow, active, ax, ay, LK["win"], LK["sm"], iters,
                    LK["eps"], LK["min_eig"])
            steps = gn_steps(lambda k: lk.lk_level_plain(*args[:9], k, *args[10:])[0], iters)
            timing("lk_level", f"{label} level {l}", lambda: lk._lk_level_cuda(*args),
                   lambda: lk.lk_level_plain(*args),
                   kernel_bounds(b, *prev.shape[-2:], n, iters, footprint=k2_footprint(
                       prev, pts_l, ax, ay), steps=sum(steps))["lk_level"], phase=phase,
                   launch_timer=launch_timer)
            timings[-1]["points_by_step"] = steps

    def time_k3(k3_in_, tcfg_, label, phase=None, launch_timer=None):
        """K3 per level of two-level tracks, each level started at the
        coarse flow."""
        prev_pyr, cur_pyr, pts, init, active = k3_in_
        flow = (init - pts) / 2.0
        for l in (1, 0):
            iters = tcfg_.lk_max_iters if l == 0 else tcfg_.lk_coarse_iters
            args, _ = k3_args(prev_pyr, cur_pyr, pts, flow, active, l, iters)
            steps = gn_steps(lambda k: lk.lk_iterate_plain(*args[:12], k, args[13])[0], iters)
            timing("lk_iterate", f"{label} level {l}", lambda: lk._lk_iterate_cuda(*args),
                   lambda: lk.lk_iterate_plain(*args),
                   kernel_bounds(pts.shape[0], 0, 0, pts.shape[1], iters,
                                 steps=sum(steps))["lk_iterate"], phase=phase,
                   launch_timer=launch_timer)
            timings[-1]["points_by_step"] = steps

    def kernels_on(d: int, f0, k2_in_, k3_in_, phase: str, errs: dict) -> None:
        """On card ``d``, launched from this thread (whose current device
        stays 0): K1 bit-exact on ``f0`` (B×480×640), K2 on ``k2_in_`` (B×N)
        and K3 on ``k3_in_`` (1×N) on both levels against their plain
        versions (their largest errors into ``errs``), then each timed on
        the card under its guard."""
        cd = torch.device("cuda", d)

        def to(x):
            return [y.to(cd) for y in x] if isinstance(x, list) else x.to(cd)

        x0 = f0.to(cd)
        b = x0.shape[0]
        out_k = fast.fast_nms(x0, thr)
        out_p = fast.nms3(fast.fast_score(x0, thr))
        require(out_k.device == cd and torch.equal(out_k, out_p), f"K1 bit-exact on {cd}")
        errs["fast_nms"] = max(errs["fast_nms"], float((out_k - out_p).abs().max()))
        k2_d, k3_d = tuple(map(to, k2_in_)), tuple(map(to, k3_in_))
        rep2, rep3 = compare_k2(*k2_d, tcfg_run), compare_k3(*k3_d, tcfg_run)
        errs["lk_level"] = max(errs["lk_level"], check_parity("K2", rep2))
        errs["lk_iterate"] = max(errs["lk_iterate"], check_parity("K3", rep3))
        require(torch.cuda.current_device() == 0, "the main thread's device stays 0")
        print(f"[{phase} {cd}] launched from the main thread (current device "
              f"{torch.cuda.current_device()}): K1 bit-exact on {b}x480x640; K2 {b}x{N}: "
              + summary(rep2) + f"; K3 1x{N}: " + summary(rep3), flush=True)
        with torch.cuda.device(cd):
            lt = LaunchTimer()
            timing("fast_nms", f"card {d}: {b}x480x640 rendered",
                   lambda: fast.fast_nms(x0, thr),
                   lambda: fast.nms3(fast.fast_score(x0, thr)),
                   kernel_bounds(b, 480, 640, N, 0, pairs=fast_pairs(x0, thr))["fast_nms"],
                   phase=phase, launch_timer=lt)
            time_k2(k2_d, tcfg_run, f"card {d}: {b}x{N}", phase=phase, launch_timer=lt)
            time_k3(k3_d, tcfg_run, f"card {d}: 1x{N}", phase=phase, launch_timer=lt)

    def phase21(after_19: bool) -> dict:
        """Phase 21: the batched runner sharded by lane over the cards."""
        import __graft_entry_torch__ as graft

        cards = torch.cuda.device_count()
        mesh = make_mesh()
        staged = stage_sharded_path(dev, B * cards, T)
        f0, f1 = (f[:B] for f in staged["frames"])
        gen21 = torch.Generator(device=dev)
        gen21.manual_seed(21)
        k2_21 = k2_inputs(f0, f1, tcfg_run, N, gen21)
        k3_21 = tuple([x[:1].contiguous() for x in a] if isinstance(a, list)
                      else a[:1].contiguous() for a in k2_21)
        errs = dict.fromkeys(KERNELS, 0.0)

        # (a) every kernel on every card, launched from this thread, whose
        # current device stays 0; then timed on each card under its guard
        for d in range(cards):
            kernels_on(d, f0, k2_21, k3_21, "21a", errs)

        # (b), (c) the main path sharded: two shards of card 0, then every card
        r = run_sharded_path(staged, dev, mesh, per_card=B, time_frames=20, turns=3,
                             profile=2)
        check_sharded_path(r)
        for case, c in r["compare"].items():
            print(f"[21b {case}] run_sharded over {c['shards']} shards "
                  f"({c['shards_on']}), B={c['B']}, {T} frames, against run at B={c['B']} "
                  f"on {dev}: max|dP| {c['max_dP_m']:.3e} m, max cost rel "
                  f"{c['max_cost_rel']:.3e}, bit-equal {c['bit_equal']}, keyframes equal "
                  f"{c['keyframes_equal']}; lane err/bound m "
                  f"{[(x['err'], x['bound']) for x in c['lanes']]}; launches by card "
                  f"{c['counts']}; peak GB {c['peak_mem_gb']}", flush=True)
        e = r["eager_vs_run"]
        print(f"[21b E] run_eager against run at B={B} on {dev}, {T} frames: bit-equal "
              f"{e['bit_equal']}, max|dP| {e['max_dP_m']:.3e} m, max cost rel "
              f"{e['max_cost_rel']:.3e}, keyframes equal {e['keyframes_equal']}", flush=True)
        for k, t in r["timing"].items():
            p = r["profile"][k]
            print(f"[21c {k}] {SHARDED_LABELS[k]}, B={t['B']}: {t['ms_per_step']:.2f} ms/step "
                  f"(turns {[round(x, 2) for x in t['turns_ms']]}), "
                  f"{t['seq_frames_per_s']:.2f} seq-frames/s; x{t['step_ratio']:.3f} the step "
                  f"and x{t['throughput_ratio']:.3f} the seq-frames/s of A; host API calls "
                  f"{p['api_calls_per_frame']:.1f} per frame {p['api_calls']}", flush=True)
        for k, p in r["profile"].items():
            print(f"[21c profile {k}] {p['frames']} frames: host waits {p['host_syncs']}; by card "
                  f"{p['by_card']}", flush=True)

        # (d) the dry runs over every card (on one card phase 19's eight
        # shards of it, which phase 19 has run in this call)
        if cards > 1 or not after_19:
            dmesh = mesh if cards > 1 else [dev] * 8
            t1 = time.perf_counter()
            graft.dryrun_multichip(len(dmesh), mesh=dmesh)
            graft.dryrun_multichip_backend(len(dmesh), mesh=dmesh)
            r["dryruns_s"] = time.perf_counter() - t1
            print(f"[21d dry runs] over {[str(x) for x in dmesh]}: "
                  f"{r['dryruns_s']:.1f} s", flush=True)
        else:
            print("[21d dry runs] one card: phase 19 ran them over its eight shards", flush=True)
        r["errs"] = errs
        run_counts = [c["counts"] for c in r["compare"].values()]
        r["counts"] = {k: sum(sum(c[k].values()) for c in run_counts) for k in KERNELS}
        return r

    def phase22() -> dict:
        """Phases 22-22c: the failure reboot of the latency pipeline."""
        out = {}
        for key, vo, label in (("recovery", False, "22"), ("recovery_vo", True, "22b")):
            r = run_recovery_path(dev, vo=vo, record=True, profile=3,
                                  path=os.path.join(OUT_DIR, f"profile_{key}.txt"))
            check_recovery_path(r)
            plain = run_recovery_path(dev, vo=vo, replay=False, record=True)
            check_recovery_path(plain)
            cmp = replay_against_plain(plain.pop("record"), r.pop("record"))
            require(plain["flags"] == r["flags"] and cmp["bit_equal"],
                    (f"phase {label}: the replayed run against the plain one", cmp,
                     plain["flags"], r["flags"]))
            prof, pre, post = r["profile"], r["pre_burst"], r["post_reboot"]
            print(f"[{label} recovery{' VO' if vo else ''}] recovery_steady_fps "
                  f"{r['recovery_steady_fps']:.2f} recovery_triggered {r['recovery_triggered']} "
                  f"recovery_frames {r['recovery_frames']} recovery_ms {r['recovery_ms']:.1f} "
                  f"(bench.py run_recovery: {r['frames']} frames 640x480, black at "
                  f"{RECOVERY_AT}-{RECOVERY_AT + RECOVERY_N - 1}, failure check every frame, "
                  f"{'VO, cold LK on 4 levels' if vo else 'IMU'}); the failure seen at frame "
                  f"{r['fail_seen_at']}, NON_LINEAR again at frame {r['nonlinear_again_at']}; "
                  f"captures at frames {r['captures']}, one graph kept across the reboot "
                  f"{r['graph_kept']}; before the burst ATE {pre['err']:.4f} m (bound "
                  f"{pre['bound']:.3f}); after the reboot, relative motion {post['d_est']:.4f} m "
                  f"against the truth's {post['d_gt']:.4f} (error {post['err']:.4f}, not "
                  f"gated); host waits on the frame thread {prof['host_syncs']} over "
                  f"{prof['frames']} profiled frames {prof['host_sync_calls']}; launches "
                  f"{r['counts']}; plain per-op frames: recovery_steady_fps "
                  f"{plain['recovery_steady_fps']:.2f}, recovery_ms {plain['recovery_ms']:.1f}, "
                  f"the same solver flag on every frame; replay against plain over "
                  f"{cmp['outputs']} outputs: {cmp}; profile {prof}", flush=True)
            out[key], out[key + "_plain"] = r, plain
            done(label)
        lr = run_loop_recovery_path(dev)
        check_loop_recovery_path(lr)
        after = [t for t in lr["taken"] if t[0] > lr["fail_seen_at"]]
        print(f"[22c loop recovery] the latency-1-loop knobs on a 3-cycle revisit scene, "
              f"{lr['frames']} frames, failure check every frame: the worker's first loop "
              f"before frame {lr['burst_at']}, black from it; the failure seen at frame "
              f"{lr['fail_seen_at']}, NON_LINEAR again at frame {lr['nonlinear_again_at']}; "
              f"the stager drained without an exception; relocalizations taken by a solve "
              f"{len(lr['taken'])} ({len(after)} after the reboot, each made in the epoch it "
              f"was taken in: (frame, made, taken) {lr['taken']}); queued ones dropped at the "
              f"reset at frames {lr['dropped']}, refused as made before it at frames "
              f"{lr['refused']}; loops {lr['loops']} over {lr['keyframes']} keyframes; at most "
              f"{lr['max_round']} frames handed over at once; launches {lr['counts']}",
              flush=True)
        out["recovery_loop"] = lr
        done("22c")
        return out

    def phase23() -> dict:
        """Phase 23: the batched closer's three modes from one staging."""
        staged = stage_batched_loop_path(dev)
        runs = {}
        for mode in ("threaded", "pipelined", "inline"):
            r = run_batched_loop_path(dev, mode=mode, staged=staged)
            check_batched_loop_path(r)
            runs[mode] = r
        staged["runner"].close()
        cmp = compare_closer_modes(runs)
        for mode, c in cmp.items():
            require(c["keyframes_equal"] and c["loops_equal"] and c["rel_t_max_diff"] <= 5e-5,
                    (f"phase 23: the {mode} closer against the threaded one", c))
        require(runs["pipelined"]["own_outputs"],
                "phase 23: each segment's ScanOutputs its own, unchanged by later segments")
        for mode, r in runs.items():
            rd = r["closer_reads"]
            reads = ("" if rd is None else f"; the closer's host reads on the frame thread "
                     f"{rd['reads']}, {rd['waited']} of them waiting for the device "
                     f"({1e3 * rd['wait_s']:.1f} ms in all)")
            print(f"[23 {mode}] batched-8-loop, B={r['B']}, {r['n_timed']} timed lock-step "
                  f"frames: {r['seq_frames_per_s']:.2f} seq-frames/s drain-inclusive, "
                  f"{r['ms_per_frame']:.3f} ms per lock-step frame, drain tail "
                  f"{r['drain_tail_ms']:.1f} ms; loop_kf {r['loop_kf']}, loops_found "
                  f"{r['loops_found']}; loop_ate_m {r['loop_ate_m']:.4f}, loop_vio_ate_m "
                  f"{r['loop_vio_ate_m']:.4f}; ate_m {r['ate_m']:.4f}; against the threaded "
                  f"closer {cmp[mode]}; closer stage ms {r['stage_ms']}; launches "
                  f"{r['counts']}{reads}", flush=True)
        done("23")
        return {f"batched_loop_{m}": r for m, r in runs.items()}

    def phase24(tap=None) -> dict:
        """Phase 24: K4 (the solve's projection assembly) against its plain
        version at every (B, M, NXP) that ``tap`` (an entered
        ``ProjSchurTap``, which the phase closes; one of its own without)
        took from the paths' runs, each at its kept
        solve's assembly: as close to the plain version in float64 as the
        plain float32 version (``k4_within``), two launches bit-equal, Hpp
        mirrored bit for bit, then timed beside its bound and the plain
        version's ms.  The shapes cover K4's tiles of 8, 16 and 32 features
        (without a tapped shape of tile 16, the fleet's lanes 0-7 stand in).
        First the main path's three shapes are run: the fleet's batched VO
        (32 × 376), its replayed steps held to ``run_eager`` bit for bit and
        its K4 launches per replayed step counted; the VO loop robot (1 ×
        376, the relo block: NXP 178), its replayed frames held to its plain
        per-op frames bit for bit in lock step; the RealSense robot (1 × 48,
        td and rolling shutter)."""
        out = {}
        tap = tap if tap is not None else ProjSchurTap().__enter__()
        try:
            fl = run_main_path(dev, 32, 8, max_cnt=250, vo=True, eager=True)
            check_main_path(fl, 32, 8)
            e = fl["eager"]
            require(e["bit_equal"] and e["states_equal"],
                    ("phase 24: the fleet's replayed steps against run_eager", e))
            runner = fl["runner"]
            per_step = fl["k4_per_replayed_frame"]
            runner.close()
            print(f"[24 fleet] batched VO B=32 640x480, max_cnt 250 ({runner.ecfg.maxf} slots), "
                  f"warm 11 + 8 steady frames: run against run_eager bit-equal "
                  f"{e['bit_equal']}, states equal {e['states_equal']}; eager "
                  f"{e['eager_step_ms']:.2f} ms/step; K4 {per_step:.0f} launches per replayed "
                  f"step (counted by replay); ATE m {[round(a, 4) for a in fl['ates']]}; "
                  f"launches {fl['counts']}", flush=True)
            out["fleet"] = dict(eager=e, k4_per_step=per_step, ates=fl["ates"],
                                counts=fl["counts"])
            lock = {}
            for rp in (False, True):
                lock[rp] = run_loop_path(dev, max_cnt=250, vo=True, lockstep=True, replay=rp,
                                         record=True)
                check_loop_path(lock[rp])
            cmp = replay_against_plain(lock[False].pop("record"), lock[True].pop("record"))
            require(cmp["bit_equal"], ("phase 24: the VO loop robot's replayed frames against "
                                       "the plain ones", cmp))
            print(f"[24 loop robot] the VO loop cell in lock step, plain / replayed: "
                  f"latency_ms_per_frame {lock[False]['latency_ms_per_frame']:.3f} / "
                  f"{lock[True]['latency_ms_per_frame']:.3f}, launches {lock[False]['counts']} "
                  f"/ {lock[True]['counts']}; replay against plain: {cmp}", flush=True)
            out["loop_robot"] = dict(compare=cmp, counts=lock[True]["counts"], **{
                k: [lock[rp][k] for rp in (False, True)]
                for k in ("latency_ms_per_frame", "latency_ate_m")})
            rig_r, seq_r, cfg_r = realsense_scene(40)
            td = run_rig_path(dev, cfg_r, rig_r, seq_r, n_frames=40, failure_check_interval=4,
                              imu_shift=TD_TRUE)
            check_rig_path(td)
            print(f"[24 IMU robot] RealSense rig, td and rolling shutter, 40 frames: "
                  f"latency_ms_per_frame {td['latency_ms_per_frame']:.3f}, td {td['td']:.5f} "
                  f"s, launches {td['counts']}", flush=True)
            out["imu_robot"] = dict(counts=td["counts"], td=td["td"],
                                    latency_ms_per_frame=td["latency_ms_per_frame"])
        finally:
            tap.__exit__()
        kept = tap.shapes(dev)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        tiles = {key: slv.proj_schur_tile(key[0], key[1], n_sm) for key in kept}
        if 16 not in tiles.values():
            live, x, vis, s = kept[(32, 376, 172)]
            part = tuple(type(t)(*[a[:8].contiguous() for a in t]) for t in (x, vis, s))
            kept[(8, 376, 172)] = (live_factors(part[1]),) + part
            tiles[(8, 376, 172)] = slv.proj_schur_tile(8, 376, n_sm)
        shapes = {}
        for key in sorted(kept, reverse=True):
            live, x, vis, s = kept[key]
            B_, M_, nxp = key
            label = f"{B_}x{M_} NXP {nxp}"
            c = compare_k4(x, vis, s)
            require(c["repeat_bit_equal"] and c["mirrored"] and k4_within(c),
                    ("phase 24: K4", label, c))
            timing("proj_schur", label, lambda: slv.proj_schur(x, vis, s),
                   lambda: slv.proj_schur_plain(x, vis, s),
                   proj_schur_bound(B_, M_, nxp, live), phase="24")
            shapes[label] = dict(live=live, tile=tiles[key], **c)
            print(f"[24 K4 {label}] tile {tiles[key]}, {live} live factors: against the plain "
                  f"version in float64 (largest error over its entry's scale) K4 "
                  f"{c['err_k4']}, plain float32 {c['err_plain']}; K4 against plain float32 "
                  f"{c['rel']}; two launches bit-equal {c['repeat_bit_equal']}; Hpp mirrored "
                  f"{c['mirrored']}", flush=True)
        require({(32, 376, 172), (1, 376, 178)} <= set(kept)
                and any(k[0] == 1 and k[2] == 172 for k in kept)
                and {8, 16, 32} <= set(tiles.values()),
                ("phase 24: the three shapes and K4's three tiles", tiles))
        out["shapes"] = shapes
        done("24")
        return out

    def k4_entry(r24: dict, paths=None) -> dict:
        """K4's row of the ``kernels`` line: its launches summed over the
        paths that count them (``paths``, with phase 24's three runs), each
        path's own count and, on the batched paths, per replayed frame; its
        errors over every shape; the fleet's shape's timing."""
        paths = {**(paths or {}), **{"k4_" + p: r24[p]
                                     for p in ("fleet", "loop_robot", "imu_robot")}}
        by_path = {p: r["counts"]["proj_schur"] for p, r in paths.items()
                   if "proj_schur" in r.get("counts", {})}
        rows = [t for t in timings if t["kernel"] == "proj_schur"]
        main = next(t for t in rows if t["shape"].startswith("32x376"))
        return dict(name="proj_schur", route="cuda",
                    source="vins_rgbd_fast_torch/csrc/proj_schur.cu", replaces=None,
                    launches=sum(by_path.values()), launches_by_path=by_path,
                    per_replayed_frame={p: r["k4_per_replayed_frame"] for p, r in paths.items()
                                        if r.get("k4_per_replayed_frame") is not None},
                    launches_per_step=r24["fleet"]["k4_per_step"],
                    max_err=max(max(c["err_k4"].values()) for c in r24["shapes"].values()),
                    max_err_plain=max(max(c["err_plain"].values())
                                      for c in r24["shapes"].values()),
                    ms=main["device_ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main["bound_by"], library_ms=None, host_us=main["host_us"],
                    timings={t["shape"]: dict(ms=t["device_ms"], bound_ms=t["bound_ms"],
                                              plain_ms=t["plain_ms"]) for t in rows})

    if phases == "24":  # phases 1-2, the main path's two B = 8 shapes tapped, and 24
        done("1-2")
        k4_tap = ProjSchurTap().__enter__()
        mains = {}
        for name, vo in (("batched", False), ("batched_vo", True)):
            r = run_main_path(dev, B, 8, max_cnt=250 if vo else 130, vo=vo)
            check_main_path(r, B, 8)
            r["runner"].close()
            mains[name] = r
            print(f"[24 {name}] B={B} 640x480, max_cnt {250 if vo else 130} "
                  f"({r['runner'].ecfg.maxf} slots), warm 11 + 8 steady frames: K4 "
                  f"{r['k4_per_replayed_frame']:.0f} per replayed frame (counted by replay); "
                  f"launches {r['counts']}; ATE m {[round(a, 4) for a in r['ates']]}", flush=True)
        done("24 main")
        r24 = phase24(k4_tap)
        with open(os.path.join(OUT_DIR, "chip_smoke_24.json"), "w") as f:
            json.dump(dict(card=smi, timings=timings, phase_s=phase_s, k4=r24, main={
                n: {k: r[k] for k in ("ates", "counts", "k4_per_replayed_frame")}
                for n, r in mains.items()}), f, indent=1, default=float)
        return finish(smi_cards, phase_s, [k4_entry(r24, mains)])

    if phases in ("22", "23"):  # phases 1-2, the kernels on card 0, and the phase alone
        done("1-2")
        _, rendered_, _ = make_sequences(rig, B, 2, dev)
        f0, f1 = (torch.stack([r[1][k] for r in rendered_]).contiguous() for k in (0, 1))
        gen_ = torch.Generator(device=dev)
        gen_.manual_seed(0)
        k2_p = k2_inputs(f0, f1, tcfg_run, N, gen_)
        k3_p = tuple([x[:1].contiguous() for x in a] if isinstance(a, list)
                     else a[:1].contiguous() for a in k2_p)
        errs = dict.fromkeys(KERNELS, 0.0)
        kernels_on(0, f0, k2_p, k3_p, phases + "a", errs)
        del rendered_, f0, f1, k2_p, k3_p
        done(phases + "a")
        got = phase22() if phases == "22" else phase23()
        with open(os.path.join(OUT_DIR, f"chip_smoke_{phases}.json"), "w") as f:
            json.dump(dict(card=smi, timings=timings, phase_s=phase_s, **{
                k: {x: y for x, y in v.items() if x not in ("cost", "segments")}
                for k, v in got.items()}), f, indent=1, default=float)
        return finish(smi_cards, phase_s, kernel_entries(
            got, errs, {"fast_nms": f"card 0: {B}x480x640 rendered",
                        "lk_level": f"card 0: {B}x{N} level",
                        "lk_iterate": f"card 0: 1x{N} level"}, timings))

    if phases == "21":  # phases 1-2 and 21 alone (the multi-card call)
        done("1-2")
        r21 = phase21(after_19=False)
        done("21")
        with open(os.path.join(OUT_DIR, "chip_smoke_21.json"), "w") as f:
            json.dump(dict(card=smi, cards=smi_cards, timings=timings, batched_sharded=r21,
                           phase_s=phase_s), f, indent=1, default=float)
        return finish(smi_cards, phase_s, kernel_entries(
            {"batched_sharded": dict(counts=r21["counts"], profile=r21["profile"]["D"])},
            r21["errs"], {"fast_nms": f"card 0: {B}x480x640 rendered",
                          "lk_level": f"card 0: {B}x{N} level",
                          "lk_iterate": f"card 0: 1x{N} level"}, timings))

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

    # 4d. K2 at the batched VO path's shapes: B x 376 cold tracks (the 376
    # strongest corners of each frame, started at their own positions) on 4
    # levels down to 80x60, where the 38-wide search window clamps
    k2_vo = k3_vo_inputs(frame0, frame1, tcfg.fast_threshold, NV)
    rep2_vo = compare_k2(*k2_vo, tcfg_run)
    print(f"[4d K2 VO] {B}x{NV}, {len(k2_vo[0])} levels, cold: " + summary(rep2_vo), flush=True)
    k2_err = max(k2_err, check_parity("K2", rep2_vo))

    done("4d")

    # 5. the main path: run (its first frame eager and captured, the rest
    # replayed), after run_eager over the same frames from the same states
    # and generator states (the per-op dispatch, held to bit for bit).  From
    # here to phase 24, which checks them, K4's inputs are tapped at every
    # shape the paths give it
    k4_tap = ProjSchurTap().__enter__()
    res = run_main_path(dev, B, T, extra=EXTRA, timer=CudaTimer(), eager=True)
    check_main_path(res, B, T)
    step5, e5 = res["step_ms"], res["eager"]
    print(f"[5 main] B={B} 640x480, warm 11 + {T} steady frames: "
          f"{1e3 / step5:.2f} steps/s = {B * 1e3 / step5:.2f} sequence-frames/s "
          f"({step5:.2f} ms/step over the {T - 1} replayed frames, CUDA events; the first "
          f"frame with its warm-up and capture {res['capture_s']:.3f} s); launches "
          f"{res['counts']}, K4 {res['k4_per_replayed_frame']:.0f} per replayed frame; ATE m "
          f"{[round(a, 4) for a in res['ates']]} (bounds "
          f"{[round(b, 3) for b in res['bounds']]}); features/seq "
          f"{res['n_features'][-1].tolist()}", flush=True)
    print(f"[5 eager] run_eager over the same {T} frames: {e5['eager_step_ms']:.2f} "
          f"ms/step (x{e5['eager_step_ms'] / step5:.2f} the replayed step); run against it: "
          f"outputs bit-equal {e5['bit_equal']}, end states bit-equal {e5['states_equal']}, "
          f"first difference {e5['first_difference']}, max|dP| {e5['max_dP_m']:.3e} m, max "
          f"cost rel {e5['max_cost_rel']:.3e}, keyframes equal {e5['keyframes_equal']}",
          flush=True)

    done("5")

    # 6. timings and profile
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
    time_k2(k2_in, tcfg_run, f"{B}x{N}")
    stages = stage_breakdown(res, res["extra_batch"][0])
    print(f"[6 stages] ms per steady frame, synchronised per stage: {stages}", flush=True)
    prof = profile_frames(res, os.path.join(OUT_DIR, "profile_steady.txt"), step5)
    print(f"[6 profile] replayed frames: {prof}", flush=True)
    check_replay_profile(prof, {"fast_nms": 1, "lk_level": res["levels"]}, "phase 6")

    res["runner"].close()  # its captured frame and the graph's memory pool

    done("6")

    # 7. the latency path (its own launch counts, zeroed just before it), at a
    # depth of 16 + 48 frames: first the plain per-op frames (1 profiled),
    # then the replayed ones (3 profiled), from the same states and generator
    # states (two pipelines built alike and fed the same frames); the replay
    # held to the plain frames bit for bit.  Each profiled frame's trace
    # takes seconds to export and read when it holds ~9 k launches
    lat_plain = run_latency_path(dev, n_frames=64, profile=1, replay=False, record=True,
                                 path=os.path.join(OUT_DIR, "profile_latency_plain.txt"))
    check_latency_path(lat_plain)
    lat = run_latency_path(dev, n_frames=64, profile=3, record=True,
                           path=os.path.join(OUT_DIR, "profile_latency.txt"))
    check_latency_path(lat)
    cmp7 = replay_against_plain(lat_plain.pop("record"), lat.pop("record"))
    require(cmp7["bit_equal"], ("phase 7: the replayed frames against the plain ones", cmp7))
    print(f"[7 latency] 1 stream 640x480, warm 16 + {lat['frames'] - 16} timed frames, "
          f"replayed: latency_fps {lat['latency_fps']:.2f}, latency_ms_per_frame "
          f"{lat['latency_ms_per_frame']:.3f} (CUDA-synchronised wall; the plain per-op frames "
          f"in this call {lat_plain['latency_ms_per_frame']:.3f}, x"
          f"{lat_plain['latency_ms_per_frame'] / lat['latency_ms_per_frame']:.2f}), "
          f"latency_ate_m {lat['latency_ate_m']:.4f} (bound {lat['bound']:.3f}); "
          f"{replay_note(lat, lat_plain)}; replay against plain over {cmp7['outputs']} "
          f"outputs: {cmp7}; launches {lat['counts']}; profile {lat['profile']}; plain profile "
          f"{lat_plain['profile']}", flush=True)

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
    # K2 at the batched VO shapes, each level from the flow the plain version
    # carried down
    prev_pyr, cur_pyr, pts, init, active = k2_vo
    flow = (init - pts) / 2.0 ** (len(prev_pyr) - 1)
    for l in range(len(prev_pyr) - 1, -1, -1):
        iters = tcfg_run.lk_max_iters if l == 0 else tcfg_run.lk_coarse_iters
        prev, cur, pts_l, flow, ax, ay = level_inputs(prev_pyr, cur_pyr, pts, flow, l)
        args = (prev, cur, pts_l, flow, active, ax, ay, LK["win"], LK["sm"], iters,
                LK["eps"], LK["min_eig"])
        steps = gn_steps(lambda k: lk.lk_level_plain(*args[:9], k, *args[10:])[0], iters)
        timing("lk_level", f"{B}x{NV} level {l} VO", lambda: lk._lk_level_cuda(*args),
               lambda: lk.lk_level_plain(*args),
               kernel_bounds(B, *prev.shape[-2:], NV, iters, footprint=k2_footprint(
                   prev, pts_l, ax, ay), steps=sum(steps))["lk_level"], phase=8)
        timings[-1]["points_by_step"] = steps
        flow = 2.0 * lk.lk_level_plain(*args)[0]

    done("8")

    # 9. the latency path with loop closure (its own launch counts)
    loop = run_loop_path(dev, profile=3, path=os.path.join(OUT_DIR, "profile_loop.txt"))
    require(loop["profile"] is not None, "phase 9 profiled")
    check_loop_path(loop)
    cmp_verify = verify_replay_against_plain(loop["graph"])
    require(cmp_verify["bit_equal"], ("phase 9: the replayed loop check against the plain one",
                                      cmp_verify))
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
          f"consumed by the worker in the timed frames and their drain (keyframes "
          f"{loop['relo_keyframes']}), at most {loop['max_round']} frames handed over at once; "
          f"the replayed loop check against the plain one: {cmp_verify}; "
          f"{replay_note(loop)}; profile {loop['profile']}", flush=True)

    done("9")

    # 9b. the same scene and configuration with no pose graph (the relo
    # block in the solve, never active): what the worker costs the frame
    # thread; the plain per-op frames first, the replay held to them bit for bit
    alone_plain = run_latency_path(dev, revisit=True, replay=False, record=True)
    check_latency_path(alone_plain, on_gpu=False)
    alone = run_latency_path(dev, profile=3, revisit=True, record=True,
                             path=os.path.join(OUT_DIR, "profile_loop_no_graph.txt"))
    check_latency_path(alone, on_gpu=False)
    cmp9b = replay_against_plain(alone_plain.pop("record"), alone.pop("record"))
    require(cmp9b["bit_equal"], ("phase 9b: the replayed frames against the plain ones", cmp9b))
    print(f"[9b no graph] the loop cell without the pose graph, replayed: latency_ms_per_frame "
          f"{alone['latency_ms_per_frame']:.3f} (plain per-op frames "
          f"{alone_plain['latency_ms_per_frame']:.3f}; phase 9: "
          f"{loop['latency_ms_per_frame']:.3f}, phase 7: {lat['latency_ms_per_frame']:.3f}), "
          f"latency_ate_m {alone['latency_ate_m']:.4f}; launches {alone['counts']}; "
          f"{replay_note(alone)}; replay against plain: {cmp9b}; profile: "
          f"{alone['profile']['kernels_per_frame']:.1f} launches and "
          f"{alone['profile']['device_ms_per_frame']} device ms per frame, "
          f"{alone['profile']['host_syncs']} host waits", flush=True)

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

    # 9e. phase 9 again with the port's tracer on: the worker's seconds by
    # span, and what tracing costs the frame thread (against 9 and 9c's 9)
    loop_traced = run_loop_path(dev, trace=True)
    check_loop_path(loop_traced)
    print(f"[9e traced] the loop cell with the tracer on: latency_ms_per_frame "
          f"{loop_traced['latency_ms_per_frame']:.3f} (untraced, phase 9 and 9c: "
          f"{loop['latency_ms_per_frame']:.3f}, {loop2['latency_ms_per_frame']:.3f}), "
          f"latency_loops {loop_traced['latency_loops']}; worker seconds by stage "
          f"{loop_traced['worker_s']}", flush=True)

    done("9e")

    # 10. the batched path with loop closure (its own launch counts)
    # the profile covers 6 frames of a segment: a profiled frame's trace
    # takes seconds to export and read, and the script's time goes to the
    # later phases
    bl = run_batched_loop_path(dev, profile=6,
                               path=os.path.join(OUT_DIR, "profile_batched_loop.txt"))
    require(bl["profile"] is not None, "phase 10 profiled")
    check_batched_loop_path(bl)
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
    # graph on the worker (its own launch counts).  First the plain per-op
    # frames and the replayed ones in lock step with the worker (a loop's
    # relocalization then reaches the estimator at a fixed frame), the replay
    # (traced: its graph holds the stage marks) held to the plain frames bit
    # for bit; then the timed run
    vo_lock = {}
    for rp in (False, True):
        vo_lock[rp] = run_loop_path(dev, max_cnt=250, vo=True, lockstep=True, replay=rp,
                                    record=True, trace=rp)
        check_loop_path(vo_lock[rp])
    cmp11 = replay_against_plain(vo_lock[False].pop("record"), vo_lock[True].pop("record"))
    require(cmp11["bit_equal"], ("phase 11: the replayed frames against the plain ones", cmp11))
    print(f"[11 VO lock step] the VO loop cell with the worker drained after each hand-over, "
          f"plain / replayed: latency_ms_per_frame "
          f"{vo_lock[False]['latency_ms_per_frame']:.3f} / "
          f"{vo_lock[True]['latency_ms_per_frame']:.3f}, relocalizations consumed "
          f"{vo_lock[False]['relo_consumed']} / {vo_lock[True]['relo_consumed']}, loops "
          f"{vo_lock[True]['loops']}, latency_loop_ate_m "
          f"{vo_lock[True]['latency_loop_ate_m']:.4f} against the VO keyframes' "
          f"{vo_lock[True]['latency_vio_kf_ate_m']:.4f}; replay against plain: {cmp11}; worker "
          f"seconds by stage (replayed, traced) {vo_lock[True]['worker_s']}", flush=True)
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
          f"in the timed frames); {vo['relo_consumed']} relocalizations consumed in the timed "
          f"frames and their drain, at most {vo['max_round']} frames handed over at once; "
          f"{replay_note(vo)}; profile {vo['profile']}", flush=True)

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
    check_rig_path(td, waits=2)
    print(f"[12 td] RealSense rig 640x480, max_cnt 30 ({cfg_r.feature_capacity} slots), td "
          f"estimated (truth {TD_TRUE} s), rolling shutter, extrinsic refined; warm 16 + "
          f"{td['timed']} timed frames, fused: latency_ms_per_frame "
          f"{td['latency_ms_per_frame']:.3f} (phase 7 in this run: "
          f"{lat['latency_ms_per_frame']:.3f}), latency_ate_m {td['latency_ate_m']:.4f} (bound "
          f"{td['bound']:.3f}); final td {td['td']:.5f} s (host pairing td "
          f"{td['td_cache']:.5f}); extrinsic drift {td['ric_err_deg']:.3f} deg; launches "
          f"{td['counts']} over {td['tracked']} tracked frames; {replay_note(td)}; profile "
          f"{td['profile']}", flush=True)

    done("12")

    # 12b. the same stream calibrating the extrinsic rotation online from
    # 5 degrees off (unfused: JAX's fused steady state does not calibrate)
    cal = run_rig_path(dev, calib_config(cfg_r, seq_r), rig_r, seq_r, n_frames=64, fused=False,
                       failure_check_interval=4, imu_shift=TD_TRUE)
    check_rig_path(cal)
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
    check_rig_path(dyn)
    require(("init_dynamic", True) in dyn["attempts"], ("init_dynamic", dyn["attempts"]))
    print(f"[13 dynamic init] OpenLORIS rig 848x480 30 Hz, max_cnt 130 "
          f"({cfg_o.feature_capacity} slots), depth to 3 m; warm 16 + {dyn['timed']} timed "
          f"frames, fused: initialized at frame {dyn['init_frame']} by {dyn['attempts']}; "
          f"latency_ms_per_frame {dyn['latency_ms_per_frame']:.3f}; relative motion "
          f"{dyn['d_est']:.4f} m against {dyn['d_gt']:.4f} m; aligned ATE "
          f"{dyn['aligned_ate_m']:.4f} m; launches {dyn['counts']}; {replay_note(dyn)}; profile "
          f"{dyn['profile']}", flush=True)

    done("13")

    # 13b. the same stream with its depth withheld until the estimator
    # initializes: dynamic initialization cannot, the monocular one must
    mono = run_rig_path(dev, cfg_o, rig_o, seq_o, n_frames=64, depthless=True)
    check_rig_path(mono, init_by=24)
    require(mono["attempts"][-1] == ("init_mono", True), ("init_mono initialized",
                                                          mono["attempts"]))
    print(f"[13b monocular init] phase 13's stream, depth withheld until initialization: "
          f"initialized at frame {mono['init_frame']} by {mono['attempts']}; relative motion "
          f"{mono['d_est']:.4f} m against {mono['d_gt']:.4f} m; aligned ATE "
          f"{mono['aligned_ate_m']:.4f} m; latency_ms_per_frame "
          f"{mono['latency_ms_per_frame']:.3f}; {replay_note(mono)}", flush=True)

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
          f"over {bagr['tracked']} tracked frames; {replay_note(bagr)}; profile "
          f"{bagr['profile']}", flush=True)

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
          f"frames; {replay_note(tumr)}; profile {tumr['profile']}; one 640x480 RGB PNG of "
          f"Paeth rows decodes in "
          f"{png['ms']:.2f} ms on the host", flush=True)

    done("14b")

    # 14c. the fisheye mask: the analytic circle and a mask file
    fish = run_fisheye(dev)
    check_fisheye(fish)
    print(f"[14c fisheye] 8 frames of the latency tracker 640x480, live points per frame and "
          f"points outside the mask (read on the device): {fish}", flush=True)
    fishp = run_fisheye_pipeline(dev)
    check_fisheye_pipeline(fishp)
    print(f"[14c fisheye pipeline] phase 7's stream with the circle mask and CLAHE, "
          f"{fishp['frames']} frames, replayed against plain: {fishp['compare']}; captured "
          f"{fishp['captured']}; launches {fishp['counts']}", flush=True)

    done("14c")

    # 14d. phase 16's Kannala-Brandt rig file through run_vio in a child
    # process, on a bag of frames rendered through the fisheye's rays
    kbe = run_camera_entry(dev)
    check_camera_entry(kbe)
    ent = kbe["entry"]
    print(f"[14d KB run_vio] {kbe['camera']} rig 640x480, {kbe['frames']} frames in a "
          f"{kbe['bag_mb']:.1f} MB rosbag: run_vio exit {ent['rc']} in {ent['wall_s']:.1f} s, "
          f"{ent['n_outputs']} odometry outputs = {kbe['csv_rows']} CSV rows, ATE "
          f"{kbe['run_vio_ate_m']:.4f} m (bound {kbe['bound']:.3f})", flush=True)

    done("14d")

    # 15. batched VO: the TUM rig's knobs on BatchedVioRunner (its own launch
    # counts), and a profile of 3 more steady frames
    vob = run_main_path(dev, B, T, max_cnt=250, extra=6, timer=CudaTimer(), vo=True)
    check_main_path(vob, B, T)
    step15 = vob["step_ms"]
    prof15 = profile_frames(vob, os.path.join(OUT_DIR, "profile_batched_vo.txt"), step15)
    check_replay_profile(prof15, {"fast_nms": 1, "lk_level": vob["levels"]}, "phase 15")
    vob["profile"] = prof15
    print(f"[15 batched VO] B={B} 640x480, no IMU, max_cnt 250 "
          f"({vob['runner'].ecfg.maxf} slots), cold LK on {vob['levels']} levels, warm 11 + "
          f"{T} steady frames: {step15:.2f} ms/step over the {T - 1} replayed frames (phase 5 "
          f"in this run: {step5:.2f}) = {B * 1e3 / step15:.2f} sequence-frames/s (CUDA events; "
          f"first frame and capture {vob['capture_s']:.3f} s); launches {vob['counts']} (K4 "
          f"{vob['k4_per_replayed_frame']:.0f} per replayed frame) over "
          f"{vob['frames']} frames; ATE m "
          f"{[round(a, 4) for a in vob['ates']]} (bounds "
          f"{[round(b, 3) for b in vob['bounds']]}); features/seq "
          f"{vob['n_features'][-1].tolist()}; profile {prof15}", flush=True)

    vob["runner"].close()

    done("15")

    # 15b. batched VO with the 6-DoF closer on the worker (its own launch
    # counts): 14 warm-up frames, the warm segment and 5 timed ones of 18
    bvl = run_batched_loop_path(dev, n_frames=14 + 6 * 18, max_cnt=250, vo=True)
    check_batched_loop_path(bvl)
    print(f"[15b batched VO loop] B={bvl['B']} 640x480, {bvl['n_revisit']} revisit sequences, "
          f"no IMU, 6-DoF graphs, {bvl['n_timed']} timed lock-step frames through the threaded "
          f"closer: {bvl['seq_frames_per_s']:.2f} seq-frames/s drain-inclusive, "
          f"{bvl['ms_per_frame']:.3f} ms per lock-step frame (phase 15 in this run: "
          f"{step15:.3f}); drain tail {bvl['drain_tail_ms']:.1f} ms; loop_kf {bvl['loop_kf']}, "
          f"loops_found {bvl['loops_found']}, 6-DoF solves {bvl['solves_6dof']}; loop_ate_m "
          f"{bvl['loop_ate_m']:.4f}, vo_kf_ate_m {bvl['loop_vio_ate_m']:.4f}; ate_m "
          f"{bvl['ate_m']:.4f}, ate_max_m {bvl['ate_max_m']:.4f} (bounds "
          f"{[round(b, 3) for b in bvl['bounds']]}); closer stage ms {bvl['stage_ms']}; "
          f"launches {bvl['counts']} ({bvl['chunks']} extraction chunks)", flush=True)

    done("15b")

    # 16. a Kannala-Brandt rig file through the latency pipeline (its own
    # launch counts), frames rendered through the fisheye's rays
    kb = run_latency_path(dev, n_frames=64, profile=2, camera="KANNALA_BRANDT",
                          path=os.path.join(OUT_DIR, "profile_kb.txt"))
    check_latency_path(kb)
    require(kb["camera"] == "EquidistantCamera", ("the KB rig's camera", kb["camera"]))
    print(f"[16 KB] Kannala-Brandt rig 640x480 (mu = mv = 300, k2..k5 = -0.01, 0.002, 0, 0) "
          f"from {kb['rig_file']}, warm 16 + {kb['frames'] - 16} timed frames, fused: "
          f"latency_ms_per_frame {kb['latency_ms_per_frame']:.3f} (phase 7 in this run: "
          f"{lat['latency_ms_per_frame']:.3f}), latency_ate_m {kb['latency_ate_m']:.4f} (bound "
          f"{kb['bound']:.3f}); launches {kb['counts']}; {replay_note(kb)}; profile "
          f"{kb['profile']}", flush=True)

    done("16")

    # 16b. the Mei and Scaramuzza cameras in the latency tracker; the three
    # models' lift and project on the card against the CPU
    cams = run_cameras(dev)
    check_cameras(cams)
    print(f"[16b cameras] 8 frames of the latency tracker 640x480 per model, live points per "
          f"frame, and lift/project at 10k pixels on the card against the CPU (largest "
          f"relative difference): {cams}", flush=True)

    done("16b")

    # 16c. Mei and Scaramuzza rig files through the latency pipeline (each
    # its own launch counts)
    rigs = {}
    for m in ("MEI", "SCARAMUZZA"):
        r = run_latency_path(dev, n_frames=28, profile=1, camera=m,
                             path=os.path.join(OUT_DIR, f"profile_{m.lower()}.txt"))
        check_latency_path(r)
        rigs[m] = r
        print(f"[16c {m}] {r['camera']} rig 640x480 from {r['rig_file']}, warm 16 + "
              f"{r['frames'] - 16} timed frames, fused: latency_ms_per_frame "
              f"{r['latency_ms_per_frame']:.3f} (phase 7 in this run: "
              f"{lat['latency_ms_per_frame']:.3f}), latency_ate_m {r['latency_ate_m']:.4f} "
              f"(bound {r['bound']:.3f}); launches {r['counts']}; {replay_note(r)}; profile "
              f"{r['profile']}", flush=True)
    require(rigs["MEI"]["camera"] == "MeiCamera"
            and rigs["SCARAMUZZA"]["camera"] == "ScaramuzzaCamera",
            ("the rigs' cameras", [r["camera"] for r in rigs.values()]))

    done("16c")

    # 16d. phase 16's Kannala-Brandt camera on the batched runner (its own
    # launch counts)
    T_KB = 16
    kbb = run_main_path(dev, B, T_KB, timer=CudaTimer(), camera="KANNALA_BRANDT")
    check_main_path(kbb, B, T_KB)
    require(kbb["camera"] == "EquidistantCamera", ("the batched camera", kbb["camera"]))
    kbb["profile"] = None
    kbb["runner"].close()
    print(f"[16d batched KB] B={B} 640x480 Kannala-Brandt, warm 11 + {T_KB} steady frames: "
          f"{kbb['step_ms']:.2f} ms/step replayed (phase 5 in this run: {step5:.2f}); "
          f"launches {kbb['counts']} over {kbb['frames']} frames; ATE m "
          f"{[round(a, 4) for a in kbb['ates']]} (bounds "
          f"{[round(b, 3) for b in kbb['bounds']]})", flush=True)

    done("16d")

    # 16e. phase 16c's Mei and Scaramuzza cameras on phase 16d's batched
    # runner (each its own launch counts)
    bcams = {}
    for m in ("MEI", "SCARAMUZZA"):
        r = run_main_path(dev, B, T_KB, timer=CudaTimer(), camera=m)
        check_main_path(r, B, T_KB)
        r["profile"] = None
        r["runner"].close()
        bcams[m] = r
        print(f"[16e batched {m}] B={B} 640x480 {r['camera']}, warm 11 + {T_KB} steady frames: "
              f"{r['step_ms']:.2f} ms/step replayed (phase 16d in this run: "
              f"{kbb['step_ms']:.2f}); launches {r['counts']} over {r['frames']} frames; "
              f"ATE m {[round(a, 4) for a in r['ates']]} (bounds "
              f"{[round(b, 3) for b in r['bounds']]})", flush=True)
    require(bcams["MEI"]["camera"] == "MeiCamera"
            and bcams["SCARAMUZZA"]["camera"] == "ScaramuzzaCamera",
            ("the batched cameras", [r["camera"] for r in bcams.values()]))

    done("16e")

    # 16f. the Scaramuzza rig with an affine stretch through the latency
    # pipeline (its own launch counts), frames rendered through its lift
    ocs = run_latency_path(dev, n_frames=28, profile=1, camera="SCARAMUZZA_AFFINE",
                           path=os.path.join(OUT_DIR, "profile_ocam_affine.txt"))
    check_latency_path(ocs)
    cam_s = camera_config("SCARAMUZZA_AFFINE", VinsConfig(image_width=640,
                                                          image_height=480)).camera()
    require((cam_s.C, cam_s.D, cam_s.E) == OCAM_STRETCH, ("the stretch", cam_s))
    ocs["lift_project_px"] = lift_project_px(cam_s, dev)
    print(f"[16f OCAM stretch] {ocs['camera']} rig 640x480 with C, D, E = {OCAM_STRETCH}, "
          f"warm 16 + {ocs['frames'] - 16} timed frames, fused: latency_ms_per_frame "
          f"{ocs['latency_ms_per_frame']:.3f}, latency_ate_m {ocs['latency_ate_m']:.4f} (bound "
          f"{ocs['bound']:.3f}); project(lift(uv)) - uv up to {ocs['lift_project_px']:.3f} px "
          f"on the card (JAX's note: ~1 px, as in the reference); launches {ocs['counts']}; "
          f"{replay_note(ocs)}; profile {ocs['profile']}", flush=True)

    done("16f")

    # 17. phase 7's stream with bench.py's harsh degradations (its own launch
    # counts): the moving sphere, depth noise and holes, exposure drift, read
    # noise, a rolling-shutter shear
    harsh = run_latency_path(dev, n_frames=64, profile=2, degrade=HARSH,
                             path=os.path.join(OUT_DIR, "profile_harsh.txt"))
    check_degraded_path(harsh)
    print(f"[17 harsh] phase 7's stream 640x480 with BENCH_DEGRADE=harsh, warm 16 + "
          f"{harsh['frames'] - 16} timed frames, fused: latency_ms_per_frame "
          f"{harsh['latency_ms_per_frame']:.3f} (phase 7 in this run: "
          f"{lat['latency_ms_per_frame']:.3f}), latency_ate_m {harsh['latency_ate_m']:.4f} "
          f"(bound {harsh['bound']:.3f}); features flagged dynamic per frame "
          f"{harsh['n_dynamic']}; launches {harsh['counts']}; {replay_note(harsh)}; profile "
          f"{harsh['profile']}", flush=True)

    done("17")

    # 18. intrinsic calibration on the card: rendered boards, the four models,
    # the CLI in a child
    calr = run_calibration(dev)
    check_calibration(calr)
    print(f"[18 calibration] {calr['found']} of 8 rendered 6x8 boards found; pinhole rms "
          f"{calr['pinhole']['rms_px']:.4f} px, fx {calr['pinhole']['fx']:.3f} (truth "
          f"{calr['truth_fx']}, {100 * calr['pinhole']['fx_err']:.3f} %), detect + calibrate "
          f"{calr['detect_s']:.1f} s; kannala-brandt {calr['kannala-brandt']}; mei "
          f"{calr['mei']}; scaramuzza (stretched) {calr['scaramuzza']}; CLI exit "
          f"{calr['cli']['rc']} in {calr['cli']['s']:.1f} s, fx {calr['cli']['fx']}", flush=True)

    done("18")

    # 19. the runner's chained and sharded API against run, stack_states, and
    # the graft twins' dry runs over eight shards of this card
    import __graft_entry_torch__ as graft

    api = run_runner_api(dev, B=2, T=4)
    stacked = run_stack_states(dev)
    check_runner_api(api, stacked)
    del stacked["pipes"]
    t1 = time.perf_counter()
    graft.dryrun_multichip(8, mesh=[dev] * 8)
    dry_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    graft.dryrun_multichip_backend(8, mesh=[dev] * 8)
    dryb_s = time.perf_counter() - t1
    print(f"[19 runner API] run_chained bit-equal to run, run_sharded over two shards of "
          f"{dev} within JAX's tolerances of it, and run_eager bit-equal to it over "
          f"{api['frames']} frames: {api['chained_equal']}, {api['sharded_equal']}, "
          f"{api['eager_bit_equal']}; misplaced inputs refused: {api['misplaced_refused']}; "
          f"stack_states of two warmed pipelines {stacked}; dryrun_multichip(8) and "
          f"dryrun_multichip_backend(8) over eight shards of {dev} (they share the card): "
          f"{dry_s:.1f} s, {dryb_s:.1f} s", flush=True)

    done("19")

    # 20. the OpenLORIS rig on the batched runner: 8 lanes moving from frame
    # 0, six with depth initialized by init_dynamic or its monocular
    # fallback and two (depth withheld) by init_mono, each in its own
    # VinsPipeline, stacked at one common frame and run 40 steady frames
    # at 8x480x848 (its own launch counts: the warm-up's and the run's)
    r20 = run_batched_rig_path(stage_batched_rig_path(dev, "dyn", B, T, profile=3),
                               timer=CudaTimer(),
                               path=os.path.join(OUT_DIR, "profile_batched_dyn.txt"))
    check_batched_rig_path(r20)
    s20 = r20["step_ms"]
    print(f"[20 batched dyn] OpenLORIS rig 848x480, B={B} lanes (seeds 7-{6 + B}; lanes "
          f"{r20['mono_lanes']} with depth withheld until init): initialized at frames "
          f"{r20['init_frames']} by {[a[-1][0] if a else 'static' for a in r20['attempts']]}, "
          f"stacked at frame {r20['common_frame']} ({r20['warm_s']:.1f} s of warm-up), "
          f"{T} steady frames: {s20:.2f} ms/step over the {T - 1} replayed frames (phase 5 in "
          f"this run: {step5:.2f}) = {B * 1e3 / s20:.2f} sequence-frames/s (CUDA events; first "
          f"frame and capture {r20['capture_s']:.3f} s); "
          f"relative motion m {[(round(x['d_est'], 4), round(x['d_gt'], 4)) for x in r20['lanes']]}"
          f" (error {[round(x['err'], 4) for x in r20['lanes']]}, bounds "
          f"{[round(x['bound'], 3) for x in r20['lanes']]})"
          f"; launches warm-up {r20['warm_counts']} over {r20['tracked']} tracked frames, run "
          f"{r20['run_counts']}; profile {r20['profile']}", flush=True)
    # K1 and K2 at its shapes: the first two frames of its lanes
    fr20 = [syn.render_sequence(seq_, rig_, dev, 0, 2)[1] for rig_, seq_, _ in r20["scenes"]]
    f0_20 = torch.stack([f[0] for f in fr20]).contiguous()
    f1_20 = torch.stack([f[1] for f in fr20]).contiguous()
    tcfg_20 = r20["runner"].tcfg
    out_k = fast.fast_nms(f0_20, tcfg_20.fast_threshold)
    out_p = fast.nms3(fast.fast_score(f0_20, tcfg_20.fast_threshold))
    k1_err = max(k1_err, float((out_k - out_p).abs().max()))
    require(torch.equal(out_k, out_p), "K1 bit-exact on 8x480x848")
    k2_20 = k2_inputs(f0_20, f1_20, tcfg_20, tcfg_20.maxc, gen)
    rep20 = compare_k2(*k2_20, tcfg_20)
    k2_err = max(k2_err, check_parity("K2", rep20))
    print(f"[20 K1 K2] K1 bit-exact on {B}x480x848 ({int((out_k > 0).sum())} corners); K2 "
          f"{B}x{tcfg_20.maxc} on 848x480: " + summary(rep20), flush=True)
    timing("fast_nms", f"{B}x480x848 rendered", lambda: fast.fast_nms(f0_20, thr),
           lambda: fast.nms3(fast.fast_score(f0_20, thr)),
           kernel_bounds(B, 480, 848, N, 0, pairs=fast_pairs(f0_20, thr))["fast_nms"], phase=20)
    time_k2(k2_20, tcfg_20, f"{B}x{tcfg_20.maxc} on 848x480", phase=20)
    del fr20, f0_20, f1_20, k2_20
    r20["runner"].close()

    done("20")

    # 20b. the RealSense rig on the batched runner: 8 lanes warmed by static
    # init with td estimated against IMU stamps 5 ms ahead, rolling shutter
    # and the extrinsic refined (estimate_extrinsic 1: one configuration for
    # every lane), 40 steady frames, 2 profiled (its own launch counts)
    r20b = run_batched_rig_path(stage_batched_rig_path(dev, "td", B, T, profile=2),
                                timer=CudaTimer(),
                                path=os.path.join(OUT_DIR, "profile_batched_td.txt"))
    check_batched_rig_path(r20b)
    print(f"[20b batched td] RealSense rig 640x480, B={B} lanes (seeds 7-{6 + B}), td from 0 "
          f"(truth {TD_TRUE} s), rolling shutter, extrinsic refined: initialized at frames "
          f"{r20b['init_frames']}, stacked at frame {r20b['common_frame']} "
          f"({r20b['warm_s']:.1f} s of warm-up), {T} steady frames: "
          f"{r20b['step_ms']:.2f} ms/step replayed (phase 5 in this run: {step5:.2f}) = "
          f"{B * 1e3 / r20b['step_ms']:.2f} sequence-frames/s; ATE m "
          f"{[round(x['ate_m'], 4) for x in r20b['lanes']]} (bounds "
          f"{[round(x['bound'], 3) for x in r20b['lanes']]}; lanes {REFERENCE_MISSES['td']} "
          f"alone on the latency pipeline where they missed it: {lane_refs(r20b)}); "
          f"td s {[round(x, 5) for x in r20b['td']]} beside the truth {TD_TRUE}; one "
          f"configuration: {r20b['configs_equal']}; launches warm-up {r20b['warm_counts']} "
          f"over {r20b['tracked']} tracked frames, run {r20b['run_counts']}; profile "
          f"{r20b['profile']}", flush=True)
    fr20b = [syn.render_sequence(seq_, rig_, dev, 0, 2)[1] for rig_, seq_, _ in r20b["scenes"]]
    tcfg_20b = r20b["runner"].tcfg
    k2_20b = k2_inputs(torch.stack([f[0] for f in fr20b]).contiguous(),
                       torch.stack([f[1] for f in fr20b]).contiguous(), tcfg_20b,
                       tcfg_20b.maxc, gen)
    rep20b = compare_k2(*k2_20b, tcfg_20b)
    k2_err = max(k2_err, check_parity("K2", rep20b))
    print(f"[20b K2] {B}x{tcfg_20b.maxc} on 640x480: " + summary(rep20b), flush=True)
    time_k2(k2_20b, tcfg_20b, f"{B}x{tcfg_20b.maxc} on 640x480", phase="20b")
    r20b["runner"].close()
    r20, r20b = batched_rig_summary(r20), batched_rig_summary(r20b)
    del fr20b, k2_20b

    done("20b")

    # 21. the batched runner sharded by lane over a mesh of cards (its own
    # launch counts, by card)
    r21 = phase21(after_19=True)

    done("21")

    # 22-22c. the failure reboot (bench.py run_recovery; their own launch counts)
    r22 = phase22()

    # 23. the batched closer's three modes (their own launch counts)
    r23 = phase23()

    # 24. K4 at every shape tapped since phase 5, and at the main path's
    # three shapes
    r24 = phase24(k4_tap)

    # the kernels line: per launch at the main path's shapes (K1 8x480x640,
    # K2 8x200 averaged over its two levels) and K3 at the latency path's
    # 1x200 (it never runs on the main path)
    res["profile"] = prof
    paths = {"batched": res, "latency": lat, "latency_loop": loop, "batched_loop": bl,
             "latency_vo": vo, "latency_td": td, "latency_dyn": dyn, "bag_replay": bagr,
             "tum_replay": tumr, "batched_vo": vob, "batched_vo_loop": bvl, "latency_kb": kb,
             "latency_mei": rigs["MEI"], "latency_scaramuzza": rigs["SCARAMUZZA"],
             "batched_kb": kbb, "latency_harsh": harsh, "batched_mei": bcams["MEI"],
             "batched_scaramuzza": bcams["SCARAMUZZA"], "latency_ocam_affine": ocs,
             "batched_dyn": r20, "batched_td": r20b,
             "batched_sharded": dict(counts=r21["counts"], profile=r21["profile"]["D"]),
             **r22, **r23}
    errs = {"fast_nms": max(k1_err, r21["errs"]["fast_nms"]),
            "lk_level": max(k2_err, r21["errs"]["lk_level"]),
            "lk_iterate": max(k3_err, r21["errs"]["lk_iterate"])}
    kernels = kernel_entries(paths, errs, {"fast_nms": f"{B}x480x640 rendered",
                                           "lk_level": f"{B}x{N} level",
                                           "lk_iterate": f"1x{N} level"}, timings)
    kernels.append(k4_entry(r24, paths))
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, cards=smi_cards, kernels=kernels, timings=timings, k2=rep,
                       k3=rep3, main={
            k: res[k] for k in ("ates", "bounds", "counts", "step_ms", "capture_s", "eager",
                                "wall_s", "frames")},
            stages=stages, profile=prof, extraction=ext, latency=lat, latency_plain=lat_plain,
            latency_replay_vs_plain=cmp7, latency_loop=jsonable(loop),
            latency_loop_no_graph=alone, latency_loop_no_graph_plain=alone_plain,
            no_graph_replay_vs_plain=cmp9b, abba_ms=ms,
            worker_cost=worker_cost, latency_loop_eager=jsonable(eager),
            batched_loop={k: v for k, v in bl.items() if k not in ("cost", "segments")},
            latency_vo=jsonable(vo), vo_lockstep={"plain": jsonable(vo_lock[False]),
                                                  "replayed": jsonable(vo_lock[True])},
            vo_replay_vs_plain=cmp11, vo_map=mp, vo_checkpoint=ck, latency_td=td,
            latency_td_calib=cal, latency_dyn=dyn, latency_mono=mono, bag_replay=bagr,
            tum_replay=tumr, png_decode=png, fisheye=fish, fisheye_pipeline=fishp,
            k2_vo=rep2_vo,
            batched_vo={k: vob[k] for k in ("ates", "bounds", "counts", "step_ms", "capture_s",
                                            "wall_s", "frames", "profile")},
            batched_vo_loop={k: v for k, v in bvl.items() if k not in ("cost", "segments")},
            latency_kb=kb, cameras=cams, latency_mei=rigs["MEI"],
            latency_scaramuzza=rigs["SCARAMUZZA"],
            batched_kb={k: kbb[k] for k in ("ates", "bounds", "counts", "step_ms", "capture_s",
                                            "wall_s", "frames")},
            latency_harsh=harsh, batched_cameras={
                m: {k: r[k] for k in ("ates", "bounds", "counts", "step_ms", "frames")}
                for m, r in bcams.items()}, latency_ocam_affine=ocs, kb_run_vio=kbe,
            calibration=calr, runner_api=api, stack_states=stacked, batched_dyn=r20,
            batched_td=r20b, k2_batched_dyn=rep20, k2_batched_td=rep20b, batched_sharded=r21,
            **{k: {x: y for x, y in v.items() if x not in ("cost", "segments")}
               for k, v in {**r22, **r23}.items()},
            k4=r24, phase_s=phase_s), f, indent=1, default=float)
    return finish(smi_cards, phase_s, kernels)


def kernel_entries(paths: dict, errs: dict, main_shape: dict, timings: list) -> list:
    """The ``kernels`` line: each kernel's launches summed over the paths
    (``counts``), its largest error against its plain version, and its
    device ms, plain ms and bound averaged over the timed rows of its main
    shape (``main_shape``: the start of the rows' shape), with the device
    ms per frame of each path's profile and every timed shape."""
    counts = {k: sum(r["counts"][k] for r in paths.values()) for k in KERNELS}
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
                p: r["profile"]["by_kernel"][name]["device_ms_per_frame"]
                for p, r in paths.items() if r.get("profile") is not None},
            timings={t["shape"]: dict(ms=t["device_ms"], bound_ms=t["bound_ms"],
                                      plain_ms=t["plain_ms"])
                     for t in timings if t["kernel"] == name}))
    return kernels


def finish(smi_cards: list, phase_s: dict, kernels: list) -> int:
    """The script's last lines: the phases' wall seconds, each card's name
    and power limit (a line each), the kernels line and the result line."""
    print(f"[phases] wall seconds {phase_s}, {sum(phase_s.values()):.1f} in all", flush=True)
    for line in smi_cards:
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
