#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vins_rgbd_fast_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build of the hand-written kernels (``csrc/*.cu``, nvcc, sm_90a);
  3. K1 (FAST + NMS) against its plain PyTorch version: bit-exact on 8
     rendered 640×480 frames and 2 uniform-noise images;
  4. K2 (one LK level) against its plain version at the slice's shapes
     (B = 8, N = 200, both pyramid levels, tracks between two rendered
     frames): status agrees on ≥ 99.5 % of points, u and err within 1e-3
     where both versions say ok;
  5. the main path: B = 8 sequences at 640×480 rendered on the device,
     ``BatchedVioRunner.warm`` (11 window-filling frames + static init) and
     ``run`` over T steady frames; finite costs, every kernel launched by
     the path, distinct sequences, per-sequence ATE under
     max(0.05·travelled, 0.08 m); prints frames per second (CUDA events);
  6. kernel vs plain timings (CUDA events, median of 20, slice shapes), a
     per-stage split, and a profile of a few steady frames (chiprun_out/)
     that must show no host synchronisation inside ``run``.
The last line is ``{"ok": true, "device": {...}}``.  Without CUDA it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from vins_rgbd_fast_torch import native
from vins_rgbd_fast_torch.backend import estimator as est
from vins_rgbd_fast_torch.backend.estimator import ImuIntervalBuffer
from vins_rgbd_fast_torch.config import EstimatorConfig, TrackerConfig
from vins_rgbd_fast_torch.frontend import feature_tracker as ft
from vins_rgbd_fast_torch.io import synthetic as syn
from vins_rgbd_fast_torch.io.stream import ate_rmse
from vins_rgbd_fast_torch.models.camera import PinholeCamera
from vins_rgbd_fast_torch.ops import fast, image, lk
from vins_rgbd_fast_torch.parallel import batched_pipeline as bp

# radtan coefficients of the bench rig (reference realsense vio.yaml)
DISTORTION = dict(k1=0.13387871564774004, k2=-0.2731913133377051,
                  p1=0.0020296263577681264, p2=-0.00044384544608203714)
OUT_DIR = "chiprun_out"
RUN_SPAN = "chip_smoke::run"
HOST_SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
                   "cudaMemcpy")


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

    fast.launches = 0
    lk.launches = 0
    t0 = time.perf_counter()
    trk, st, _ = runner.warm(trk, st, warm_batch)
    if timer is not None:
        timer.start()
    trk, st, outs = runner.run(trk, st, run_batch)
    run_ms = timer.stop() if timer is not None else None
    P = outs.P.cpu().numpy()  # the one read-back of the steady run
    wall = time.perf_counter() - t0
    counts = {"fast_nms": fast.launches, "lk_level": lk.launches}

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
    for b in range(1, B):
        require(not np.allclose(res["P"][:, 0], res["P"][:, b], atol=1e-3),
                f"sequences 0 and {b} coincide")
    for b, (ate, bound) in enumerate(zip(res["ates"], res["bounds"])):
        require(np.isfinite(ate) and ate < bound, ("ATE", b, ate, bound))


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


def compare_k2(prev_pyr, cur_pyr, pts, init, active, tcfg):
    """Both levels, kernel and plain version on identical inputs."""
    win, sm, eps, min_eig = 21, 8, 0.01, 1e-4
    report = []
    flow = (init - pts) / 2.0
    for l in (1, 0):
        iters = tcfg.lk_max_iters if l == 0 else tcfg.lk_coarse_iters
        pts_l = (pts / 2.0 ** l).contiguous()
        flow = flow.contiguous()
        prev, cur = prev_pyr[l], cur_pyr[l]
        H, W = prev.shape[-2:]
        # the wrapper (CUDA tensors: the kernel) against the plain version
        u_k, st_k, err_k = lk.lk_level(prev, cur, pts_l, flow, active, win, iters, eps,
                                       min_eig, check_border=(l == 0), search_margin=sm)
        ax, ay = lk.window_anchor(pts_l, flow, H, W, win, sm)
        u_p, ok_p, err_p = lk.lk_level_plain(prev, cur, pts_l, flow, active, ax, ay, win,
                                             sm, iters, eps, min_eig)
        st_p = lk.level_status(pts_l, u_p, ok_p, active, ax, ay, H, W, win, sm, l == 0)
        both = st_k & st_p
        du = torch.where(both[..., None], (u_k - u_p).abs(), torch.zeros_like(u_k)).amax()
        de = torch.where(both, (err_k - err_p).abs(), torch.zeros_like(err_k)).amax()
        agree = (st_k == st_p).float().mean().item()
        bad = torch.nonzero((st_k != st_p) | (both & (((u_k - u_p).abs().amax(-1) > 1e-3)
                                                      | ((err_k - err_p).abs() > 1e-3))))
        report.append(dict(level=l, iters=iters, agree=agree, max_du=du.item(),
                           max_derr=de.item(), n_ok=int(both.sum()), mismatches=[
                               dict(b=int(b), n=int(n), st_k=bool(st_k[b, n]),
                                    st_p=bool(st_p[b, n]), u_k=u_k[b, n].tolist(),
                                    u_p=u_p[b, n].tolist(), err_k=float(err_k[b, n]),
                                    err_p=float(err_p[b, n])) for b, n in bad.tolist()]))
        flow = 2.0 * u_p
    return report


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
    """torch.profiler over the extra steady frames: kernel launches and
    device kernel time per frame, the device's busy share against the
    unprofiled step time, and the heaviest kernels (table in ``path``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    trk, st = res["state"]
    batch = res["extra_batch"][1]
    frames = int(batch.ts.shape[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(RUN_SPAN):
            res["runner"].run(trk, st, batch)
        torch.cuda.synchronize()
    # host waits that start and end inside run() (the profiler's own device
    # synchronisation and the one above fall outside its span)
    span = next(e.time_range for e in prof.events()
                if e.name == RUN_SPAN and e.device_type == DeviceType.CPU)
    host_syncs = sum(1 for e in prof.events() if e.name in HOST_SYNC_CALLS
                     and span.start <= e.time_range.start and e.time_range.end <= span.end)
    events = prof.key_averages()
    # the span also shows as a device-side annotation; it is not a kernel
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key != RUN_SPAN]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=50))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    dev_ms = dev_us / 1e3 / frames
    return dict(frames=frames, kernels_per_frame=n_kernels / frames, host_syncs=host_syncs,
                device_ms_per_frame=round(dev_ms, 3),
                busy_share=round(dev_ms / step_ms, 4) if dev_ms > 0 else "not measured",
                top_ms_per_frame=[(e.key[:50], round(e.self_device_time_total / 1e3 / frames, 3))
                                  for e in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
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
    print(f"[2 build] {time.perf_counter() - t0:.2f} s ({path})", flush=True)

    B, N, T, EXTRA = 8, 200, 40, 10
    rig, tcfg, ecfg, cam = slice_config()
    tcfg_run = bp.BatchedVioRunner(tcfg, cam, ecfg, dev, 1).tcfg  # LK 12/6 envelope
    seqs, rendered, _ = make_sequences(rig, B, 2, dev)
    frame0 = torch.stack([r[1][0] for r in rendered]).contiguous()
    frame1 = torch.stack([r[1][1] for r in rendered]).contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # 3. K1 bit-exactness
    noise = torch.rand((2, 480, 640), generator=gen, device=dev) * 255.0
    k1_err = 0.0
    for name, imgs in (("rendered", frame0), ("noise", noise)):
        out_k = fast.fast_nms(imgs, tcfg.fast_threshold)
        out_p = fast.nms3(fast.fast_score(imgs, tcfg.fast_threshold))
        torch.cuda.synchronize()
        k1_err = max(k1_err, float((out_k - out_p).abs().max()))
        require(torch.equal(out_k, out_p), f"K1 bit-exact on {name} images")
    print(f"[3 K1] bit-exact on {frame0.shape[0]} rendered + 2 noise images, "
          f"{int((out_k > 0).sum())} corners in the last batch", flush=True)

    # 4. K2 vs plain at the slice's shapes
    k2_in = k2_inputs(frame0, frame1, tcfg_run, N, gen)
    rep = compare_k2(*k2_in, tcfg_run)
    k2_err = max(max(r["max_du"], r["max_derr"]) for r in rep)
    for r in rep:
        for m in r["mismatches"]:
            print(f"  K2 mismatch level {r['level']}: {m}", flush=True)
    print("[4 K2] " + "; ".join(
        f"level {r['level']} ({r['iters']} it): status agree {100 * r['agree']:.2f}%, "
        f"{r['n_ok']} ok, max|du| {r['max_du']:.2e}, max|derr| {r['max_derr']:.2e}"
        for r in rep), flush=True)
    for r in rep:
        require(r["agree"] >= 0.995, r)
        require(r["max_du"] <= 1e-3 and r["max_derr"] <= 1e-3, r)

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

    # 6. timings and profile
    imgs8 = frame0
    k1_ms = median_ms(lambda: fast.fast_nms(imgs8, tcfg.fast_threshold))
    k1_plain = median_ms(lambda: fast.nms3(fast.fast_score(imgs8, tcfg.fast_threshold)))
    prev_pyr, cur_pyr, pts, init, active = k2_in
    k2_ms, k2_plain = 0.0, 0.0
    for l in (1, 0):
        iters = tcfg_run.lk_max_iters if l == 0 else tcfg_run.lk_coarse_iters
        pts_l = (pts / 2.0 ** l).contiguous()
        flow = ((init - pts) / 2.0).contiguous()
        H, W = prev_pyr[l].shape[-2:]
        ax, ay = lk.window_anchor(pts_l, flow, H, W, 21, 8)
        args = (prev_pyr[l], cur_pyr[l], pts_l, flow, active, ax, ay, 21, 8, iters, 0.01, 1e-4)
        k2_ms += median_ms(lambda: lk._lk_level_cuda(*args))
        k2_plain += median_ms(lambda: lk.lk_level_plain(*args))
    print(f"[6 timing] K1 fast_nms (8x480x640): {k1_ms:.4f} ms vs plain {k1_plain:.4f} ms; "
          f"K2 lk_level both levels (8x200): {k2_ms:.4f} ms vs plain {k2_plain:.4f} ms",
          flush=True)
    stages = stage_breakdown(res, res["extra_batch"][0])
    print(f"[6 stages] ms per steady frame, synchronised per stage: {stages}", flush=True)
    prof = profile_frames(res, os.path.join(OUT_DIR, "profile_steady.txt"), res["run_ms"] / T)
    print(f"[6 profile] {prof}", flush=True)
    require(prof["host_syncs"] == 0, "no host synchronisation inside run()")

    kernels = [
        dict(name="fast_nms", route="cuda", source="vins_rgbd_fast_torch/csrc/fast_nms.cu",
             replaces="vins_rgbd_fast_tpu/ops/fast_pallas.py:99",
             launches=res["counts"]["fast_nms"], max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain),
        dict(name="lk_level", route="cuda", source="vins_rgbd_fast_torch/csrc/lk_level.cu",
             replaces="vins_rgbd_fast_tpu/ops/lk_pallas3.py:273",
             launches=res["counts"]["lk_level"], max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain),
    ]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels, k2=rep, main={
            k: res[k] for k in ("ates", "bounds", "counts", "run_ms", "wall_s", "frames")},
            stages=stages, profile=prof), f, indent=1, default=float)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
