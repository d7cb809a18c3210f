"""One robot: a single stream through ``pipeline.VinsPipeline`` with its
steady frames replayed (``fused_steady_state``), the pose graph on the
``AsyncLoopStager`` worker where the traffic turns loop closure on.  Closed
loop: each camera frame is handed in (its IMU samples pushed first) when
the previous frame's result is on the host: its pose (P, Q) read back, or
nothing where the rig's publish rate withholds the frame from the
estimator.

Traffic keys: ``warm_frames`` (frames before the window: initialization and
the capture of the steady frame), ``max_rate`` (camera frames per second
of window rendered ahead, with room above the rate the port sustains),
``trajectory`` (the generator: ``kind`` walk or revisit and its
parameters), ``imu_shift_s`` (the IMU clock's offset, the truth of td),
``imu_lead_s`` (how far the IMU runs ahead of the frame handed in),
``vins`` (keys of the rig switched for the cell: loop closure),
``lk_iters`` (the LK caps the pipeline runs, for the reference),
``check_frames`` and ``check_rate`` (how many frames the reference
checks, drawn from the seed among the first ``seconds · check_rate``
frames of the window: their window solve and, on the IMU rig, their LK
from the program's prediction), ``trace_frames``.  The failure check runs
every frame, as the pipeline's default has it.
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from .. import bounds, check, tap
from .. import harness as H
from ..reference import frontend as ref
from ..traffic import synthetic as syn
from .fleet import tracker_config


def make_stream(tr: dict, n: int, rig, seed: int):
    kw = dict(tr["trajectory"])
    kind = kw.pop("kind")
    if kind == "walk":
        return syn.make_trajectory(n, rig, seed=seed, **kw)
    if kind == "revisit":
        period = kw.pop("period_frames")
        cycles = max(n // period, 1)
        seq = syn.make_revisit_trajectory(cycles * period, rig, seed=seed, cycles=cycles,
                                          accel=kw["accel"], axis=tuple(kw["axis"]))
        if n > cycles * period:
            raise ValueError("a revisit stream is a whole number of periods")
        return seq
    raise ValueError(f"unknown trajectory kind {kind!r}")


def run(ctx: H.Ctx) -> H.Outcome:
    from vins_rgbd_fast_torch.loop.pose_graph import PoseGraphConfig
    from vins_rgbd_fast_torch.pipeline import VinsPipeline

    tr, cfg = ctx.traffic, ctx.config
    vcfg = H.vins_config(cfg, **tr.get("vins", {}))
    dev = ctx.devices[0]
    on_card = dev.type == "cuda"
    rig = H.rig(cfg)
    spans = H.Spans()
    warm = tr["warm_frames"]
    n = warm + int(math.ceil(ctx.seconds * tr["max_rate"])) + tr["trace_frames"] + 1
    if tr["trajectory"]["kind"] == "revisit":
        n = -(-n // tr["trajectory"]["period_frames"]) * tr["trajectory"]["period_frames"]
    seed = H.lane_seeds(ctx.seed, 1)[0]
    with spans.span("render"):
        seq = make_stream(tr, n, rig, seed)
        imgs = torch.empty((n, rig.height, rig.width), device=dev)
        depths = torch.empty_like(imgs)
        syn.render_into(seq, rig, imgs, depths)
        H.synchronize([dev])
    ts = seq.times
    shift = tr.get("imu_shift_s", 0.0)
    imu = [(t + shift, a, g) for (t, a, g) in seq.imu] if vcfg.imu else []
    pg = (PoseGraphConfig(max_wp=vcfg.feature_capacity, use_6dof=not vcfg.imu, **cfg["pose_graph"])
          if vcfg.loop_closure else None)
    tcfg = tracker_config(vcfg)
    taps = tap.program_taps(imu=vcfg.imu, lk=vcfg.imu)
    taps.__enter__()  # before the steady frame is captured; closed after the window
    pipe = VinsPipeline(vcfg, dev, eager_outputs=False, fused_steady_state=True,
                        pose_graph_config=pg)
    stager = pipe._loop_stager
    lead = tr.get("imu_lead_s", 0.0)
    cursor = [0]

    def hand_in(k: int):
        """Frame k's IMU samples, then its image and depth; returns the
        pipeline's output and the host times around ``spin_once``."""
        while cursor[0] < len(imu) and imu[cursor[0]][0] <= ts[k] + shift + lead:
            pipe.push_imu(*imu[cursor[0]])
            cursor[0] += 1
        t_in = time.perf_counter()
        pipe.push_image(float(ts[k]), imgs[k])
        pipe.push_depth(float(ts[k]), depths[k])
        out = pipe.spin_once()
        return out, t_in, time.perf_counter()

    def pose(out):
        return torch.cat([out.P[0], out.Q[0]]).cpu().numpy()

    with spans.span("warmup"):
        for k in range(warm):
            out, _, _ = hand_in(k)
            if out is not None:
                pose(out)
        pipe.drain()
        if stager is not None:
            stager.compile_warmup(imgs[0])
        H.synchronize([dev])
    if pipe.estimator.solver_flag != pipe.estimator.NON_LINEAR:
        raise RuntimeError(f"the estimator did not initialize in {warm} frames")
    graph = pipe.pose_graph
    loops0 = len(graph.loops) if graph is not None else 0
    with spans.span("nvidia_smi"):
        smi = [H.nvidia_smi([dev.index])] if on_card else []
    gc_pauses = []  # (generation, seconds) of the collector's passes in the window

    def on_gc(phase, info, t=[0.0]):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            gc_pauses.append((info["generation"], time.perf_counter() - t[0]))

    gc.callbacks.append(on_gc)
    t_window = time.time()
    p0 = time.perf_counter()
    k = warm
    lat, host, rb, at, outs, frames = [], [], [], [], [], 0
    # the window's frames whose answers the reference checks, drawn from the
    # seed: the tracker's state before and after each, its window solve and,
    # on the IMU rig, where its LK started each point (nothing else of a
    # frame is kept, so the window holds no more objects as it goes on)
    check_at = set(check.checked_frames(ctx.seed, max(int(ctx.seconds * tr["check_rate"]), 1),
                                        tr["check_frames"], first=0))
    taken = []
    index = {float(t): i for i, t in enumerate(ts)}

    def processed():
        """The frame the tracker last ran on, and its state after it."""
        t = pipe._last_frame_time
        return (index[float(t)] if t is not None else -1), pipe.tracker_state

    prev = processed()
    while True:
        if k >= n - tr["trace_frames"]:  # a program faster than max_rate: the window ends here
            ctx.log(f"the stream ran out at frame {k}, {time.perf_counter() - p0:.3f} s into "
                    f"the window")
            break
        fused0 = pipe._fused_step
        out, t_in, t_ret = hand_in(k)
        if out is not None:
            pq = pose(out)
            t_done = time.perf_counter()
            lat.append(t_done - t_in)
            host.append(t_ret - t_in)
            rb.append(t_done - t_ret)
            at.append(t_done - p0)
            outs.append((k, pq, out.n_features))
        else:
            t_done = t_ret
            spans.add("host_unpublished", t_ret - t_in)
            spans.add("at_unpublished", t_done - p0)
        cur = processed()
        ran = cur[1] is not prev[1]  # the tracker ran on a frame (as a rule frame k)
        if frames in check_at and ran:
            fused = pipe._fused_step != fused0
            got = taps.take(on_card and fused, ["lk"]) if vcfg.imu else {}
            if fused:
                got.update(taps.take(on_card, ["solve", "imu"]))
            taken.append(dict(k0=prev[0], s0=prev[1]._replace(pyramid=()), k=cur[0],
                              s1=cur[1]._replace(pyramid=()), **got))
        if ran:
            prev = cur
        frames += 1
        k += 1
        if t_done - p0 >= ctx.seconds:
            break
    H.synchronize([dev])
    elapsed = time.perf_counter() - p0
    gc.callbacks.remove(on_gc)
    taps.__exit__()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    spans.s["host"], spans.s["readback"] = host, rb
    e2e = dict(setup_s=t_window - ctx.t_process, frame_ms_p95=1e3 * H.quantile(lat, 0.95),
               frames_per_s=frames / elapsed)
    pipe.drain()  # the worker's answers for the window's frames
    loops = (len(graph.loops) - loops0) if graph is not None else None
    rec = dict(spans=spans.s, frames=frames, poses=len(lat), window_s=elapsed, smi=smi,
               loops=loops, frame_ms_p50=1e3 * H.quantile(lat, 0.5))
    quarters = {k: [round(1e3 * float(np.mean(q)), 3) if len(q) else None
                    for q in np.array_split(np.asarray(v), 4)]
                for k, v in dict(spans.s, frame=lat).items()
                if k in ("frame", "host", "readback", "host_unpublished")}
    ctx.log(f"mean ms by quarter of the window: {quarters}")
    tenth = np.minimum((np.asarray(at) * 10 / elapsed).astype(int), 9)
    by_tenth = [round(1e3 * float(np.mean(np.asarray(rb)[tenth == i])), 3)
                for i in range(10) if (tenth == i).any()]
    ctx.log(f"read-back ms by tenth of the window's time: {by_tenth}")
    if spans.s.get("host_unpublished"):
        tu = np.minimum((np.asarray(spans.s["at_unpublished"]) * 10 / elapsed).astype(int), 9)
        hu = np.asarray(spans.s["host_unpublished"])
        tenths = [round(1e3 * float(np.mean(hu[tu == i])), 3) for i in range(10) if (tu == i).any()]
        ctx.log(f"unpublished frames' host ms by tenth of the window's time: {tenths}")
    rec["gc"] = {g_: [sum(1 for gg, _ in gc_pauses if gg == g_),
                      sum(d for gg, d in gc_pauses if gg == g_)] for g_ in (0, 1, 2)}
    ctx.log(f"garbage collections in the window (generation: count, seconds): {rec['gc']}")
    ctx.log(f"window: {frames} frames, {len(lat)} poses in {elapsed:.3f} s; p50 "
            f"{rec['frame_ms_p50']:.3f} ms, p95 {e2e['frame_ms_p95']:.3f} ms; setup "
            f"{e2e['setup_s']:.3f} s (render {spans.total('render'):.3f}, warm-up "
            f"{spans.total('warmup'):.3f}); loops {loops}")

    breakdown = None
    if ctx.trace:
        n_tr = tr["trace_frames"]
        before = []

        def frame(i):
            before.append(pipe.tracker_state)
            out, _, _ = hand_in(k + i)
            if out is not None:
                pose(out)

        path = os.path.join(ctx.out_dir, f"{ctx.cell['name']}-{ctx.seed}.trace.json")
        red = H.profile_frames(frame, n_tr, ctx.devices, path)
        rec["trace"] = red
        rec["bounds_ms"] = _bounds(before, imgs, k, tcfg, tr, vcfg.imu)
        rec["frame_streams"] = red["frame_streams"]
        breakdown = red["breakdown"]
        del before
        pipe.drain()
    x = pipe.estimator.state.x
    td, qic = float(x.td[0]), x.qic[0].double().cpu().numpy()
    path_c = [p for p in graph.path() if p[0] <= ts[k - 1]] if graph is not None else []
    if on_card:
        smi.append(H.nvidia_smi([dev.index]))
    pipe.close()
    del pipe, x

    # the comparisons, once the window has closed and the program's state is freed
    tally, shown = check.Tally(), check.Tally()
    g = cfg["guarantees"]
    failed = 0
    if outs:  # a window with no pose leaves the ATE unread: NaN, which fails
        ks = np.array([o[0] for o in outs])
        P = np.stack([o[1][:3] for o in outs])
        failed = int((~np.isfinite(P).all(-1)).sum())
        ate, bound = check.ate_ratio(P, ks, seq, g)
        tally.add("ate_ratio", ate / bound if math.isfinite(ate) else float("nan"))
        ctx.log(f"ATE {ate:.5f} m against {bound:.5f} m over {len(ks)} poses")
    required = ["ate_ratio", "k1_off_corner"]
    if vcfg.imu and vcfg.estimate_td:
        tally.add("td_err_ms", 1e3 * abs(td - shift))
        required.append("td_err_ms")
    if vcfg.imu and vcfg.estimate_extrinsic:
        tally.add("ric_err_deg", check.rot_err_deg(qic, seq.ric))
        required.append("ric_err_deg")
    if graph is not None:
        kt = np.array([p[0] for p in path_c])
        kf = np.array([int(np.argmin(np.abs(ts - t))) for t in kt])
        if len(kf) >= 2:
            la, lb = check.ate_ratio(np.stack([p[1] for p in path_c]), kf, seq, g)
            tally.add("loop_ate_ratio", la / lb if math.isfinite(la) else float("nan"))
        required.append("loop_ate_ratio")
    fi, li = tr["lk_iters"]
    levels = tcfg.pyr_levels_cold
    control = {}
    limits = dict(ate_ratio=1.0, loop_ate_ratio=1.0, k1_off_corner=check.K1_LIMIT,
                  lk_gap_px=check.LK_GAP_LIMIT_PX, td_err_ms=g.get("td_err_ms", 0.0),
                  ric_err_deg=g.get("ric_err_deg", 0.0))

    flags = check.solve_flags(cfg)
    for c in taken:
        k0, s0, k1, s1 = c["k0"], c["s0"], c["k"], c["s1"]
        # K1: the corners the tracker took in at the frame
        mask = check.new_features(s1.ids, s1.track_cnt)
        n_chk, off = check.k1_off_corner(imgs[k1][None], s1.pts, mask, tcfg.fast_threshold)
        tally.sum("k1_off_corner", off, n_chk)
        if ctx.control:
            c_chk, c_off = check.k1_control(imgs[k1][None], tcfg.fast_threshold, tcfg.grid_rows,
                                            tcfg.grid_cols, tcfg.cand_per_grid)
            kc = control.setdefault("k1_off_corner", [0, 0])
            kc[0] += c_off
            kc[1] += c_chk
        # LK from where the program started each point: its previous position
        # (VO, cold) or its IMU prediction
        if k1 - k0 == 1 and (not vcfg.imu or c.get("lk") is not None):
            live0 = s0.ids >= 0
            init = None
            if vcfg.imu:
                live0 = live0 & c["lk"]["active"]
                init = c["lk"]["init"]
            live1 = (s1.ids >= 0) & (s1.track_cnt >= 2)
            args = (imgs[k0][None], imgs[k1][None], s0.pts, s0.ids, live0, s1.pts, s1.ids, live1,
                    tcfg.pyr_levels_predicted if vcfg.imu else levels, fi, li)
            pts, status, matched, _ = check.lk_tracks(*args, init_prev=init)
            gaps = check.lk_gaps(pts, status, matched, s1.pts)
            tally.add("lk_gap_px", float(gaps.max()) if gaps.numel() else 0.0, int(gaps.numel()))
            if ctx.control:
                p16, s16, m16, _ = check.lk_tracks(*args, init_prev=init, dtype=torch.bfloat16)
                cg = check.lk_gaps(p16, s16 & status, m16, pts)
                control.setdefault("lk_gap_px", []).append(float(cg.max()) if cg.numel() else 0.0)
        if c.get("solve") is not None:
            prog, ctrl, printed = check.solve_numbers(c, flags, control=ctx.control)
            for name, v in prog.items():
                tally.add(name, v)
            for name, v in printed.items():
                shown.add(name, v)
            for name, v in ctrl.items():
                control.setdefault(name, []).append(v)
    required.append("lk_gap_px")
    limits.update(check.solve_limits(flags))
    required.extend(check.solve_limits(flags))
    rec["control"] = control
    rec["solved_gaps"] = check.summary(shown)
    nf = torch.cat([o[2] for o in outs]).tolist() if outs else []
    rec["n_features"] = [float(np.mean(nf)), float(min(nf))] if nf else None
    ctx.log("features by quarter of the window: "
            f"{[round(float(np.mean(q)), 1) for q in np.array_split(np.asarray(nf), 4) if len(q)]}")
    checks = check.checks(tally, limits, required)
    rec["tally"] = check.summary(tally)
    return H.Outcome(e2e=e2e, rec=rec, checks=checks, attempted=frames, failed=failed,
                     memory_peak_bytes=int(peak), breakdown=breakdown)


def _bounds(before, imgs, k0: int, tcfg, tr: dict, imu: bool) -> dict:
    """The least time K1 and K3 could take over the traced frames: K1 on
    its pre-test survivors; K3 with the Gauss-Newton steps of the
    reference's LK started where the program's tracker stood (cold, VO).
    Where the start is the IMU's prediction the steps these inputs need
    are not known here, so K3 gets no bound (and no roofline)."""
    fi, li = tr["lk_iters"]
    out = {"fast_nms": 0.0} if imu else {"fast_nms": 0.0, "lk_iterate": 0.0}
    for i, trk in enumerate(before):
        img = imgs[k0 + i][None]
        _, Hh, W = img.shape
        out["fast_nms"] += bounds.kernel_bounds(1, Hh, W, tcfg.maxc, fi, pairs=bounds.fast_pairs(
            img, tcfg.fast_threshold))["fast_nms"]["bound_ms"]
        if imu:
            continue
        levels = tcfg.pyr_levels_cold
        pp = ref.pyramid(imgs[k0 + i - 1][None].float(), levels)
        cp = ref.pyramid(img.float(), levels)
        active = (trk.ids >= 0) & trk.has_prev[:, None]
        _, _, lv = ref.pyramidal_lk(pp, cp, trk.pts, trk.pts, active, fi, li)
        for j, level in enumerate(lv):
            out["lk_iterate"] += bounds.level_bounds("lk_iterate", pp[levels - 1 - j], level, 1,
                                                     tcfg.maxc)
    return out
