"""A fleet of logs reprocessed on the batched runner
(``parallel/batched_pipeline.BatchedVioRunner``): ``lanes_per_card``
streams on one card, warmed by the runner's own ``warm`` (the
window-filling frames and the initialization), then passes of
``pass_frames`` steady frames through ``run``, each pass from the
post-warm-up tracker, estimator and generator states, so every pass does
the same work.  Closed loop: each call (a chunk of a pass) is dispatched
when the one before has finished.

Traffic keys: ``lanes_per_card``, ``pass_frames``, ``chunk_frames`` (the
frames of one call: the window ends on a whole call; a traced run profiles
the window's first call again), ``trajectory`` (the generator's walk),
``lk_iters`` (the LK caps the runner runs, fine and coarse, for the
reference), ``check_frames`` (frames whose tracks the reference follows),
``solve_checks`` and ``check_rate`` (how many calls of the first pass,
drawn from the seed among the first ``seconds · check_rate``, have their
last frame's window solve, every lane, checked by the reference).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from .. import bounds, check, tap
from .. import harness as H
from ..reference import frontend as ref
from ..traffic import synthetic as syn


def tracker_config(vcfg):
    """The tracker settings ``VinsPipeline`` derives from a rig's keys."""
    from vins_rgbd_fast_torch.config import TrackerConfig

    return TrackerConfig(
        width=vcfg.image_width, height=vcfg.image_height, max_cnt=vcfg.max_cnt,
        capacity=vcfg.feature_capacity, min_dist=vcfg.min_dist,
        grid_rows=vcfg.num_grid_rows, grid_cols=vcfg.num_grid_cols,
        f_threshold=vcfg.f_threshold, fast_threshold=float(vcfg.fast_threshold),
        equalize=bool(vcfg.equalize), fisheye=bool(vcfg.fisheye),
        fisheye_mask_path=vcfg.fisheye_mask, use_imu_prediction=bool(vcfg.imu))


def _generator_states(runner) -> list:
    return [g.get_state() for g in runner.generators + (runner.pnp_generators or [])]


def _set_generator_states(runner, states) -> None:
    for g, s in zip(runner.generators + (runner.pnp_generators or []), states):
        g.set_state(s)


def run(ctx: H.Ctx) -> H.Outcome:
    from vins_rgbd_fast_torch.config import EstimatorConfig
    from vins_rgbd_fast_torch.parallel import batched_pipeline as bp

    tr, cfg = ctx.traffic, ctx.config
    vcfg = H.vins_config(cfg)
    if vcfg.imu:
        raise ValueError("the fleet driver warms its lanes with the runner's own warm-up, "
                         "which a rig with an IMU clock offset cannot use: VO rigs only")
    if len(ctx.devices) != 1:
        raise ValueError("the fleet driver runs one card")
    dev = ctx.devices[0]
    on_card = dev.type == "cuda"
    rig = H.rig(cfg)
    B = tr["lanes_per_card"]
    K = bp.WINDOW_SIZE + 1
    T = tr["pass_frames"]
    n = K + T
    tcfg = tracker_config(vcfg)
    ecfg = EstimatorConfig.from_vins(vcfg)
    maxi = ecfg.max_imu
    spans = H.Spans()
    seeds = H.lane_seeds(ctx.seed, B + 1)
    with spans.span("render"):
        seqs = [syn.make_trajectory(n, rig, seed=s, **tr["trajectory"]) for s in seeds[:B]]
        imgs = torch.empty((n, B, rig.height, rig.width), device=dev)
        depths = torch.empty_like(imgs)
        for b, s in enumerate(seqs):
            syn.render_into(s, rig, imgs[:, b], depths[:, b])
        ts = torch.as_tensor(np.stack([s.times for s in seqs], 1), dtype=torch.float32)
        batch = bp.FrameBatch(imgs, depths, ts.to(dev), torch.zeros((n, B, maxi), device=dev),
                              torch.zeros((n, B, maxi + 1, 3), device=dev),
                              torch.zeros((n, B, maxi + 1, 3), device=dev))
        H.synchronize([dev])
    C = tr["chunk_frames"]

    def frames(j0, j1):
        return bp.FrameBatch(*(a[K + j0:K + j1] for a in batch))

    chunks = [frames(j, min(j + C, T)) for j in range(0, T, C)]
    # the calls of the first pass whose last frame's solve is compared, among
    # those the window reaches at ``check_rate`` calls a second
    pool = max(1, min(len(chunks), int(ctx.seconds * tr["check_rate"])))
    solve_at = set(check.checked_frames(ctx.seed, pool, tr["solve_checks"], first=0))
    taps = tap.program_taps()
    with spans.span("warmup"), taps:
        runner = bp.BatchedVioRunner(tcfg, vcfg.camera(), ecfg, dev, B, seed=seeds[B] % 2 ** 31)
        trk, st = runner.init_states(seqs[0].ric, seqs[0].tic)
        trk, st, _ = runner.warm(trk, st, bp.FrameBatch(*(a[:K] for a in batch)))
        gens = _generator_states(runner)
        runner.run(trk, st, chunks[0])  # the warm-up and capture, and the call's output buffers
        H.synchronize([dev])
    with spans.span("nvidia_smi"):
        smi = [H.nvidia_smi([dev.index])] if on_card else []
    t_window = time.time()
    p0 = time.perf_counter()
    steps, passes, first, trk_end, solves, done = 0, [], [], None, [], False
    with taps:
        while not done:
            _set_generator_states(runner, gens)
            state, poses = (trk, st), []
            passes.append(poses)
            for j, ch in enumerate(chunks):
                with spans.span("run_call"):
                    *state, outs = runner.run(*state, ch)
                H.synchronize([dev])
                poses.append(outs)
                steps += min(C, T - j * C)
                if len(passes) == 1:
                    first.append(outs)
                    trk_end = state[0]
                    if j in solve_at:
                        solves.append(taps.take(replayed=on_card))
                if time.perf_counter() - p0 >= ctx.seconds:
                    done = True
                    break
    elapsed = time.perf_counter() - p0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    e2e = dict(setup_s=t_window - ctx.t_process, seq_frames_per_s=steps * B / elapsed)
    rec = dict(spans=spans.s, steps=steps, lanes=B, cards=1, passes=len(passes),
               window_s=elapsed, smi=smi)
    ctx.log(f"window: {steps} frames x {B} lanes ({len(passes)} passes) in {elapsed:.3f} s; "
            f"setup {e2e['setup_s']:.3f} s (render {spans.total('render'):.3f}, warm-up "
            f"{spans.total('warmup'):.3f})")

    breakdown = None
    if ctx.trace:
        # the window's first call again, from the same states and draws
        _set_generator_states(runner, gens)
        path = os.path.join(ctx.out_dir, f"{ctx.cell['name']}-{ctx.seed}.trace.json")
        red = H.profile_frames(lambda i: runner.run(trk, st, chunks[0]), 1, [dev], path,
                               frames=min(C, T))
        # the tracker's state before each of its frames, from the same call
        # made a frame at a time outside the profile (the frame program
        # does not depend on a call's length)
        _set_generator_states(runner, gens)
        t_trk, t_st, before = trk, st, []
        for i in range(min(C, T)):
            before.append(t_trk._replace(pyramid=()))
            t_trk, t_st, _ = runner.run(t_trk, t_st, frames(i, i + 1))
        rec["trace"] = red
        rec["bounds_ms"] = _bounds(before, imgs, K, tcfg, tr, B)
        rec["frame_streams"] = red["frame_streams"]
        breakdown = red["breakdown"]
        del t_trk, t_st, before
    if on_card:
        smi.append(H.nvidia_smi([dev.index]))
    runner.close()
    del runner, trk, st, state
    trk_end = trk_end._replace(pyramid=())

    # the comparisons, once the window has closed and the program's state is freed
    tally, shown = check.Tally(), check.Tally()
    g = cfg["guarantees"]
    failed = 0
    for poses in passes:
        Pn = np.concatenate([check.to_np(out.P) for out in poses])
        frames_t = np.arange(K, K + Pn.shape[0])
        failed += int((~np.isfinite(Pn).all(-1)).sum())
        for b in range(B):
            ate, bound = check.ate_ratio(Pn[:, b], frames_t, seqs[b], g)
            tally.add("ate_ratio", ate / bound if math.isfinite(ate) else float("nan"))
    control = {}
    last = bp.ScanOutputs(*(torch.cat(f) for f in zip(*first)))
    _check_frontend(ctx, tr, tcfg, imgs, K, last, trk_end, tally, control)
    flags = check.solve_flags(cfg)
    for s in solves:
        prog, ctrl, printed = check.solve_numbers(s, flags, control=ctx.control)
        for k, v in prog.items():
            tally.add(k, v, B)
        for k, v in printed.items():
            shown.add(k, v, B)
        for k, v in ctrl.items():
            control.setdefault(k, []).append(v)
    rec["control"] = control
    rec["solved_gaps"] = check.summary(shown)
    limits = dict(ate_ratio=1.0, k1_off_corner=check.K1_LIMIT, lk_gap_px=check.LK_GAP_LIMIT_PX,
                  **check.solve_limits(flags))
    checks = check.checks(tally, limits, list(limits))
    rec["tally"] = check.summary(tally)
    return H.Outcome(e2e=e2e, rec=rec, checks=checks, attempted=steps * B, failed=failed,
                     memory_peak_bytes=int(peak), breakdown=breakdown)


def _check_frontend(ctx, tr, tcfg, imgs, K: int, last, trk_end, tally, control) -> None:
    """The reference's LK over the tracks of sampled frames of the first
    pass, and K1's corners at its last frame."""
    T0 = last.P.shape[0]
    fi, li = tr["lk_iters"]
    levels = tcfg.pyr_levels_cold
    for t in check.checked_frames(ctx.seed, T0, tr["check_frames"]):
        uv0, id0, v0 = last.wp_uv[t - 1], last.wp_ids[t - 1], last.wp_valid[t - 1]
        uv1, id1, v1 = last.wp_uv[t], last.wp_ids[t], last.wp_valid[t]
        pts, status, matched, _ = check.lk_tracks(imgs[K + t - 1], imgs[K + t], uv0, id0, v0,
                                                  uv1, id1, v1, levels, fi, li)
        gaps = check.lk_gaps(pts, status, matched, uv1)
        tally.add("lk_gap_px", float(gaps.max()) if gaps.numel() else 0.0, int(gaps.numel()))
        if ctx.control:
            p16, s16, m16, _ = check.lk_tracks(imgs[K + t - 1], imgs[K + t], uv0, id0, v0, uv1,
                                               id1, v1, levels, fi, li, dtype=torch.bfloat16)
            cg = check.lk_gaps(p16, s16 & status, m16, pts)
            control.setdefault("lk_gap_px", []).append(float(cg.max()) if cg.numel() else 0.0)
    mask = check.new_features(trk_end.ids, trk_end.track_cnt)
    n_chk, off = check.k1_off_corner(imgs[K + T0 - 1], trk_end.pts, mask, tcfg.fast_threshold)
    tally.sum("k1_off_corner", off, n_chk)
    if ctx.control:
        c_chk, c_off = check.k1_control(imgs[K + T0 - 1], tcfg.fast_threshold, tcfg.grid_rows,
                                        tcfg.grid_cols, tcfg.cand_per_grid)
        k = control.setdefault("k1_off_corner", [0, 0])
        k[0] += c_off
        k[1] += c_chk


def _bounds(before, imgs, k0: int, tcfg, tr: dict, B: int) -> dict:
    """The least time K1 and K2 could take over the traced frames, on the
    work these frames' own inputs need: K1's pre-test survivors, and K2's
    covered pixels and Gauss-Newton steps from the reference's LK started
    where the program's tracker stood."""
    fi, li = tr["lk_iters"]
    levels = tcfg.pyr_levels_cold
    out = {"fast_nms": 0.0, "lk_level": 0.0}
    for i, trk in enumerate(before):
        img = imgs[k0 + i]
        _, Hh, W = img.shape
        out["fast_nms"] += bounds.kernel_bounds(
            B, Hh, W, tcfg.maxc, fi, pairs=bounds.fast_pairs(img, tcfg.fast_threshold)
        )["fast_nms"]["bound_ms"]
        pp = ref.pyramid(imgs[k0 + i - 1].float(), levels)
        cp = ref.pyramid(img.float(), levels)
        active = (trk.ids >= 0) & trk.has_prev[:, None]
        _, _, lv = ref.pyramidal_lk(pp, cp, trk.pts, trk.pts, active, fi, li)
        for j, level in enumerate(lv):
            out["lk_level"] += bounds.level_bounds("lk_level", pp[levels - 1 - j], level, B,
                                                   tcfg.maxc)
    return out
