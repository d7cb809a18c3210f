#!/usr/bin/env python3
"""Two designs of the hand-written kernels, on one card, in one process.

    python3 kernel_ab.py --old OTHER

``OTHER`` is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Its ``vins_rgbd_fast_torch/native.py`` builds its own ``csrc/``
into its own ``build/``; this script then calls this checkout's kernel
wrappers once with that library and once with this checkout's, on the same
inputs:
  * parity: K1 bit for bit; K2 and K3 status agreement and the largest
    |du| and |derr| where both say ok, held to ``chip_smoke.py``'s phase-4
    bounds (>= 99.5 %, 1e-3);
  * time: device ms per launch (``chip_smoke.LaunchTimer``: 100 launches
    between one pair of CUDA events, queued behind a spin kernel) at the
    path shapes, in turns old, new, new, old: K1 on 8 rendered frames and
    on 8 uniform-noise images at 8x480x640 and on one rendered frame at
    1x480x640, K2 per level at 8x200 and K3 per level at 1x200 (the
    latency path's shape) and 8x200.
``OTHER`` may also be a copy of this checkout with one design choice
changed, for example K3's warps per point (``K3_WARPS`` in
``csrc/lk_level.cu``) set to 1 or 2.
Prints one line per case; the last line is one JSON object with each
case's means and old/new ratio (the turns, the iteration-cap sweeps of K2 at
8x200 and K3 at 1x200, both at the fine level, the points that take each
GN step and an empty launch's time go to ``kernel_ab.json`` in
``chip_smoke.py``'s output directory).  Exits non-zero without CUDA or
when a parity bound fails.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys

import torch

import chip_smoke as cs
from vins_rgbd_fast_torch import native
from vins_rgbd_fast_torch.ops import fast, lk
from vins_rgbd_fast_torch.parallel import batched_pipeline as bp


def other_library(checkout: str):
    """The kernel library of another checkout, built and loaded by that
    checkout's own ``native.py``."""
    path = os.path.join(checkout, "vins_rgbd_fast_torch", "native.py")
    spec = importlib.util.spec_from_file_location("kernel_ab_other_native", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib()


@contextlib.contextmanager
def using(L):
    """This checkout's wrappers launch the kernels of library ``L``."""
    saved = native._lib
    native._lib = L
    try:
        yield
    finally:
        native._lib = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="another checkout of this repository")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(args.old, "vins_rgbd_fast_torch", "native.py")):
        print(f"kernel_ab: {args.old} is not a checkout of this repository", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    native.build(verbose=True)
    libs = {"old": other_library(args.old), "new": native.lib()}

    def run(which, fn):
        with using(libs[which]):
            return fn()

    B, N = 8, 200
    rig, tcfg, ecfg, cam = cs.slice_config()
    tcfg_run = bp.BatchedVioRunner(tcfg, cam, ecfg, dev, 1).tcfg  # LK 12/6 envelope
    _, rendered, _ = cs.make_sequences(rig, B, 2, dev)
    frame0 = torch.stack([r[1][0] for r in rendered]).contiguous()
    frame1 = torch.stack([r[1][1] for r in rendered]).contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    noise = torch.rand((B, 480, 640), generator=gen, device=dev) * 255.0
    prev_pyr, cur_pyr, pts, init, active = cs.k2_inputs(frame0, frame1, tcfg_run, N, gen)
    timer = cs.LaunchTimer()
    thr = float(tcfg.fast_threshold)
    results, failures = {}, []

    def record(case, fn, what, ok):
        """Time ``fn`` old, new, new, old and print the case."""
        t = [run(w, lambda: timer(fn)["device_ms"]) for w in ("old", "new", "new", "old")]
        old, new = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        results[case] = dict(turns_ms=t, old_ms=old, new_ms=new, old_over_new=old / new,
                             parity=what)
        print(f"[{case}] old {old:.5f} ms, new {new:.5f} ms per launch (turns "
              f"{[round(x, 5) for x in t]}), old/new {old / new:.2f}x; parity {what}",
              flush=True)
        if not ok:
            failures.append(case)

    def lk_parity(st, u, err):
        rep = cs.parity(dict(level=l), st["new"], st["old"], u["new"], u["old"], err["new"],
                        err["old"])
        return cs.summary([rep]), rep["agree"] >= 0.995 and max(rep["max_du"],
                                                                rep["max_derr"]) <= 1e-3

    # K1
    for case, img in (("K1 8x480x640 rendered", frame0), ("K1 8x480x640 noise", noise),
                      ("K1 1x480x640 rendered", frame0[:1].contiguous())):
        out = {w: run(w, lambda: fast.fast_nms(img, thr)) for w in libs}
        same = torch.equal(out["old"], out["new"])
        record(case, lambda: fast.fast_nms(img, thr), "bit-exact" if same else "DIFFERS", same)

    # K2 and K3 per level, from the same noisy warm start as phase 4
    flow = (init - pts) / 2.0
    k3_fine = None
    for l in (1, 0):
        iters = tcfg_run.lk_max_iters if l == 0 else tcfg_run.lk_coarse_iters
        prev, cur, pts_l, flow, ax, ay = cs.level_inputs(prev_pyr, cur_pyr, pts, flow, l)
        H, W = prev.shape[-2:]
        k2 = (prev, cur, pts_l, flow, active, ax, ay, cs.LK["win"], cs.LK["sm"], iters,
              cs.LK["eps"], cs.LK["min_eig"])
        out = {w: run(w, lambda: lk._lk_level_cuda(*k2)) for w in libs}
        st = {w: lk.level_status(pts_l, o[0], o[1], active, ax, ay, H, W, cs.LK["win"],
                                 cs.LK["sm"], l == 0) for w, o in out.items()}
        what, ok = lk_parity(st, {w: o[0] for w, o in out.items()},
                             {w: o[2] for w, o in out.items()})
        record(f"K2 {B}x{N} level {l} ({iters} it)", lambda: lk._lk_level_cuda(*k2), what, ok)

        # K3 on the first sequence's points (the latency path's 1x200) and on all
        for b in (1, B):
            k3, st_args = cs.k3_args(*([x[:b].contiguous() for x in pyr]
                                       for pyr in (prev_pyr, cur_pyr)),
                                     *(x[:b].contiguous() for x in (pts, flow, active)), l,
                                     iters)
            k3 = tuple(a.contiguous() if torch.is_tensor(a) else a for a in k3)
            if b == 1 and l == 0:
                k3_fine = k3
            out3 = {w: run(w, lambda: lk._lk_iterate_cuda(*k3)) for w in libs}
            st3 = {w: lk.level_status(st_args[0], o[0], *st_args[1:]) for w, o in out3.items()}
            what, ok = lk_parity(st3, {w: o[0] for w, o in out3.items()},
                                 {w: o[1] for w, o in out3.items()})
            record(f"K3 {b}x{N} level {l} ({iters} it)", lambda: lk._lk_iterate_cuda(*k3),
                   what, ok)
        flow = 2.0 * out["new"][0]

    # where K2's and K3's time goes: the fine level at an iteration cap of 0
    # (copies, template, final residual) up to 12, the points that take each
    # GN step (the plain version), and the floor of a launch (a spin of 0
    # cycles)
    caps = tuple(range(13))
    sweep = {w: {it: run(w, lambda: timer(lambda: lk._lk_level_cuda(
        *k2[:9], it, *k2[10:]))["device_ms"]) for it in caps} for w in libs}
    moving = cs.gn_steps(lambda it: lk.lk_level_plain(*k2[:9], it, *k2[10:])[0], 12)
    sweep3 = {w: {it: run(w, lambda: timer(lambda: lk._lk_iterate_cuda(
        *k3_fine[:12], it, k3_fine[13]))["device_ms"]) for it in caps} for w in libs}
    moving3 = cs.gn_steps(lambda it: lk.lk_iterate_plain(*k3_fine[:12], it, k3_fine[13])[0],
                          12)
    floor_ms = timer(lambda: torch.cuda._sleep(0))["device_ms"]
    print(f"[K2 {B}x{N} level 0 by iteration cap] {sweep}; points taking steps 1..12 "
          f"{moving}", flush=True)
    print(f"[K3 1x{N} level 0 by iteration cap] {sweep3}; points taking steps 1..12 "
          f"{moving3}; empty launch {floor_ms:.5f} ms", flush=True)

    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "kernel_ab.json"), "w") as f:
        json.dump(dict(card=smi, reps=timer.reps, results=results,
                       k2_iteration_sweep=sweep, k2_points_by_step=moving,
                       k3_iteration_sweep=sweep3, k3_points_by_step=moving3,
                       empty_launch_ms=floor_ms), f, indent=1)
    print(smi)
    print(json.dumps(dict(card=smi, results={k: {x: v[x] for x in (
        "old_ms", "new_ms", "old_over_new")} for k, v in results.items()})))
    if failures:
        print(f"kernel_ab: parity failed in {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
