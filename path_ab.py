#!/usr/bin/env python3
"""The end-to-end cells of ``chip_smoke.py`` for two checkouts, on one
card, in turns; or, with ``--plain``, this checkout's latency cells plain
and replayed.

    python3 path_ab.py --old OTHER
    python3 path_ab.py --plain [--cells latency,loop,...]

``OTHER`` is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Each turn runs one checkout's own ``chip_smoke`` cell functions in
a fresh process started in that checkout (its package, its kernel build),
in the order old, new, new, old (``--rounds`` times):
  * batched: phase 5's step (``run_main_path``, B = 8 at 640×480, 11 warm-up
    and 40 steady frames; ms per step by CUDA events, over the replayed
    frames in a checkout whose ``run`` replays a captured frame);
  * latency: phase 7's cell (``run_latency_path``, 16 warm-up and 96 timed
    frames; ms per frame, CUDA-synchronised wall);
  * loop: phase 9's cell (``run_loop_path``, the pose graph on the worker;
    ms per frame, and the loops);
  * vo: phase 15's step (``run_main_path(vo=True)``, batched VO, B = 8 at
    640×480, max_cnt 250, 11 warm-up and 40 steady frames; ms per step by
    CUDA events);
  * marg: one ``ops/marginalization._schur_sqrt_prior`` call at the batched
    step's shapes (B = 8, float32, marginalize-old's index sets, a random
    positive definite H of 172 dimensions), ms by CUDA events over 200
    calls after 20 warm-up calls.
Prints one line per turn; the last line is one JSON object with each cell's
mean per checkout and the new/old ratio of the means (the turns go to
``path_ab.json`` in ``chip_smoke.py``'s output directory).  Compare the
ratio with the spread (max − min over the mean) of one checkout's turns.

``--plain`` runs, in this process, each latency cell of ``chip_smoke.py``
with its steady frames dispatched op by op (``VinsPipeline(replay=False)``,
the plain version) and replayed from the captured frame, in the order
plain, replayed, replayed, plain (``--rounds`` times), each turn a fresh
pipeline over the cell's frames: latency (phase 7: 16 warm-up + 48 timed
frames), loop (phase 9: the revisit scene, the pose graph on the worker,
16 + 96), no_graph (phase 9b), vo_loop (phase 11: VO, the 6-DoF graph on
the worker), td (phase 12: the RealSense rig, 16 + 48), dyn (phase 13: the
OpenLORIS rig, 848×480, dynamic init), mono (phase 13b), kb (phase 16: a
Kannala-Brandt rig file) and harsh (phase 17: the harsh degradations).  A
turn's ms per frame is CUDA-synchronised wall time over the timed frames
(a replayed pipeline's capture frame falls before them).  It prints the
card's name and power limit, a line per turn and per cell (the means, the
plain/replayed ratio of the means, each side's spread), and as the last
line one JSON object, also written to ``path_ab_plain.json``.
Exits non-zero without CUDA or when a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

OUT_DIR = "chiprun_out"
CELLS = ("batched", "latency", "loop", "vo", "marg")
TURN = """
import json, torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
b = c.run_main_path(dev, 8, 40, timer=c.CudaTimer())
lat = c.run_latency_path(dev)
loop = c.run_loop_path(dev)
vo = c.run_main_path(dev, 8, 40, max_cnt=250, timer=c.CudaTimer(), vo=True)
from vins_rgbd_fast_torch.ops import marginalization as m
g = torch.Generator(device=dev).manual_seed(0)
R = torch.randn(8, m.NX, 2 * m.NX, device=dev, generator=g)
H = R @ R.transpose(1, 2) / (2 * m.NX)
bv = torch.randn(8, m.NX, device=dev, generator=g)
pos = m._shifted_positions_old(m._KEEP_OLD)
for _ in range(20):
    m._schur_sqrt_prior(H, bv, m._DROP_OLD, m._KEEP_OLD, pos)
e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
e0.record()
for _ in range(200):
    m._schur_sqrt_prior(H, bv, m._DROP_OLD, m._KEEP_OLD, pos)
e1.record()
torch.cuda.synchronize()
def step(r):  # replayed frames' step, or (before the replay) the whole run's
    return r["step_ms"] if "step_ms" in r else r["run_ms"] / 40
print(json.dumps(dict(batched=step(b), latency=lat["latency_ms_per_frame"],
                      loop=loop["latency_ms_per_frame"], loops=loop["latency_loops"],
                      vo=step(vo), marg=e0.elapsed_time(e1) / 200,
                      ate=[float(a) for a in b["ates"]] + [lat["latency_ate_m"],
                                                           loop["latency_ate_m"]]
                      + [float(a) for a in vo["ates"]])))
"""


def turn(checkout: str) -> dict:
    res = subprocess.run([sys.executable, "-c", TURN], cwd=checkout, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"path_ab: the turn in {checkout} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def latency_cells(dev) -> dict:
    """name -> fn(replay) returning a latency cell's result dict (its ms
    per frame under ``latency_ms_per_frame``)."""
    import chip_smoke as c

    rig_r, seq_r, cfg_r = c.realsense_scene(64 + 4)  # phase 12's scene
    rig_o, seq_o, cfg_o = c.openloris_scene(64 + 3)  # phase 13's scene
    return {
        "latency": lambda rp: c.run_latency_path(dev, n_frames=64, replay=rp),
        "loop": lambda rp: c.run_loop_path(dev, replay=rp),
        "no_graph": lambda rp: c.run_latency_path(dev, revisit=True, replay=rp),
        "vo_loop": lambda rp: c.run_loop_path(dev, max_cnt=250, vo=True, replay=rp),
        "td": lambda rp: c.run_rig_path(dev, cfg_r, rig_r, seq_r, n_frames=64,
                                        failure_check_interval=4, imu_shift=c.TD_TRUE,
                                        replay=rp),
        "dyn": lambda rp: c.run_rig_path(dev, cfg_o, rig_o, seq_o, n_frames=64, replay=rp),
        "mono": lambda rp: c.run_rig_path(dev, cfg_o, rig_o, seq_o, n_frames=64,
                                          depthless=True, replay=rp),
        "kb": lambda rp: c.run_latency_path(dev, n_frames=64, camera="KANNALA_BRANDT",
                                            replay=rp),
        "harsh": lambda rp: c.run_latency_path(dev, n_frames=64, degrade=c.HARSH, replay=rp),
    }


def plain_against_replayed(rounds: int, names: list) -> int:
    """``--plain``: this checkout's latency cells, plain and replayed in turns."""
    import chip_smoke as c

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = c.nvidia_smi_line()
    print(card, flush=True)
    table = latency_cells(torch.device("cuda", 0))
    out = {}
    for name in names or list(table):
        turns = {False: [], True: []}
        for rp in (False, True, True, False) * rounds:
            r = table[name](rp)
            turns[rp].append(r["latency_ms_per_frame"])
            print(f"[{name}] {'replayed' if rp else 'plain'}: {turns[rp][-1]:.3f} ms per frame, "
                  f"capture s {[round(x, 3) for x in r.get('capture_s', [])]}", flush=True)
        mean = {rp: statistics.fmean(v) for rp, v in turns.items()}
        out[name] = dict(plain_ms=turns[False], replayed_ms=turns[True],
                         plain_mean_ms=mean[False], replayed_mean_ms=mean[True],
                         ratio=mean[False] / mean[True],
                         spread={("replayed" if rp else "plain"): (max(v) - min(v)) / mean[rp]
                                 for rp, v in turns.items()})
        print(f"[{name}] plain {mean[False]:.3f} ms, replayed {mean[True]:.3f} ms per frame: "
              f"x{out[name]['ratio']:.2f}; spread {out[name]['spread']}", flush=True)
    res = dict(card=card, cells=out)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "path_ab_plain.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    side = ap.add_mutually_exclusive_group(required=True)
    side.add_argument("--old", help="another checkout of this repository")
    side.add_argument("--plain", action="store_true",
                      help="this checkout's latency cells, plain against replayed")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of four turns (default 1)")
    ap.add_argument("--cells", default="", help="--plain: comma-separated cells (default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_ab: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 2
    if args.plain:
        return plain_against_replayed(args.rounds, [n for n in args.cells.split(",") if n])
    new = os.path.dirname(os.path.abspath(__file__))
    turns = []
    order = (("old", args.old), ("new", new), ("new", new), ("old", args.old)) * args.rounds
    for name, checkout in order:
        r = turn(checkout)
        turns.append(dict(checkout=name, **r))
        print(f"[{name}] " + ", ".join(f"{k} {r[k]:.3f} ms" for k in CELLS)
              + f", loops {r['loops']}", flush=True)
    summary = {}
    for k in CELLS:
        m = {s: statistics.fmean(t[k] for t in turns if t["checkout"] == s)
             for s in ("old", "new")}
        spread = {s: (max(t[k] for t in turns if t["checkout"] == s)
                      - min(t[k] for t in turns if t["checkout"] == s)) / m[s]
                  for s in ("old", "new")}
        summary[k] = dict(old_ms=m["old"], new_ms=m["new"], ratio=m["new"] / m["old"],
                          old_spread=spread["old"], new_spread=spread["new"])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "path_ab.json"), "w") as f:
        json.dump(dict(turns=turns, summary=summary), f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
