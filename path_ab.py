#!/usr/bin/env python3
"""The end-to-end cells of ``chip_smoke.py`` for two checkouts, on one
card, in turns.

    python3 path_ab.py --old OTHER

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="another checkout of this repository")
    ap.add_argument("--rounds", type=int, default=1, help="old-new-new-old rounds (default 1)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_ab: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 2
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
