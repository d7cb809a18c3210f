"""The readings that the limits of ``correct`` are set from: the program's
numbers over many seeds (the lower reading: the largest a sound run gives)
and the control's (the upper: the smallest the reference gives when it is
put in the program's place one precision below the float32 the
configurations state: the frontend in bfloat16, the window solve in
float32 with TF32 operands).  One process reads every seed of one cell:

    python -m vinsbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]
                                [--control-seeds <k>]

Each seed runs the cell as ``vinsbench.run`` does (its window at the
cell's own load, shortened), then prints one JSON line; the last line gives,
for each number, the largest program reading and the smallest control
reading.  The control is read on the first ``--control-seeds`` seeds (all
by default).  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def control_readings(rec: dict) -> dict:
    """The control's numbers from a run's record, read as the program's
    are: K1's off-corner count, and the worst of every other number over
    the frames it was read in."""
    out = {}
    for k, v in rec.get("control", {}).items():
        if k == "k1_off_corner":
            out[k] = float(v[0])
        elif v:
            out[k] = max(v)
    return out


def main(argv=None) -> int:
    from . import harness as H

    ap = argparse.ArgumentParser(prog="python -m vinsbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None)
    args = ap.parse_args(argv)
    n_ctrl = len(args.seeds) if args.control_seeds is None else args.control_seeds
    root = H.checkout_root()
    H.set_cache_dirs(root)
    bench = H.load_benchmark(root)
    cell = H.find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("vinsbench.control: needs the cell's CUDA cards", file=sys.stderr)
        return 3
    cfg = H.config_file(cell["config"])
    traffic = H.traffic_file(cell["traffic"])
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    lower, upper = {}, {}
    for i, seed in enumerate(args.seeds):
        ctx = H.Ctx(cell=cell, config=cfg, traffic=traffic, seed=seed, seconds=args.seconds,
                    trace=False, devices=devices, t_process=time.time(), out_dir=root,
                    log=lambda m: None, control=i < n_ctrl)
        res = H.driver(traffic["driver"]).run(ctx)
        prog = {k: v for k, (v, _) in res.checks.items()}
        ctrl = control_readings(res.rec)
        for k, v in prog.items():
            lower[k] = v if math.isnan(v) else max(lower.get(k, -math.inf), v)
        for k, v in ctrl.items():
            upper[k] = min(upper.get(k, math.inf), v)
        print(json.dumps(dict(seed=seed, correct=H.passes(res.checks) and res.failed == 0,
                              program=prog, control=ctrl, control_raw=res.rec.get("control"),
                              counts=res.rec.get("tally"), gaps=res.rec.get("solved_gaps"),
                              e2e=res.e2e)), flush=True)
        del res
        torch.cuda.empty_cache()
    print(json.dumps(dict(workload=args.workload, seeds=len(args.seeds), lower=lower,
                          upper=upper, device=torch.cuda.get_device_name(devices[0]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
