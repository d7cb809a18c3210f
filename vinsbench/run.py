"""One run of one cell of ``BENCHMARK.json`` on the cards of this machine.

    python -m vinsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic, warms up every shape the cell
uses (counted as set-up), measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints as its last line one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, ``breakdown`` (traced runs) and, last, every
number compared beside its limit.  The comparisons go to standard error too,
as its last lines.  Exits non-zero, printing no result, without enough CUDA
cards, without the program beside it, or when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_IMPORT = time.time()


def _fail(msg: str, code: int) -> int:
    print(f"vinsbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    from . import harness as H

    t_process = min(H.process_start_epoch(), T_IMPORT)
    ap = argparse.ArgumentParser(prog="python -m vinsbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = H.checkout_root()
    H.set_cache_dirs(root)
    os.environ["USE_FLAX"] = "0"
    bench = H.load_benchmark(root)
    cell = H.find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has {n}",
                     3)
    try:
        import vins_rgbd_fast_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        return _fail(f"the program vins_rgbd_fast_torch is not beside the benchmark: {e}", 4)

    cfg = H.config_file(cell["config"])
    traffic = H.traffic_file(cell["traffic"])
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    torch.cuda.set_device(devices[0])
    out_dir = os.path.join(root, "vinsbench_out")
    os.makedirs(out_dir, exist_ok=True)

    def log(msg):
        print(f"vinsbench: {msg}", flush=True)

    ctx = H.Ctx(cell=cell, config=cfg, traffic=traffic, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), devices=devices, t_process=t_process, out_dir=out_dir,
                log=log)
    res = H.driver(traffic["driver"]).run(ctx)
    bad = H.forbidden_modules()
    if bad:
        return _fail(f"modules of JAX or of the JAX package were loaded: {bad}", 5)
    return report(bench, cell, res, devices, args, log)


def report(bench: dict, cell: dict, res, devices, args, log) -> int:
    """Print the run's record, the comparisons on standard error and the
    result line; returns 0."""
    import json

    import torch

    from . import harness as H

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in H.cell_metrics(bench, cell["name"], kind):
        v = H.reader(m["name"])(res.rec) if args.trace else res.e2e.get(m["name"])
        if v is not None:
            metrics[m["name"]] = (v, m["unit"])
    smi = res.rec.get("smi", [])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
              "count": len(devices), "memory_peak_bytes": int(res.memory_peak_bytes),
              "power_limit_w": [r.get("power.limit") for r in (smi[0] if smi else [])]}
    if args.trace and "trace" in res.rec:
        device["busy_s"] = res.rec["trace"]["busy_s"]
        device["window_s"] = res.rec["trace"]["window_s"]
    rec = {k: v for k, v in res.rec.items() if k != "trace"}
    rec["spans"] = {k: [len(v), sum(v)] for k, v in rec["spans"].items()}
    log("record " + json.dumps(rec, default=str))
    if args.trace and "trace" in res.rec:
        t = res.rec["trace"]
        log("trace " + json.dumps({k: t[k] for k in ("window_s", "busy_s", "busy_by_device",
                                                       "n_kernels", "kernel_s", "frames",
                                                       "frame_streams")}))
    correct = H.passes(res.checks) and res.failed == 0
    for k, (v, lim) in res.checks.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"correct = {correct}", file=sys.stderr, flush=True)
    print(H.result_line(correct, res.attempted, res.failed, metrics, device, res.checks,
                        res.breakdown if args.trace else None), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
