"""Calibration CLI, the reference's ``intrinsic_calib`` entry point
(``camera_model/src/intrinsic_calib.cc:29-56``) with its flags:

    python3 -m vins_rgbd_fast_torch.calib -w 8 --bh 12 -s 7.0 \\
        -i calibrationdata -p left- -e .png --camera-model pinhole

Reads ``{prefix}*{extension}`` PNGs from the input directory (the port's
PNG decoder; colour is averaged to grey), detects the chessboard in each,
calibrates, prints per-view RMS, and writes ``{camera_name}_camera_calib.yaml``
(camodocal layout, readable by ``config.load_config``).  Detection and the
refinement run on CUDA; ``--device cpu`` runs them on the CPU, and without
CUDA and without it the CLI exits 2.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vins_rgbd_fast_torch.calib")
    ap.add_argument("-w", "--width", type=int, default=8, help="inner corners in x")
    ap.add_argument("--bh", "--board-height", dest="bheight", type=int, default=12,
                    help="inner corners in y")
    ap.add_argument("-s", "--size", type=float, default=7.0, help="square size (mm)")
    ap.add_argument("-i", "--input", default="calibrationdata")
    ap.add_argument("-p", "--prefix", default="")
    ap.add_argument("-e", "--file-extension", dest="ext", default=".png")
    ap.add_argument("--camera-model", dest="model", default="mei",
                    choices=["pinhole", "kannala-brandt", "mei", "scaramuzza"])
    ap.add_argument("--camera-name", dest="name", default="camera")
    ap.add_argument("-v", "--verbose", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to calibrate on the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available (pass --device cpu to calibrate on the CPU)")

    from ..io.images import decode_png
    from .calibrate import calibrate, write_camera_yaml
    from .chessboard import find_chessboard

    if not os.path.isdir(args.input):
        print(f"# ERROR: Cannot find input directory {args.input}.", file=sys.stderr)
        return 1
    files = sorted(f for f in os.listdir(args.input)
                   if f.startswith(args.prefix) and f.endswith(args.ext))
    views, used = [], []
    wh = None
    for f in files:
        with open(os.path.join(args.input, f), "rb") as fh:
            img = decode_png(fh.read()).astype(np.float32)
        if img.ndim == 3:
            img = img.mean(axis=2)
        wh = (img.shape[1], img.shape[0])
        got = find_chessboard(img, rows=args.bheight, cols=args.width, device=device)
        if got is None:
            print(f"# INFO: no chessboard in {f}")
            continue
        views.append(got)
        used.append(f)
    if len(views) < 3:
        print(f"# ERROR: only {len(views)} usable views (need >= 3).", file=sys.stderr)
        return 1

    res = calibrate(args.model, views, rows=args.bheight, cols=args.width, square=args.size,
                    width=wh[0], height=wh[1], device=device)
    if args.verbose:
        for f, e in zip(used, res.per_view_rms_px):
            print(f"# INFO: {f}: rms = {e:.4f} px")
        print(f"# INFO: overall rms = {res.rms_px:.4f} px ({len(views)} views)")
        print(f"# INFO: {res.params}")
    out = f"{args.name}_camera_calib.yaml"
    write_camera_yaml(out, res, camera_name=args.name)
    print(f"# INFO: wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
