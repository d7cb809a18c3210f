"""TUM RGB-D dataset reader (twin of ``vins_rgbd_fast_tpu/io/tum.py``; the
reference's third evaluation suite, ``config/tum_rgbd/tum_fr3.yaml``: VO
mode, 30 Hz RGB-D).

Format: a directory with ``rgb.txt`` / ``depth.txt`` listing ``timestamp
filename`` pairs, ``groundtruth.txt`` with ``t tx ty tz qx qy qz qw``, and
16-bit depth PNGs at 1/5000 m.  Every image is decoded by the port's own
PNG decoder (``io/images.decode_png``), on any machine, so a frame is the
same array everywhere: the JAX reader's imageio path is not taken.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .images import decode_png

DEPTH_SCALE = 1.0 / 5000.0  # TUM convention
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def _read_list_file(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _decode_png(path: str) -> np.ndarray:
    """A PNG file's samples (grey 8/16-bit, RGB 8-bit; filters 0-4)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def load_image(path: str) -> np.ndarray:
    return _decode_png(path)


class TumSequence:
    """Associates rgb/depth by stamp and iterates pipeline-ready frames."""

    def __init__(self, root: str, max_dt: float = 0.02):
        self.root = root
        self.rgb = _read_list_file(os.path.join(root, "rgb.txt"))
        self.depth = _read_list_file(os.path.join(root, "depth.txt"))
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth: Optional[np.ndarray] = None
        if os.path.exists(gt_path):
            rows = []
            with open(gt_path) as f:
                for line in f:
                    if line.startswith("#") or not line.strip():
                        continue
                    rows.append([float(x) for x in line.split()])
            self.groundtruth = np.asarray(rows)
        # associate each rgb stamp with the nearest depth stamp near the last match
        self.pairs: List[Tuple[float, str, str]] = []
        di = 0
        for t, rgb_file in self.rgb:
            best, best_dt = None, max_dt
            for j in range(max(di - 3, 0), min(di + 10, len(self.depth))):
                dt = abs(self.depth[j][0] - t)
                if dt < best_dt:
                    best, best_dt = j, dt
            if best is not None:
                di = best
                self.pairs.append((t, rgb_file, self.depth[best][1]))

    def __len__(self):
        return len(self.pairs)

    def frames(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        for t, rgb_file, depth_file in self.pairs:
            rgb = load_image(os.path.join(self.root, rgb_file))
            if rgb.ndim == 3:
                rgb = rgb.astype(np.float32) @ _LUMA
            depth = load_image(os.path.join(self.root, depth_file)).astype(np.float32) \
                * DEPTH_SCALE
            yield t, rgb.astype(np.float32), depth
