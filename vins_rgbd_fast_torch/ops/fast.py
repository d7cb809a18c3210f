"""FAST-9/16 corner score + 3×3 NMS, and the per-grid top-k selection
(twin of ``vins_rgbd_fast_tpu/ops/fast.py``).

``fast_nms`` is the wrapper of kernel K1 (``csrc/fast_nms.cu``, the Hopper
replacement of ``ops/fast_pallas.py:fast_score_nms``): on a CUDA tensor it
launches the kernel, on a CPU tensor it runs the plain version
``nms3(fast_score(...))`` below.  The two agree bit for bit (every step is
a subtraction, a min, a max or a negation of float32 values).  The kernel
skips the arc work of pixels that fail a compass pre-test and builds the
arc minima by doubling; ``tests/test_torch_fast.py`` holds that arithmetic
to ``ring_differences`` and ``arc_terms`` here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .. import native

# Bresenham circle of radius 3 (OpenCV ordering), (dy, dx)
FAST_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
ARC_LEN = 9

launches = native.LaunchCount()  # K1 launches (the CUDA path only), by device too


def ring_differences(f: torch.Tensor) -> torch.Tensor:
    """(16, B, H, W): ring point k minus the centre, for float32 images
    (B, H, W); the image wraps around at its edges."""
    ring = torch.stack([torch.roll(f, (-dy, -dx), dims=(-2, -1))
                        for dy, dx in FAST_OFFSETS], dim=0)
    return ring - f[None]


def arc_terms(diff: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bright and dark terms of the V-measure from ``ring_differences``:
    the max over the 16 contiguous 9-arcs of the arc's min difference, of
    the differences and of their negation."""
    ring2_b = torch.cat([diff, diff[:ARC_LEN - 1]], dim=0)
    ring2_d = -ring2_b

    def arc_min(x):
        m = x[:16]
        for k in range(1, ARC_LEN):
            m = torch.minimum(m, x[k:k + 16])
        return m

    return arc_min(ring2_b).amax(dim=0), arc_min(ring2_d).amax(dim=0)


def fast_score(img: torch.Tensor, threshold: float = 10.0) -> torch.Tensor:
    """FAST-9/16 V-measure score map (B, H, W), 0 for non-corners: the max
    over contiguous 9-arcs of the arc's min ring difference, bright and
    dark arcs separately; 3-px border zeroed."""
    f = img.to(torch.float32)
    bright, dark = arc_terms(ring_differences(f))
    score = torch.maximum(bright, dark)
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    H, W = f.shape[-2:]
    yy = torch.arange(H, device=f.device)[:, None]
    xx = torch.arange(W, device=f.device)[None, :]
    inb = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return torch.where(inb, score, torch.zeros_like(score))


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3×3 non-maximum suppression (keep s ≥ 3×3 max and s > 0); pixels
    outside the image count as -inf (``reduce_window`` "SAME")."""
    m = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where((score >= m) & (score > 0), score, torch.zeros_like(score))


def fast_nms(img: torch.Tensor, threshold: float = 10.0) -> torch.Tensor:
    """NMS'd FAST-9/16 score map for a batch of images (B, H, W) f32."""
    if img.device.type == "cpu":
        return nms3(fast_score(img, threshold))
    if img.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError("fast_nms: needs a contiguous (B, H, W) float32 tensor")
    if not threshold >= 0.0:
        raise ValueError(f"fast_nms: the kernel takes a threshold >= 0 (got {threshold})")
    B, H, W = img.shape
    out = torch.empty_like(img)
    native.launch("fast_nms_launch", img.device, img.data_ptr(), out.data_ptr(), B, H, W,
                  float(threshold))
    launches.add(img.device.index)
    return out


def grid_topk(score: torch.Tensor, rows: int, cols: int,
              per_grid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``per_grid`` responses per grid cell of a (B, H, W) score map.

    Returns (xy (B, rows·cols·per_grid, 2), response (B, ...)).  Iterative
    argmax keeps the JAX tie order: among equal scores the first (row-major
    within the cell) index wins."""
    B, H, W = score.shape
    gh, gw = H // rows, W // cols
    s = score[:, :gh * rows, :gw * cols].reshape(B, rows, gh, cols, gw)
    s = s.permute(0, 1, 3, 2, 4).reshape(B, rows * cols, gh * gw)
    iota = torch.arange(s.shape[-1], device=score.device)
    vs, ids = [], []
    sc = s
    for _ in range(per_grid):
        i = torch.argmax(sc, dim=-1)
        vs.append(torch.gather(sc, -1, i[..., None])[..., 0])
        ids.append(i)
        sc = torch.where(iota == i[..., None], -torch.inf, sc)
    vals = torch.stack(vs, dim=-1)
    idx = torch.stack(ids, dim=-1)
    cy = idx // gw
    cx = idx % gw
    g = torch.arange(rows * cols, device=score.device)
    gy = (g // cols)[:, None] * gh
    gx = (g % cols)[:, None] * gw
    xy = torch.stack([(gx + cx).to(score.dtype), (gy + cy).to(score.dtype)], dim=-1)
    return xy.reshape(B, -1, 2), vals.reshape(B, -1)
