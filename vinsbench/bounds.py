"""The least time each of the port's kernels can take on one H100: a frozen
copy of the bound arithmetic of ``chip_smoke.py`` (``_bound``,
``kernel_bounds``, ``fast_pairs``, ``k2_footprint``), with its peaks, so the
yardstick does not move with the program.  ``vinsbench/tests/test_frozen.py``
holds it to its source.

A bound is the larger of the bytes (each input read once, each output
written once) over the memory rate and the operations over the float32
rate; where the work depends on the data, the caller passes what its data
needs (``fast_pairs``, ``k2_footprint``, and the Gauss-Newton steps that the
reference's LK counts).
"""

from __future__ import annotations

import torch

from .reference import frontend as ref

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): device memory,
# and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# K1 per pixel: 16 ring differences; the compass pre-test's 8 comparisons;
# 9 for the 3×3 NMS; 5 for the polarity max, the threshold and border
# selects.  Per (pixel, polarity) that passes the pre-test: its 9-arc term
# by doubling, 4 × 16 min/max + 16 for the best arc.
FAST_OPS_PER_PX = 16 + 8 + 9 + 5
FAST_OPS_PER_PAIR = 80
# one bilinear sample of a GN pass and its two products: 4 taps, 3 blends
# (2 flop each), the residual and the two multiply-adds
LK_FLOP_PER_SAMPLE = 16


def _bound(nbytes: float, ops: float) -> dict:
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_F32_PER_S
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(B: int, H: int, W: int, N: int, iters: int, win: int = 21,
                  search_margin: int = 8, pairs=None, footprint=None, steps=None) -> dict:
    """The least time of one launch of each kernel: K1 (``fast_nms``) on
    B×H×W images; K2 (``lk_level``) and K3 (``lk_iterate``) on B×N points at
    a level of at most ``iters`` GN steps.  Without ``pairs``, ``footprint``
    or ``steps`` the counts are the most the shapes could need."""
    px = B * H * W
    P = B * N
    S, PS, WIN = win * win, win + 2, win + 1 + 2 * search_margin
    pairs = 2 * px if pairs is None else pairs
    if footprint is None:
        footprint = (min(P * (PS + 1) ** 2, px), min(P * WIN ** 2, px))
    # every point ends with one residual pass, done or not
    gn_ops = ((P * iters if steps is None else steps) + P) * S * LK_FLOP_PER_SAMPLE
    # K2: the covered pixels of prev and cur; pts, flow (2 f32 each), active
    # (1 B), anchors (2 i32) in; u (2 f32), ok (1 B), err (f32) out
    k2_bytes = 4 * sum(footprint) + P * (8 + 8 + 1 + 8 + 8 + 1 + 4)
    k2_ops = gn_ops + P * (8 * PS * PS + 8 * S)
    # K3: per point template, two gradients and the window; px, py, u0,
    # done0 (1 B), inv_det and the 3 structure terms in; u, err out
    k3_bytes = P * (4 * (3 * S + WIN ** 2) + 8 + 8 + 1 + 16 + 8 + 4)
    return {"fast_nms": _bound(2 * 4 * px, FAST_OPS_PER_PX * px + FAST_OPS_PER_PAIR * pairs),
            "lk_level": _bound(k2_bytes, k2_ops),
            "lk_iterate": _bound(k3_bytes, gn_ops)}


def fast_pairs(img: torch.Tensor, thr: float) -> int:
    """The (pixel, polarity) pairs of (B, H, W) images, inside the 3-px
    border, that pass K1's compass pre-test: two cyclically adjacent points
    of the ring's {0, 4, 8, 12} beyond the threshold."""
    d = ref.ring_differences(img.to(torch.float32))[[0, 4, 8, 12]]
    H, W = img.shape[-2:]
    inner = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    inner[3:H - 3, 3:W - 3] = True

    def passes(beyond):
        return (beyond & beyond.roll(-1, 0)).any(0) & inner

    return int(passes(d > thr).sum() + passes(d < -thr).sum())


def k2_footprint(prev: torch.Tensor, pts_l, ax, ay, win: int = 21,
                 search_margin: int = 8):
    """The pixels of prev and of cur (each counted once) that K2 reads: the
    (win + 3)² template tiles at ``pts_l`` and the search windows at the
    anchors (ax, ay), with clamp-to-edge addresses."""
    B, H, W = prev.shape
    WIN = win + 1 + 2 * search_margin
    pad, PS = WIN, win + 2
    half = (PS - 1) // 2
    x0 = torch.clamp(ref.floor_int(pts_l[..., 0]) + pad - half, 0, W + 2 * pad - PS - 1)
    y0 = torch.clamp(ref.floor_int(pts_l[..., 1]) + pad - half, 0, H + 2 * pad - PS - 1)
    ids = torch.arange(B * H * W, device=prev.device).reshape(B, H, W)

    def covered(y, x, n):
        return int(ref.gather_tiles(ids, y, x, n, n, pad).unique().numel())

    return covered(y0, x0, PS + 1), covered(ay, ax, WIN)


def level_bounds(kernel: str, prev_level: torch.Tensor, level, B: int, N: int) -> float:
    """The bound (ms) of one LK launch at one pyramid level: K2 with the
    covered pixels and the steps the reference took, or K3 with its steps
    (``level`` a ``reference.frontend.Level``)."""
    H, W = prev_level.shape[-2:]
    fp = (k2_footprint(prev_level, level.pts_l, level.ax, level.ay) if kernel == "lk_level"
          else None)
    return kernel_bounds(B, H, W, N, level.iters, footprint=fp,
                         steps=level.steps)[kernel]["bound_ms"]
