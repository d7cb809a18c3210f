"""Chessboard corner detection for intrinsic calibration (twin of
``vins_rgbd_fast_tpu/calib/chessboard.py``).

``detect_corners`` runs on the image's device: local-mean removal and the
two checkerboard response convolutions (``F.conv2d``, zero "SAME" padding,
TF32 off), the window-max NMS (``F.max_pool2d`` over a ``-inf``-padded
map), the border mask, the top-k (a stable descending sort: JAX's
``top_k`` order, the lowest flat index first among ties) and the quadratic
sub-pixel refinement.  Only the grid ordering, a few hundred points, runs
on the host, after one read-back; ``_quadrant_kernels``, ``_h_from_4``,
``_apply_h`` and ``order_grid`` are numpy copies of JAX's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _quadrant_kernels(r: int) -> np.ndarray:
    """(2, 2r+1, 2r+1) checkerboard response kernels: sign(x̃·ỹ) fires on
    axis-aligned saddle corners, sign(|x̃|−|ỹ|) on 45°-rotated ones (the
    ChESS-style pair; together they cover any board orientation)."""
    xs = np.arange(-r, r + 1, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs)
    a = np.sign(X * Y)
    b = np.sign(np.abs(X) - np.abs(Y))
    a /= np.abs(a).sum() or 1.0
    b /= np.abs(b).sum() or 1.0
    return np.stack([a, b]).astype(np.float32)


def _conv2(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(H, W) ⋆ (2r+1, 2r+1) cross-correlation, zero padded to (H, W)."""
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic,
                 allow_tf32=False):
        return F.conv2d(img[None, None], k[None, None], padding=k.shape[-1] // 2)[0, 0]


def detect_corners(img: torch.Tensor, max_corners: int, radius: int = 4):
    """Checkerboard corner candidates of an (H, W) image on its device:
    (uv (M, 2) float32 sub-pixel, score (M,)) sorted by response, M =
    ``max_corners``."""
    img = img.to(torch.float32)
    dev = img.device
    ka, kb = (torch.as_tensor(k, device=dev) for k in _quadrant_kernels(radius))
    n = 2 * radius + 1
    mean_k = torch.full((n, n), 1.0 / (n * n), dtype=torch.float32, device=dev)
    z = img - _conv2(img, mean_k)  # local-mean removal
    resp = torch.maximum(torch.abs(_conv2(z, ka)), torch.abs(_conv2(z, kb)))

    # NMS over a (2radius+1)² window, border suppressed
    H, W = img.shape
    mx = F.max_pool2d(F.pad(resp[None, None], (radius,) * 4, value=-torch.inf), n,
                      stride=1)[0, 0]
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    border = ((yy >= radius + 1) & (yy < H - radius - 1)
              & (xx >= radius + 1) & (xx < W - radius - 1))
    peaks = torch.where((resp >= mx) & border, resp, torch.zeros_like(resp))

    vals, idx = torch.sort(peaks.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:max_corners], idx[:max_corners]
    ys = idx // W
    xs = idx % W

    # quadratic sub-pixel refinement on the response surface
    def quad(c_m, c_0, c_p):
        denom = c_m - 2.0 * c_0 + c_p
        return torch.where(torch.abs(denom) > 1e-9, 0.5 * (c_m - c_p) / denom,
                           torch.zeros_like(denom))

    def g(dy, dx):
        return resp[torch.clamp(ys + dy, 0, H - 1), torch.clamp(xs + dx, 0, W - 1)]

    dx = torch.clamp(quad(g(0, -1), g(0, 0), g(0, 1)), -0.5, 0.5)
    dy = torch.clamp(quad(g(-1, 0), g(0, 0), g(1, 0)), -0.5, 0.5)
    uv = torch.stack([xs.to(torch.float32) + dx, ys.to(torch.float32) + dy], dim=-1)
    return uv, vals


# ---------------------------------------------------------------------------
# grid ordering (host; a few hundred points)
# ---------------------------------------------------------------------------

def _h_from_4(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Homography from exactly 4 correspondences (plain DLT)."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A, np.float64))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def _apply_h(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    ph = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1) @ H.T
    return ph[:, :2] / ph[:, 2:3]


def order_grid(uv: np.ndarray, rows: int, cols: int,
               tol: float = 0.25) -> np.ndarray | None:
    """Order rows*cols detected corners into board-index order
    (row-major, like the reference's ``Chessboard::getCorners``).

    Picks the 4 extreme corners (max/min of x±y), tries the 8 assignments
    of them to the board's rectangle corners (4 rotations × transpose),
    keeps the homography under which every point snaps to a distinct
    integer grid node within ``tol`` (grid units).  Returns (rows*cols, 2)
    or None if no consistent ordering exists.  Board orientation is
    recovered up to the checkerboard's own symmetry — exactly the
    ambiguity every chessboard detector has."""
    uv = np.asarray(uv, np.float64)
    n = rows * cols
    if uv.shape[0] < n:
        return None
    s, d = uv[:, 0] + uv[:, 1], uv[:, 0] - uv[:, 1]
    ext = uv[[np.argmin(s), np.argmax(d), np.argmax(s), np.argmin(d)]]
    if len({tuple(p) for p in map(tuple, ext)}) < 4:
        return None

    corners = [(0.0, 0.0), (cols - 1.0, 0.0),
               (cols - 1.0, rows - 1.0), (0.0, rows - 1.0)]
    best = None
    for rot in range(4):
        for flip in (False, True):
            tgt = corners[rot:] + corners[:rot]
            if flip:
                tgt = tgt[::-1]
            H = _h_from_4(ext, np.asarray(tgt))
            g = _apply_h(H, uv)
            gi = np.round(g)
            res = np.abs(g - gi).max(axis=1)
            ok = ((res < tol) & (gi[:, 0] >= 0) & (gi[:, 0] < cols)
                  & (gi[:, 1] >= 0) & (gi[:, 1] < rows))
            if ok.sum() < n:
                continue
            keys = (gi[ok, 1] * cols + gi[ok, 0]).astype(int)
            if len(np.unique(keys)) != n:
                continue
            # clutter can snap onto an occupied node (ok.sum() > n with
            # unique count still n): keep the LOWEST-residual point per
            # node, never last-write-wins
            res_ok = res[ok]
            order = np.argsort(-res_ok)  # worst first -> best written last
            out = np.zeros((n, 2))
            out[keys[order]] = uv[ok][order]
            kept = np.full(n, np.inf)
            np.minimum.at(kept, keys, res_ok)
            err = float(kept.mean())
            if best is None or err < best[0]:
                best = (err, out)
    return None if best is None else best[1]


def find_chessboard(img, rows: int, cols: int, radius: int = 4,
                    device="cuda") -> np.ndarray | None:
    """Detect + order a (rows×cols inner corner) chessboard in ``img``, an
    array or a tensor, detected on ``device`` (default cuda; ``"cpu"`` to
    detect on the CPU).  Returns (rows*cols, 2) pixel corners in row-major
    board order, or None."""
    n = rows * cols
    img = torch.as_tensor(img, device=device)
    uv, score = detect_corners(img, max_corners=n + n // 2, radius=radius)
    uv, score = (a.cpu().numpy() for a in (uv, score))  # the one read-back
    # adaptive cut: corners of a real board have comparable response;
    # clutter tails off
    thresh = 0.35 * score[: n].mean()
    uv = uv[score > thresh]
    for take in (n, min(len(uv), n + n // 4), len(uv)):
        if take >= n:
            got = order_grid(uv[:take], rows, cols)
            if got is not None:
                return got
    return None
