"""Gaussian image pyramid, CLAHE and bilinear sampling (twins of
``pyr_down``/``build_pyramid``, ``clahe`` and ``bilinear_sample`` in
``vins_rgbd_fast_tpu/ops/image.py``); the pyramid and CLAHE over batched
images (B, H, W)."""

from __future__ import annotations

import functools
from typing import List

import torch


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at float coordinates xy (..., 2) = (x, y); the four
    taps clamp to the border (OpenCV's BORDER_REPLICATE)."""
    H, W = img.shape
    x0 = torch.floor(xy[..., 0])
    y0 = torch.floor(xy[..., 1])
    fx = xy[..., 0] - x0
    fy = xy[..., 1] - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    return (img[y0i, x0i] * (1 - fx) * (1 - fy) + img[y0i, x1i] * fx * (1 - fy)
            + img[y1i, x0i] * (1 - fx) * fy + img[y1i, x1i] * fx * fy)


def _tap5(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Separable [1 4 6 4 1]/16 along ``dim`` with edge padding."""
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(-2, n + 2, device=x.device), 0, n - 1)
    xp = x.index_select(dim, idx)

    def sl(off):
        return xp.narrow(dim, off, n)

    return (sl(0) + 4.0 * sl(1) + 6.0 * sl(2) + 4.0 * sl(3) + sl(4)) * (1.0 / 16.0)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One level: separable 5-tap Gaussian then 2x decimation."""
    x = _tap5(_tap5(img, -2), -1)
    return x[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


# ---------------------------------------------------------------------------
# CLAHE (twin of ``clahe`` in ``vins_rgbd_fast_tpu/ops/image.py``)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _clahe_geometry(H: int, W: int, tiles: int, device: torch.device):
    """Per-pixel tile index of the histograms, and the bilinear blend
    between tile centres (the four tiles and the weights per row and per
    column), for an H×W frame."""
    th, tw = H // tiles, W // tiles
    Hc, Wc = th * tiles, tw * tiles

    def axis(n: int, t: int):
        c = (torch.arange(n, dtype=torch.float32) - t / 2.0 + 0.5) / t
        c0 = torch.clamp(torch.floor(c).to(torch.int64), 0, tiles - 1)
        c1 = torch.clamp(c0 + 1, 0, tiles - 1)
        f = torch.clamp(c - torch.floor(c), 0.0, 1.0)
        # constant extension past the first and last tile centres
        f = torch.where((c < 0) | (c > tiles - 1),
                        torch.where(c < 0, torch.zeros_like(f), torch.ones_like(f)), f)
        return c0.to(device), c1.to(device), f.to(device)

    tile = ((torch.arange(Hc) // th)[:, None] * tiles + (torch.arange(Wc) // tw)[None, :])
    return tile.to(device), axis(Hc, th), axis(Wc, tw)


def clahe(img: torch.Tensor, tiles: int = 8, clip_limit: float = 3.0,
          nbins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization with OpenCV's
    semantics (clip 3.0 and an 8×8 tile grid, as the reference configures
    it) over (B, H, W) frames in [0, 255]; float32 out.

    Tiles are (H // 8)×(W // 8); a margin past the last whole tile is
    passed through unchanged.  Each tile's 256-bin histogram is counted in
    int64 with ``scatter_add_`` (exact, and no (H·W·256) one-hot as in the
    JAX version), clipped, its excess spread uniformly in one pass, and
    its cumulative sum scaled to a 0..255 LUT; each pixel blends the LUTs
    of the four tile centres around it bilinearly."""
    B, H, W = img.shape
    dev = img.device
    th, tw = H // tiles, W // tiles
    Hc, Wc = th * tiles, tw * tiles
    tile, (ty0, ty1, fy), (tx0, tx1, fx) = _clahe_geometry(H, W, tiles, dev)
    imgc = img[:, :Hc, :Wc].to(torch.float32)
    pix = torch.clamp(imgc.to(torch.int64), 0, nbins - 1)

    nt = tiles * tiles
    slot = (torch.arange(B, device=dev)[:, None, None] * nt + tile) * nbins + pix
    counts = torch.zeros(B * nt * nbins, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, slot.reshape(-1), torch.ones_like(slot.reshape(-1)))
    hist = counts.reshape(B, nt, nbins).to(torch.float32)

    # clip + uniform redistribution of the excess (one pass, OpenCV-style)
    limit = max(clip_limit * (th * tw) / nbins, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins
    cdf = torch.cumsum(hist, dim=-1)
    lut = ((cdf - cdf[..., :1]) / torch.clamp(cdf[..., -1:] - cdf[..., :1], min=1.0)
           * (nbins - 1)).reshape(B, nt * nbins)

    def at(ty, tx):  # (B, Hc, Wc) LUT values of tile (ty[y], tx[x]) at each pixel
        i = (ty[:, None] * tiles + tx[None, :]) * nbins + pix
        return torch.gather(lut, 1, i.reshape(B, -1)).reshape(B, Hc, Wc)

    fyg, fxg = fy[:, None], fx[None, :]
    out = (at(ty0, tx0) * (1 - fyg) * (1 - fxg)
           + at(ty0, tx1) * (1 - fyg) * fxg
           + at(ty1, tx0) * fyg * (1 - fxg)
           + at(ty1, tx1) * fyg * fxg)
    if (Hc, Wc) == (H, W):
        return out
    full = img.to(torch.float32).clone()
    full[:, :Hc, :Wc] = out
    return full
