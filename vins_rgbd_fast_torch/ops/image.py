"""Gaussian image pyramid (twin of ``pyr_down``/``build_pyramid`` in
``vins_rgbd_fast_tpu/ops/image.py``) over batched images (B, H, W)."""

from __future__ import annotations

from typing import List

import torch


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
