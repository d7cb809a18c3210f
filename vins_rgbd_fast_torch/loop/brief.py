"""BRIEF-256 descriptors and Hamming matching (twin of
``vins_rgbd_fast_tpu/loop/brief.py``).

The test pattern is a DVision pattern file (OpenCV YAML with x1/y1/x2/y2
lists) named by ``VINS_BRIEF_PATTERN``, or else the one in the reference
source tree when ``VINS_REFERENCE_DIR`` names it; ``VINS_BRIEF_PATTERN=
generated``, a missing file or a file that fails to parse give the
generated pattern ``make_pattern(7)``.  The file is parsed with a regex (no
YAML package on the card).

A descriptor bit is ``a < b`` for the two bilinear samples of a pattern
pair on the 5×5 box-smoothed image; the samples are read from one 49×49
patch per keypoint (``ops.lk.batched_subpix_patches``), as JAX reads them,
so a keypoint near the border takes JAX's clamped patch.  JAX picks the
pair values out of the patch with one-hot selector matmuls; here they are
indexed (the same values: a selector column has a single 1).  Hamming
distances are one float32 matmul of the ±1 rows, exact for ±1 and 0.
"""

from __future__ import annotations

import logging
import os
import re
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.lk import batched_subpix_patches

N_BITS = 256
PATCH_HALF = 24  # the pattern's offsets span [-24, 24]
PATCH = 2 * PATCH_HALF + 1
PAD = PATCH_HALF + 2
REFERENCE_PATTERN = os.path.join("support_files", "brief_pattern.yml")  # in the reference tree

_log = logging.getLogger(__name__)


def make_pattern(seed: int = 7) -> np.ndarray:
    """(256, 4) int offsets (x1, y1, x2, y2): Gaussian pairs clipped to the
    patch (the generated pattern)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_HALF / 2.5, size=(N_BITS, 4))
    return np.clip(np.round(pts), -PATCH_HALF + 1, PATCH_HALF - 1).astype(np.int32)


def load_pattern_yml(path: str) -> np.ndarray:
    """Parse a DVision BRIEF pattern file (``x1: [..]`` … ``y2: [..]`` flow
    or block lists) into the (256, 4) offset layout."""
    text = re.sub(r"^%YAML:.*$", "", open(path).read(), flags=re.MULTILINE)
    cols = []
    for key in ("x1", "y1", "x2", "y2"):
        m = re.search(rf"^{key}\s*:\s*(\[[^\]]*\]|(?:\s*-\s*[-+\d]+\s*)+)", text, re.MULTILINE)
        if m is None:
            raise ValueError(f"pattern {path}: no list {key!r}")
        cols.append(np.asarray([int(v) for v in re.findall(r"[-+]?\d+", m.group(1))], np.int32))
    if len({len(c) for c in cols}) != 1:
        raise ValueError(f"pattern {path}: lists of different lengths")
    pat = np.stack(cols, axis=1)
    if pat.shape != (N_BITS, 4):
        raise ValueError(f"pattern {path}: shape {pat.shape} != ({N_BITS}, 4)")
    if np.abs(pat).max() > PATCH_HALF:
        raise ValueError(f"pattern {path}: offsets exceed ±{PATCH_HALF}")
    return pat


def _select_pattern() -> np.ndarray:
    ref = os.environ.get("VINS_REFERENCE_DIR")
    default = os.path.join(ref, REFERENCE_PATTERN) if ref else None
    p = os.environ.get("VINS_BRIEF_PATTERN", default)
    if p and p != "generated":
        if os.path.exists(p):
            try:
                return load_pattern_yml(p)
            except Exception as e:  # noqa: BLE001 — fall back, but loudly
                _log.warning("BRIEF pattern %s failed to load (%s): falling back to the "
                             "generated pattern", p, e)
        elif "VINS_BRIEF_PATTERN" in os.environ:
            _log.warning("BRIEF pattern %s not found: using the generated pattern", p)
    return make_pattern()


PATTERN = _select_pattern()


def pattern_hash() -> int:
    """CRC32 of the active pattern (the JAX package's ``pattern_hash``)."""
    return int(zlib.crc32(PATTERN.tobytes()))


_SEL = {}  # device -> (A flat indices, B flat indices) into a 49×49 patch


def _selectors(device):
    key = str(device)
    if key not in _SEL:
        p = PATTERN.astype(np.int64) + PATCH_HALF
        _SEL[key] = (torch.as_tensor(p[:, 1] * PATCH + p[:, 0], device=device),
                     torch.as_tensor(p[:, 3] * PATCH + p[:, 2], device=device))
    return _SEL[key]


def smooth(img: torch.Tensor) -> torch.Tensor:
    """5×5 box blur with zero padding ("SAME"), of an (H, W) image."""
    return F.avg_pool2d(img[None, None], 5, stride=1, padding=2,
                        count_include_pad=True)[0, 0]


def smoothed_padded(img: torch.Tensor) -> torch.Tensor:
    """The smoothed image, edge-padded by ``PAD`` for the patches."""
    return F.pad(smooth(img)[None, None], (PAD,) * 4, mode="replicate")[0, 0]


def pair_values(sp: torch.Tensor, uv: torch.Tensor):
    """The two samples (a, b) (N, 256) of every pattern pair at keypoints
    ``uv`` (N, 2) on a ``smoothed_padded`` image."""
    flat = batched_subpix_patches(sp, uv, PATCH, PAD).reshape(uv.shape[0], -1)
    ia, ib = _selectors(sp.device)
    return flat[:, ia], flat[:, ib]


def descriptors_on_smoothed(sp: torch.Tensor, uv: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """int8 ±1 descriptors (N, 256); invalid keypoints get zero rows."""
    a, b = pair_values(sp, uv)
    bits = torch.where(a < b, 1, -1).to(torch.int8)
    return torch.where(valid[:, None], bits, torch.zeros_like(bits))


def compute_descriptors(img: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return descriptors_on_smoothed(smoothed_padded(img), uv, valid)


def compute_descriptors_pair(img: torch.Tensor, uv1, v1, uv2, v2):
    """Two keypoint sets against one smoothing pass."""
    sp = smoothed_padded(img)
    return descriptors_on_smoothed(sp, uv1, v1), descriptors_on_smoothed(sp, uv2, v2)


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances of ±1 int8 rows, (Na, 256) × (Nb, 256) ->
    (Na, Nb) float32 (a zero row is at 128 from everything)."""
    sim = da.to(torch.float32) @ db.to(torch.float32).transpose(-1, -2)
    return (N_BITS - sim) * 0.5


def match(da, db, valid_a, valid_b, max_dist: float = 80.0):
    """Best match in ``db`` of every row of ``da`` (batched over leading
    axes), accepted under ``max_dist``; returns (idx_b, ok).  Ties go to the
    lowest index, as ``jnp.argmin``."""
    D = hamming_matrix(da, db)
    D = torch.where(valid_b[..., None, :], D, torch.full_like(D, torch.inf))
    idx = torch.argmin(D, dim=-1)
    best = torch.gather(D, -1, idx[..., None])[..., 0]
    ok = valid_a & (best < max_dist) & torch.isfinite(best)
    return idx, ok
