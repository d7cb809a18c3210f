"""Host-side stage timing (twin of ``vins_rgbd_fast_tpu/utils/timing.py``,
which cannot be imported without JAX: ``vins_rgbd_fast_tpu/utils/
__init__.py`` imports jax).

``StageTimer`` accumulates the host wall time of named stages with
running averages.  On the card a stage's time is the host's enqueue time
unless the stage ends in a synchronisation.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict


class StageTimer:
    """Accumulates per-stage wall-clock with running averages."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = collections.defaultdict(float)
        self.count: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        c = self.count[name]
        return 1e3 * self.total[name] / c if c else 0.0

    def summary(self) -> Dict[str, float]:
        return {k: self.mean_ms(k) for k in sorted(self.total)}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f}ms avg" for k, v in self.summary().items())
