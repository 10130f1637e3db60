"""Per-stage wall timing for the serving pipeline.

`StageTimer` is a copy of `tepose_tpu/utils/profiling.py::StageTimer` (a
host-only class; importing the original would import JAX), pinned equal to
it by tests/test_torch_serve.py.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()  # monotonic: NTP steps can't skew totals
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1000.0 * self.totals[k]
                    / max(self.counts[k], 1)}
                for k in self.totals}

    def report(self) -> str:
        return " | ".join(
            f"{k}: {v['total_s']:.2f}s ({v['mean_ms']:.1f}ms x {v['count']})"
            for k, v in sorted(self.summary().items()))
