"""Per-stage wall timing for the serving pipeline, and the training loop's
non-finite-loss guard.

`StageTimer` and `NaNGuard` are copies of their namesakes in
`tepose_tpu/utils/profiling.py` (host-only classes; importing the original
would import JAX), pinned equal to them by tests/test_torch_serve.py and
tests/test_torch_train_loop.py.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


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


class NaNGuard:
    """Detects persistent non-finite losses and recommends rollback.

    The reference only prints on NaN (trainer.py:285-287); this tracks a
    consecutive-failure budget so the host loop can stop and restore the
    last good checkpoint.
    """

    def __init__(self, patience: int = 3):
        self.patience = patience
        self.consecutive = 0
        self.total = 0
        self.last_good_step: Optional[int] = None

    def check(self, loss: float, step: int) -> bool:
        """Returns True while training may continue."""
        import math

        if math.isfinite(loss):
            self.consecutive = 0
            self.last_good_step = step
            return True
        self.consecutive += 1
        self.total += 1
        return self.consecutive < self.patience

    @property
    def should_rollback(self) -> bool:
        return self.consecutive >= self.patience
