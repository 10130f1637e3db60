"""Device traces, per-stage wall timing for the serving pipeline, and the
training loop's non-finite-loss guard.

`trace` is the port of `tepose_tpu/utils/profiling.py::trace` onto
`torch.profiler` (`--profile DIR` of the demo and training CLIs).
`StageTimer` and `NaNGuard` are copies of their namesakes there (host-only
classes; importing the original would import JAX), pinned equal to them by
tests/test_torch_serve.py and tests/test_torch_train_loop.py.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from types import SimpleNamespace
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, device: torch.device | str = "cpu"
          ) -> Iterator[SimpleNamespace]:
    """Record the enclosed code with `torch.profiler`: host activity and,
    when `device` is a CUDA device, the card's kernels and copies.

    On exit the trace is written to `<logdir>/<time>_<pid>.pt.trace.json`
    (Chrome/Perfetto JSON, which TensorBoard's profiler plugin also reads).
    Yields a namespace whose `path` is that file and whose `profiler` is the
    `torch.profiler.profile` object. On a CUDA device the work is
    synchronised before the profiler stops, and a trace without any CUDA
    event raises: a CPU-only trace of a card run would hide the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    out = SimpleNamespace(path=os.path.join(
        logdir, f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
        ".pt.trace.json"), profiler=None)
    with profile(activities=activities) as prof:
        out.profiler = prof
        yield out
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(out.path)
    print(f"Saved the profiler trace to {out.path}")
    if cuda and not any(e.device_type == DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError(f"torch.profiler recorded no CUDA activity on "
                           f"{device} ({out.path}): device tracing (CUPTI) "
                           "is unavailable")


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
