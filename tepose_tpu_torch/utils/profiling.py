"""Device traces, a profiled call's device busy time, per-stage wall timing
for the serving pipeline, and the training loop's non-finite-loss guard.

`trace` is the port of `tepose_tpu/utils/profiling.py::trace` onto
`torch.profiler` (`--profile DIR` of the demo and training CLIs).
`profile_device` sums one call's device time and kernels (`bench_notes`,
`chip_smoke.py`, `tools/lbs_kernel_bench.py`). `span` names a stretch of
host work in any profiler trace (`tepose:<name>`), on the profiler's clock.
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

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`torch.profiler.record_function("tepose:<name>")` while a profiler is
    recording, else a shared no-op context: the check costs under a
    microsecond, where an unguarded `record_function` costs over ten even
    with no profiler on. The span is a host event of the same trace as the
    card's kernels, so the device time and idle time under it can be read
    from that trace."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(f"tepose:{name}")
    return _NO_SPAN


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


def profile_device(fn) -> dict | None:
    """One call of `fn` under `torch.profiler` (CPU and CUDA activities).

    Returns its span on the profiler's clock (first to last event), the
    device's busy time (the union of device-event intervals, user
    annotations left out), the idle share 1 - busy / span, the number of
    kernels (device events that are not copies or fills), the five kernels
    that took most device time and the eight host ops with the most self
    CPU time; None if the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    kernels = [e for e in dev if not e.name.lower().startswith(
        ("memcpy", "memset"))]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span, "kernels": len(kernels),
            "top_kernels_ms": [(n[:80], t / 1e3) for n, t in top],
            "top_host_ops_ms": [(a.key[:60], a.self_cpu_time_total / 1e3,
                                 a.count) for a in host[:8]]}


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
