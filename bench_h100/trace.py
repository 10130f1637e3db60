"""What the per-layer metrics read from a traced slice.

`profiled(fn)` runs `fn` under `torch.profiler` (host ops and the card's
kernels and copies, through CUPTI) and reduces the events in memory: the
device intervals and their union (the busy time, as
`tepose_tpu_torch/utils/profiling.py::profile_device` computes it), the
slice's span on the profiler's clock, the kernels by name, and the device
time of the kernels launched under a named host op. Nothing is written to
disk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

COPY_PREFIXES = ("memcpy", "memset")


@dataclasses.dataclass
class Trace:
    """One traced slice. Times are seconds on the profiler's clock."""
    span_s: float
    device: List[Tuple[str, float, float]]      # (name, start, end)
    host: list                                  # the profiler's CPU events
    start_s: float

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [d for d in self.device
                if not d[0].lower().startswith(COPY_PREFIXES)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, in order."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_s_under(self, op_name: str) -> float:
        """Device time of the kernels launched under the outermost host
        ops called `op_name` and everything they called."""
        total = 0.0
        for e in self.host:
            if e.name != op_name or _has_ancestor(e, op_name):
                continue
            stack = [e]
            while stack:
                x = stack.pop()
                total += sum(k.duration for k in x.kernels) / 1e6
                stack.extend(x.cpu_children)
        return total

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        return [[k[:64], v] for k, v in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between busy intervals, each named by the
        innermost host op that was running at its middle."""
        busy = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                       for a, b in zip(busy, busy[1:])), reverse=True)[:n]
        starts = np.array([e.time_range.start for e in self.host]) / 1e6
        ends = np.array([e.time_range.end for e in self.host]) / 1e6
        starts, ends = starts - self.start_s, ends - self.start_s
        out = []
        for length, mid in gaps:
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = (self.host[inside[np.argmin(ends[inside]
                                               - starts[inside])]].name
                    if len(inside) else "host_outside_any_aten_op")
            out.append([name[:64], length])
        return out


_CPU = torch.autograd.DeviceType.CPU


def _has_ancestor(e, name: str) -> bool:
    p = e.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def profiled(fn, cuda: bool = True):
    """(fn's result, the `Trace` of its call). With `cuda` the card's
    activity is recorded too, and synchronised before the profiler
    stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        result = fn()
        if cuda:
            torch.cuda.synchronize()
    events = list(prof.events())
    if not events:
        raise RuntimeError("the profiler recorded no events")
    t0 = min(e.time_range.start for e in events) / 1e6
    t1 = max(e.time_range.end for e in events) / 1e6
    dev_type = torch.autograd.DeviceType.CUDA
    device = [(e.name, e.time_range.start / 1e6 - t0,
               e.time_range.end / 1e6 - t0) for e in events
              if e.device_type == dev_type
              and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if e.device_type == _CPU]
    return result, Trace(span_s=t1 - t0, device=device, host=host,
                         start_s=t0)
