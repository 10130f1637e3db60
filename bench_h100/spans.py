"""What the per-layer metrics read from the program's own spans in a traced
slice.

The program marks its layers with `tepose:<name>` host events
(`tepose_tpu_torch/utils/profiling.py::span`), recorded by the same
profiler as the card's kernels, so their intervals are on the slice's
clock. A reading takes the outermost events of the names it is given (a
span nested in another of those names adds nothing), and either the card's
idle time inside the union of their intervals, or, as
`Trace.device_s_under` does, the device time of the kernels launched under
them (without the copies the profiler's overhead events hold).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from bench_h100.flops import PEAK_FLOPS

Interval = Tuple[float, float]

# CUPTI's overhead records, which the profiler lists as host events: one
# such event can hold copies of kernels that an op or a span launched. In a
# traced slice of the engine cell on an H100, the "Command Buffer Full"
# events (the host waiting for room in the launch queue) held 1.06 s of
# copies against 2.26 s of device time.
OVERHEAD = frozenset((
    "Activity Buffer Request", "Buffer Flush", "Command Buffer Full",
    "Driver Compiler", "Instrumentation", "Lazy Function Loading",
    "Resource", "Runtime Triggered Module Loading"))


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of the intervals, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_s(a: List[Interval], b: List[Interval]) -> float:
    """Length of the intersection of two unions (each in order, disjoint)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_s(spans: List[Interval], busy: List[Interval]) -> float:
    """The time inside the union `spans` not covered by the union `busy`."""
    return sum(e - s for s, e in spans) - overlap_s(spans, busy)


def _under(e, names) -> bool:
    p = e.cpu_parent
    while p is not None:
        if p.name in names:
            return True
        p = p.cpu_parent
    return False


def outermost(trace, names) -> list:
    """The host events called one of `names` under none of `names`."""
    names = set(names)
    return [e for e in trace.host if e.name in names and not _under(e, names)]


def intervals(trace, names) -> List[Interval]:
    """The union of the outermost `names` events' intervals, in seconds
    from the slice's start, as `Trace.busy_intervals` gives the card's."""
    return union((e.time_range.start / 1e6 - trace.start_s,
                  e.time_range.end / 1e6 - trace.start_s)
                 for e in outermost(trace, names))


def idle_share(trace, names) -> Optional[float]:
    """The card's idle time inside the spans `names`, over the slice's
    span, in %; None without device events or without such a span."""
    spans = intervals(trace, names)
    if not trace.device or not spans:
        return None
    return 100.0 * idle_inside_s(spans, trace.busy_intervals()) / trace.span_s


def device_s_under(trace, names) -> float:
    """Device time of the kernels and copies launched under the outermost
    `names` events and everything they called, the profiler's overhead
    events left out."""
    total = 0.0
    stack = outermost(trace, names)
    while stack:
        x = stack.pop()
        if x.name not in OVERHEAD:
            total += sum(k.duration for k in x.kernels) / 1e6
        stack.extend(x.cpu_children)
    return total


def roofline(trace, names, flops: float) -> Optional[float]:
    """`flops` over the device time under the spans `names` times the
    dense TF32 peak, in %; None where no device time falls under them."""
    t = device_s_under(trace, names)
    if t <= 0.0:
        return None
    return 100.0 * flops / (t * PEAK_FLOPS)
