"""The readings of the program's spans (`bench_h100/spans.py`): the interval
arithmetic on hand-built slices, the readers on traced tiny cells on the
CPU (every span they read is there; with no device events they read
nothing), and on the card each shipped cell's traced run with every
per-layer metric it lists."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_h100 import harness, spans
from bench_h100.trace import Trace, profiled
from bench_h100.tests import tiny

_two_threads = pytest.fixture(scope="module", autouse=True)(tiny.two_threads)

REPO = Path(__file__).resolve().parents[2]
READERS = {"tepose-engine-crops": ["host_copy_idle_share.engine",
                                   "scan_idle_share.engine",
                                   "scan_roofline.engine"],
           "vibe-demo-crops": ["temporal_roofline.vibe"]}


def _event(name, start_s, end_s, parent=None, kernels=()):
    """A host event as the profiler gives it: times in us, its kernels as
    (name, device, duration in us)."""
    e = SimpleNamespace(
        name=name, cpu_parent=parent, cpu_children=[],
        time_range=SimpleNamespace(start=start_s * 1e6, end=end_s * 1e6),
        kernels=[SimpleNamespace(name=k, device=0, duration=d * 1e6)
                 for k, d in kernels])
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def _trace(host, busy, span_s=10.0, start_s=100.0):
    device = [(f"k{i}", s, e) for i, (s, e) in enumerate(busy)]
    return Trace(span_s=span_s, device=device, host=host, start_s=start_s)


def test_union_and_overlap():
    assert spans.union([(3, 4), (0, 2), (1, 2.5), (2.5, 3)]) == [(0, 4)]
    assert spans.union([(5, 6), (0, 1)]) == [(0, 1), (5, 6)]
    a, b = [(0, 2), (4, 8)], [(1, 5), (6, 7), (7.5, 9)]
    assert spans.overlap_s(a, b) == pytest.approx(1 + 1 + 1 + 0.5)
    assert spans.overlap_s(b, a) == pytest.approx(3.5)
    assert spans.idle_inside_s(a, b) == pytest.approx(6 - 3.5)


def test_overlapping_spans_count_once():
    """Two spans of the read names overlapping in [2, 3]: their union is
    [1, 4]; the card is busy in [0, 1.5] and [3.5, 5], so 2 s of it are
    idle, a fifth of the 10 s slice."""
    host = [_event("tepose:a", 101, 103), _event("tepose:b", 102, 104),
            _event("tepose:c", 104, 110)]
    tr = _trace(host, [(0, 1.5), (3.5, 5)])
    assert spans.intervals(tr, {"tepose:a", "tepose:b"}) == [(1, 4)]
    assert spans.idle_share(tr, {"tepose:a", "tepose:b"}) == pytest.approx(20)


def test_span_crossing_a_busy_edge():
    """A span [2, 6] over busy [0, 3] and [5, 9]: idle only in [3, 5]."""
    tr = _trace([_event("tepose:a", 102, 106)], [(0, 3), (5, 9)])
    assert spans.idle_share(tr, ["tepose:a"]) == pytest.approx(20)


def test_nested_span_with_its_parents_name():
    """A nested call's span inside one of the same name adds no interval
    and no device time twice; a child op's kernels and the span's own
    (a launch from outside any op) count once, and the copies a profiler's
    overhead event holds not at all."""
    outer = _event("tepose:run", 101, 107, kernels=[("k2", 0.25)])
    op = _event("aten::mm", 101.5, 102, outer, kernels=[("k0", 0.25)])
    _event("Command Buffer Full", 101.6, 101.8, op, kernels=[("k0", 0.25)])
    inner = _event("tepose:run", 103, 106, outer)
    mm = _event("aten::mm", 103, 104, inner, kernels=[("k1", 1.0)])
    tr = _trace([outer, op, op.cpu_children[0], inner, mm],
                [(1.5, 2), (3, 4)])
    assert spans.outermost(tr, ["tepose:run"]) == [outer]
    assert spans.intervals(tr, ["tepose:run"]) == [(1, 7)]
    assert spans.idle_share(tr, ["tepose:run"]) == pytest.approx(45)
    assert spans.device_s_under(tr, ["tepose:run"]) == pytest.approx(1.5)
    assert spans.roofline(tr, ["tepose:run"], 0.75 * spans.PEAK_FLOPS) == (
        pytest.approx(50))


def test_nothing_to_read():
    tr = _trace([_event("tepose:a", 101, 102)], [])
    assert spans.idle_share(tr, ["tepose:a"]) is None
    tr = _trace([_event("aten::mm", 101, 102)], [(0, 1)])
    assert spans.idle_share(tr, ["tepose:a"]) is None
    assert spans.roofline(tr, ["tepose:a"], 1.0) is None


@pytest.mark.parametrize("workload", sorted(READERS))
def test_readers_on_a_traced_tiny_cell(workload):
    """On the CPU the slice holds every span a reader reads and no device
    event, so each reader returns None."""
    spec = tiny.spec(workload)
    cell = harness.driver(spec["traffic"]).Cell(
        spec["config"], spec["traffic"], 2**31 + 23, "cpu")
    cell.warm_unit()
    info, tr = profiled(cell.traced_slice, cuda=False)
    assert not tr.device
    for name in READERS[workload]:
        read = harness.reader(name)
        for span in read.__globals__["SPANS"]:
            assert spans.outermost(tr, [span]), (name, span)
        assert read(tr, info) is None, name


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", sorted(READERS))
def test_traced_run_reports_every_metric(card, workload):
    """A traced run of the cell at full size reports every per-layer metric
    that lists it, finite and above 0, and no span as a device op."""
    out = subprocess.run(
        [sys.executable, "-m", "bench_h100.run", "--workload", workload,
         "--seed", str(2**31 + 503), "--seconds", "3", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    want = {m["name"] for m in harness.cell_spec(workload)["per_layer"]}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        assert math.isfinite(m["value"]) and m["value"] > 0, name
    assert not any(op.startswith("tepose:")
                   for op, _ in line["breakdown"]["device_ops"])
