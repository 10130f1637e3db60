"""Every cell end to end at tiny widths on the CPU: the result line has the
contract's shape, the program agrees with the reference within the cell's
limits, and the control (the reference in TF32) does not."""

from __future__ import annotations

import json
import math

import pytest
import torch

from bench_h100 import harness
from bench_h100.compare import gaps, within
from bench_h100.reference.model import Reference
from bench_h100.tests import tiny

_two_threads = pytest.fixture(scope="module", autouse=True)(tiny.two_threads)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


@pytest.mark.parametrize("workload", tiny.CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(workload, trace, capsys):
    from bench_h100.run import print_result

    result = tiny.run(workload, trace)
    print_result(result)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in last
    assert last["correct"] is True, last["checks"]
    assert last["attempted"] >= 1 and last["failed"] == 0
    spec = harness.cell_spec(workload)
    if trace:
        names = {m["name"] for m in spec["per_layer"]}
        assert set(last["metrics"]) <= names
        assert _finite(last["device"]["window_s"])
        assert len(last["breakdown"]["device_ops"]) <= 10
    else:
        names = {m["name"] for m in spec["end_to_end"]}
        assert set(last["metrics"]) == names
    for name, m in last["metrics"].items():
        assert _finite(m["value"]) and m["value"] > 0, name


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_control_is_caught(workload):
    """The reference computed in TF32 (the next precision below the
    configuration's float32), judged as the program is, fails a limit."""
    spec = tiny.spec(workload)
    cell = harness.driver(spec["traffic"]).Cell(
        spec["config"], spec["traffic"], 2**31 + 5, "cpu")
    cell.warm_unit()
    cell.window(tiny.SECONDS.get(workload, 0.3))
    cell.free_program()
    ref = cell.reference_outputs(Reference())
    program = gaps(cell.judged(), ref)
    control = gaps(cell.reference_outputs(Reference(tf32=True)), ref)
    assert within(program, spec["limits"]), program
    assert not within(control, spec["limits"]), control


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0 - 2**-12])
    from bench_h100.reference.model import round_tf32

    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0]
