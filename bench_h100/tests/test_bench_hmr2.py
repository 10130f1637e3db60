"""The cell `hmr2-engine-crops` at tiny widths on the CPU, through
`harness.run`: the program agrees with the reference within the cell's
limits, the control (the reference in TF32) does not, a traced run holds
every span the cell's readers read and finite FLOP counts from the
program's counter; on the card, a traced run at full size reports all four
per-layer metrics.

    python -m pytest bench_h100/tests/test_bench_hmr2.py
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench_h100 import harness, spans
from bench_h100.compare import gaps, within
from bench_h100.reference.model import Reference
from bench_h100.tests import tiny
from bench_h100.trace import profiled

_two_threads = pytest.fixture(scope="module", autouse=True)(tiny.two_threads)

REPO = Path(__file__).resolve().parents[2]
CELL = "hmr2-engine-crops"
READERS = ("idle_share.hmr2", "mfu.hmr2", "vit_roofline.hmr2",
           "head_roofline.hmr2")


def spec() -> dict:
    """The cell with a ViT of width 64 (2 blocks of 4 heads), a decoder of
    width 64 (2 layers of 4 heads of 32), 64 x 64 crops read at columns
    8:-8, three short tracklets and small uploads."""
    s = harness.cell_spec(CELL)
    c = s["config"]
    s["config"] = dict(
        c, image_size=64, crop_margin=8,
        vit=dict(c["vit"], img_size=[64, 48], embed_dim=64, depth=2,
                 num_heads=4, head_dim=16, mlp_dim=256, tokens=12),
        head=dict(c["head"], dim=64, depth=2, heads=4, dim_head=32,
                  mlp_dim=64, context_dim=64))
    s["traffic"] = dict(s["traffic"], lengths=[5, 9, 3], crop_size=64,
                        crop_batch=4, max_frames_per_call=8,
                        check_tracklets=2, trace_calls=1, reference_block=4,
                        warm_units=1, warm_seconds=0, warm_max_seconds=0)
    return s


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(trace):
    result = harness.run(CELL, 2**31 + 13, 0.3, trace, "cpu",
                         time.perf_counter(), spec())
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    if not trace:
        assert set(result["metrics"]) == {"engine_frames_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_control_is_caught():
    s = spec()
    cell = harness.driver(s["traffic"]).Cell(s["config"], s["traffic"],
                                             2**31 + 5, "cpu")
    cell.warm_unit()
    cell.window(0.3)
    cell.free_program()
    ref = cell.reference_outputs(Reference())
    program = gaps(cell.judged(), ref)
    control = gaps(cell.reference_outputs(Reference(tf32=True)), ref)
    assert set(program) == {"verts_rel", "joints_rel", "theta_gap"}
    assert within(program, s["limits"]), program
    assert not within(control, s["limits"]), control


def test_readers_on_a_traced_tiny_cell():
    """The slice holds the spans the roofline readers read, and the FLOPs
    of the 17 crops the program counted; with no device events on the CPU
    every reader returns None."""
    s = spec()
    cell = harness.driver(s["traffic"]).Cell(s["config"], s["traffic"],
                                             2**31 + 23, "cpu")
    cell.warm_unit()
    info, tr = profiled(cell.traced_slice, cuda=False)
    assert info["crops"] == 17
    for k in ("flops", "vit_flops", "head_flops"):
        assert math.isfinite(info[k]) and info[k] > 0, k
    assert info["flops"] > info["vit_flops"] + info["head_flops"] * 0.99
    for name in READERS:
        read = harness.reader(name)
        for span in read.__globals__.get("SPANS", ()):
            assert spans.outermost(tr, [span]), (name, span)
        assert read(tr, info) is None, name


def test_full_size_flops():
    from bench_h100 import flops_hmr2 as FH

    c = harness.cell_spec(CELL)["config"]
    assert FH.tokens(c) == 192
    assert FH.vit_flops(c) == pytest.approx(248.0e9, rel=1e-3)
    assert FH.hmr2_head_flops(c) == pytest.approx(3.09e9, rel=1e-2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.requires_cuda
def test_traced_run_reports_every_metric(card):
    out = subprocess.run(
        [sys.executable, "-m", "bench_h100.run", "--workload", CELL,
         "--seed", str(2**31 + 503), "--seconds", "3", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert set(line["metrics"]) == set(READERS)
    for name, m in line["metrics"].items():
        assert math.isfinite(m["value"]) and 0 < m["value"] < 100, name
