"""On the card: each cell's comparison at its own size, the program within
its limits and the control (the reference in TF32) outside them, on three
seeds in one process; and one short run of each cell through the command.

    python -m pytest bench_h100/tests/test_bench_card.py -m requires_cuda

Skips where torch sees no CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100 import harness

REPO = Path(__file__).resolve().parents[2]
CELLS = ["tepose-engine-crops", "vibe-demo-crops", "tepose-eval-3dpw",
         "tepose-live-crops"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes_at_full_size(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "bench_h100.run", "--workload", workload,
         "--seed", str(2**31 + 301), "--seconds", "2", "--calibrate", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = harness.cell_spec(workload)["limits"]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 3
    for line in lines:
        assert all(v <= limits[k]["limit"]
                   for k, v in line["program"].items()), line
        assert any(v > limits[k]["limit"]
                   for k, v in line["control"].items()), line


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_command_run_is_correct(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "bench_h100.run", "--workload", workload,
         "--seed", str(2**31 + 401), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
