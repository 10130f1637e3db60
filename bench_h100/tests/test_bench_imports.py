"""Nothing the benchmark runs loads JAX or the JAX package. Module names
are compared by their whole top-level name: the program,
`tepose_tpu_torch`, starts with the JAX package's name and is allowed."""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

from bench_h100 import harness

REPO = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tepose_tpu_torch_lookalike", sys)
    assert "tepose_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "tepose_tpu.models", sys)
    assert harness.loaded_forbidden() == ["tepose_tpu"]


def test_no_module_the_benchmark_runs_loads_jax():
    """In a fresh interpreter: every module of the benchmark, every metric
    reader, and one run of every cell at tiny widths."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys, json, torch
        torch.set_num_threads(2)
        import bench_h100
        for m in pkgutil.walk_packages(bench_h100.__path__, "bench_h100."):
            if ".tests" not in m.name:
                importlib.import_module(m.name)
        from bench_h100 import harness
        from bench_h100.tests import tiny
        for path in (harness.HERE / "metrics").glob("*.py"):
            harness.reader(path.stem)
        for w in tiny.CELLS:
            tiny.run(w)
        print(json.dumps(harness.loaded_forbidden()))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_refuses_without_a_card():
    """The command exits non-zero and prints no result where torch sees no
    CUDA card."""
    out = subprocess.run(
        [sys.executable, "-m", "bench_h100.run", "--workload",
         "vibe-demo-crops", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(REPO)})
    assert out.returncode != 0
    assert "correct" not in out.stdout
