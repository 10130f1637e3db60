"""The benchmark's cells at tiny widths, for the CPU tests: narrow GRUs,
64 x 64 crops, a few short tracklets, videos and ticks. Every other key is
the cell's own."""

from __future__ import annotations

import time

import torch

from bench_h100 import harness

CONFIG = {"hidden_size": 16}
TRAFFIC = {
    "tepose-engine-crops": {"lengths": [9, 7, 12], "crop_size": 64,
                            "max_frames_per_call": 64, "window_bucket": 16,
                            "check_tracklets": 2, "trace_calls": 1},
    "vibe-demo-crops": {"frames": 12, "crop_size": 64, "trace_calls": 1},
    "tepose-eval-3dpw": {"lengths": [30, 12, 7, 25, 9], "max_batch": 3,
                         "warm_windows": 3, "check_videos": 3},
    "tepose-live-crops": {"streams": 3, "crop_size": 64, "pool": 8,
                          "reset_mean_frames": 6, "fps": 10,
                          "check_ticks": 5, "trace_ticks": 12},
}
SECONDS = {"tepose-live-crops": 2.0}
CELLS = sorted(TRAFFIC)


def spec(workload: str) -> dict:
    s = harness.cell_spec(workload)
    s["config"] = dict(s["config"], **CONFIG,
                       vibe=dict(s["config"]["vibe"], **CONFIG))
    s["traffic"] = dict(s["traffic"], **TRAFFIC[workload], warm_units=1,
                        warm_seconds=0, warm_max_seconds=0)
    return s


def run(workload: str, trace: bool = False, seed: int = 2**31 + 11) -> dict:
    """One run of the tiny cell on the CPU; the result line's object."""
    return harness.run(workload, seed, SECONDS.get(workload, 0.3), trace,
                       "cpu", time.perf_counter(), spec(workload))


def two_threads():
    """Torch on two threads for a module's tests, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
