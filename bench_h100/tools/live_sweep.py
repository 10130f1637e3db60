"""The sweep that fixed the live cell's stream count.

    python -m bench_h100.tools.live_sweep --seed <n> --seconds <s> [--streams 1,2,4,...]

For each stream count K, in one process: the live cell's set-up and
warm-up at K streams, then one window of `seconds`; prints one JSON line a
K with the tick latency's p50 and p95 and the mean latency of the window's
first and last quarter (a backlog that grows shows as a last quarter far
above the first). The cell takes the largest K whose p95 stays under one
tick (33.3 ms at 30 fps) with no growing backlog, then the grid value at
or below four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from bench_h100 import harness

GRID = "1,2,4,8,16,24,32,48,64"


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--streams", default=GRID)
    p.add_argument("--workload", default="tepose-live-crops")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("live_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.cell_spec(args.workload)
    clock = harness.Clock().start()
    try:
        for K in (int(k) for k in args.streams.split(",")):
            traffic = dict(spec["traffic"], streams=K)
            cell = harness.driver(traffic).Cell(spec["config"], traffic,
                                                args.seed, "cuda")
            harness.warm_up(cell, traffic, clock)
            t0 = time.perf_counter()
            stats = cell.window(args.seconds)
            lat = [1e3 * (end - due) for due, _, end in cell.times]
            q = max(1, len(lat) // 4)
            print(json.dumps({
                "streams": K, **stats["metrics"],
                "first_quarter_ms": sum(lat[:q]) / q,
                "last_quarter_ms": sum(lat[-q:]) / q,
                "clock": clock.summary(t0, time.perf_counter())}),
                flush=True)
            del cell
            torch.cuda.empty_cache()
    finally:
        clock.stop()


if __name__ == "__main__":
    main()
