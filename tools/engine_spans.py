"""Where an engine cell's time goes, span by span, on the card.

Builds a cell of BENCHMARK.json (`tepose-engine-crops` unless
`--workload` names another, such as `hmr2-engine-crops`) as
`bench_h100.run` does, warms it up, times its traced slice untraced, then
traces it again and prints one JSON object: the slice, busy and idle
seconds; for each `tepose:<name>` span its count, host seconds, the
card's idle seconds inside it, the device seconds launched under it, as
`bench_h100/spans.py` reads them, and the kernels that make them up;
`fast_scan.GRAPH_STATS`, `hmr2.HMR2_STATS`, `engine.STAGING_STATS` and
the ViT kernel's launches over the traced calls; the top device ops and
the longest gaps. From the repository root, on a machine with a card:

    python3 tools/engine_spans.py [seed] [--workload NAME]

To compare commits on one card, run it from a checkout of each in turns.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

from bench_h100 import harness, spans  # noqa: E402
from bench_h100.trace import profiled  # noqa: E402
from tepose_tpu_torch.models import hmr2  # noqa: E402
from tepose_tpu_torch.ops import vit_linear  # noqa: E402
from tepose_tpu_torch.streaming import engine, fast_scan  # noqa: E402

WORKLOAD = "tepose-engine-crops"


def kernels_under(trace, name: str, n: int = 6) -> list:
    """The `n` kernels with the most device seconds launched under the
    outermost `name` spans, as `spans.device_s_under` walks them."""
    by_name = {}
    stack = spans.outermost(trace, [name])
    while stack:
        x = stack.pop()
        if x.name not in spans.OVERHEAD:
            for k in x.kernels:
                by_name[k.name] = by_name.get(k.name, 0.0) + k.duration / 1e6
        stack.extend(x.cpu_children)
    return [[k[:64], v] for k, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def counters() -> dict:
    return {**{f"graph.{k}": v for k, v in fast_scan.GRAPH_STATS.items()},
            **{f"hmr2.{k}": v for k, v in hmr2.HMR2_STATS.items()},
            **{f"staging.{k}": v for k, v in engine.STAGING_STATS.items()},
            "vit_linear.launches": vit_linear.LAUNCHES}


def main(seed: int, workload: str = WORKLOAD) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.cell_spec(workload)
    clock = harness.Clock().start()
    try:
        cell = harness.driver(spec["traffic"]).Cell(
            spec["config"], spec["traffic"], seed, "cuda")
        harness.warm_up(cell, spec["traffic"], clock)
    finally:
        clock.stop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cell.traced_slice()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    before = counters()
    _, tr = profiled(cell.traced_slice, True)
    after = counters()
    busy = tr.busy_intervals()
    rows = {}
    for name in sorted({h.name for h in tr.host
                        if h.name.startswith("tepose:")}):
        iv = spans.intervals(tr, [name])
        rows[name] = {"count": len(spans.outermost(tr, [name])),
                      "host_s": sum(e - s for s, e in iv),
                      "idle_s": spans.idle_inside_s(iv, busy),
                      "device_s": spans.device_s_under(tr, [name]),
                      "kernels": kernels_under(tr, name)}
    below_run = [n for n in rows if n != "tepose:engine.run"]
    return {
        "card": torch.cuda.get_device_name(0), "untraced_2_calls_s": untraced,
        "slice_s": tr.span_s, "busy_s": tr.busy_s,
        "idle_s": tr.span_s - tr.busy_s,
        "idle_inside_spans_below_run": spans.idle_inside_s(
            spans.intervals(tr, below_run), busy),
        "device_events": len(tr.device), "kernels": len(tr.kernels),
        "counters": {k: after[k] - before[k] for k in before},
        "spans": rows, "top_ops": tr.top_ops(8), "gaps": tr.idle_gaps(5)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("seed", type=int, nargs="?", default=3000001801)
    parser.add_argument("--workload", default=WORKLOAD)
    args = parser.parse_args()
    print(json.dumps(main(args.seed, args.workload)))
