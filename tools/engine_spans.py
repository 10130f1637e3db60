"""Where the engine cell's time goes, span by span, on the card.

Builds `tepose-engine-crops` from BENCHMARK.json as `bench_h100.run`
does, warms it up, times 2 calls untraced, then traces 2 more and prints
one JSON object: the slice, busy and idle seconds; for each
`tepose:<name>` span (and `tepose::replay_window_graph`, the window
scan's graph replays) its count, host seconds, the card's idle seconds
inside it and the device seconds launched under it, as
`bench_h100/spans.py` reads them; `fast_scan.GRAPH_STATS` over the traced
calls; the top device ops and the longest gaps. From the repository
root, on a machine with a card:

    python3 tools/engine_spans.py [seed]

To compare commits on one card, run it from a checkout of each in turns.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

from bench_h100 import harness, spans  # noqa: E402
from bench_h100.trace import profiled  # noqa: E402
from tepose_tpu_torch.streaming import fast_scan  # noqa: E402

WORKLOAD = "tepose-engine-crops"


def main(seed: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.cell_spec(WORKLOAD)
    clock = harness.Clock().start()
    try:
        cell = harness.driver(spec["traffic"]).Cell(
            spec["config"], spec["traffic"], seed, "cuda")
        harness.warm_up(cell, spec["traffic"], clock)
    finally:
        clock.stop()
    stats = getattr(fast_scan, "GRAPH_STATS", {})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cell.traced_slice()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    before = dict(stats)
    _, tr = profiled(cell.traced_slice, True)
    busy = tr.busy_intervals()
    rows = {}
    for name in sorted({h.name for h in tr.host
                        if h.name.startswith("tepose:")}):
        iv = spans.intervals(tr, [name])
        rows[name] = {"count": len(spans.outermost(tr, [name])),
                      "host_s": sum(e - s for s, e in iv),
                      "idle_s": spans.idle_inside_s(iv, busy),
                      "device_s": spans.device_s_under(tr, [name])}
    below_run = [n for n in rows if n != "tepose:engine.run"]
    return {
        "card": torch.cuda.get_device_name(0), "untraced_2_calls_s": untraced,
        "slice_s": tr.span_s, "busy_s": tr.busy_s,
        "idle_s": tr.span_s - tr.busy_s,
        "idle_inside_spans_below_run": spans.idle_inside_s(
            spans.intervals(tr, below_run), busy),
        "device_events": len(tr.device), "kernels": len(tr.kernels),
        "graph_stats": {k: stats[k] - before[k] for k in before},
        "spans": rows, "top_ops": tr.top_ops(8), "gaps": tr.idle_gaps(5)}


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1
                          else 3000001801)))
