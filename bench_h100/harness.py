"""One run of one cell: set-up, warm-up, the measured window or a traced
slice, then the comparison with the reference.

The cell is found by name: its entry in `BENCHMARK.json`, its
configuration `configs/<config>.json`, its traffic `traffic/<traffic>.json`
(which names the driver, `drivers/<driver>.py`), its limits
`limits/<workload>.json`, and, in a traced run, one reader
`metrics/<metric>.py` for each per-layer metric that lists the cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tepose_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, bench: Optional[dict] = None) -> dict:
    """Everything the run of `workload` reads, found by name. A cell of
    `parked.json` (measured, but not in BENCHMARK.json: see PERF.md) runs
    the same way."""
    bench = bench or load_json(REPO / "BENCHMARK.json")
    parked = load_json(HERE / "parked.json")
    cells = {w["name"]: w for w in bench["workloads"] + parked["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"and parked.json have {sorted(cells)}")
    cell = cells[workload]
    limits_path = HERE / "limits" / f"{workload}.json"

    def listed(m):
        return workload in m.get("workloads", [workload])

    return {
        "cell": cell,
        "config": load_json(HERE / "configs" / f"{cell['config']}.json"),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(limits_path) if limits_path.is_file() else {},
        "end_to_end": [m for m in bench["end_to_end"] + parked["end_to_end"]
                       if listed(m)],
        "per_layer": [m for m in bench["per_layer"] + parked["per_layer"]
                      if listed(m)],
    }


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (`tepose_tpu_torch` is not `tepose_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def reader(metric: str):
    """The `read(trace, info)` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_h100.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Clock:
    """`nvidia-smi` sampling the SM clock and power every 200 ms in a
    process of its own, read by a thread; both end in `stop`."""

    QUERY = "clocks.sm,power.draw,power.limit"

    def __init__(self):
        self.samples: List[tuple] = []     # (time, sm MHz, W, limit W)
        self.proc = None
        self.thread = None

    def start(self) -> "Clock":
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-i", "0", "-lms", "200"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        return self

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                sm, pw, lim = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), sm, pw, lim))

    def settled(self, span_s: float = 1.0, tol_mhz: float = 30.0) -> bool:
        """The SM clock kept within `tol_mhz` over the last `span_s`; true
        where there is no sampler."""
        if self.proc is None:
            return True
        now = time.perf_counter()
        last = [s[1] for s in self.samples if s[0] >= now - span_s]
        return len(last) >= 4 and max(last) - min(last) <= tol_mhz

    def summary(self, t0: float, t1: float) -> Optional[dict]:
        inside = [s for s in self.samples if t0 <= s[0] <= t1]
        if not inside:
            return None
        sm = [s[1] for s in inside]
        return {"sm_mhz_min": min(sm), "sm_mhz_median": statistics.median(sm),
                "sm_mhz_max": max(sm),
                "power_w_median": statistics.median(s[2] for s in inside),
                "power_limit_w": inside[-1][3], "samples": len(inside)}

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait()
            self.thread.join(timeout=5)


def driver(traffic: dict):
    return importlib.import_module(f"bench_h100.drivers.{traffic['driver']}")


def warm_up(cell, traffic: dict, clock: Clock) -> int:
    """The cell's own traffic until it has run `warm_units` units and
    `warm_seconds`, and the SM clock has settled (at most
    `warm_max_seconds`)."""
    t0 = time.perf_counter()
    n = 0
    while True:
        cell.warm_unit()
        n += 1
        el = time.perf_counter() - t0
        if (n >= traffic["warm_units"] and el >= traffic["warm_seconds"]
                and (clock.settled() or el >= traffic["warm_max_seconds"])):
            return n


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, spec: Optional[dict] = None) -> dict:
    """One run; returns the result line's object, the checks last."""
    import torch

    from bench_h100.compare import gaps, within
    from bench_h100.reference.model import Reference
    from bench_h100.trace import profiled

    spec = spec or cell_spec(workload)
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = Clock().start() if cuda else Clock()
    try:
        cell = driver(spec["traffic"]).Cell(spec["config"], spec["traffic"],
                                            seed, device)
        t_built = time.perf_counter()
        units = warm_up(cell, spec["traffic"], clock)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        print(f"set-up: {t_built - t_start:.3f} s to build, {t0 - t_built:.3f}"
              f" s of warm-up ({units} units)", file=sys.stderr)
        setup_s = t0 - t_start
        if trace:
            info, tr = profiled(cell.traced_slice, cuda)
            metrics = {}
            for m in spec["per_layer"]:
                v = reader(m["name"])(tr, info)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            attempted, failed = info["units"], 0
        else:
            stats = cell.window(seconds)
            metrics = {m["name"]: {"value": stats["metrics"][m["name"]],
                                   "unit": m["unit"]}
                       for m in spec["end_to_end"] if m["name"] != "setup_s"}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            attempted, failed = stats["attempted"], stats["failed"]
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        clock_line = clock.summary(t0, t1)
    finally:
        clock.stop()

    found = loaded_forbidden()
    if found:
        print(f"bench_h100: the run loaded {found}", file=sys.stderr)
        raise SystemExit(4)

    cell.free_program()
    if cuda:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    values = gaps(cell.judged(), cell.reference_outputs(Reference()))
    print(f"window {t1 - t0:.3f} s; reference {time.perf_counter() - t2:.3f}"
          " s", file=sys.stderr)
    limits = spec["limits"]
    result = {
        "correct": within(values, limits), "attempted": attempted,
        "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak},
    }
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.span_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["clock"] = clock_line
    result["checks"] = {k: {"value": v,
                            "limit": limits.get(k, {}).get("limit")}
                        for k, v in values.items()}
    return result
