"""The readings that a cell's correctness limits are set from.

For each of k seeds, in one process: the cell's set-up, one warm-up unit,
a window of `seconds`, then the comparison's numbers twice, for the program
against the reference, and for the control (the reference computed in
TF32, the next precision below the configuration's float32) against the
reference on the same inputs. One JSON line a seed.
"""

from __future__ import annotations

import json

import torch

from bench_h100 import harness
from bench_h100.compare import gaps
from bench_h100.reference.model import Reference


def calibrate(spec: dict, seed: int, n: int, seconds: float, device) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for s in range(seed, seed + n):
        cell = harness.driver(spec["traffic"]).Cell(
            spec["config"], spec["traffic"], s, device)
        cell.warm_unit()
        stats = cell.window(seconds)
        cell.free_program()
        ref = cell.reference_outputs(Reference())
        line = {"seed": s, "program": gaps(cell.judged(), ref),
                "control": gaps(cell.reference_outputs(Reference(tf32=True)),
                                ref),
                "metrics": stats["metrics"]}
        print(json.dumps(line), flush=True)
        del cell, ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
