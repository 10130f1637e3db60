"""Run one cell of BENCHMARK.json on the card this process sees.

    python -m bench_h100.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the card's clock and power beside the window, the numbers compared
with the reference beside their limits (as the last lines of standard
error), and as the last line of standard output one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and `checks` last.

    python -m bench_h100.run --workload <name> --seed <n> --seconds <s> --calibrate <k>

reads the comparison's numbers on k seeds from `--seed` on, in one process,
for the program and for the control (the reference in TF32), one JSON line
a seed: the readings the limits are set from.

Exits 3 without a result where no CUDA card is visible, and 4 where the
run loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from bench_h100.harness import REPO  # noqa: E402

# every build and kernel cache of the run at fixed paths in the checkout
CACHE = REPO / "build" / "bench_h100_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(CACHE / sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=int, default=0)
    return p.parse_args(argv)


def card_or_exit(chips: int):
    import torch

    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"bench_h100: needs {chips} CUDA card(s); torch sees {seen}",
              file=sys.stderr)
        raise SystemExit(3)
    return torch.device("cuda", 0)


def print_result(result: dict) -> None:
    if result.get("clock"):
        print("clock " + json.dumps(result["clock"]), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> None:
    from bench_h100 import harness

    args = parse(argv)
    spec = harness.cell_spec(args.workload)
    device = card_or_exit(spec["cell"]["chips"])
    if args.calibrate:
        from bench_h100.calibrate import calibrate

        calibrate(spec, args.seed, args.calibrate, args.seconds, device)
        return
    print_result(harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), device, T_START, spec))


if __name__ == "__main__":
    main()
