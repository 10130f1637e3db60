#!/usr/bin/env python3
"""Measure the LBS skinning kernel on one CUDA card.

  python tools/lbs_kernel_bench.py [--ptxas] [--shapes] [--baseline-cu PATH]

Always: checks the kernel against its plain version at V = 6890 for every
batch size in --batches (the main path's launch sizes) and prints its
device time per launch at the launch shape `_launch_config` picks, its
bound and share of bound, and the card's name and power limit.

  --ptxas            print `nvcc -Xptxas -v` for csrc/lbs_skinning.cu:
                     registers, shared memory and spills of each
                     instantiation.
  --shapes           for each batch size, time other launch shapes (each
                     variant, block size and a few group counts) beside the
                     one `_launch_config` picks: the check of its rule.
  --baseline-cu PATH build an earlier kernel source whose C entry is
                     tepose_lbs_skin_f32(wT, A, v, out, B, V, J, stream),
                     for example the first port's, written by
                       git show dac4449:tepose_tpu_torch/csrc/lbs_skinning.cu
                     under build/, and time it in turns with the current
                     kernel (baseline/current/current/baseline).

Device times use tools/kernel_timing.py's `device_ms` (a sleep kernel
queued ahead of the timed launches). Each result is also appended as a
JSON line to --out (default build/lbs_kernel_bench.jsonl).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tools")]

from kernel_timing import device_ms, lbs_bound, lbs_inputs  # noqa: E402
from tepose_tpu_torch import kernels  # noqa: E402
from tepose_tpu_torch.ops import lbs_skinning as LS  # noqa: E402

V = 6890


def emit(record: dict, out: str) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def nvcc(source: str, out: str, *extra: str) -> subprocess.CompletedProcess:
    cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, *extra, "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    return proc


def baseline_launcher(path: str):
    """Build `path` into a library and return fn(wT, A, v, out)."""
    so = str(kernels.BUILD_DIR / "liblbs_baseline.so")
    nvcc(path, so)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tepose_lbs_skin_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.tepose_lbs_skin_f32.restype = i

    def launch(wT, A, v, out):
        err = lib.tepose_lbs_skin_f32(
            p(wT.data_ptr()), p(A.data_ptr()), p(v.data_ptr()),
            p(out.data_ptr()), v.shape[0], wT.shape[1], wT.shape[0],
            p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"baseline launch failed ({err})")

    return launch


def other_shapes(B: int, J: int, picked: LS.LaunchConfig):
    """Launch shapes besides `picked`: each variant the joint count takes,
    each block size it takes, and the group count that fills one wave with
    three quarters, half and twice that."""
    sms = LS._num_sms(torch.device("cuda"))
    for vpt, most in LS.THREADS.items():
        if vpt == 4 and J != 24:
            continue
        for threads in range(32, most + 1, 32):
            tiles = -(-V // (threads * vpt))
            wave = LS.BLOCKS_PER_SM * sms // tiles
            for g in sorted({wave, 3 * wave // 4, wave // 2, 2 * wave}):
                cfg = LS.LaunchConfig(threads, vpt, tiles, max(1, min(B, g)))
                if cfg != picked:
                    yield cfg


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--batches", default="1,8,32,48,160,192,256")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--baseline-cu")
    ap.add_argument("--out", default=str(kernels.BUILD_DIR.parent
                                         / "lbs_kernel_bench.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lbs_kernel_bench: needs a CUDA card")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out_file = args.out
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda}, out_file)
    kernels.build_all()
    if args.ptxas:
        proc = nvcc(str(kernels.CSRC_DIR / "lbs_skinning.cu"),
                    str(kernels.BUILD_DIR / "ptxas_report.cubin"),
                    "-Xptxas=-v", "-cubin")
        emit({"ptxas": proc.stderr.strip().splitlines()}, out_file)
    baseline = baseline_launcher(args.baseline_cu) if args.baseline_cu \
        else None

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    for B in (int(b) for b in args.batches.split(",")):
        wT, A, v = lbs_inputs(rs, B, V, dev)
        J = wT.shape[0]
        ref = LS.lbs_skinning_reference(wT, A, v)
        bound_ms, bound_by = lbs_bound(B, V, J)
        out = torch.empty_like(v)
        picked = LS._launch_config(B, V, J, LS._num_sms(dev))

        def checked(launch, name):
            out.fill_(float("nan"))
            launch()
            err = (out - ref).abs().max().item()
            if not err <= 1e-5:
                raise RuntimeError(f"B={B} {name}: max abs err {err}")
            return err

        def kernel(cfg=picked):
            return lambda: LS._launch(wT, A, v, out, cfg)

        err = checked(kernel(), picked)
        t = {"current": []}
        if baseline is not None:
            old = lambda: baseline(wT, A, v, out)  # noqa: E731
            checked(old, "baseline")
            t["baseline"] = []
            for name in ("baseline", "current", "current", "baseline"):
                t[name] += device_ms(old if name == "baseline" else kernel())
        else:
            t["current"] = device_ms(kernel())
        ms = float(np.median(t["current"]))
        rec = {"B": B, "V": V, "device_ms": ms, "max_abs_err": err,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "share_of_bound": bound_ms / ms, "config": vars(picked),
               "card": card}
        if baseline is not None:
            old_ms = float(np.median(t["baseline"]))
            rec.update(baseline_ms=old_ms,
                       baseline_share_of_bound=bound_ms / old_ms,
                       turns_ms={k: [float(np.median(x[:len(x) // 2])),
                                     float(np.median(x[len(x) // 2:]))]
                                 for k, x in t.items()})
        emit(rec, out_file)

        if args.shapes:
            times = [(ms, picked)]
            for cfg in other_shapes(B, J, picked):
                checked(kernel(cfg), cfg)
                times.append((float(np.median(device_ms(kernel(cfg),
                                                        reps=7))), cfg))
            # the best few again, in turns with the picked shape
            best = sorted(times, key=lambda x: x[0])[:3]
            again = {c: [] for _, c in best} | {picked: []}
            for _ in range(2):
                for c in again:
                    again[c] += device_ms(kernel(c), reps=7)
            emit({"shapes_B": B, "picked": vars(picked),
                  "picked_ms": float(np.median(again[picked])),
                  "best_again": [(float(np.median(x)), vars(c))
                                 for c, x in again.items()],
                  "all": [(m, vars(c)) for m, c in times], "card": card},
                 out_file)


if __name__ == "__main__":
    main()
