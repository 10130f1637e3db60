#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (tepose_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Phases, each of which raises on failure (no phase's error is caught):
  0. require CUDA; strict float32 (TF32 off for matmuls and cuDNN); print
     the card's name and power limit as nvidia-smi reports them;
  1. build every CUDA kernel of the port from csrc/ with nvcc;
  2. LBS skinning kernel against its plain PyTorch version on the card, at
     V = 6890 with B in {1, 8, 256} and at a ragged V = 700: max abs error
     <= 1e-5, a non-contiguous input must raise, and median CUDA-event times
     of both after warm-up;
  3. the eval rollout through its entry point,
     `tepose_tpu_torch.evaluate.run_eval(--synthetic, 3dpw, full width)`,
     with the kernels' launch counts zeroed just before and read just after:
     finite metrics and at least one launch of every kernel;
  4. the full-width JAX golden (tests/golden/torch_port_eval_f32.npz, from
     tools/make_torch_port_golden.py): per-frame joints and MPVPE within
     1e-4 m, theta within 1e-3.

Before the last line it prints one JSON line with the kernels' routes,
launches, errors and times; the last line is the ok/device JSON object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

KERNEL_ATOL = 1e-5       # fp32, as tests/test_lbs_pallas.py holds the kernel
GOLDEN_J3D_ATOL = 1e-4   # 0.1 mm, the reproduction bar (BASELINE.md:64)
GOLDEN_THETA_ATOL = 1e-3


def cuda_ms(fn, launches: int = 20, reps: int = 15) -> float:
    """Median over `reps` of CUDA-event time per call across `launches`
    back-to-back calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def phase0_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return card


def phase1_build() -> float:
    from tepose_tpu_torch import kernels

    t0 = time.time()
    kernels.build_all()
    seconds = time.time() - t0
    print(f"phase 1: kernels built and loaded in {seconds:.2f} s "
          f"({kernels.BUILD_DIR})")
    return seconds


def phase2_kernel() -> dict:
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.ops.lbs_skinning import (
        lbs_skinning, lbs_skinning_reference)

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    results = {"max_abs_err": 0.0, "times": {}}
    for V, batches in ((6890, (1, 8, 256)), (700, (3,))):
        wT = synthetic_smpl_model(0, V, device=dev).lbs_weights_t
        J = wT.shape[0]
        for B in batches:
            A = rs.randn(B, J, 4, 4).astype(np.float32)
            A[:, :, 3] = [0, 0, 0, 1]
            A = torch.from_numpy(A).to(dev)
            v = torch.from_numpy(rs.randn(B, V, 3).astype(np.float32)).to(dev)
            out = lbs_skinning(wT, A, v)
            ref = lbs_skinning_reference(wT, A, v)
            torch.cuda.synchronize()
            if out.shape != (B, V, 3) or not torch.isfinite(out).all():
                raise RuntimeError(f"lbs kernel output bad at B={B} V={V}")
            err = (out - ref).abs().max().item()
            print(f"phase 2: lbs B={B} V={V} max_abs_err={err:.3e}")
            if not err <= KERNEL_ATOL:
                raise RuntimeError(f"lbs kernel disagrees with the plain "
                                   f"version at B={B} V={V}: {err} > "
                                   f"{KERNEL_ATOL}")
            results["max_abs_err"] = max(results["max_abs_err"], err)
            if V == 6890:
                plain_ms = cuda_ms(lambda: lbs_skinning_reference(wT, A, v))
                ms = cuda_ms(lambda: lbs_skinning(wT, A, v))
                plain_ms2 = cuda_ms(lambda: lbs_skinning_reference(wT, A, v))
                ms2 = cuda_ms(lambda: lbs_skinning(wT, A, v))
                results["times"][B] = (min(ms, ms2), min(plain_ms, plain_ms2))
                print(f"phase 2: lbs B={B} V={V} kernel {ms:.4f}/{ms2:.4f} "
                      f"ms, plain einsum {plain_ms:.4f}/{plain_ms2:.4f} ms "
                      f"(median of CUDA-event means, two turns each)")
    non_contig = torch.empty(2, 3, 6890, device=dev).transpose(1, 2)
    A = torch.eye(4, device=dev).expand(2, 24, 4, 4).contiguous()
    wT = synthetic_smpl_model(0, 6890, device=dev).lbs_weights_t
    try:
        lbs_skinning(wT, A, non_contig)
    except ValueError as e:
        print(f"phase 2: non-contiguous input raised: {e}")
    else:
        raise RuntimeError("lbs kernel accepted a non-contiguous input")
    return results


def phase3_slice() -> dict:
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.config import parse_args
    from tepose_tpu_torch.evaluate import run_eval

    cfg, _, args = parse_args([
        "--cfg", os.path.join(REPO, "configs", "repr_wopw_3dpw_model.yaml"),
        "--dataset", "3dpw"])
    run_eval(cfg, args, synthetic=True, device="cuda")   # warm-up run
    lbs.LAUNCHES = 0
    res = run_eval(cfg, args, synthetic=True, device="cuda")
    torch.cuda.synchronize()
    launches = lbs.LAUNCHES
    metrics = {k: res[k] for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel_err")}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"non-finite metrics from run_eval: {metrics}")
    if launches <= 0:
        raise RuntimeError("run_eval never launched the lbs kernel")
    fps = res["frames"] / res["seconds"]
    print(f"phase 3: run_eval synthetic 3dpw (seqlen 6, 2x1024 GRUs) on cuda: "
          f"{json.dumps(metrics)}; {res['frames']} frames in "
          f"{res['seconds']:.3f} s = {fps:.1f} frames/s (warm run); "
          f"lbs launches {launches}")
    return {"launches": launches}


def phase4_golden() -> None:
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_torch_port_golden import (
        load_golden, port_rollout, port_setup, weight_checksums)

    golden = load_golden()
    setup = port_setup(golden["spec"], "cuda")
    sums = weight_checksums(setup)
    if not np.allclose(sums, golden["weight_checksums"], rtol=1e-9, atol=0):
        raise RuntimeError(
            f"weights rebuilt from the golden's seeds differ from the "
            f"golden's ({sums} vs {golden['weight_checksums']}): the torch "
            f"CPU generator stream changed")
    out = port_rollout(setup)
    dev = {}
    for key, atol in (("pred_j3d", GOLDEN_J3D_ATOL), ("mpvpe", GOLDEN_J3D_ATOL),
                      ("pred_theta", GOLDEN_THETA_ATOL)):
        if out[key].shape != golden[key].shape or not np.isfinite(
                out[key]).all():
            raise RuntimeError(f"golden {key}: shape {out[key].shape} vs "
                               f"{golden[key].shape}, or non-finite values")
        dev[key] = float(np.abs(out[key] - golden[key]).max())
        if not dev[key] <= atol:
            raise RuntimeError(f"golden {key} deviates by {dev[key]} > {atol}")
    print(f"phase 4: full-width golden ({golden['spec']['num_videos']} videos, "
          f"{out['pred_theta'].shape[1]} frames, V={golden['spec']['num_verts']})"
          f" max deviation: pred_j3d {dev['pred_j3d']:.3e} m, mpvpe "
          f"{dev['mpvpe']:.3e} m, pred_theta {dev['pred_theta']:.3e}")


def main() -> None:
    card = phase0_device()
    sys.path.insert(0, REPO)
    phase1_build()
    kern = phase2_kernel()
    sl = phase3_slice()
    phase4_golden()
    ms, plain_ms = kern["times"][256]
    print(json.dumps({"kernels": [{
        "name": "lbs_skinning", "route": "cuda",
        "source": "tepose_tpu_torch/csrc/lbs_skinning.cu",
        "replaces": "tepose_tpu/ops/lbs_pallas.py:76",
        "launches": sl["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": ms, "plain_ms": plain_ms, "shape": "B=256 V=6890 J=24",
        "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
