"""Device timing of the port's CUDA kernels and the LBS kernel's bound and
inputs, shared by chip_smoke.py and tools/lbs_kernel_bench.py (a profiled
run's device busy time is `utils.profiling.profile_device`)."""

from __future__ import annotations

import time

import numpy as np
import torch

from tepose_tpu_torch.utils.flops import H100_PEAK_FLOPS

# the card's peaks for a bound: fp32 outside the tensor cores (the H100
# SXM's entry of the port's peak table) and HBM3 (its datasheet figure)
PEAK_FP32_FLOPS = H100_PEAK_FLOPS["NVIDIA H100 80GB HBM3"]["float32"]
PEAK_BYTES_PER_S = 3.35e12


def device_ms(fn, launches: int = 50, reps: int = 15) -> list:
    """Device milliseconds per call of `fn`, one value per repeat.

    Each repeat queues a sleep kernel, then the start event, `launches`
    calls and the end event. The sleep outlasts the host's enqueueing, so
    the device runs the calls back to back and the events time the device,
    not how fast the host issues launches. Where the device reached the
    start event before the host had queued the last call, the repeat is
    run again with twice the sleep; it fails after a few doublings."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(enqueue_s, 1e-3) * 8e9)   # ~4x the enqueue at 2 GHz
    times = []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if not queued_in_time:
            cycles *= 2
            if cycles > 2e10:
                raise RuntimeError("device_ms: the device keeps reaching "
                                   "the start event before the launches "
                                   "are queued")
            continue
        times.append(start.elapsed_time(end) / launches)
    return times


def host_us_per_call(fn, launches: int = 200) -> float:
    """Host-clock microseconds per call of `fn`: its enqueue cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / launches
    torch.cuda.synchronize()
    return us


def lbs_bound(B: int, V: int, J: int) -> tuple[float, str]:
    """Least time in ms the card could take to skin B x V vertices, and
    what sets it: 24 J + 18 flops per sample and vertex (the blend's 12 J
    FMAs and the apply's 9 FMAs, two flops each) at the fp32 peak, against
    v_posed, the output, W^T and the transforms moved once at the memory
    rate."""
    flops = (24 * J + 18) * B * V
    nbytes = 4 * (2 * B * V * 3 + J * V + B * J * 16)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def lbs_inputs(rs, B: int, V: int, dev, offset: int = 0):
    """wT (J, V), A (B, J, 4, 4), v (B, V, 3) on `dev`; with `offset`, each
    is a contiguous view at that storage offset of a larger buffer."""
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model

    wT = synthetic_smpl_model(0, V, device=dev).lbs_weights_t
    J = wT.shape[0]
    A = rs.randn(B, J, 4, 4).astype(np.float32)
    A[:, :, 3] = [0, 0, 0, 1]
    v = rs.randn(B, V, 3).astype(np.float32)
    out = []
    for t in (wT, torch.from_numpy(A).to(dev), torch.from_numpy(v).to(dev)):
        if offset:
            buf = torch.empty(t.numel() + offset, device=dev)
            buf[offset:] = t.reshape(-1)
            t = buf[offset:].view(t.shape)
        out.append(t)
    return out
