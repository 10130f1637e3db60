#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (tepose_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Phases, each of which raises on failure (no phase's error is caught):
  0. require CUDA; strict float32 (TF32 off for matmuls and cuDNN); print
     the card's name and power limit as nvidia-smi reports them;
  1. build every CUDA kernel of the port from csrc/ with nvcc;
  2. LBS skinning kernel against its plain PyTorch version on the card, at
     V = 6890 with B in {1, 8, 32, 192, 256} (the main path's launch sizes
     and a large batch), at ragged V in {700, 301} with B = 3, and on inputs
     that are views at storage offset 1 of larger buffers (contiguous, only
     4-byte aligned): max abs error <= 1e-5; a non-contiguous input must
     raise. Then, at V = 6890 for each B, the device time per launch of the
     kernel and of the plain version (`device_ms`: a sleep kernel queued
     ahead of the start event, so the device reaches the launches only once
     the host has queued them all; CUDA-event mean per launch, median over
     repeats, in turns plain/kernel/kernel/plain), its bound from the shapes,
     its share of the bound, and the wrapper's host microseconds per call;
  3. the eval rollout through its entry point,
     `tepose_tpu_torch.evaluate.run_eval(--synthetic, 3dpw, full width)`,
     with the kernels' launch counts zeroed just before and read just after:
     finite metrics and at least one launch of every kernel;
  4. the full-width JAX golden (tests/golden/torch_port_eval_f32.npz, from
     tools/make_torch_port_golden.py): per-frame joints and MPVPE within
     1e-4 m, theta within 1e-3;
  5. the serving engine at full width (ResNet-50 on seeded uint8 224 x 224
     crops, TePose and VIBE 2 x 1024, V = 6890):
     `StreamingEngine.run_tracklets_from_crops` on two tracklets of 7 and
     12 frames (one bucket, B_pad 2, T_pad 16), with the launch counts
     zeroed just before and read just after, held to the JAX serving golden
     (tests/golden/torch_port_serve_f32.npz, from
     tools/make_torch_serve_golden.py): theta within 1e-3, kp_3d and
     verts within 1e-4 m, kp_2d within 1e-4 of its magnitude; then the
     same through `extract_features_multi` + `run_tracklets`;
  6. `LiveSession` (2 streams, the backbone on board) pushed the same crops
     frame by frame, one slot reset once, against phase 5's engine outputs
     at rtol 2e-4, atol 2e-5 (tests/test_live.py's bar), counts zeroed
     just before the pushes;
  7. serving timings: engine frames/s (8 tracklets x 128 uint8 frames,
     `parity` and `serving` presets), ResNet-50 crops/s (crop_batch 16
     and 128, float32 and bfloat16), `fast_stream_scan` ms/window against
     the plain-encoder window loop (B = 32, T = 128) and `LiveSession.push`
     p50/p99 latency (1 and 32 streams, the first push excluded);
  8. training at the full width of configs/repr_wopw_3dpw_model.yaml
     (batch 32 = 19 2D + 13 3D rows, seqlen 6, 2 x 1024 GRUs through the
     fast encoder, GCN discriminator at 13 / 6 scales, both Adam
     optimizers, synthetic SMPL with 6890 vertices, strict float32):
     (a) the JAX training golden (tests/golden/torch_port_train_f32.npz,
     from tools/make_torch_train_golden.py), segments of K = 1 and K = 3
     windows with dropout off: mean losses within 1e-4 (K = 1) and 1e-3
     (K = 3) relative, window 1's sum ||g||^2 within 1e-3, BN running
     statistics within 1e-4 (K = 1) and 1e-3 (K = 3) of each array's
     magnitude (after an update: JAX and the port round the
     discriminator's float32 gradient differently and Adam steps a few
     elements opposite ways, by up to 2 lr), leaves within 2 K lr and
     their RMS deviation within 0.05 lr, both Adam optimizers' step
     counts (torch's per-parameter state) equal to optax's; then the K = 3
     segment against the same segment on the host's CPU, losses and BN
     statistics within 1e-4; the training step launches no skinning; (b) `tepose_tpu_torch.train.run.run_train
     (--synthetic)`: one epoch of one segment of 20 windows, then
     validation, with the LBS count zeroed before and required > 0 after
     (every launch is validation's), finite losses and metrics, and a
     fresh loop resumed from the checkpoint with bit-equal parameters and
     optimizer state; (c) timings on the resumed loop: train ms per
     window and samples x windows / s (host clock ending in the metrics
     readback, median over 4 segments), peak device memory over them,
     device idle share and kernels per window from one profiled segment,
     and validation ms per window (one batch of 8 videos).

  9. the demo's and evaluate's host CLI paths at full width (TePose and
     VIBE 2 x 1024, VIBE seqlen 16, ResNet-50, synthetic SMPL with 6890
     vertices, strict float32): (a) `run_eval(--synthetic, 3dpw)` without
     and with `--filter`, counts zeroed before each and read after: finite
     metrics and one more LBS launch per video with --filter; then
     `evaluate.filter_video_predictions` on the stored thetas of
     tests/golden/torch_port_demo_f32.npz (from
     tools/make_torch_demo_golden.py) within 1e-4 m of JAX's J14 joints;
     (b) `smplify_refine` on the golden's tracklet (T = 48, 60 Adam
     iterations, lr 0.02) within the bars of that tool (4x the larger
     float32-versus-float64 drift on the CPU), its loss trace falling, with
     exactly one LBS launch (the final forward; the objective skins
     nothing); (c) the offline demo after decode (`demo.track` and
     `demo.run_offline`) on 64 numpy-drawn 320 x 240 frames of two moving
     figures, once with a --detections npz of two tracklets, --smooth and
     --sideview, once with OpenPose JSONs of projected SMPL joints
     (--tracking_method pose), --run_smplify and --smooth: the engine's
     outputs equal a direct `run_tracklets_from_crops` on the same crops,
     the smoothed vertices equal the plain einsum's on the same theta
     within 1e-5, the native library is the one built from source,
     rendered frames have the input's height and twice its width and
     change only inside the projected meshes' box, and the engine,
     --smooth and SMPLify each launch the LBS kernel; (d) timings: the
     demo's stage times, SMPLify ms and kernels per iteration and its idle
     share (one `torch.profiler` run), --filter's added ms per video (the
     filter step on the golden's 64-frame video, timed alone), and
     the LBS kernel against its plain version at B = 48 and 600 (error
     within 1e-5, device time, bound). No cv2 is needed: the frames never
     pass through a video file.

Before the last line it prints one JSON line with the kernels' routes,
launches per path, errors and times; the last line is the ok/device JSON
object.
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
# phase 2's shapes: the main path's launch sizes at V = 6890 (eval 32 and
# 192, engine 8, live 1) and the large batch; ragged vertex counts; views at
# storage offset 1 for one and for four vertices per thread
LBS_V, LBS_BATCHES = 6890, (1, 8, 32, 192, 256)
LBS_RAGGED = ((700, 3), (301, 3))
LBS_OFFSET = ((LBS_V, 3), (700, 8), (LBS_V, 32))
GOLDEN_J3D_ATOL = 1e-4   # 0.1 mm, the reproduction bar (BASELINE.md:64)
GOLDEN_THETA_ATOL = 1e-3
LIVE_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_live.py's bar

# phase 7's shapes
ENGINE_TRACKS, ENGINE_FRAMES = 8, 128
BACKBONE_CROPS = 512
SCAN_B, SCAN_T = 32, 128
LIVE_STREAMS, LIVE_PUSHES = (1, 32), 100


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


def phase2_kernel(card: str) -> dict:
    from kernel_timing import (
        device_ms, host_us_per_call, lbs_bound, lbs_inputs)
    from tepose_tpu_torch.ops.lbs_skinning import (
        lbs_skinning, lbs_skinning_reference)

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    res = {"max_abs_err": 0.0, "device_ms": {}, "plain_ms": {}, "bound": {}}
    cases = [(LBS_V, B, 0) for B in LBS_BATCHES]
    cases += [(V, B, 0) for V, B in LBS_RAGGED]
    cases += [(V, B, 1) for V, B in LBS_OFFSET]
    inputs = {}
    for V, B, offset in cases:
        wT, A, v = lbs_inputs(rs, B, V, dev, offset)
        out = lbs_skinning(wT, A, v)
        ref = lbs_skinning_reference(wT, A, v)
        torch.cuda.synchronize()
        if out.shape != (B, V, 3) or not torch.isfinite(out).all():
            raise RuntimeError(f"lbs kernel output bad at B={B} V={V}")
        err = (out - ref).abs().max().item()
        where = (f" (inputs at storage offset {offset}, data_ptr % 16 = "
                 f"{[t.data_ptr() % 16 for t in (wT, A, v)]})"
                 if offset else "")
        print(f"phase 2: lbs B={B} V={V}{where} max_abs_err={err:.3e}")
        if not err <= KERNEL_ATOL:
            raise RuntimeError(f"lbs kernel disagrees with the plain version "
                               f"at B={B} V={V} offset={offset}: {err} > "
                               f"{KERNEL_ATOL}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if V == LBS_V and not offset:
            inputs[B] = (wT, A, v)
    non_contig = torch.empty(2, 3, LBS_V, device=dev).transpose(1, 2)
    wT, A, _ = inputs[1]
    try:
        lbs_skinning(wT, A.expand(2, -1, -1, -1).contiguous(), non_contig)
    except ValueError as e:
        print(f"phase 2: non-contiguous input raised: {e}")
    else:
        raise RuntimeError("lbs kernel accepted a non-contiguous input")

    for B, (wT, A, v) in inputs.items():
        def kernel():
            lbs_skinning(wT, A, v)

        def plain():
            lbs_skinning_reference(wT, A, v)

        times = {kernel: [], plain: []}
        for fn in (plain, kernel, kernel, plain):
            times[fn] += device_ms(fn, launches=50 if fn is kernel else 10)
        ms, plain_ms = (float(np.median(times[f])) for f in (kernel, plain))
        bound_ms, bound_by = lbs_bound(B, LBS_V, wT.shape[0])
        res["device_ms"][B], res["plain_ms"][B] = ms, plain_ms
        res["bound"][B] = (bound_ms, bound_by)
        print(f"phase 2: lbs B={B} V={LBS_V} device {ms:.5f} ms per launch "
              f"(turns {np.median(times[kernel][:15]):.5f}/"
              f"{np.median(times[kernel][15:]):.5f}), bound {bound_ms:.5f} ms "
              f"({bound_by}), {bound_ms / ms:.1%} of bound; plain einsum "
              f"{plain_ms:.5f} ms [{card}]")
    wT, A, v = inputs[32]
    res["host_us"] = host_us_per_call(lambda: lbs_skinning(wT, A, v))
    print(f"phase 2: lbs wrapper host time {res['host_us']:.2f} us per call "
          f"(B=32 V={LBS_V}, enqueue only, host clock) [{card}]")
    return res


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


def serve_golden():
    import make_torch_serve_golden

    return make_torch_serve_golden


def phase5_engine() -> dict:
    import tepose_tpu_torch.ops.lbs_skinning as lbs

    sg = serve_golden()
    golden = sg.load_golden()
    spec = golden["spec"]
    setup = sg.port_setup(spec, "cuda")
    sums = sg.weight_checksums(setup)
    if not np.allclose(sums, golden["weight_checksums"], rtol=1e-9, atol=0):
        raise RuntimeError(
            f"weights rebuilt from the serving golden's seeds differ from the "
            f"golden's ({sums} vs {golden['weight_checksums']})")
    engine = sg.port_engine(setup)
    runs = {
        "run_tracklets_from_crops":
            lambda: engine.run_tracklets_from_crops(setup["crops"]),
        "extract_features_multi + run_tracklets":
            lambda: engine.run_tracklets(
                engine.extract_features_multi(setup["crops"])),
    }
    out = {"setup": setup}
    for name, run in runs.items():
        lbs.LAUNCHES = 0
        results = run()
        torch.cuda.synchronize()
        launches = lbs.LAUNCHES
        if launches <= 0:
            raise RuntimeError(f"engine {name} never launched the lbs kernel")
        dev = sg.golden_deviation(sg.golden_outputs(results, spec), golden)
        print(f"phase 5: engine {name} on cuda ({len(spec['lengths'])} "
              f"tracklets of {spec['lengths']} uint8 {spec['crop_size']}^2 "
              f"crops, 2x1024 GRUs, V={spec['num_verts']}), lbs launches "
              f"{launches}; deviation from the JAX serving golden / bar: "
              + ", ".join(f"{k} {d:.3e} / {bar:.1e}"
                          for k, (d, bar) in dev.items()))
        bad = {k: v for k, v in dev.items() if not v[0] <= v[1]}
        if bad:
            raise RuntimeError(f"engine {name} misses the serving golden: "
                               f"{bad}")
        if "results" not in out:
            out.update(results=results, launches=launches)
    return out


def phase6_live(p5: dict) -> dict:
    """Slot 1 streams tracklet 1; slot 0 streams tracklet 0, is reset after
    its last frame and streams tracklet 0 again from frame 0."""
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.streaming.live import LiveSession

    setup, offline = p5["setup"], p5["results"]
    c0, c1 = setup["crops"]
    S = setup["spec"]["seqlen"]
    keys = ("theta", "verts", "kp_2d", "kp_3d")
    live = LiveSession(setup["smpl"], setup["gen"], setup["vibe"],
                       n_streams=2, backbone=setup["backbone"], outputs=keys)
    worst = {k: (0.0, 0.0) for k in keys}   # (max abs dev, max dev / bar)
    lbs.LAUNCHES = 0
    for t in range(len(c1)):
        f0 = t % len(c0)
        out = live.push(np.stack([c0[f0], c1[t]]),
                        reset=np.array([t == len(c0), False]))
        for slot, (res, f) in enumerate(((offline[0], f0), (offline[1], t))):
            if bool(out["valid"][slot]) != (f >= S - 1):
                raise RuntimeError(f"live slot {slot} frame {f}: valid "
                                   f"{out['valid'][slot]}")
            for k in keys:
                got, want = out[k][slot].astype(np.float64), res[k][f]
                if not np.isfinite(got).all():
                    raise RuntimeError(f"live {k} not finite at t={t}")
                d = np.abs(got - want)
                bar = LIVE_TOL["atol"] + LIVE_TOL["rtol"] * np.abs(want)
                ratio = d / bar
                worst[k] = (max(worst[k][0], float(d.max())),
                            max(worst[k][1], float(ratio.max())))
    torch.cuda.synchronize()
    launches = lbs.LAUNCHES
    print(f"phase 6: LiveSession 2 streams on cuda, {len(c1)} pushes of "
          f"uint8 crops, slot 0 reset at t={len(c0)}; lbs launches "
          f"{launches}; against the engine (rtol {LIVE_TOL['rtol']}, atol "
          f"{LIVE_TOL['atol']}), max abs deviation / largest share of the "
          f"bar: " + ", ".join(f"{k} {d:.3e} / {r:.3f}"
                               for k, (d, r) in worst.items()))
    if launches <= 0:
        raise RuntimeError("LiveSession never launched the lbs kernel")
    bad = {k: v for k, v in worst.items() if not v[1] <= 1.0}
    if bad:
        raise RuntimeError(f"live disagrees with the engine: {bad}")
    return {"launches": launches}


def host_seconds(fn, reps: int = 3) -> list:
    """Host-clock seconds of `reps` calls of `fn`, each ending in a
    device synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase7_timings(p5: dict, card: str) -> dict:
    from tepose_tpu_torch.streaming.engine import device_scope, upload
    from tepose_tpu_torch.streaming.fast_scan import (
        fast_stream_scan, plain_stream_scan)
    from tepose_tpu_torch.streaming.live import LiveSession

    sg = serve_golden()
    setup = p5["setup"]
    size = setup["spec"]["crop_size"]
    rs = np.random.RandomState(7)
    res: dict = {"card": card}

    crops = [rs.randint(0, 256, (ENGINE_FRAMES, 3, size, size)).astype(
        np.uint8) for _ in range(ENGINE_TRACKS)]
    for preset in ("parity", "serving"):
        engine = sg.port_engine(setup, preset=preset)
        secs = host_seconds(lambda: engine.run_tracklets_from_crops(crops))
        fps = ENGINE_TRACKS * ENGINE_FRAMES / float(np.median(secs))
        res[f"engine_fps_{preset}"] = fps
        print(f"phase 7: engine run_tracklets_from_crops {ENGINE_TRACKS} x "
              f"{ENGINE_FRAMES} uint8 frames, preset {preset}: {fps:.1f} "
              f"frames/s (median of {[round(s, 4) for s in secs]} s) [{card}]")

    dev = setup["smpl"].v_template.device
    dev_crops = upload(rs.randint(0, 256, (BACKBONE_CROPS, 3, size, size))
                       .astype(np.uint8), dev)
    for dtype in (None, torch.bfloat16):
        for cb in (16, 128):
            engine = sg.port_engine(setup, backbone_dtype=dtype, crop_batch=cb)

            def run():
                with device_scope():
                    engine._features(dev_crops)

            secs = host_seconds(run)
            rate = BACKBONE_CROPS / float(np.median(secs))
            name = "bf16" if dtype is not None else "f32"
            res[f"resnet50_crops_per_s_{name}_cb{cb}"] = rate
            print(f"phase 7: ResNet-50 {name} crop_batch {cb}, "
                  f"{BACKBONE_CROPS} device-resident uint8 crops: {rate:.1f} "
                  f"crops/s (median of {[round(s, 4) for s in secs]} s) "
                  f"[{card}]")

    feats = torch.from_numpy(
        rs.randn(SCAN_B, SCAN_T, 2048).astype(np.float32) * 0.5).to(dev)
    buf0 = torch.zeros(SCAN_B, 5, 85, device=dev)
    buf0[..., 0] = 1.0
    W = SCAN_T - setup["spec"]["seqlen"] + 1
    fns = {"plain": plain_stream_scan, "fast": fast_stream_scan}
    secs = {"plain": [], "fast": []}
    outs = {}
    for name in ("plain", "fast", "fast", "plain", "plain", "fast"):
        def run():
            with device_scope():
                outs[name] = fns[name](setup["gen"], setup["smpl"], feats,
                                       buf0, W)
        secs[name] += host_seconds(run, reps=2)
    ms = {k: 1e3 * float(np.median(v)) / W for k, v in secs.items()}
    agree = float((outs["fast"]["theta"] - outs["plain"]["theta"]).abs().max())
    res.update(scan_ms_per_window_fast=ms["fast"],
               scan_ms_per_window_plain=ms["plain"])
    print(f"phase 7: theta-feedback scan B={SCAN_B} T={SCAN_T} ({W} windows, "
          f"2x1024): fast_stream_scan {ms['fast']:.3f} ms/window, plain "
          f"encoder loop {ms['plain']:.3f} ms/window (medians of 6 runs "
          f"each, in turns plain/fast/fast/plain/plain/fast); theta max "
          f"|fast - plain| {agree:.2e} [{card}]")

    for n in LIVE_STREAMS:
        live = LiveSession(setup["smpl"], setup["gen"], setup["vibe"],
                           n_streams=n, backbone=setup["backbone"])
        pool = rs.randint(0, 256, (8, n, 3, size, size)).astype(np.uint8)
        lat = []
        for i in range(LIVE_PUSHES + 1):
            t0 = time.perf_counter()
            live.push(pool[i % len(pool)])
            lat.append(time.perf_counter() - t0)
        p50, p99 = (1e3 * float(np.percentile(lat[1:], q)) for q in (50, 99))
        res[f"live_push_ms_p50_{n}"], res[f"live_push_ms_p99_{n}"] = p50, p99
        print(f"phase 7: LiveSession.push {n} stream(s), uint8 crops + "
              f"float32 backbone, {LIVE_PUSHES} pushes after the first: p50 "
              f"{p50:.3f} ms, p99 {p99:.3f} ms [{card}]")
    print(json.dumps({"serving_timings": res}))
    return res


TRAIN_WINDOWS, TRAIN_TIMED_SEGMENTS = 20, 4


def phase8_train(card: str) -> dict:
    import make_torch_train_golden as tg
    from kernel_timing import profile_device
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.config import update_cfg
    from tepose_tpu_torch.train.optim import opt_state_leaves
    from tepose_tpu_torch.train.run import (
        build_train_loop, close_loaders, run_train)
    from tepose_tpu_torch.train.trainer import train_segment

    # (a) the JAX golden
    golden = tg.load_golden()
    spec = golden["spec"]
    for K in spec["windows"]:
        setup = tg.port_setup(spec, "cuda")
        sums = tg.weight_checksums(setup)
        if not np.allclose(sums, golden["weight_checksums"], rtol=1e-9,
                           atol=0):
            raise RuntimeError(
                f"weights rebuilt from the training golden's seeds differ "
                f"from the golden's ({sums} vs {golden['weight_checksums']})")
        lbs.LAUNCHES = 0
        out = tg.port_segment(setup, K)
        torch.cuda.synchronize()
        if lbs.LAUNCHES:
            raise RuntimeError(f"the training step skinned the mesh "
                               f"({lbs.LAUNCHES} LBS launches)")
        dev = tg.golden_deviation(golden, out, K)
        print(f"phase 8a: training golden K={K} (batch {spec['n_2d']}+"
              f"{spec['n_3d']}, {spec['n_layers']}x{spec['hidden_size']} "
              f"GRUs, GCN {spec['num_gcn_scales']}/{spec['num_g3d_scales']}, "
              f"V={spec['num_verts']}) on cuda; deviation / bar: "
              + ", ".join(f"{k} {d:.3e} / {bar:.1e}"
                          for k, (d, bar) in dev.items())
              + f"; Adam steps gen {out['adam_steps']['gen']} disc "
              f"{out['adam_steps']['disc']}; gen_loss "
              f"{out['losses']['gen_loss']:.6f}")
        bad = {k: v for k, v in dev.items() if not v[0] <= v[1]}
        if bad:
            raise RuntimeError(f"training misses the golden at K={K}: {bad}")
    # the last segment against the same segment on the host's CPU
    host = tg.port_segment(tg.port_setup(spec, "cpu"), K)
    dev = tg.pair_deviation(out, host)
    print(f"phase 8a: K={K} segment on cuda against the same on the cpu; "
          "deviation / bar: " + ", ".join(f"{k} {d:.3e} / {bar:.1e}"
                                          for k, (d, bar) in dev.items()))
    bad = {k: v for k, v in dev.items() if not v[0] <= v[1]}
    if bad:
        raise RuntimeError(f"training on cuda misses the cpu at K={K}: {bad}")

    # (b) the entry point, one epoch
    cfg = update_cfg(os.path.join(REPO, "configs",
                                  "repr_wopw_3dpw_model.yaml"))
    cfg.OUTPUT_DIR = os.path.join(REPO, "build", "chip_smoke_train")
    cfg.TRAIN.END_EPOCH = 1
    kw = dict(synthetic=True, smoke_iters=TRAIN_WINDOWS, device="cuda")
    lbs.LAUNCHES = 0
    t0 = time.perf_counter()
    loop = run_train(cfg, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = lbs.LAUNCHES
    lines = [json.loads(x) for x in
             open(os.path.join(loop.logdir, "metrics.jsonl"))]
    values = {d["tag"]: d["value"] for d in lines}
    if not all(np.isfinite(v) for v in values.values()):
        raise RuntimeError(f"non-finite training metrics: {values}")
    if launches <= 0:
        raise RuntimeError("training validation never launched the lbs "
                           "kernel")
    print(f"phase 8b: run_train --synthetic on cuda, 1 epoch of 1 segment x "
          f"{TRAIN_WINDOWS} windows then validation ({len(loop.valid)} "
          f"batches), {run_s:.1f} s; lbs launches {launches}; gen_loss "
          f"{values['train_loss/gen_loss']:.4f}, dis_loss "
          f"{values['train_loss/dis_loss']:.4f}, pa-mpjpe "
          f"{values['error/pa-mpjpe']:.2f} mm")
    cfg2 = cfg.clone()
    cfg2.TRAIN.RESUME = os.path.join(loop.logdir, "checkpoint.npz")
    fresh, _ = build_train_loop(cfg2, **kw)
    for a, b in ((loop.gen, fresh.gen), (loop.disc, fresh.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k])
                                             for k in sa):
            raise RuntimeError("the resumed loop's weights differ")
    for a, b in ((loop.gen_opt, fresh.gen_opt),
                 (loop.disc_opt, fresh.disc_opt)):
        if not all(np.array_equal(x, y) for x, y in
                   zip(opt_state_leaves(a), opt_state_leaves(b))):
            raise RuntimeError("the resumed loop's optimizer state differs")
    print(f"phase 8b: checkpoint resumed into a fresh loop (epoch "
          f"{fresh.start_epoch}): parameters, buffers and optimizer state "
          f"bit-equal")

    # (c) timings, on the resumed loop
    loop = fresh
    hp, B = loop.hp, loop.hp.n_2d + loop.hp.n_3d
    torch.cuda.reset_peak_memory_stats()
    loop.train_epoch(1, TRAIN_TIMED_SEGMENTS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = float(np.median(loop.segment_seconds))
    it2, it3, itd = (iter(x) for x in (loop.train_2d, loop.train_3d,
                                       loop.disc_loader))
    b2, b3 = next(it2), next(it3)
    amass = loop._amass_windows(itd, TRAIN_WINDOWS, B)
    prof = profile_device(lambda: train_segment(
        loop.gen, loop.disc, loop.smpl, loop.gen_opt, loop.disc_opt, hp,
        loop.weights, b2, b3, amass, loop.generator))
    loop.max_valid_batches = 1
    lbs.LAUNCHES = 0
    t0 = time.perf_counter()
    loop.validate()
    val_s = time.perf_counter() - t0
    val_windows = lbs.LAUNCHES // 2
    close_loaders(loop)
    res = {"card": card, "train_ms_per_window": 1e3 * med / TRAIN_WINDOWS,
           "samples_windows_per_s": B * TRAIN_WINDOWS / med,
           "segment_s": loop.segment_seconds, "peak_memory_gb": peak_gb,
           "validation_ms_per_window": 1e3 * val_s / max(val_windows, 1),
           "validation_launches": launches}
    if prof is None:
        res.update(idle_share="not measured", kernels_per_window=
                   "not measured")
    else:
        res.update(idle_share=prof["idle_share"],
                   kernels_per_window=prof["kernels"] / TRAIN_WINDOWS,
                   profiled_span_ms=prof["span_ms"],
                   profiled_busy_ms=prof["busy_ms"],
                   top_kernels_ms=prof["top_kernels_ms"],
                   top_host_ops_ms=prof["top_host_ops_ms"])
    print(f"phase 8c: training at batch {B} (strict fp32): "
          f"{res['train_ms_per_window']:.2f} ms/window, "
          f"{res['samples_windows_per_s']:.1f} samples x windows/s (median "
          f"of {[round(x, 4) for x in loop.segment_seconds]} s per "
          f"{TRAIN_WINDOWS}-window segment); idle share "
          f"{res['idle_share']}, kernels/window {res['kernels_per_window']}"
          f"; peak memory {peak_gb:.2f} GB; validation "
          f"{res['validation_ms_per_window']:.3f} ms/window ({val_windows} "
          f"windows at B=8, one batch) [{card}]")
    print(json.dumps({"train_timings": res}))
    return {"launches": launches}


# phase 9's shapes: the demo clip, SMPLify's tracklet length and a long
# video's --filter rebuild as LBS launch sizes
DEMO_T, DEMO_H, DEMO_W = 64, 240, 320
DEMO_LBS_BATCHES = (48, 600)
DEMO_DIR = os.path.join(REPO, "build", "chip_smoke_demo")


def demo_frames(T: int = DEMO_T, h: int = DEMO_H, w: int = DEMO_W):
    """T RGB frames drawn with numpy: two filled ellipses (the figures)
    moving over a noisy static background; and each figure's boxes
    (T, 4) = (cx, cy, w, h)."""
    rs = np.random.RandomState(3)
    bg = rs.randint(30, 50, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    figures = [((0.3, 0.5), (22, 60), (220, 170, 60), 0.0),
               ((0.7, 0.52), (25, 66), (60, 180, 220), 1.7)]
    frames, boxes = [], [[] for _ in figures]
    for t in range(T):
        img = bg.copy()
        for i, ((fx, fy), (ax, ay), color, ph) in enumerate(figures):
            cx = w * fx + 30 * np.sin(t / 9.0 + ph)
            cy = h * fy + 8 * np.cos(t / 7.0 + ph)
            inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
            img[inside] = color
            boxes[i].append([cx, cy, 2.2 * ax, 2.2 * ay])
        frames.append(img)
    return frames, [np.asarray(b, np.float32) for b in boxes]


def write_demo_inputs(boxes) -> tuple:
    """A --detections npz of the figures' tracklets, and OpenPose (staf)
    keypoint JSONs: SMPL joints of a seeded pose track, projected with a
    weak-perspective camera into each figure's box."""
    from tepose_tpu_torch.data.kp_utils import convert_kps
    from tepose_tpu_torch.models.regressor import projection
    from tepose_tpu_torch.models.smpl import (
        smpl_joints_reduced, synthetic_smpl_model)
    from tepose_tpu_torch.ops.geometry import batch_rodrigues

    os.makedirs(DEMO_DIR, exist_ok=True)
    det = os.path.join(DEMO_DIR, "detections.npz")
    T = len(boxes[0])
    np.savez(det, **{k: v for i, b in enumerate(boxes) for k, v in (
        (f"tracklet_{i}_bbox", b),
        (f"tracklet_{i}_frames", np.arange(T)))})
    json_dir = os.path.join(DEMO_DIR, "staf_json")
    os.makedirs(json_dir, exist_ok=True)
    rs = np.random.RandomState(4)
    smpl = synthetic_smpl_model(0, device="cpu")
    people = [[] for _ in range(T)]
    for pid, b in enumerate(boxes):
        aa = rs.randn(T, 24, 3).astype(np.float32) * 0.15
        aa[:, 0] = [np.pi, 0.0, 0.0]          # upright in image coords
        with torch.no_grad():
            rot = batch_rodrigues(torch.from_numpy(aa).reshape(-1, 3))
            j49 = smpl_joints_reduced(
                smpl, torch.zeros(T, 10), rot.reshape(T, 24, 3, 3))
            kp = projection(j49, torch.tensor([[0.9, 0.0, 0.0]] * T)).numpy()
        side = np.maximum(b[:, 2], b[:, 3])[:, None]
        px = np.stack([b[:, :1] + kp[..., 0] * side / 2,
                       b[:, 1:2] + kp[..., 1] * side / 2,
                       np.ones_like(kp[..., 0])], -1)
        staf = convert_kps(px.astype(np.float32), "spin", "staf")
        for t in range(T):
            people[t].append({"person_id": [pid],
                              "pose_keypoints_2d": staf[t].ravel().tolist()})
    for t in range(T):
        with open(os.path.join(json_dir, f"{t:06d}_keypoints.json"),
                  "w") as f:
            json.dump({"people": people[t]}, f)
    return det, json_dir


def mesh_pixels(rendered, frame, results, t: int) -> int:
    """How many pixels of frame t the render changed; raises if one lies
    outside the box (grown by 2 px) that the meshes project to."""
    diff = np.any(rendered != frame, axis=-1)
    h, w = diff.shape
    x0 = y0 = np.inf
    x1 = y1 = -np.inf
    for r in results.values():
        sx, sy, tx, ty = r["orig_cam"][t]
        v = r["verts"][t]
        px = (1 + sx * (v[:, 0] + tx)) * 0.5 * w
        py = (1 + sy * (-v[:, 1] + ty)) * 0.5 * h
        x0, x1 = min(x0, px.min()), max(x1, px.max())
        y0, y1 = min(y0, py.min()), max(y1, py.max())
    ys, xs = np.nonzero(diff)
    if len(xs) and (xs.min() < x0 - 2 or xs.max() > x1 + 2
                    or ys.min() < y0 - 2 or ys.max() > y1 + 2):
        raise RuntimeError(f"frame {t}: the render changed pixels outside "
                           f"the meshes' projection")
    return len(xs)


def phase9_demo(card: str) -> dict:
    import make_torch_demo_golden as dg
    from kernel_timing import device_ms, lbs_bound, lbs_inputs, profile_device
    import tepose_tpu_torch.models.smpl as smpl_mod
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch import demo, native
    from tepose_tpu_torch.config import parse_args
    from tepose_tpu_torch.evaluate import run_eval
    from tepose_tpu_torch.ops.geometry import batch_rodrigues
    from tepose_tpu_torch.evaluate import (
        filter_video_predictions, synthetic_eval_data, synthetic_j_regressor)
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.streaming.demo_utils import (
        convert_crop_cam_to_orig_img)
    from tepose_tpu_torch.streaming.engine import StreamingEngine

    res = {"card": card}
    golden = dg.load_golden()
    spec = golden["spec"]

    # (a) evaluate --filter through the entry point, then the golden
    cfg, _, args = parse_args([
        "--cfg", os.path.join(REPO, "configs", "repr_wopw_3dpw_model.yaml"),
        "--dataset", "3dpw"])
    launches, seconds = {}, {}
    for flt in (False, True):
        args.filter = flt
        lbs.LAUNCHES = 0
        r = run_eval(cfg, args, synthetic=True, device="cuda")
        torch.cuda.synchronize()
        launches[flt], seconds[flt] = lbs.LAUNCHES, r["seconds"]
        metrics = [r[k] for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel_err")]
        if not all(np.isfinite(v) for v in metrics):
            raise RuntimeError(f"non-finite metrics from run_eval --filter "
                               f"{flt}: {r}")
    args.filter = False
    n_videos = len(synthetic_eval_data())
    if launches[True] != launches[False] + n_videos:
        raise RuntimeError(f"--filter launched {launches[True]} LBS kernels, "
                           f"not {launches[False]} + {n_videos} videos")
    j14 = dg.port_filter(spec, golden["filter_theta"], "cuda")
    dev_f = float(np.abs(j14 - golden["filter_j14"]).max())
    # --filter's added time per video: the filter step itself on the
    # golden's video, timed alone (whole eval runs differ by more than it)
    smpl = synthetic_smpl_model(0, device="cuda")
    jreg = torch.as_tensor(synthetic_j_regressor(smpl.num_verts),
                           device="cuda")
    secs = host_seconds(lambda: filter_video_predictions(
        smpl, golden["filter_theta"], jreg), reps=5)
    res["filter_ms_per_video"] = 1e3 * float(np.median(secs))
    print(f"phase 9a: run_eval --filter synthetic 3dpw on cuda: lbs launches "
          f"{launches[True]} (unfiltered {launches[False]}, {n_videos} "
          f"videos), eval loop {seconds[True]:.3f} s (unfiltered "
          f"{seconds[False]:.3f} s); filter_video_predictions on the "
          f"golden's {len(j14)} thetas (V={spec['num_verts']}): J14 "
          f"deviation {dev_f:.3e} / {dg.FILTER_ATOL:.0e} m, "
          f"{res['filter_ms_per_video']:.2f} ms per video (median of "
          f"{[round(1e3 * x, 2) for x in secs]} ms, host clock to a "
          f"synchronise) [{card}]")
    if not dev_f <= dg.FILTER_ATOL:
        raise RuntimeError(f"--filter misses the JAX golden: {dev_f}")

    # (b) SMPLify on the card against the JAX golden
    kp = golden["kp_2d_target"]
    lbs.LAUNCHES = 0
    out = dg.port_smplify(spec, kp, "cuda")
    torch.cuda.synchronize()
    smplify_launches = lbs.LAUNCHES
    dev_s = dg.golden_deviation(dg.smplify_outputs(out, spec), golden)
    losses = out["losses"].cpu().numpy()
    print(f"phase 9b: smplify_refine on cuda (T={spec['T']}, "
          f"{spec['num_iters']} iterations, lr {spec['lr']}, "
          f"V={spec['num_verts']}): loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"lbs launches {smplify_launches}; deviation from the JAX golden "
          f"/ bar: " + ", ".join(f"{k} {d:.3e} / {b:.0e}"
                                 for k, (d, b) in dev_s.items()))
    bad = {k: v for k, v in dev_s.items() if not v[0] <= v[1]}
    if bad:
        raise RuntimeError(f"SMPLify misses the JAX golden: {bad}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"SMPLify's loss did not fall: {losses}")
    if smplify_launches != 1:
        raise RuntimeError(f"SMPLify launched {smplify_launches} LBS "
                           f"kernels; the objective must skin nothing and "
                           f"the final forward once")

    # (c) the offline demo after decode
    frames, boxes = demo_frames()
    det_path, json_dir = write_demo_inputs(boxes)
    common = ["--synthetic", "--gpu", "0", "--output_folder", DEMO_DIR,
              "--smooth"]
    dargs = demo.parse_args(common + ["--detections", det_path,
                                      "--sideview"])
    models = demo.build_demo_models(dargs)
    t0 = time.perf_counter()
    tracklets = demo.track(frames, dargs)
    track_s = time.perf_counter() - t0
    demo_out = demo.run_offline(frames, tracklets, models, dargs)
    if len(tracklets) != 2 or len(demo_out["results"]) != 2:
        raise RuntimeError(f"demo: {len(tracklets)} tracklets")
    lib = native.get_lib()
    if lib._name != str(native.library_path()) or not os.path.isfile(
            lib._name):
        raise RuntimeError(f"the native library {lib._name} is not the one "
                           f"built from source")
    engine = StreamingEngine(models.smpl, models.gen, models.vibe,
                             models.backbone)
    direct = engine.run_tracklets_from_crops(
        [demo.tracklet_crops(frames, tracklets[p])[1] for p in tracklets])
    dev_e = 0.0
    for a, b in zip(demo_out["engine_outputs"], direct):
        for k in b:
            scale = max(1.0, float(np.abs(b[k]).max()))
            dev_e = max(dev_e, float(np.abs(a[k] - b[k]).max()) / scale)
    if not dev_e <= 1e-6:
        raise RuntimeError(f"the demo's engine outputs differ from a direct "
                           f"run_tracklets_from_crops: {dev_e}")
    dev_v = 0.0
    plain_skin = smpl_mod.lbs_skinning
    smpl_mod.lbs_skinning = lbs.lbs_skinning_reference
    try:
        with torch.no_grad():
            for r in demo_out["results"].values():
                T = len(r["pose"])
                rot = batch_rodrigues(torch.as_tensor(
                    r["pose"].reshape(-1, 3), dtype=torch.float32,
                    device="cuda")).reshape(T, 24, 3, 3)
                ref = smpl_mod.smpl_forward(models.smpl, torch.as_tensor(
                    r["betas"], dtype=torch.float32, device="cuda"),
                    rot)["verts"].cpu().numpy()
                dev_v = max(dev_v, float(np.abs(ref - r["verts"]).max()))
    finally:
        smpl_mod.lbs_skinning = plain_skin
    if not dev_v <= KERNEL_ATOL:
        raise RuntimeError(f"--smooth verts differ from the plain einsum's: "
                           f"{dev_v}")
    # the network's random weights may put a mesh outside the frame, so
    # the same results are also drawn at an in-view camera, [0.9, 0, 0] in
    # each crop; either way pixels change only where the meshes project
    # (and, in view, in every frame)
    in_view = {p: dict(r, orig_cam=convert_crop_cam_to_orig_img(
        np.tile([0.9, 0.0, 0.0], (DEMO_T, 1)), r["bboxes"], DEMO_W, DEMO_H))
        for p, r in demo_out["results"].items()}
    changed_px = {}
    for name, results, rendered in (
            ("demo", demo_out["results"], demo_out["frames"]),
            ("in view", in_view,
             demo.render_frames(frames, in_view, models.faces, dargs))):
        if len(rendered) != DEMO_T or any(
                f.shape != (DEMO_H, 2 * DEMO_W, 3) for f in rendered):
            raise RuntimeError(f"rendered frames: {len(rendered)} of shape "
                               f"{rendered[0].shape}")
        changed_px[name] = [mesh_pixels(rendered[t][:, :DEMO_W], frames[t],
                                        results, t) for t in range(DEMO_T)]
    if min(changed_px["in view"]) == 0:
        raise RuntimeError("a frame with meshes in view rendered no mesh")
    print(f"phase 9c: demo --detections --smooth --sideview on cuda, "
          f"{DEMO_T} frames {DEMO_W}x{DEMO_H}, {len(tracklets)} tracklets: "
          f"engine vs direct run_tracklets_from_crops {dev_e:.1e} "
          f"(relative), smoothed verts vs plain einsum {dev_v:.3e} m, "
          f"rendered frames {(DEMO_H, 2 * DEMO_W, 3)}, mesh pixels per "
          f"frame " + ", ".join(f"{k} {min(v)}-{max(v)}"
                                for k, v in changed_px.items())
          + f"; native library "
          f"{os.path.basename(lib._name)}; lbs launches "
          f"{dict(demo_out['launches'])}")

    sargs = demo.parse_args(common + ["--tracking_method", "pose",
                                      "--staf_dir", json_dir,
                                      "--run_smplify"])
    t0 = time.perf_counter()
    pose_tracklets = demo.track(frames, sargs)
    track_s = min(track_s, time.perf_counter() - t0)
    if len(pose_tracklets) != 2 or not all(
            "joints2d" in v for v in pose_tracklets.values()):
        raise RuntimeError(f"pose tracklets: {list(pose_tracklets)}")
    demo.run_offline(frames, pose_tracklets, models, sargs)  # warm-up
    smp_out = demo.run_offline(frames, pose_tracklets, models, sargs)
    dl = smp_out["launches"]
    for stage in ("engine", "smooth", "smplify"):
        if not dl[stage] > 0:
            raise RuntimeError(f"demo stage {stage} never launched the lbs "
                               f"kernel: {dict(dl)}")
    for r in smp_out["results"].values():
        for k in ("verts", "pose", "betas", "joints3d", "kp_2d"):
            if not np.isfinite(r[k]).all():
                raise RuntimeError(f"demo --run_smplify: non-finite {k}")
    stages = {k: 1e3 * v["total_s"] for k, v in
              smp_out["timer"].summary().items()}
    stages["track"] = 1e3 * track_s
    res["demo_stage_ms"] = stages
    res["demo_launches"] = dict(dl)
    print(f"phase 9c: demo --tracking_method pose --run_smplify --smooth on "
          f"cuda ({len(pose_tracklets)} tracklets of {DEMO_T} frames): lbs "
          f"launches {dict(dl)}; stage ms " + ", ".join(
              f"{k} {v:.1f}" for k, v in stages.items()) + f" [{card}]")

    # (d) SMPLify per iteration, and the LBS kernel at the new sizes
    n_it = spec["num_iters"]
    secs = host_seconds(lambda: dg.port_smplify(spec, kp, "cuda"), reps=3)
    prof = profile_device(lambda: dg.port_smplify(spec, kp, "cuda"))
    res["smplify_ms_per_iter"] = 1e3 * float(np.median(secs)) / n_it
    res["smplify_s"] = secs
    if prof is None:
        res.update(smplify_kernels_per_iter="not measured",
                   smplify_idle_share="not measured")
    else:
        res.update(smplify_kernels_per_iter=prof["kernels"] / n_it,
                   smplify_idle_share=prof["idle_share"],
                   smplify_busy_ms=prof["busy_ms"],
                   smplify_span_ms=prof["span_ms"],
                   smplify_top_kernels_ms=prof["top_kernels_ms"],
                   smplify_top_host_ops_ms=prof["top_host_ops_ms"])
    print(f"phase 9d: smplify_refine T={spec['T']} on cuda: "
          f"{res['smplify_ms_per_iter']:.3f} ms/iteration (median of "
          f"{[round(x, 4) for x in secs]} s per {n_it} iterations, host "
          f"clock to a synchronise); kernels/iteration "
          f"{res['smplify_kernels_per_iter']}, idle share "
          f"{res['smplify_idle_share']} (one profiled run) [{card}]")

    rs = np.random.RandomState(9)
    res["lbs"] = {}
    for B in DEMO_LBS_BATCHES:
        wT, A, v = lbs_inputs(rs, B, LBS_V, torch.device("cuda"))
        err = float((lbs.lbs_skinning(wT, A, v)
                     - lbs.lbs_skinning_reference(wT, A, v)).abs().max())
        if not err <= KERNEL_ATOL:
            raise RuntimeError(f"lbs kernel disagrees at B={B}: {err}")

        def kernel():
            lbs.lbs_skinning(wT, A, v)

        def plain():
            lbs.lbs_skinning_reference(wT, A, v)

        times = {kernel: [], plain: []}
        for fn in (plain, kernel, kernel, plain):
            times[fn] += device_ms(fn, launches=50 if fn is kernel else 5)
        ms, plain_ms = (float(np.median(times[f])) for f in (kernel, plain))
        bound_ms, bound_by = lbs_bound(B, LBS_V, wT.shape[0])
        res["lbs"][B] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"phase 9d: lbs B={B} V={LBS_V} max_abs_err={err:.3e}; device "
              f"{ms:.5f} ms per launch, bound {bound_ms:.5f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of bound; plain einsum {plain_ms:.5f} ms "
              f"[{card}]")
    print(json.dumps({"demo_timings": res}))
    return {"launches": {"eval_filter": launches[True],
                         "smplify": smplify_launches,
                         "demo": int(sum(demo_out["launches"].values())
                                     + sum(dl.values()))},
            "lbs": res["lbs"]}


def main() -> None:
    card = phase0_device()
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    phase1_build()
    kern = phase2_kernel(card)
    sl = phase3_slice()
    phase4_golden()
    p5 = phase5_engine()
    p6 = phase6_live(p5)
    phase7_timings(p5, card)
    p8 = phase8_train(card)
    p9 = phase9_demo(card)
    big = max(LBS_BATCHES)
    bound_ms, bound_by = kern["bound"][big]
    by_path = {"eval": sl["launches"], "engine": p5["launches"],
               "live": p6["launches"], "train_validation": p8["launches"],
               **p9["launches"]}
    for B, r in p9["lbs"].items():
        kern["device_ms"][B], kern["plain_ms"][B] = r["ms"], r["plain_ms"]
        kern["bound"][B] = (r["bound_ms"], r["bound_by"])
        kern["max_abs_err"] = max(kern["max_abs_err"], r["max_abs_err"])
    print(json.dumps({"kernels": [{
        "name": "lbs_skinning", "route": "cuda",
        "source": "tepose_tpu_torch/csrc/lbs_skinning.cu",
        "replaces": "tepose_tpu/ops/lbs_pallas.py:76",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["device_ms"][big], "plain_ms": kern["plain_ms"][big],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": f"B={big} V={LBS_V} J=24",
        "device_ms_by_B": kern["device_ms"],
        "plain_ms_by_B": kern["plain_ms"],
        "bound_ms_by_B": {B: b[0] for B, b in kern["bound"].items()},
        "share_of_bound_by_B": {B: kern["bound"][B][0] / ms
                                for B, ms in kern["device_ms"].items()},
        "host_us_per_call": kern["host_us"],
        "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
