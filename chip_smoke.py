#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (tepose_tpu_torch) on one CUDA card.

  python3 chip_smoke.py
  python3 chip_smoke.py --timings   # phases 1, 5, 7 and 8c only

Phases, each of which raises on failure (no phase's error is caught):
  0. require CUDA; strict float32 (TF32 off for matmuls and cuDNN); print
     the card's name and power limit as nvidia-smi reports them;
  1. build every CUDA kernel of the port from csrc/ with nvcc, each
     library's seconds printed where `kernels.BUILD_SECONDS` has them;
  2. LBS skinning kernel against its plain PyTorch version on the card, at
     V = 6890 with B in {1, 3, 8, 32, 128, 192, 256} (the main path's launch sizes
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

 10. the release tools at full width: (a) and (b) `verify_release`'s
     self-test on cuda: a reference-layout release fabricated with the
     port's own fabricators (a 6890-vertex SMPL pkl, full-width TePose and
     VIBE .pth.tar checkpoints, plain-pickle eval DBs) in a temporary
     directory under build/chip_smoke_release/, converted by
     `convert_checkpoint` and `convert_smpl` and evaluated through
     `evaluate.run_eval` on the three self-test runs, with the LBS count
     zeroed before and required > 0 after, every metric finite, the
     paper's gate failing the random weights and the gate checked both
     ways; then `convert_checkpoint` forward -> --reverse --like ->
     forward giving equal arrays and the source's tensors back; (c)
     `utils.profiling.trace` around two windows of phase 8's training step,
     the trace parsed: kernels per window, the ten kernels with the most
     device time and the ten host ops whose kernels took most; (d) `counted_flops` on the card (backbone, encoder
     window, IEF + SMPL) against `model_flops_per_frame`, and the eval
     rollout at B = 32, T = 128: its FLOPs, time and share of
     `peak_flops(cuda, float32)`.

 11. offline DB building at full width (ResNet-50 on 224 x 224 crops, SMPL
     with 6890 vertices, VIBE 2 x 1024 at batch 450, strict float32),
     after printing which of cv2, PIL, h5py, joblib and scipy this host
     has: (a) a reference-layout 3DPW test split fabricated under
     build/chip_smoke_preprocess/ (one sequence pkl, 2 people x 24 frames,
     240 x 320 uint8 frames from a numpy seed, handed to the builder from
     memory through `imread`) built by
     `tepose_tpu_torch.preprocess.threedpw.read_data` on cuda, written by
     `data.db.save_db` and read back equal by `data.db.load_db`, held to
     the JAX golden (tests/golden/torch_port_preprocess_f32.npz, from
     tools/make_torch_preprocess_golden.py): host arrays equal, pose and
     joints3D within 1e-4, features within 1e-4 of their magnitude; (b)
     `preprocess.pseudo_theta.pseudo_thetas_for_features` on seeded
     features of videos of 500, 450 and 120 frames (a chunk and a tail,
     an exact chunk, a video shorter than a chunk) within 1e-6 of the
     golden, written by `write_db` and read back equal, and once more with
     TF32 allowed, a control that must miss that bar; each with the LBS
     count zeroed before and required > 0 after (pseudo-theta's skinned
     vertices are discarded, so (c) is what checks the kernel at
     B = 450); (c) timings: the
     extractor's host crops and its device features apart (1,024 crops
     at batch 256), pseudo-theta ms per 450-frame chunk with its kernels
     and idle share, and the LBS kernel at B = 450 against its plain
     version (error within 1e-5, device time, bound).

 12. the scale-out slice at full width on two shards of the card
     ([cuda:0, cuda:0]): (a) `run_eval(--synthetic, 3dpw,
     devices=make_mesh(devices=[cuda:0, cuda:0]))` with twice phase 3's
     LBS launches (one a shard where one device launched once) and its
     metrics within 1e-2 mm of phase 3's, and the sharded rollout's
     per-frame J14, theta and MPVPE within 1e-5 of one device, its
     launches at B/2; (b) data-parallel training at batch 40 = 24 2D + 16
     3D rows (both halves with rows whose videos end early and rows in the
     GAN), K = 3 windows at update rate 0.9 with dropout: world 1 over
     NCCL through `parallel.dp` against the plain segment, both in
     deterministic mode, losses within 1e-6 relative and every leaf within
     1e-6 of its magnitude (two plain segments in the default mode are
     printed apart: cuDNN's backward sums in any order); then world 2 as
     two processes on cuda:0 over gloo (`chip_smoke.py --dp-worker`)
     against world 1 at phase 8a's K = 3 bars; (c) `StreamingEngine`
     (8 tracklets x 128 uint8 frames, `parity`), `LiveSession` (2 streams,
     one reset) and `FeatureExtractor` (batch 256, 300 crops) with the
     mesh against the same without it, at phase 5's, 6's and 11's bars,
     each object's LBS launches counted alone: the mesh engine and live
     session launch twice what one device launches (live: twice phase
     6's); (d) eval ms per window with the mesh and without (B = 32,
     T = 128, in turns) and each one's kernels a window and idle share
     (`utils.profiling.profile_device`), training ms per window plain,
     at world 1 over NCCL and at world 2 over gloo, and the all-reduce's
     share of a traced segment (`utils.profiling.trace`); (e) `python -m
     tepose_tpu_torch.train --synthetic --devices 1 --smoke-iters 2`
     writes one logdir, and `--devices 2` on a one-card host exits
     non-zero naming the visible count. Its outputs go under
     build/chip_smoke_parallel/.
 13. bf16 training and evaluate's precision tiers, at full width: (a) the
     bf16 gate (tools/bf16_gate.py: one window with SGD at lr 1 in float32
     and in bf16 compute from the same weights and dropout draws; update
     cosine > 0.98, relative norm < 0.2, gen_loss and dis_loss within 5 %,
     metrics finite, every master parameter, gradient, optimizer state and
     BN statistic float32, no LBS launch) at batch 32 (19 + 13) and 128
     (76 + 52); (b) configs/fast_train.yaml as it stands (TRAIN.PRECISION
     bf16, batch 128) through `build_train_loop` and `fit`, one epoch of a
     few windows and validation on one batch (LBS launches > 0, finite
     metrics), then its checkpoint resumed bit-equal and still bf16; (c)
     float32 and bf16 at batch 32 and 128 and the shared fake
     discriminator pass, timed in turns: ms a window, samples x windows/s,
     kernels a window and idle share (`utils.profiling.profile_device`),
     peak memory; (d) `run_eval(--synthetic, 3dpw)` at each `--precision`
     tier (float32, tensorfloat32, bfloat16) with equal LBS launches, and
     each tier's rollout on phase 3's batch and on one 520-frame video
     against the port in float64 (skinned by the plain einsum as an
     oracle, `precision_sweep.plain_skinning`): max joint and MPVPE
     deviation in mm,
     frames/s, LBS launches; float32 must stay within 0.1 mm. Outputs
     under build/chip_smoke_bf16/.
 14. the eval tuning tools, full width: (a) `python -m
     tepose_tpu_torch.tune_eval_batching` on 3DPW and H36M at --scale 0.25
     (lengths clipped to 100 frames so a point costs about one chunk a
     bucket) over the 2 x 2 grid of MAX_B {the JAX CLI's,
     `evaluate.EVAL_BATCHING`'s} x bucket {none (the default), the JAX
     CLI's}, each row finite with LBS launches; (b) `run_eval(--synthetic,
     3dpw)` with the defaults and with --eval_batch 32 --eval_bucket 128
     (the JAX CLI's chunks): per-video J14 and MPVPE within 1e-6 m,
     frames/s and LBS launches of both; (c)
     `precision_sweep.measure_accuracy` (F = 66, B = 2): float32 within
     0.1 mm of float64. It first checks that phase 2 held the kernel at
     `EVAL_BATCHING`'s batches and at phase 3's. Outputs under
     build/chip_smoke_tuning/.
 15. InstaVariety without h5py (h5py put in sys.modules as None first),
     against tests/golden/torch_port_insta_f32.npz
     (tools/make_torch_insta_golden.py): (a) `preprocess.insta.read_data`
     builds insta_train_db.h5 on the card from 3 fabricated tfrecord shards
     through `data.h5.H5Writer`; `data.h5.open_h5` reads it back: host
     arrays equal to the JAX builder's, features within 1e-4 of their
     magnitude; (b) `preprocess.pseudo_theta.main(--file_name
     insta_train)` on it and on a DB of the JAX builder's features (LBS
     launches > 0), the latter's thetas within 1e-5 of their largest
     magnitude, which a TF32 control must miss; (c)
     `Insta` items against the JAX `Insta`'s; (d) `build_train_loop`
     without --synthetic, 2D rows from that file: 2 segments of 3
     windows, finite losses, ms a window; (e) `mpii3d.read_test_data` on
     the committed MATLAB v7.3-style annot_data.mat; (f) the writer's and
     the reader's MB/s on the features. Outputs under
     build/chip_smoke_insta/.
 16. the benchmark commands' functions at full width, with fewer reps and
     windows than their CLIs: `tepose_tpu_torch.bench.measure` (the plain
     and fast scans at B = 192 streams over 125 frames, 120 windows, under
     the float32 and tensorfloat32 tiers; the four engines and the
     device-only engine call on 8 x 120 uint8 224 x 224 crops; training
     segments of 4, 2 and 2 windows at batch 32 float32, 32 bf16 and 128
     bf16; one timed call each) and `bench.summarize`: every figure finite
     and none null, the LBS launches of the scans and the engine each > 0
     and summing to the count zeroed just before and read just after, and
     the fast scan's thetas within 5e-4 of the plain loop's (the bar of
     tests/test_torch_fast_encoder.py for the same pair); then
     `bench_notes.stage_breakdown` (its scans launch the kernel) and
     `bench_notes.render_benchmark`, finite.
 17. VIBE over image crops at full width: `vibe_demo_forward` (the
     bootstrap VIBE 2 x 1024, seqlen 16, ResNet-50, synthetic SMPL with
     6890 vertices, seeded weights, strict float32) on 2 videos x 16
     seeded uint8 224 x 224 crops through `normalize_crop`, with the LBS
     count zeroed just before and read just after (one launch at
     B T = 32): every output against the same call on the CPU (plain
     kernels, same weights and crops) at phases 5-6's bars; the LBS kernel
     on the inputs that call gave it against its plain version within
     1e-5; `TemporalAttention(2048, 16)`, tanh and relu, on (32, 16, 2048)
     against the CPU within 1e-5 with rows summing to 1 within 1e-5; then
     frames/s, the median of 5 calls after a warm-up, and in turns with
     them the ResNet-50 features of the 32 crops alone.

 18. ViT-H's linear layers (`ops/vit_linear.py`, the 3xTF32 kernel
     `csrc/vit_gemm_3xtf32.cu`): the library's build seconds as
     `kernels.build` recorded them; one 128-crop chunk of HMR 2.0's main
     path at the published widths (`StreamingEngine.run_tracklets_from_crops`
     with an `HMR2` of seeded weights on one tracklet of 128 seeded uint8
     256 x 256 crops, as `hmr2-engine-crops` runs it), with the kernel's
     count zeroed just before and read just after: one chunk, 4 launches
     for each of the ViT's 32 blocks, finite outputs; at the
     four linears' shapes (qkv, proj, fc1, fc2) for M = 24,576 (128 crops
     of 192 tokens, the main path), 2,112 (a call's last chunk of 11) and
     192 (one crop), the worst error from the float64 product of the
     kernel and of cuBLAS's strict float32 SGEMM (the kernel's within 4x
     of the SGEMM's) and of cuBLAS in TF32; then at M = 24,576 the device
     time per call of the kernel (`device_ms`, in turns with the others),
     of the plain version (`F.linear` and its GELU or residual add), of
     cuBLAS strict float32 alone (`library_ms`) and of cuBLAS TF32 for
     scale, beside the bounds: the products' flops at the 494.5 TFLOP/s
     TF32 peak, and three times that, 3xTF32's ceiling.

Phases 2, 9d and 11c also time the library call that computes the LBS
kernel's function, one `torch.einsum("jv,bjik,bvk->bvi")` over the top
rows of the transforms and the homogeneous vertices (built outside the
timed call), in turns with the kernel and its plain version.

With `--timings` it runs phases 0, 1, 5 and 7, and phase 8c on a fresh
training loop after one untimed segment, and prints no kernels or ok line:
a copy of this script at the root of another tree of the port (a parent
commit's `git archive`) times that tree the same way, in turns.

Before the last line it prints one JSON line with the kernels' routes,
launches per path, errors and times; the last line is the ok/device JSON
object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

KERNEL_ATOL = 1e-5       # fp32, as tests/test_lbs_pallas.py holds the kernel
# phase 2's shapes: the main path's launch sizes at V = 6890 (eval's 3 on
# phase 3's synthetic videos and EVAL_BATCHING's MAX_B 32 and 128, the mesh's
# and the bench's scans' 192, engine 8, live 1; phase 14 checks that eval's
# are here) and the large batch; ragged vertex counts; views at storage
# offset 1 for one and for four vertices per thread
LBS_V, LBS_BATCHES = 6890, (1, 3, 8, 32, 128, 192, 256)
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
    each = getattr(kernels, "BUILD_SECONDS", {})   # a parent tree may lack it
    print(f"phase 1: kernels built and loaded in {seconds:.2f} s "
          f"({''.join(f'{k} {v:.2f} s; ' for k, v in each.items())}"
          f"{kernels.BUILD_DIR})")
    return seconds


def lbs_times(wT, A, v, plain_launches: int) -> dict:
    """Device ms per launch, in turns plain/library/kernel/kernel/library/
    plain, of the LBS kernel, its plain einsum and the library call: one
    `torch.einsum("jv,bjik,bvk->bvi")` over the top three rows of the
    transforms and the homogeneous vertices, both built outside the timed
    call; and the library call's max abs error from the kernel."""
    from kernel_timing import device_ms
    from tepose_tpu_torch.ops.lbs_skinning import (
        lbs_skinning, lbs_skinning_reference)

    A3 = A[:, :, :3, :]
    vh = torch.cat([v, torch.ones_like(v[..., :1])], -1)

    def kernel():
        lbs_skinning(wT, A, v)

    def plain():
        lbs_skinning_reference(wT, A, v)

    def library():
        return torch.einsum("jv,bjik,bvk->bvi", wT, A3, vh)

    lib_err = float((library() - lbs_skinning(wT, A, v)).abs().max())
    times = {kernel: [], plain: [], library: []}
    for fn in (plain, library, kernel, kernel, library, plain):
        times[fn] += device_ms(fn, launches=50 if fn is kernel
                               else plain_launches)
    half = len(times[kernel]) // 2
    return {"ms": float(np.median(times[kernel])),
            "plain_ms": float(np.median(times[plain])),
            "library_ms": float(np.median(times[library])),
            "library_err": lib_err,
            "turns": (float(np.median(times[kernel][:half])),
                      float(np.median(times[kernel][half:])))}


def check_library(B: int, t: dict) -> None:
    """The library call computes the kernel's function."""
    if not t["library_err"] <= KERNEL_ATOL:
        raise RuntimeError(f"the one-einsum library call disagrees with the "
                           f"lbs kernel at B={B}: {t['library_err']}")


def phase2_kernel(card: str) -> dict:
    from kernel_timing import host_us_per_call, lbs_bound, lbs_inputs
    from tepose_tpu_torch.ops.lbs_skinning import (
        lbs_skinning, lbs_skinning_reference)

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    res = {"max_abs_err": 0.0, "device_ms": {}, "plain_ms": {},
           "library_ms": {}, "bound": {}}
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
        t = lbs_times(wT, A, v, plain_launches=10)
        ms, plain_ms = t["ms"], t["plain_ms"]
        bound_ms, bound_by = lbs_bound(B, LBS_V, wT.shape[0])
        res["device_ms"][B], res["plain_ms"][B] = ms, plain_ms
        res["library_ms"][B] = t["library_ms"]
        res["bound"][B] = (bound_ms, bound_by)
        check_library(B, t)
        print(f"phase 2: lbs B={B} V={LBS_V} device {ms:.5f} ms per launch "
              f"(turns {t['turns'][0]:.5f}/{t['turns'][1]:.5f}), bound "
              f"{bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.1%} of bound; "
              f"plain einsum {plain_ms:.5f} ms; library call (one einsum) "
              f"{t['library_ms']:.5f} ms, max abs err {t['library_err']:.3e}"
              f"{' -- FASTER than the kernel' if t['library_ms'] < ms else ''}"
              f" [{card}]")
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
    return {"launches": launches, "metrics": metrics,
            "ms_per_frame": 1e3 * res["seconds"] / res["frames"]}


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
    from tepose_tpu_torch.parallel.mesh import upload
    from tepose_tpu_torch.precision import device_scope
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
    res.update(setup=setup, engine_crops=crops)
    return res


TRAIN_WINDOWS, TRAIN_TIMED_SEGMENTS = 20, 4


def phase8_train(card: str) -> dict:
    import make_torch_train_golden as tg
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.config import update_cfg
    from tepose_tpu_torch.train.optim import opt_state_leaves
    from tepose_tpu_torch.train.run import build_train_loop, run_train

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
    _, train_two_windows = train_timings(fresh, card, launches)
    return {"launches": launches, "train_two_windows": train_two_windows}


def train_timings(loop, card: str, validation_launches=None) -> tuple:
    """Phase 8c on a built training loop: TRAIN_TIMED_SEGMENTS segments'
    host seconds, one profiled segment, one validation batch. Returns the
    timings and a two-window training step (phase 10's trace)."""
    from tepose_tpu_torch.utils.profiling import profile_device
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.train.run import close_loaders
    from tepose_tpu_torch.train.trainer import train_segment

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
    # two windows of the same training step, for phase 10's trace
    amass2 = loop._amass_windows(itd, 2, B)

    def train_two_windows():
        train_segment(loop.gen, loop.disc, loop.smpl, loop.gen_opt,
                      loop.disc_opt, hp, loop.weights, b2, b3, amass2,
                      loop.generator)
    close_loaders(loop)
    res = {"card": card, "train_ms_per_window": 1e3 * med / TRAIN_WINDOWS,
           "samples_windows_per_s": B * TRAIN_WINDOWS / med,
           "segment_s": loop.segment_seconds, "peak_memory_gb": peak_gb,
           "validation_ms_per_window": 1e3 * val_s / max(val_windows, 1),
           "validation_launches": validation_launches}
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
    return res, train_two_windows


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
    from kernel_timing import lbs_bound, lbs_inputs
    from tepose_tpu_torch.utils.profiling import profile_device
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
        t = lbs_times(wT, A, v, plain_launches=5)
        check_library(B, t)
        ms, plain_ms = t["ms"], t["plain_ms"]
        bound_ms, bound_by = lbs_bound(B, LBS_V, wT.shape[0])
        res["lbs"][B] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=t["library_ms"], bound_ms=bound_ms,
                             bound_by=bound_by)
        print(f"phase 9d: lbs B={B} V={LBS_V} max_abs_err={err:.3e}; device "
              f"{ms:.5f} ms per launch, bound {bound_ms:.5f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of bound; plain einsum {plain_ms:.5f} ms; "
              f"library call {t['library_ms']:.5f} ms [{card}]")
    print(json.dumps({"demo_timings": res}))
    return {"launches": {"eval_filter": launches[True],
                         "smplify": smplify_launches,
                         "demo": int(sum(demo_out["launches"].values())
                                     + sum(dl.values()))},
            "lbs": res["lbs"]}


RELEASE_DIR = os.path.join(REPO, "build", "chip_smoke_release")
MFU_B, MFU_T = 32, 128      # the eval rollout at the 3dpw batch


def eval_rollout_flops(B: int, T: int, S: int, V: int) -> float:
    """Analytic FLOPs of `eval_rollout` over B videos of T frames (2 x 1024
    GRUs, 2048-d features): per window the TePose encoder, IEF, the
    predicted and the ground-truth SMPL; once per video the causal VIBE
    bootstrap over S frames and the bootstrap frames' ground-truth SMPL."""
    from tepose_tpu_torch.utils import flops as F

    W = T - S + 1
    window = (F.encoder_window_flops(S, 2, 1024) + F.regressor_ief_flops()
              + 2 * F.smpl_flops(V))
    vibe = (F.gru_flops(S, 2048, 1024, 2, False) + S * 2 * 1024 * 2048
            + S * (F.regressor_ief_flops() + F.smpl_flops(V)))
    return float(B * (W * window + vibe + (S - 1) * F.smpl_flops(V)))


def phase10_release(card: str, p5: dict, p8: dict) -> dict:
    import shutil
    import tempfile

    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch import verify_release as VR
    from tepose_tpu_torch.convert_checkpoint import (
        convert_forward, convert_reverse)
    from tepose_tpu_torch.eval.evaluator import eval_rollout
    from tepose_tpu_torch.evaluate import synthetic_j_regressor
    from tepose_tpu_torch.precision import device_scope
    from tepose_tpu_torch.utils import flops as F
    from tepose_tpu_torch.utils.profiling import trace
    from tepose_tpu_torch.weights import flatten_tree, load_checkpoint

    res = {"card": card}
    shutil.rmtree(RELEASE_DIR, ignore_errors=True)
    os.makedirs(RELEASE_DIR)
    with tempfile.TemporaryDirectory(dir=RELEASE_DIR) as tmp:
        # (a) + (b): fabricate a full-size release with the port's own
        # fabricators, convert it and verify it on the card
        lbs.LAUNCHES = 0
        t0 = time.perf_counter()
        report = VR.self_test("cuda", VR.SELFTEST_KEYS, workdir=tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lbs.LAUNCHES
        if launches <= 0:
            raise RuntimeError("verify_release never launched the lbs kernel")
        if set(report["runs"]) != set(VR.SELFTEST_KEYS):
            raise RuntimeError(f"verify_release ran {sorted(report['runs'])}")
        pa = {}
        for key, rr in report["runs"].items():
            vals = [r["measured"] for r in rr["metrics"].values()]
            if not all(v is not None and np.isfinite(v) for v in vals):
                raise RuntimeError(f"verify_release {key}: non-finite "
                                   f"metrics {rr['metrics']}")
            pa[key] = rr["metrics"]["pa_mpjpe"]["measured"]
        res.update(verify_wall_s=wall, verify_launches=launches,
                   pa_mpjpe_mm=pa, eval_s={k: r["raw"]["seconds"] for k, r
                                           in report["runs"].items()})
        print(f"phase 10b: verify_release self-test on cuda ({len(pa)} runs, "
              f"6890-vertex SMPL, full-width TePose and VIBE, plain-pickle "
              f"DBs): PA-MPJPE mm " + ", ".join(
                  f"{k} {v:.4f}" for k, v in pa.items())
              + f"; all metrics finite, random weights fail the paper gate; "
              f"lbs launches {launches} (the CUDA kernel); wall "
              f"{wall:.2f} s with fabrication and conversion, eval loops "
              + ", ".join(f"{v:.3f}" for v in res["eval_s"].values())
              + f" s [{card}]")

        # (a) --reverse then forward again gives the same arrays
        fab = os.path.join(tmp, "fabricated")
        src = os.path.join(fab, VR._ckpt_npz_name(
            VR.SELFTEST_KEYS[0].split(":")[1]).replace(".npz", ".pth.tar"))
        npz1, pth, npz2 = (os.path.join(tmp, n) for n in (
            "rt1.npz", "rt.pth.tar", "rt2.npz"))
        convert_forward(src, npz1, "tepose")
        convert_reverse(npz1, pth, like=src)
        convert_forward(pth, npz2, "tepose")
        a, b = (flatten_tree(load_checkpoint(p)[0]) for p in (npz1, npz2))
        if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k])
                                           for k in a):
            raise RuntimeError("--reverse then forward changed the arrays")
        srcsd = torch.load(src, weights_only=False)["gen_state_dict"]
        back = torch.load(pth, weights_only=False)["gen_state_dict"]
        if srcsd.keys() != back.keys() or not all(
                torch.equal(srcsd[k], back[k]) for k in srcsd):
            raise RuntimeError("--reverse did not give back the source's "
                               "tensors")
        print(f"phase 10a: convert_checkpoint forward -> --reverse --like -> "
              f"forward on {os.path.basename(src)}: {len(a)} arrays equal, "
              f"{len(srcsd)} source tensors given back exactly")

    # (c) the training step's kernels, attributed
    with trace(os.path.join(RELEASE_DIR, "profile"), "cuda") as tr:
        p8["train_two_windows"]()
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict = {}
    n_kernels = 0
    for e in events:
        if e.get("cat") == "kernel":
            n_kernels += 1
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0)
    if not n_kernels:
        raise RuntimeError(f"the trace {tr.path} holds no kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy_us = sum(by_name.values())
    # the host ops that launched them: each aten op's own kernels' device
    # time (the averages also list the kernels and annotations themselves)
    ops = sorted((a for a in tr.profiler.key_averages()
                  if a.device_type == torch.autograd.DeviceType.CPU
                  and not getattr(a, "is_user_annotation", False)),
                 key=lambda a: -a.self_device_time_total)[:10]
    res.update(train_trace_kernels_per_window=n_kernels / 2,
               train_trace_kernel_us_per_window=busy_us / 2,
               train_trace_top10_us=[(n[:200], t) for n, t in top],
               train_trace_top10_ops_us=[
                   (a.key, a.self_device_time_total, a.count) for a in ops])
    print(f"phase 10c: trace of 2 training windows (batch 32, full width) "
          f"-> {os.path.relpath(tr.path, REPO)}: {n_kernels} kernels "
          f"({n_kernels / 2:.1f} a window), {busy_us / 2e3:.3f} ms of "
          f"kernel time a window; top 10 by device time: " + "; ".join(
              f"{n[:70]} {t:.1f} us" for n, t in top) + "; top 10 host ops "
          "by their kernels' device time (us, calls): " + "; ".join(
              f"{a.key} {a.self_device_time_total:.1f} {a.count}"
              for a in ops) + f" [{card}]")

    # (d) FLOPs counted on the card against the formulas, and the eval
    # rollout's achieved rate
    setup = p5["setup"]
    gen, vibe, smpl, bb = (setup[k] for k in ("gen", "vibe", "smpl",
                                              "backbone"))
    dev, S, V = smpl.v_template.device, gen.cfg.seqlen, smpl.num_verts
    rs = np.random.RandomState(10)
    parts = F.model_flops_per_frame(S, 2, 1024, V)
    with device_scope():
        counted = {
            "backbone": F.counted_flops(bb, torch.zeros(1, 3, 224, 224,
                                                        device=dev)),
            "encoder_window": F.counted_flops(
                gen.encoder, torch.zeros(1, S, 2048 + 85, device=dev)),
            "ief+smpl": F.counted_flops(
                gen.regressor, torch.zeros(1, 2048, device=dev), smpl)}
    analytic = {"backbone": parts["backbone"],
                "encoder_window": parts["encoder_window"],
                "ief+smpl": parts["ief"] + parts["smpl"]}
    res.update(counted_flops=counted, analytic_flops=analytic)
    print("phase 10d: FLOPs per frame counted on cuda (FlopCounterMode, "
          "cuDNN GRU mapped) / analytic: " + ", ".join(
              f"{k} {counted[k]:.4e} / {analytic[k]:.4e} "
              f"({counted[k] / analytic[k]:.3f})" for k in analytic))
    feats = torch.from_numpy(rs.randn(MFU_B, MFU_T, 2048).astype(np.float32)
                             * 0.5).to(dev)
    pseu = torch.zeros(MFU_B, S - 1, 85, device=dev)
    pseu[..., 0] = 1.0
    gt = torch.from_numpy(rs.randn(MFU_B, MFU_T, 85).astype(np.float32)
                          * 0.2).to(dev)
    jreg = torch.as_tensor(synthetic_j_regressor(V), device=dev)
    W = MFU_T - S + 1

    def rollout():
        with device_scope():
            eval_rollout(gen, vibe, smpl, feats, pseu, gt, jreg, W)

    secs = host_seconds(rollout, reps=3)
    flops_analytic = eval_rollout_flops(MFU_B, MFU_T, S, V)
    flops_counted = F.counted_flops(rollout)
    peak = F.peak_flops(dev, torch.float32)
    rate = flops_analytic / float(np.median(secs))
    res.update(eval_rollout_s=secs, eval_flops_analytic=flops_analytic,
               eval_flops_counted=flops_counted, eval_flops_per_s=rate,
               peak_fp32_flops=peak,
               eval_share_of_fp32_peak=None if peak is None else rate / peak)
    share = ("no peak entry for this card" if peak is None
             else f"{rate / peak:.4%} of the {peak:.3e} FLOP/s fp32 peak")
    print(f"phase 10d: eval rollout B={MFU_B} T={MFU_T} ({W} windows, "
          f"2x1024, V={V}, strict fp32): {flops_analytic:.4e} FLOPs "
          f"(analytic; counted on cuda {flops_counted:.4e}) in "
          f"{np.median(secs):.4f} s (median of "
          f"{[round(x, 4) for x in secs]} s, host clock to a synchronise) = "
          f"{rate:.4e} FLOP/s, {share} [{card}]")
    print(json.dumps({"release_tools": res}))
    return {"launches": launches}


# phase 11's shapes: the extractor's timing batch, the pseudo-theta chunk
# (the VIBE batch of `tools/preprocess/pseudo_theta.py`), which is also the
# skinning kernel's new launch size
PRE_DIR = os.path.join(REPO, "build", "chip_smoke_preprocess")
EXTRACT_CROPS, EXTRACT_BATCH = 1024, 256
PRE_LBS_BATCH = 450


@contextlib.contextmanager
def tf32_scope():
    """TF32 allowed for matmuls and cuDNN (what `device_scope` clears),
    inference mode on."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def pseudo_thetas_tf32(vid, feats, setup: dict, batch: int) -> np.ndarray:
    """`pseudo_thetas_for_features` with TF32 allowed: the control a
    pseudo-theta bar must tell from strict fp32."""
    from tepose_tpu_torch.preprocess import pseudo_theta

    strict_scope, pseudo_theta.device_scope = (pseudo_theta.device_scope,
                                               tf32_scope)
    try:
        return pseudo_theta.pseudo_thetas_for_features(
            vid, feats, setup["vibe"], setup["smpl"], batch)
    finally:
        pseudo_theta.device_scope = strict_scope


def phase11_preprocess(card: str) -> dict:
    import importlib
    import shutil

    import make_torch_preprocess_golden as pg
    from kernel_timing import device_ms, lbs_bound, lbs_inputs
    from tepose_tpu_torch.utils.profiling import profile_device
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.data.db import (
        load_db, load_pseudotheta, save_db, write_db)
    from tepose_tpu_torch.data.preprocess import FeatureExtractor
    from tepose_tpu_torch.models.backbone import (
        normalize_crop, resnet50_features)
    from tepose_tpu_torch.native import crop_normalize
    from tepose_tpu_torch.preprocess import pseudo_theta, threedpw
    from tepose_tpu_torch.precision import device_scope

    def importable(name: str):
        try:
            importlib.import_module(name)
        except ImportError as e:
            return f"{type(e).__name__}: {e}"[:120]
        return True

    res = {"card": card}
    have = {m: importable(m) for m in ("cv2", "PIL", "h5py", "joblib",
                                       "scipy.io")}
    res["host_libraries"] = have
    print(f"phase 11: host libraries on this machine (true, or why the "
          f"import failed): {json.dumps(have)}")
    golden = pg.load_golden()
    spec = golden["spec"]
    setup = pg.port_setup(spec, "cuda")
    sums = pg.weight_checksums(setup)
    if not np.allclose(sums, golden["weight_checksums"], rtol=1e-9, atol=0):
        raise RuntimeError(
            f"weights rebuilt from the preprocess golden's seeds differ from "
            f"the golden's ({sums} vs {golden['weight_checksums']})")
    shutil.rmtree(PRE_DIR, ignore_errors=True)
    folder, frames = pg.fabricate_3dpw(PRE_DIR, spec)
    db_dir = os.path.join(PRE_DIR, "db")

    # (a) the 3DPW builder on the card, frames from memory; the DB file
    # written and read back
    lbs.LAUNCHES = 0
    t0 = time.perf_counter()
    db = threedpw.read_data(folder, "test", backbone=setup["backbone"],
                            smpl=setup["smpl"], j_regressor=setup["jreg"],
                            device="cuda", imread=frames.__getitem__)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    db_launches = lbs.LAUNCHES
    if db_launches <= 0:
        raise RuntimeError("the 3DPW builder never launched the lbs kernel")
    path = save_db(db, "3dpw_test", db_dir)
    back = load_db(path)
    if back.keys() != db.keys() or not all(
            back[k].dtype == db[k].dtype and np.array_equal(back[k], db[k])
            for k in db):
        raise RuntimeError(f"{path} read back differs from what was written")

    # (b) pseudo-thetas on the card, written and read back
    vid, feats = pg.pseudo_inputs(spec)
    lbs.LAUNCHES = 0
    thetas = pseudo_theta.pseudo_thetas_for_features(
        vid, feats, setup["vibe"], setup["smpl"], spec["vibe_batch"])
    torch.cuda.synchronize()
    pse_launches = lbs.LAUNCHES
    # pseudo-theta keeps only theta, so these launches skin vertices that no
    # comparison reads: the count shows the path runs the kernel at B = 450,
    # and (c) holds the kernel's output at B = 450 against the einsum
    if pse_launches <= 0:
        raise RuntimeError("pseudo-theta never launched the lbs kernel")
    pse_path = write_db(thetas, os.path.join(db_dir,
                                             "3dpw_test_pseudotheta.pt"))
    if not np.array_equal(load_pseudotheta(pse_path), thetas):
        raise RuntimeError(f"{pse_path} read back differs")

    dev = pg.golden_deviation(pg.golden_outputs(back, thetas, folder),
                              golden)
    res.update(deviation=dev, build_s=build_s, db_rows=len(db["vid_name"]),
               launches={"preprocess_3dpw": db_launches,
                         "pseudo_theta": pse_launches})
    print(f"phase 11a: threedpw.read_data test split on cuda ({spec['people']}"
          f" people x {spec['frames']} frames of {spec['height']} x "
          f"{spec['width']}, ResNet-50 on 224^2 crops, V={spec['num_verts']})"
          f" -> {len(db['vid_name'])} rows in {build_s:.3f} s; {path} read "
          f"back equal; host arrays equal to the JAX golden; lbs launches "
          f"{db_launches}; deviation / bar: " + ", ".join(
              f"{k} {d:.3e} / {bar:.3e}" for k, (d, bar) in dev.items()
              if k != "pseudo_theta"))
    print(f"phase 11b: pseudo_thetas_for_features on cuda (VIBE "
          f"{spec['vibe_n_layers']} x {spec['vibe_hidden_size']}, videos of "
          f"{spec['pseudo_lengths']} frames at batch {spec['vibe_batch']}) "
          f"-> {thetas.shape}; {pse_path} read back equal; lbs launches "
          f"{pse_launches}; deviation from the JAX golden / bar: "
          f"{dev['pseudo_theta'][0]:.3e} / {dev['pseudo_theta'][1]:.1e}")
    bad = {k: v for k, v in dev.items() if not v[0] <= v[1]}
    if bad:
        raise RuntimeError(f"offline DB building misses its golden: {bad}")

    # the control: the same pseudo-thetas with TF32 allowed (the flags that
    # `device_scope` clears); the theta bar must tell it from strict fp32
    tf32 = pseudo_thetas_tf32(vid, feats, setup, spec["vibe_batch"])
    tf32_dev = float(np.abs(tf32 - golden["pseudo_theta"]).max())
    res["pseudo_theta_tf32_deviation"] = tf32_dev
    print(f"phase 11b: control with TF32 allowed: pseudo-thetas "
          f"{tf32_dev:.3e} from the golden (strict fp32 "
          f"{dev['pseudo_theta'][0]:.3e}, bar {dev['pseudo_theta'][1]:.1e})")
    if not tf32_dev > dev["pseudo_theta"][1]:
        raise RuntimeError(
            f"the theta bar {dev['pseudo_theta'][1]:.1e} does not tell "
            f"TF32 ({tf32_dev:.3e}) from strict fp32")

    # (c) timings: the extractor's host crops and device features apart,
    # VIBE per 450-frame chunk, the skinning kernel at B = 450
    rs = np.random.RandomState(11)
    imgs = list(frames.values())
    H, W = spec["height"], spec["width"]
    boxes = np.stack([rs.uniform(0.3, 0.7, EXTRACT_CROPS) * W,
                      rs.uniform(0.3, 0.7, EXTRACT_CROPS) * H,
                      rs.uniform(80, 200, EXTRACT_CROPS),
                      rs.uniform(80, 200, EXTRACT_CROPS)], 1).astype(
        np.float32)
    crops = np.empty((EXTRACT_CROPS, 3, 224, 224), np.uint8)
    t0 = time.perf_counter()
    for i in range(EXTRACT_CROPS):   # one call a crop, as the builders crop
        crops[i] = crop_normalize(imgs[i % len(imgs)], boxes[i:i + 1], 224,
                                  1.3, normalize=False)[0]
    crop_s = time.perf_counter() - t0
    fe = FeatureExtractor(setup["backbone"], batch_size=EXTRACT_BATCH)
    fe_s = host_seconds(lambda: fe.features_from_crops(crops), reps=3)
    fe_prof = profile_device(lambda: fe.features_from_crops(crops))
    x = torch.from_numpy(crops[:EXTRACT_BATCH]).cuda()

    def one_batch():
        with device_scope():
            resnet50_features(setup["backbone"], normalize_crop(x))

    batch_ms = float(np.median(device_ms(one_batch, launches=2, reps=5)))
    res.update(
        crop_host_s=crop_s, crops_per_s_host_crop=EXTRACT_CROPS / crop_s,
        features_s=fe_s,
        crops_per_s_features=EXTRACT_CROPS / float(np.median(fe_s)),
        device_ms_per_batch=batch_ms,
        crops_per_s_device=1e3 * EXTRACT_BATCH / batch_ms,
        features_idle_share=None if fe_prof is None
        else fe_prof["idle_share"])
    print(f"phase 11c: extractor at batch {EXTRACT_BATCH}, {EXTRACT_CROPS} "
          f"uint8 224^2 crops: host crops (native, one call a crop) "
          f"{crop_s:.3f} s = {res['crops_per_s_host_crop']:.1f} crops/s; "
          f"features_from_crops {np.median(fe_s):.3f} s (median of "
          f"{[round(t, 4) for t in fe_s]}, upload + ResNet-50 + readback, "
          f"host clock) = {res['crops_per_s_features']:.1f} crops/s, idle "
          f"share {res['features_idle_share']}; device time per batch of "
          f"{EXTRACT_BATCH} (normalise + ResNet-50, strict fp32) "
          f"{batch_ms:.3f} ms = {res['crops_per_s_device']:.1f} crops/s "
          f"[{card}]")

    n = PRE_LBS_BATCH
    one_vid, one_feats = vid[:n], feats[:n]
    if len(set(one_vid)) != 1:
        raise RuntimeError("the first pseudo-theta video is under a chunk")

    def chunk():
        pseudo_theta.pseudo_thetas_for_features(
            one_vid, one_feats, setup["vibe"], setup["smpl"], n)

    chunk_s = host_seconds(chunk, reps=5)
    prof = profile_device(chunk)
    res.update(pseudo_ms_per_chunk=1e3 * float(np.median(chunk_s)),
               pseudo_chunk_s=chunk_s)
    if prof is None:
        res.update(pseudo_kernels_per_chunk="not measured",
                   pseudo_idle_share="not measured")
    else:
        res.update(pseudo_kernels_per_chunk=prof["kernels"],
                   pseudo_idle_share=prof["idle_share"],
                   pseudo_busy_ms=prof["busy_ms"],
                   pseudo_top_kernels_ms=prof["top_kernels_ms"])
    print(f"phase 11c: pseudo-theta {res['pseudo_ms_per_chunk']:.3f} ms per "
          f"{n}-frame chunk (VIBE {spec['vibe_n_layers']} x "
          f"{spec['vibe_hidden_size']} + IEF + SMPL V={spec['num_verts']}"
          f", median of {[round(t, 4) for t in chunk_s]} s, host clock to a "
          f"synchronise and the readback); kernels per chunk "
          f"{res['pseudo_kernels_per_chunk']}, idle share "
          f"{res['pseudo_idle_share']} (one profiled chunk) [{card}]")

    wT, A, v = lbs_inputs(rs, n, LBS_V, torch.device("cuda"))
    err = float((lbs.lbs_skinning(wT, A, v)
                 - lbs.lbs_skinning_reference(wT, A, v)).abs().max())
    if not err <= KERNEL_ATOL:
        raise RuntimeError(f"lbs kernel disagrees at B={n}: {err}")
    t = lbs_times(wT, A, v, plain_launches=5)
    check_library(n, t)
    ms, plain_ms = t["ms"], t["plain_ms"]
    bound_ms, bound_by = lbs_bound(n, LBS_V, wT.shape[0])
    res["lbs"] = {n: dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=t["library_ms"], bound_ms=bound_ms,
                          bound_by=bound_by)}
    print(f"phase 11c: lbs B={n} V={LBS_V} max_abs_err={err:.3e}; device "
          f"{ms:.5f} ms per launch, bound {bound_ms:.5f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of bound; plain einsum {plain_ms:.5f} ms; "
          f"library call {t['library_ms']:.5f} ms [{card}]")
    print(json.dumps({"preprocess_timings": res}, default=str))
    return {"launches": res["launches"], "lbs": res["lbs"]}


# phase 12: the scale-out paths on one card. Two shards of cuda:0 stand in
# for two devices; the data-parallel batch is 40 = 24 2D + 16 3D rows (the
# config's 32 splits 19 + 13, which no world of 2 divides)
PAR_DIR = os.path.join(REPO, "build", "chip_smoke_parallel")
PAR_DEVICES = ["cuda:0", "cuda:0"]
DP_N2D, DP_N3D, DP_K, DP_RATE, DP_TIMED = 24, 16, 3, 0.9, 2
DP_TIMEOUT = 600


def dp_spec():
    import make_torch_train_golden as tg

    return dict(tg.FULL_SPEC, n_2d=DP_N2D, n_3d=DP_N3D, windows=(DP_K,))


def dp_setup():
    """Full-width training models on cuda:0 and one batch of 24 + 16 rows
    at update_theta_rate 0.9, the 3D rows of both halves with videos that
    end after window 1 and rows in the GAN (different counts a half)."""
    import dataclasses

    import make_torch_train_golden as tg

    setup = tg.port_setup(dp_spec(), "cuda")
    setup["hp"] = dataclasses.replace(setup["hp"], update_theta_rate=DP_RATE)
    b3 = setup["batch_3d"]
    b3["vidlen_each"][DP_N3D - 3:] = setup["hp"].seqlen + 1
    b3["w_smpl"][DP_N3D - 2:] = 0.0
    return setup


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and torch's deterministic mode
    (warnings only where an op has none): two runs of one segment then
    agree bit for bit. By default cuDNN's convolution backward may sum in
    any order, and Adam turns float-noise gradients into steps of lr."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.backends.cudnn.benchmark = saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def leaf_deviation(got: dict, want: dict) -> float:
    """The largest deviation of any parameter or BN statistic, relative to
    that array's magnitude."""
    return max(float(np.abs(got[g][k] - v).max() / max(np.abs(v).max(),
                                                        1e-12))
               for g in ("gen", "disc", "disc_state")
               for k, v in want[g].items())


def dp_draws():
    return torch.Generator(device="cuda").manual_seed(5)


def dp_segment(setup, sharded: bool) -> dict:
    """One DP_K-window segment with dropout; returns losses and state."""
    import make_torch_train_golden as tg
    from tepose_tpu_torch.parallel import dp
    from tepose_tpu_torch.train.trainer import train_segment

    args = (setup["gen"], setup["disc"], setup["smpl"], setup["gen_opt"],
            setup["disc_opt"], setup["hp"], setup["weights"])
    batches = (setup["batch_2d"], setup["batch_3d"], setup["amass"])
    if sharded:
        losses = dp.sharded_train_segment(*args, *dp.local_batches(*batches),
                                          dp_draws())
    else:
        losses = train_segment(*args, *batches, dp_draws())
    torch.cuda.synchronize()
    return {"losses": losses, **tg.port_state(setup)}


def all_reduce_share(prof, span_ms: float) -> dict:
    """The collectives' time in a `utils.profiling.trace` of a segment that
    took `span_ms` (host clock, under the profiler): host time inside
    `tepose:all_reduce` spans and device time of NCCL kernels (none at
    world size 1), and the larger as a share of the span."""
    host_us = dev_us = 0.0
    for k in prof.key_averages():
        if k.key == "tepose:all_reduce":
            host_us += k.cpu_time_total
        elif "nccl" in k.key.lower():
            dev_us += getattr(k, "device_time_total",
                              getattr(k, "cuda_time_total", 0.0))
    return {"host_ms": host_us / 1e3, "nccl_device_ms": dev_us / 1e3,
            "share": max(host_us, dev_us) / 1e3 / span_ms}


def dp_timed(setup, sharded: bool, trace_dir) -> dict:
    """DP_TIMED segments' host ms per window (to a synchronise), then one
    traced segment's all-reduce share (`trace_dir` None: not traced)."""
    from tepose_tpu_torch.utils.profiling import trace

    secs = []
    for _ in range(DP_TIMED):
        t0 = time.perf_counter()
        dp_segment(setup, sharded)
        secs.append(time.perf_counter() - t0)
    out = {"ms_per_window": 1e3 * float(np.median(secs)) / DP_K,
           "segment_s": secs}
    if trace_dir is None:
        dp_segment(setup, sharded)
        return out
    with trace(trace_dir, "cuda") as t:
        t0 = time.perf_counter()
        dp_segment(setup, sharded)
        span_ms = 1e3 * (time.perf_counter() - t0)
    out["all_reduce"] = dict(all_reduce_share(t.profiler, span_ms),
                             traced_segment_ms=span_ms)
    return out


def dp_worker(argv) -> None:
    """One rank of phase 12b's world 2: `RANK WORLD PORT OUT`, on cuda:0
    over gloo; rank 0 writes the state after one segment and the timings."""
    from tepose_tpu_torch.parallel import distributed

    rank, world, port, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.maybe_initialize(f"localhost:{port}", world, rank,
                                 backend="gloo", timeout_s=DP_TIMEOUT)
    try:
        setup = dp_setup()
        got = dp_segment(setup, sharded=True)
        timing = dp_timed(setup, True, os.path.join(PAR_DIR, "trace_gloo")
                          if rank == 0 else None)
    finally:
        distributed.shutdown()
    if rank == 0:
        flat = {f"{g}/{k}": v for g in ("gen", "disc", "disc_state")
                for k, v in got[g].items()}
        np.savez(out, **flat)
        with open(out + ".json", "w") as f:
            json.dump({"losses": got["losses"], "timing": timing}, f)


def dp_deviation(got: dict, want: dict) -> dict:
    """(largest deviation, bar) at phase 8a's K = 3 bars: losses relative
    (1e-3), BN running statistics relative to each array's magnitude
    (1e-3), every leaf absolute (2 K lr of its optimizer)."""
    spec = dp_spec()
    dev = {"losses": (max(abs(got["losses"][k] - v) / max(abs(v), 1e-12)
                          for k, v in want["losses"].items()), 1e-3),
           "bn_stats": (max(float(np.abs(got["disc_state"][k] - v).max()
                                  / max(np.abs(v).max(), 1e-12))
                            for k, v in want["disc_state"].items()
                            if k.endswith(("running_mean", "running_var"))),
                        1e-3)}
    for g, lr in (("gen", spec["gen_lr"]), ("disc", spec["disc_lr"])):
        dev[f"{g}_leaves"] = (max(float(np.abs(got[g][k] - v).max())
                                  for k, v in want[g].items()),
                              2.0 * DP_K * lr)
    return dev


def phase12_parallel(card: str, p3: dict, p6: dict, p7: dict) -> dict:
    """The scale-out paths at full width on [cuda:0, cuda:0]: (a) sharded
    eval, (b) data-parallel training (world 1 over NCCL, world 2 over gloo
    in two processes), (c) engine, live session and extractor with a mesh,
    (d) timings, (e) the training CLI's --devices."""
    import shutil
    import socket

    from tepose_tpu_torch.utils.profiling import profile_device
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.config import parse_args
    from tepose_tpu_torch.data.preprocess import FeatureExtractor
    from tepose_tpu_torch.eval.evaluator import (
        eval_rollout, make_sharded_eval_rollout)
    from tepose_tpu_torch.evaluate import (
        build_models, make_eval_batch, run_eval, synthetic_eval_data)
    from tepose_tpu_torch.parallel import distributed
    from tepose_tpu_torch.parallel.mesh import make_mesh
    from tepose_tpu_torch.precision import device_scope
    from tepose_tpu_torch.streaming.live import LiveSession

    shutil.rmtree(PAR_DIR, ignore_errors=True)
    os.makedirs(PAR_DIR)
    mesh = make_mesh(devices=PAR_DEVICES)
    res: dict = {"card": card, "launches": {}}
    cfg_path = os.path.join(REPO, "configs", "repr_wopw_3dpw_model.yaml")

    # (a) eval: run_eval with the mesh against phase 3, then the rollout's
    # per-frame outputs on one batch
    cfg, _, args = parse_args(["--cfg", cfg_path, "--dataset", "3dpw"])
    lbs.LAUNCHES = 0
    out = run_eval(cfg, args, synthetic=True, device="cuda", devices=mesh)
    torch.cuda.synchronize()
    launches = lbs.LAUNCHES
    res["launches"]["eval_mesh"] = launches
    dm = max(abs(out[k] - v) for k, v in p3["metrics"].items())
    print(f"phase 12a: run_eval synthetic 3dpw over {PAR_DEVICES}: lbs "
          f"launches {launches} (one device: {p3['launches']}); metrics "
          f"{json.dumps({k: out[k] for k in p3['metrics']})}, max |mesh - "
          f"one device| {dm:.3e} mm (bar 1e-2 mm = 1e-5 m)")
    if launches != 2 * p3["launches"]:
        raise RuntimeError(f"the sharded eval launched LBS {launches} times, "
                           f"not one launch per shard where one device "
                           f"launched once ({p3['launches']})")
    if not dm <= 1e-2:
        raise RuntimeError(f"sharded run_eval metrics differ by {dm} mm")
    smpl, gen, vibe, jreg = build_models(cfg, True, "cuda")
    data = synthetic_eval_data()
    names = sorted(data)
    S = gen.cfg.seqlen
    T = 128
    batch = make_eval_batch(data, names, S, T, 4)
    W = T - S + 1
    sharded = make_sharded_eval_rollout(gen, vibe, smpl, jreg, mesh)
    with device_scope():
        lbs.LAUNCHES = 0
        got = sharded(batch["feats"], batch["theta_pseu"], batch["theta_gt"],
                      W)
        torch.cuda.synchronize()
        per_shard = lbs.LAUNCHES
        lbs.LAUNCHES = 0
        want = eval_rollout(gen, vibe, smpl, *(torch.from_numpy(batch[k]).to(
            "cuda") for k in ("feats", "theta_pseu", "theta_gt")), jreg, W)
        torch.cuda.synchronize()
        single = lbs.LAUNCHES
    devs = {k: float((got[k] - want[k].cpu()).abs().max())
            for k in ("pred_j3d", "pred_theta", "mpvpe")}
    print(f"phase 12a: sharded rollout B=4 T={T} over {PAR_DEVICES} against "
          f"one device: max |dev| J14 {devs['pred_j3d']:.3e} m, theta "
          f"{devs['pred_theta']:.3e}, MPVPE {devs['mpvpe']:.3e} m (bars "
          f"1e-5); lbs launches {per_shard} at B=2 against {single} at B=4")
    if not all(d <= 1e-5 for d in devs.values()):
        raise RuntimeError(f"sharded rollout misses one device: {devs}")
    if per_shard != 2 * single:
        raise RuntimeError("the sharded rollout did not launch LBS once a "
                           "shard")
    res["eval_deviation"] = devs

    # (b) data-parallel training: world 1 over NCCL against the plain
    # segment, both in deterministic mode, then world 2 (two processes on
    # cuda:0 over gloo) against it. Two plain segments in the default mode
    # show the spread that mode leaves.
    spread = leaf_deviation(dp_segment(dp_setup(), sharded=False),
                            dp_segment(dp_setup(), sharded=False))
    with deterministic():
        want = dp_segment(dp_setup(), sharded=False)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    distributed.maybe_initialize(f"localhost:{port}", 1, 0, backend="nccl",
                                 timeout_s=DP_TIMEOUT)
    try:
        one = dp_setup()
        with deterministic():
            got = dp_segment(one, sharded=True)
        timing1 = dp_timed(one, True, os.path.join(PAR_DIR, "trace_nccl"))
    finally:
        distributed.shutdown()
    rel = max(abs(got["losses"][k] - v) / max(abs(v), 1e-12)
              for k, v in want["losses"].items())
    leaf = leaf_deviation(got, want)
    print(f"phase 12b: world 1 over NCCL, batch {DP_N2D}+{DP_N3D}, K={DP_K} "
          f"at update rate {DP_RATE} with dropout, against the plain segment"
          f" (deterministic mode): losses {rel:.3e} relative (bar 1e-6), "
          f"leaves {leaf:.3e} of their magnitude (bar 1e-6); gen_loss "
          f"{got['losses']['gen_loss']:.6f}; two plain segments in the "
          f"default mode part by {spread:.3e}")
    if not (rel <= 1e-6 and leaf <= 1e-6):
        raise RuntimeError("world 1 over NCCL misses the plain segment")
    plain = dp_setup()
    timing0 = dp_timed(plain, False, None)
    del plain, one

    out_path = os.path.join(PAR_DIR, "world2.npz")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
         "2", str(port), out_path], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise RuntimeError(f"world-2 rank {r} failed (rc {p.returncode})"
                               f":\n{log[-4000:]}")
    with np.load(out_path) as z:
        w2 = {g: {} for g in ("gen", "disc", "disc_state")}
        for key in z.files:
            g, k = key.split("/", 1)
            w2[g][k] = z[key]
    with open(out_path + ".json") as f:
        meta = json.load(f)
    w2["losses"] = meta["losses"]
    dev = dp_deviation(w2, got)
    print("phase 12b: world 2 (2 processes on cuda:0 over gloo) against "
          "world 1; deviation / bar: " + ", ".join(
              f"{k} {d:.3e} / {b:.1e}" for k, (d, b) in dev.items()))
    bad = {k: v for k, v in dev.items() if not v[0] <= v[1]}
    if bad:
        raise RuntimeError(f"world 2 misses world 1: {bad}")
    res["train"] = {"plain": timing0, "world1_nccl": timing1,
                    "world2_gloo": meta["timing"],
                    "world1_vs_plain": {"losses": rel, "leaves": leaf},
                    "world2_vs_world1": {k: d for k, (d, _) in dev.items()}}

    # (c) engine, live session and extractor with the mesh against the
    # same object without one
    import make_torch_serve_golden as sg

    setup = p7["setup"]
    crops = p7["engine_crops"]
    engines = {"one": sg.port_engine(setup, preset="parity"),
               "mesh": sg.port_engine(setup, preset="parity", mesh=mesh)}
    outs, counts = {}, {}
    for name, eng in engines.items():
        lbs.LAUNCHES = 0
        outs[name] = eng.run_tracklets_from_crops(crops)
        torch.cuda.synchronize()
        counts[name] = lbs.LAUNCHES
    res["launches"]["engine_mesh"] = counts["mesh"]
    worst = {}
    for k in ("theta", "verts", "kp_3d", "kp_2d"):
        d = max(float(np.abs(a[k] - b[k]).max())
                for a, b in zip(outs["mesh"], outs["one"]))
        mag = max(float(np.abs(b[k]).max()) for b in outs["one"])
        worst[k] = (d, 1e-4 * mag if k == "kp_2d"
                    else (1e-3 if k == "theta" else 1e-4))
    print(f"phase 12c: engine parity {len(crops)} x {len(crops[0])} uint8 "
          f"crops over {PAR_DEVICES}: lbs launches {counts['mesh']} (one "
          f"device {counts['one']}); against one device / bar: "
          + ", ".join(f"{k} {d:.3e} / {b:.1e}" for k, (d, b) in
                      worst.items()))
    if not all(d <= b for d, b in worst.values()):
        raise RuntimeError(f"the mesh engine misses one device: {worst}")
    if not counts["mesh"] == 2 * counts["one"] > 0:
        raise RuntimeError("the mesh engine did not launch LBS once a shard "
                           "where one device launched once")

    c0, c1 = setup["crops"]
    lives = {n: LiveSession(setup["smpl"], setup["gen"], setup["vibe"],
                            n_streams=2, backbone=setup["backbone"],
                            outputs=("theta", "verts", "kp_3d"), mesh=m)
             for n, m in (("one", None), ("mesh", mesh))}
    pushed, counts = {}, {}
    for name in ("mesh", "one"):
        # each session's launches alone: the count is zeroed before its
        # pushes and read after them
        lbs.LAUNCHES = 0
        pushed[name] = [lives[name].push(
            np.stack([c0[t % len(c0)], c1[t]]),
            reset=np.array([t == len(c0), False])) for t in range(len(c1))]
        torch.cuda.synchronize()
        counts[name] = lbs.LAUNCHES
    worst = 0.0
    for t, (a, b) in enumerate(zip(pushed["mesh"], pushed["one"])):
        if not np.array_equal(a["valid"], b["valid"]):
            raise RuntimeError(f"live valid differs at t={t}")
        for k in ("theta", "verts", "kp_3d"):
            ratio = np.abs(a[k] - b[k]) / (LIVE_TOL["atol"] + LIVE_TOL["rtol"]
                                           * np.abs(b[k]))
            worst = max(worst, float(ratio.max()))
    res["launches"]["live_mesh"] = counts["mesh"]
    print(f"phase 12c: LiveSession 2 streams over {PAR_DEVICES}, "
          f"{len(c1)} pushes, slot 0 reset at t={len(c0)}; lbs launches "
          f"{counts['mesh']} (one device {counts['one']}, phase 6 "
          f"{p6['launches']}); largest share of the bar (rtol 2e-4, atol "
          f"2e-5) against one device {worst:.3f}")
    if not worst <= 1.0:
        raise RuntimeError("the mesh live session misses one device")
    if not counts["mesh"] == 2 * counts["one"] == 2 * p6["launches"]:
        raise RuntimeError("the mesh live session did not launch LBS once a "
                           "shard where one device launched once")

    rs = np.random.RandomState(12)
    fe_crops = rs.randint(0, 256, (300, 3, 224, 224)).astype(np.uint8)
    fa = FeatureExtractor(setup["backbone"], mesh=mesh).features_from_crops(
        fe_crops)
    fb = FeatureExtractor(setup["backbone"]).features_from_crops(fe_crops)
    fd = float(np.abs(fa - fb).max() / np.abs(fb).max())
    print(f"phase 12c: FeatureExtractor batch 256 over {PAR_DEVICES}, 300 "
          f"uint8 crops: max |dev| {fd:.3e} of the features' magnitude (bar "
          f"1e-4)")
    if not fd <= 1e-4:
        raise RuntimeError("the mesh extractor misses one device")

    # (d) timings: eval ms per window with the mesh and without
    rs = np.random.RandomState(3)
    feats = rs.randn(32, T, 2048).astype(np.float32) * 0.5
    pseu = np.zeros((32, S - 1, 85), np.float32)
    pseu[..., 0] = 1.0
    gt = rs.randn(32, T, 85).astype(np.float32) * 0.2
    dfe, dps, dgt = (torch.from_numpy(x).to("cuda") for x in (feats, pseu,
                                                              gt))

    def run_mesh():
        with device_scope():
            sharded(feats, pseu, gt, W)

    def run_one():
        with device_scope():
            eval_rollout(gen, vibe, smpl, dfe, dps, dgt, jreg, W)

    secs = {"mesh": [], "one": []}
    for name, fn in (("one", run_one), ("mesh", run_mesh),
                     ("mesh", run_mesh), ("one", run_one)):
        secs[name] += host_seconds(fn, reps=2)
    res["eval_ms_per_window"] = {k: 1e3 * float(np.median(v)) / W
                                 for k, v in secs.items()}
    # one host thread queues every shard's kernels: the launches a window
    # and the device's idle share, with the mesh and without
    profs = {"one": profile_device(run_one), "mesh": profile_device(run_mesh)}
    res["eval_profile"] = {k: "not measured" if pr is None else {
        "kernels_per_window": pr["kernels"] / W,
        "idle_share": pr["idle_share"]} for k, pr in profs.items()}
    tr = res["train"]
    ar1, ar2 = (tr[k]["all_reduce"] for k in ("world1_nccl", "world2_gloo"))
    print(f"phase 12d: eval rollout B=32 T={T} ({W} windows): "
          f"{res['eval_ms_per_window']['one']:.3f} ms/window on cuda:0, "
          f"{res['eval_ms_per_window']['mesh']:.3f} over {PAR_DEVICES} "
          f"(medians, in turns) [{card}]")
    print(f"phase 12d: eval rollout B=32, kernels a window and idle share: "
          f"{json.dumps(res['eval_profile'])} [{card}]")
    print(f"phase 12d: training batch {DP_N2D}+{DP_N3D}: plain "
          f"{tr['plain']['ms_per_window']:.2f} ms/window, world 1 NCCL "
          f"{tr['world1_nccl']['ms_per_window']:.2f} (all-reduce "
          f"{ar1['share']:.3%} of a traced segment: host "
          f"{ar1['host_ms']:.2f} ms, NCCL device {ar1['nccl_device_ms']:.2f} "
          f"ms), world 2 gloo on one card "
          f"{tr['world2_gloo']['ms_per_window']:.2f} (all-reduce "
          f"{ar2['share']:.3%}, host {ar2['host_ms']:.2f} ms a segment, "
          f"rank 0) [{card}]")

    # (e) the training CLI: --devices 1 trains and only the primary writes
    # the logdir; --devices 2 on a one-card host exits naming the count
    cfg2 = cfg.clone()
    cfg2.OUTPUT_DIR = os.path.join(PAR_DIR, "cli")
    cfg2.TRAIN.END_EPOCH = 1
    tiny = os.path.join(PAR_DIR, "cli.yaml")
    with open(tiny, "w") as f:
        f.write(cfg2.dump())
    base = [sys.executable, "-m", "tepose_tpu_torch.train", "--synthetic",
            "--cfg", tiny, "--smoke-iters", "2"]
    lbs.LAUNCHES = 0
    runs = {}
    for n in ("1", str(torch.cuda.device_count() + 1)):
        t0 = time.perf_counter()
        p = subprocess.run(base + ["--devices", n], cwd=REPO, text=True,
                           capture_output=True, timeout=DP_TIMEOUT)
        runs[n] = (p.returncode, p.stdout + p.stderr,
                   time.perf_counter() - t0)
    rc1, log1, s1 = runs["1"]
    dirs = os.listdir(cfg2.OUTPUT_DIR) if os.path.isdir(
        cfg2.OUTPUT_DIR) else []
    files = sorted(os.listdir(os.path.join(cfg2.OUTPUT_DIR, dirs[0]))) \
        if len(dirs) == 1 else []
    print(f"phase 12e: train --synthetic --devices 1 --smoke-iters 2: rc "
          f"{rc1} in {s1:.1f} s, logdirs {dirs}, files {files}")
    if rc1 or len(dirs) != 1 or "checkpoint.npz" not in files:
        raise RuntimeError(f"train --devices 1 failed:\n{log1[-4000:]}")
    n2 = str(torch.cuda.device_count() + 1)
    rc2, log2, _ = runs[n2]
    msg = [ln for ln in log2.splitlines() if "visible" in ln]
    print(f"phase 12e: train --devices {n2}: rc {rc2}, {msg}")
    if rc2 == 0 or not msg or \
            f"only {torch.cuda.device_count()} CUDA" not in msg[-1]:
        raise RuntimeError(f"train --devices {n2} did not exit naming the "
                           f"visible count:\n{log2[-2000:]}")
    print(json.dumps({"parallel": res}, default=str))
    return res


# phase 13: bf16 training and evaluate's precision tiers. Batch 32 is the
# parity configs', 128 configs/fast_train.yaml's (76 2D + 52 3D rows).
P13_DIR = os.path.join(REPO, "build", "chip_smoke_bf16")
P13_BATCHES = ((19, 13), (76, 52))
P13_WINDOWS = 4          # windows a timed segment (make_batch's vidlen 10)
# (compute dtype, 2D rows, 3D rows, share_fake_disc), timed in turns
P13_TIMED = ((None, 19, 13, False), ("bfloat16", 19, 13, False),
             (None, 76, 52, False), ("bfloat16", 76, 52, False),
             (None, 19, 13, True), ("bfloat16", 76, 52, True))
P13_TIERS = ("float32", "tensorfloat32", "bfloat16")
P13_VIDEO = 520          # frames: the reference's longest eval video


def p13_name(cd, n2, n3, share) -> str:
    return (f"{'bf16' if cd else 'f32'}_b{n2 + n3}"
            + ("_shared_disc" if share else ""))


def phase13_bf16(card: str) -> dict:
    import bf16_gate
    import make_torch_train_golden as tg
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.utils.profiling import profile_device
    from tepose_tpu_torch.config import parse_args, update_cfg
    from tepose_tpu_torch.evaluate import (
        build_models, make_eval_batch, run_eval, synthetic_eval_data)
    from tepose_tpu_torch.precision_sweep import rollout, tier_models
    from tepose_tpu_torch.train.optim import opt_state_leaves
    from tepose_tpu_torch.train.run import build_train_loop, close_loaders
    from tepose_tpu_torch.train.trainer import train_segment

    res = {"card": card, "gate": {}, "train": {}, "tiers": {}, "seconds": {}}
    t_phase = time.perf_counter()

    def lap(part: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        res["seconds"][part] = now - t_phase
        t_phase = now

    # (a) the bf16 gate at full width, against the float32 window
    for n2, n3 in P13_BATCHES:
        spec = dict(tg.FULL_SPEC, n_2d=n2, n_3d=n3, windows=(1,))
        lbs.LAUNCHES = 0
        f32 = bf16_gate.port_window(spec, "cuda", None)
        bf16 = bf16_gate.port_window(spec, "cuda", "bfloat16")
        torch.cuda.synchronize()
        gate = bf16_gate.gate(f32, bf16)
        res["gate"][n2 + n3] = gate
        print(f"phase 13a: bf16 gate at batch {n2}+{n3} (2x1024 GRUs, GCN "
              f"13/6, V={spec['num_verts']}) on cuda: "
              + ", ".join(f"{k} {v:.6g} (bar {bar:g})"
                          for k, (v, bar, _) in gate.items())
              + f"; gen_loss f32 {f32['metrics']['gen_loss']:.6f} bf16 "
              f"{bf16['metrics']['gen_loss']:.6f}; lbs launches "
              f"{lbs.LAUNCHES}")
        failed = {k: v for k, v in gate.items() if not v[2]}
        if failed or lbs.LAUNCHES:
            raise RuntimeError(f"bf16 training misses its gate at batch "
                               f"{n2 + n3}: {failed}, lbs {lbs.LAUNCHES}")

    lap("a")

    # (b) the fast-training config as it stands (TRAIN.PRECISION bf16,
    # batch 128): one epoch of a few windows, validation on one batch
    cfg = update_cfg(os.path.join(REPO, "configs", "fast_train.yaml"))
    cfg.OUTPUT_DIR = os.path.join(P13_DIR, "train")
    cfg.TRAIN.END_EPOCH = 1
    kw = dict(synthetic=True, smoke_iters=P13_WINDOWS, device="cuda")
    loop, num_outer = build_train_loop(cfg, **kw)
    if loop.hp.compute_dtype != "bfloat16" or \
            loop.hp.n_2d + loop.hp.n_3d != 128:
        raise RuntimeError(f"fast_train.yaml built {loop.hp}")
    loop.max_valid_batches = 1
    lbs.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        loop.fit(cfg.TRAIN.END_EPOCH, num_outer)
    finally:
        close_loaders(loop)
    torch.cuda.synchronize()
    res["fast_train_s"] = time.perf_counter() - t0
    res["launches"] = {"train_fast_validation": lbs.LAUNCHES}
    values = {d["tag"]: d["value"] for d in map(json.loads, open(
        os.path.join(loop.logdir, "metrics.jsonl")))}
    print(f"phase 13b: configs/fast_train.yaml --synthetic on cuda (bf16, "
          f"batch 128, {P13_WINDOWS} windows, validation on one batch): "
          f"{res['fast_train_s']:.1f} s; lbs launches {lbs.LAUNCHES}; "
          f"gen_loss {values['train_loss/gen_loss']:.4f}, dis_loss "
          f"{values['train_loss/dis_loss']:.4f}, pa-mpjpe "
          f"{values['error/pa-mpjpe']:.2f} mm")
    if not all(np.isfinite(v) for v in values.values()) or \
            lbs.LAUNCHES <= 0:
        raise RuntimeError(f"fast training failed: {values}, lbs "
                           f"{lbs.LAUNCHES}")
    cfg2 = cfg.clone()
    cfg2.TRAIN.RESUME = os.path.join(loop.logdir, "checkpoint.npz")
    fresh, _ = build_train_loop(cfg2, **kw)
    close_loaders(fresh)
    for a, b in ((loop.gen, fresh.gen), (loop.disc, fresh.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k])
                                             for k in sa):
            raise RuntimeError("the resumed bf16 loop's weights differ")
    for a, b in ((loop.gen_opt, fresh.gen_opt),
                 (loop.disc_opt, fresh.disc_opt)):
        if not all(np.array_equal(x, y) for x, y in
                   zip(opt_state_leaves(a), opt_state_leaves(b))):
            raise RuntimeError("the resumed bf16 loop's optimizer state "
                               "differs")
    if fresh.hp.compute_dtype != "bfloat16" or fresh.start_epoch != 1:
        raise RuntimeError("the resumed loop lost bf16 or its epoch")
    print("phase 13b: checkpoint resumed into a fresh bf16 loop: "
          "parameters, buffers and optimizer state bit-equal")
    del loop, fresh
    lap("b")

    # (c) training timings, in turns: f32 and bf16 at batch 32 and 128,
    # share_fake_disc on and off
    runs = {}
    for cd, n2, n3, share in P13_TIMED:
        name = p13_name(cd, n2, n3, share)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        setup = tg.port_setup(dict(tg.FULL_SPEC, n_2d=n2, n_3d=n3,
                                   windows=(P13_WINDOWS,)), "cuda")
        setup["hp"] = dataclasses.replace(
            setup["hp"], update_theta_rate=0.9, compute_dtype=cd,
            share_fake_disc=share)
        draws = torch.Generator(device="cuda").manual_seed(5)

        def seg(windows=P13_WINDOWS, setup=setup, draws=draws):
            return train_segment(
                setup["gen"], setup["disc"], setup["smpl"],
                setup["gen_opt"], setup["disc_opt"], setup["hp"],
                setup["weights"], setup["batch_2d"], setup["batch_3d"],
                setup["amass"][:windows], draws)
        losses = seg()       # the first call, untimed
        torch.cuda.synchronize()
        runs[name] = {"seg": seg, "secs": [], "B": n2 + n3, "losses": losses,
                      "peak_memory_gb": (torch.cuda.max_memory_allocated()
                                         - base) / 1e9}
        if not all(np.isfinite(v) for v in losses.values()):
            raise RuntimeError(f"{name}: non-finite losses {losses}")
    order = list(runs)
    for turn in (order, order[::-1]):
        for name in turn:
            t0 = time.perf_counter()
            runs[name]["seg"]()
            torch.cuda.synchronize()
            runs[name]["secs"].append(time.perf_counter() - t0)
    for name, r in runs.items():
        med = float(np.median(r["secs"]))
        # one window profiled: the trace's events are read in Python
        seg = r.pop("seg")
        prof = profile_device(lambda: seg(1))
        r.update(ms_per_window=1e3 * med / P13_WINDOWS,
                 samples_windows_per_s=r["B"] * P13_WINDOWS / med)
        r.update({"kernels_per_window": "not measured",
                  "idle_share": "not measured"} if prof is None else
                 {"kernels_per_window": prof["kernels"],
                  "idle_share": prof["idle_share"],
                  "top_kernels_ms": prof["top_kernels_ms"]})
        res["train"][name] = r
        print(f"phase 13c: training {name}: {r['ms_per_window']:.2f} "
              f"ms/window, {r['samples_windows_per_s']:.1f} samples x "
              f"windows/s (median of {[round(x, 4) for x in r['secs']]} s "
              f"per {P13_WINDOWS}-window segment, in turns), kernels/window "
              f"{r['kernels_per_window']} and idle share {r['idle_share']} "
              f"(one window profiled), "
              f"peak memory {r['peak_memory_gb']:.2f} GB [{card}]")
    del runs
    ms = {k: v["ms_per_window"] for k, v in res["train"].items()}
    for b, shared in ((32, "f32_b32"), (128, "bf16_b128")):
        print(f"phase 13c: bf16 / f32 ms a window at batch {b}: "
              f"{ms[f'bf16_b{b}'] / ms[f'f32_b{b}']:.3f}; shared / "
              f"two-call fake pass: "
              f"{ms[shared + '_shared_disc'] / ms[shared]:.3f} ({shared})")

    lap("c")

    # (d) evaluate's tiers: the entry point per tier (LBS launches equal,
    # frames/s), then the drift of each tier's rollout against a float64
    # run of the port on phase 3's synthetic 3DPW batch and on one
    # 520-frame video
    pcfg, _, args = parse_args([
        "--cfg", os.path.join(REPO, "configs", "repr_wopw_3dpw_model.yaml"),
        "--dataset", "3dpw"])
    for tier in P13_TIERS:
        lbs.LAUNCHES = 0
        out = run_eval(pcfg, args, synthetic=True, device="cuda",
                       precision=tier)
        torch.cuda.synchronize()
        res["launches"][f"eval_{tier}"] = lbs.LAUNCHES
        res["tiers"][tier] = {"run_eval_frames_per_s":
                              out["frames"] / out["seconds"],
                              "lbs_launches": lbs.LAUNCHES,
                              "metrics": {k: out[k] for k in (
                                  "mpjpe", "pa_mpjpe", "mpvpe")}}
    launches = {res["tiers"][t]["lbs_launches"] for t in P13_TIERS}
    if len(launches) != 1 or launches == {0}:
        raise RuntimeError(f"the tiers' LBS launches differ or are 0: "
                           f"{res['launches']}")
    smpl, gen, vibe, jreg = build_models(pcfg, True, "cuda")
    S = gen.cfg.seqlen
    data = synthetic_eval_data()
    video = synthetic_eval_data(num_videos=1, min_len=P13_VIDEO,
                                max_len=P13_VIDEO + 1, seed=5)
    inputs = {"3dpw_batch": (make_eval_batch(data, list(data), S, 128, 4),
                             [len(d["features"]) for d in data.values()]),
              "video_520": (make_eval_batch(video, list(video), S,
                                            P13_VIDEO, 1), [P13_VIDEO])}
    models = {t: tier_models((smpl, gen, vibe, jreg), t)
              for t in ("float64",) + P13_TIERS}
    for case, (batch, lengths) in inputs.items():
        outs = {}
        for tier in ("float64",) + P13_TIERS:
            lbs.LAUNCHES = 0
            t0 = time.perf_counter()
            outs[tier] = rollout(models[tier], tier, batch["feats"],
                                 batch["theta_pseu"], batch["theta_gt"],
                                 "cuda")
            secs = time.perf_counter() - t0
            if tier == "float64":
                if lbs.LAUNCHES:
                    raise RuntimeError("the float64 oracle launched the "
                                       "float32 kernel")
                continue
            ref = outs["float64"]
            dev = {k: 1e3 * max(float((outs[tier][k][i, :n]
                                       - ref[k][i, :n]).abs().max())
                                for i, n in enumerate(lengths))
                   for k in ("pred_j3d", "mpvpe")}
            res["tiers"][tier][case] = {
                "max_joint_dev_mm": dev["pred_j3d"],
                "max_mpvpe_dev_mm": dev["mpvpe"],
                "frames_per_s": sum(lengths) / secs,
                "lbs_launches": lbs.LAUNCHES}
            print(f"phase 13d: eval tier {tier} on {case} ({len(lengths)} "
                  f"videos, {sum(lengths)} frames, full width) against the "
                  f"port in float64: max joint deviation "
                  f"{dev['pred_j3d']:.6g} mm, max MPVPE deviation "
                  f"{dev['mpvpe']:.6g} mm; {sum(lengths) / secs:.1f} "
                  f"frames/s; lbs launches {lbs.LAUNCHES} [{card}]")
            if not all(np.isfinite(v) for v in dev.values()) or \
                    lbs.LAUNCHES <= 0:
                raise RuntimeError(f"eval tier {tier} failed on {case}")
    if res["tiers"]["float32"]["3dpw_batch"]["max_joint_dev_mm"] > 0.1:
        raise RuntimeError("the float32 tier misses the 0.1 mm bar against "
                           "float64")
    for tier in P13_TIERS:
        print(f"phase 13d: run_eval --precision {tier}: "
              f"{res['tiers'][tier]['run_eval_frames_per_s']:.1f} frames/s, "
              f"lbs launches {res['tiers'][tier]['lbs_launches']}, metrics "
              f"{json.dumps(res['tiers'][tier]['metrics'])} [{card}]")
    lap("d")
    print(f"phase 13: seconds by part {json.dumps(res['seconds'])}")
    print(json.dumps({"bf16": res}, default=str))
    return res


P14_DIR = os.path.join(REPO, "build", "chip_smoke_tuning")
P14_SCALE = 0.25         # the tuner's --scale: 15 3DPW and 30 H36M videos
P14_MAX_LEN = 100        # --max_len: one bucket a size, to fit the phase
P14_JAX_DEFAULTS = {"3dpw": (32, 128), "h36m": (8, 256)}
P14_VIDEO_ATOL = 1e-6    # m: rows are independent, so plans agree


def phase14_tuning(card: str) -> dict:
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch import precision_sweep, tune_eval_batching
    from tepose_tpu_torch.config import parse_args
    from tepose_tpu_torch.evaluate import (
        EVAL_BATCHING, plan_eval_batches, run_eval, synthetic_eval_data)

    res = {"sweep": {}, "launches": {}, "seconds": {}}
    t_phase = time.perf_counter()

    def lap(part: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        res["seconds"][part] = now - t_phase
        t_phase = now

    lengths = {n: len(d["features"]) for n, d in synthetic_eval_data().items()}
    eval_bs = {B for _, _, B in plan_eval_batches(
        lengths, tune_eval_batching.SEQLEN, EVAL_BATCHING["3dpw"])}
    missing = (eval_bs | set(EVAL_BATCHING.values())) - set(LBS_BATCHES)
    if missing:
        raise RuntimeError(f"phase 2 does not hold the kernel at eval's "
                           f"default batch {sorted(missing)}")

    # (a) the tuner on a 2 x 2 grid holding the JAX and the new defaults
    os.makedirs(P14_DIR, exist_ok=True)
    for ds, key in (("3dpw", "3dpw"), ("h36m", "long")):
        jax_b, jax_bucket = P14_JAX_DEFAULTS[ds]
        lbs.LAUNCHES = 0
        entry = tune_eval_batching.main([
            "--dataset", ds, "--scale", str(P14_SCALE),
            "--max_len", str(P14_MAX_LEN),
            "--batches", *map(str, sorted({jax_b, EVAL_BATCHING[key]})),
            "--bucket_sizes", "0", str(jax_bucket),
            "--out", os.path.join(P14_DIR, "sweep.json")])
        res["launches"][f"tuner_{ds}"] = lbs.LAUNCHES
        res["sweep"][ds] = entry
        for name, r in entry["results"].items():
            print(f"phase 14a: {ds} {name}: {r['useful_fps']:.1f} useful "
                  f"frames/s (passes {r['useful_fps_by_pass']}), "
                  f"{r['window_steps']} steps, {r['ms_per_step']:.3f} ms a "
                  f"step, peak {r['peak_memory_gb']:.3f} GB, lbs launches "
                  f"{r['lbs_launches']} [{card}]")
            if not (np.isfinite(r["useful_fps"]) and r["lbs_launches"] > 0):
                raise RuntimeError(f"the tuner's row {ds} {name} failed")
    lap("a")

    # (b) run_eval with the defaults and with the JAX CLI's chunks
    cfg, _, args = parse_args([
        "--cfg", os.path.join(REPO, "configs", "repr_wopw_3dpw_model.yaml"),
        "--dataset", "3dpw"])
    runs = {}
    for name, (batch, bucket) in (("new_defaults", (None, None)),
                                  ("jax_chunks", (32, 128))):
        args.eval_batch, args.eval_bucket = batch, bucket
        videos = {}
        lbs.LAUNCHES = 0
        out = run_eval(cfg, args, synthetic=True, device="cuda",
                       per_video=videos)
        torch.cuda.synchronize()
        res["launches"][f"eval_{name}"] = lbs.LAUNCHES
        runs[name] = (out, videos)
        print(f"phase 14b: run_eval synthetic 3dpw, {name} "
              f"(eval_batch {batch}, eval_bucket {bucket}): "
              f"{out['frames'] / out['seconds']:.1f} frames/s, lbs launches "
              f"{lbs.LAUNCHES} [{card}]")
        if lbs.LAUNCHES <= 0:
            raise RuntimeError(f"run_eval ({name}) never launched the lbs "
                               f"kernel")
    (_, new), (_, old) = runs["new_defaults"], runs["jax_chunks"]
    dev = max(float(np.abs(new[n][k] - old[n][k]).max())
              for n in old for k in ("pred_j3d", "mpvpe"))
    res["per_video_max_dev_m"] = dev
    print(f"phase 14b: per-video J14 and MPVPE, defaults against the JAX "
          f"CLI's chunks: "
          f"max deviation {dev:.3e} m over {len(old)} videos (bar "
          f"{P14_VIDEO_ATOL:g})")
    if sorted(new) != sorted(old) or not dev <= P14_VIDEO_ATOL:
        raise RuntimeError(f"the plans disagree per video: {dev} m")
    lap("b")

    # (c) the precision sweep's accuracy half, F = 66, B = 2, full width
    lbs.LAUNCHES = 0
    acc, shapes = precision_sweep.measure_accuracy("cuda")
    torch.cuda.synchronize()
    res["launches"]["precision_sweep"] = lbs.LAUNCHES
    res["accuracy"] = acc
    print(f"phase 14c: tiers against float64 ({shapes}): "
          f"{json.dumps(acc)}; lbs launches {lbs.LAUNCHES} [{card}]")
    if not precision_sweep.passes_bar(acc["float32"]) or lbs.LAUNCHES <= 0:
        raise RuntimeError(f"float32 misses the 0.1 mm bar: "
                           f"{acc['float32']}")
    lap("c")
    print(f"phase 14: seconds by part {json.dumps(res['seconds'])}")
    return res


# phase 16's cut of the bench's CLI shapes: the scans over 125 frames (120
# windows) instead of 485, training segments of fewer windows, one timed
# call of each variant
BENCH_FRAMES = 125
BENCH_TRAIN_ITERS = {"f32": 4, "bf16": 2, "fast": 2}
BENCH_SCAN_ATOL = 5e-4   # tests/test_torch_fast_encoder.py's fast-vs-plain bar


def phase16_bench(card: str) -> dict:
    import tepose_tpu_torch.bench as bench
    import tepose_tpu_torch.bench_notes as notes
    import tepose_tpu_torch.ops.lbs_skinning as lbs

    full = bench.FULL_SHAPES
    shapes = dataclasses.replace(full, frames=BENCH_FRAMES, train_tiers=tuple(
        t._replace(iters=BENCH_TRAIN_ITERS[t.name]) for t in full.train_tiers))
    reps = bench.Reps(scan=1, e2e=1, e2e_device=2, train=1, burn=1,
                      train_burn=0)
    lbs.LAUNCHES = 0
    t0 = time.perf_counter()
    raw = bench.measure(bench.FULL_MODEL, shapes, reps, "cuda:0")
    torch.cuda.synchronize()
    launches = lbs.LAUNCHES
    line = bench.summarize(bench.FULL_MODEL, shapes, raw)
    bench.check_finite(line, allow_none=False)
    print(f"phase 16: bench.measure in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: {json.dumps(line, allow_nan=False)}")
    by_path = line["extra"]["lbs_launches"]
    if min(by_path.values()) <= 0 or sum(by_path.values()) != launches:
        raise RuntimeError(f"bench paths' lbs launches {by_path} against "
                           f"{launches} counted around the run")
    fast, plain = (raw["scans"]["theta"][k] for k in ("fast", "plain"))
    dev = float((fast - plain).abs().max())
    print(f"phase 16: the bench's scans at B={shapes.streams}, "
          f"{raw['scans']['windows']} windows: theta max |fast - plain| "
          f"{dev:.3e} (bar {BENCH_SCAN_ATOL}); lbs launches {by_path}")
    if not dev <= BENCH_SCAN_ATOL:
        raise RuntimeError(f"the bench's fast scan misses the plain loop: "
                           f"{dev}")

    lbs.LAUNCHES = 0
    stage = notes.stage_breakdown(device="cuda:0", reps=2)
    torch.cuda.synchronize()
    stage_launches = lbs.LAUNCHES
    render = notes.render_benchmark(reps=2)
    bench.check_finite([stage, render], allow_none=False)
    print(f"phase 16: bench_notes stage and render [{card}]: "
          + json.dumps({"stage_breakdown": stage,
                        "render_benchmark": render}, allow_nan=False))
    if not stage_launches >= stage["lbs_launches"] > 0:
        raise RuntimeError(f"bench_notes' stage scans launched the lbs "
                           f"kernel {stage_launches} times")
    return {"launches": {**by_path, "bench_notes_stage": stage_launches}}


# phase 17's shapes: the demo's VIBE window over B videos of T crops
VDEMO_B, VDEMO_T, VDEMO_CALLS = 2, 16, 5
ATTENTION_SHAPE = (32, 16, 2048)


def vibe_demo_setup(device) -> dict:
    """Phase 17's models and crops on `device`, the same from the seeds on
    any device."""
    from tepose_tpu_torch.models.backbone import normalize_crop, resnet50_init
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.models.tepose import Vibe, VibeConfig

    crops = np.random.RandomState(17).randint(
        0, 256, (VDEMO_B * VDEMO_T, 3, 224, 224)).astype(np.uint8)
    images = normalize_crop(torch.from_numpy(crops).to(device))
    return {
        "vibe": Vibe(VibeConfig(), device=device,
                     generator=torch.Generator().manual_seed(1)).eval(),
        "backbone": resnet50_init(torch.Generator().manual_seed(2),
                                  device).eval(),
        "smpl": synthetic_smpl_model(0, LBS_V, device=device),
        "images": images.reshape(VDEMO_B, VDEMO_T, 3, 224, 224),
    }


def phase17_vibe_demo(card: str) -> dict:
    import tepose_tpu_torch.models.smpl as smpl_mod
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from make_torch_serve_golden import KP2D_RTOL, METRE_ATOL, THETA_ATOL
    from tepose_tpu_torch.models.backbone import resnet50_features
    from tepose_tpu_torch.models.temporal import TemporalAttention
    from tepose_tpu_torch.models.tepose import vibe_demo_forward

    setups = {d: vibe_demo_setup(d) for d in ("cuda", "cpu")}

    def run(device):
        s = setups[device]
        with torch.no_grad():
            return vibe_demo_forward(s["vibe"], s["backbone"], s["smpl"],
                                     s["images"])

    run("cuda")   # warm-up: cuDNN's plans
    torch.cuda.synchronize()
    lbs.LAUNCHES = 0
    got = run("cuda")
    torch.cuda.synchronize()
    launches = lbs.LAUNCHES
    if launches != 1:
        raise RuntimeError(f"vibe_demo_forward launched the lbs kernel "
                           f"{launches} times, not once")
    want = run("cpu")
    dev = {}
    for k, w in want.items():
        g = got[k].cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"vibe demo {k}: shape {tuple(g.shape)} "
                               f"against {tuple(w.shape)}, or non-finite")
        bar = {"theta": THETA_ATOL, "rotmat": THETA_ATOL,
               "kp_2d": KP2D_RTOL * float(w.abs().max())}.get(k, METRE_ATOL)
        dev[k] = (float((g - w).abs().max()), bar)
    print(f"phase 17: vibe_demo_forward on cuda ({VDEMO_B} x {VDEMO_T} "
          f"224^2 crops, VIBE 2x1024, V={LBS_V}), lbs launches {launches}; "
          f"deviation from the CPU / bar: " + ", ".join(
              f"{k} {d:.3e} / {bar:.1e}" for k, (d, bar) in dev.items()))
    bad = {k: v for k, v in dev.items() if not v[0] <= v[1]}
    if bad:
        raise RuntimeError(f"vibe_demo_forward on cuda misses the CPU: {bad}")

    seen = []

    def recorded(*args):
        seen.append(args)
        return lbs.lbs_skinning(*args)

    smpl_mod.lbs_skinning = recorded
    try:
        run("cuda")
    finally:
        smpl_mod.lbs_skinning = lbs.lbs_skinning
    (wT, A, v), = seen
    err = float((lbs.lbs_skinning(wT, A, v)
                 - lbs.lbs_skinning_reference(wT, A, v)).abs().max())
    print(f"phase 17: lbs on the call's inputs B={A.shape[0]} V={v.shape[1]} "
          f"max_abs_err={err:.3e}")
    if not err <= KERNEL_ATOL:
        raise RuntimeError(f"lbs kernel disagrees on the vibe demo's "
                           f"inputs: {err}")

    x = np.random.RandomState(18).randn(*ATTENTION_SHAPE).astype(np.float32)
    for nl in ("tanh", "relu"):
        scores = []
        for device in ("cuda", "cpu"):
            att = TemporalAttention(
                ATTENTION_SHAPE[2], ATTENTION_SHAPE[1], nl, device=device,
                generator=torch.Generator().manual_seed(3))
            with torch.no_grad():
                scores.append(att(torch.from_numpy(x).to(device)).cpu())
        d = float((scores[0] - scores[1]).abs().max())
        rows = float((scores[0].sum(1) - 1.0).abs().max())
        print(f"phase 17: TemporalAttention({ATTENTION_SHAPE[2]}, "
              f"{ATTENTION_SHAPE[1]}, {nl}) on {ATTENTION_SHAPE}: max |cuda "
              f"- cpu| {d:.3e}, max |row sum - 1| {rows:.3e} (bars 1e-5)")
        if not (d <= 1e-5 and rows <= 1e-5):
            raise RuntimeError(f"TemporalAttention {nl} on cuda: {d}, {rows}")

    s = setups["cuda"]
    crops = s["images"].reshape((-1,) + s["images"].shape[2:])

    def backbone():
        with torch.no_grad():
            resnet50_features(s["backbone"], crops)

    secs = {"call": [], "backbone": []}
    for _ in range(VDEMO_CALLS):
        for name, fn in (("call", lambda: run("cuda")),
                         ("backbone", backbone)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
    ms = {k: 1e3 * float(np.median(v)) for k, v in secs.items()}
    fps = VDEMO_B * VDEMO_T / ms["call"] * 1e3
    print(f"phase 17: vibe_demo_forward {fps:.1f} frames/s (median of "
          f"{[round(t, 5) for t in secs['call']]} s per call of "
          f"{VDEMO_B * VDEMO_T} frames, host clock to a synchronise), of "
          f"which ResNet-50 alone {ms['backbone']:.3f} ms (median of "
          f"{[round(t, 5) for t in secs['backbone']]} s, in turns); lbs "
          f"launches {launches} a call [{card}]")
    return {"launches": {"vibe_demo": launches}, "frames_per_s": fps,
            "ms": ms}


# phase 18's shapes: ViT-H's four linears (name, N, K, epilogue) and the
# row counts of the main path
VIT_SHAPES = (("qkv", 3840, 1280, "bias"), ("proj", 1280, 1280, "residual"),
              ("fc1", 5120, 1280, "gelu"), ("fc2", 1280, 5120, "residual"))
VIT_ROWS = (24_576, 2112, 192)
VIT_ERR_RATIO = 4.0     # the kernel's float64 error within 4x of the SGEMM's


def hmr2_chunk_launches() -> int:
    """Phase 18's count: the ViT kernel's launches in one 128-crop chunk
    of HMR 2.0 through the engine's per-frame route, at the published
    widths."""
    import tepose_tpu_torch.models.hmr2 as hmr2_mod
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.ops import vit_linear as VL
    from tepose_tpu_torch.streaming.engine import StreamingEngine

    model = hmr2_mod.HMR2(device="meta").to_empty(device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(18)
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            t.copy_(torch.randn(t.shape, device="cuda", generator=g) * 0.02)
    engine = StreamingEngine(synthetic_smpl_model(0, LBS_V, device="cuda"),
                             model, crop_batch=128, preset="parity")
    S = model.cfg.image_size
    crops = np.random.RandomState(18).randint(
        0, 256, (128, 3, S, S)).astype(np.uint8)
    chunks = hmr2_mod.HMR2_STATS["chunks"]
    VL.LAUNCHES = 0
    out, = engine.run_tracklets_from_crops([crops])
    torch.cuda.synchronize()
    launches = VL.LAUNCHES
    chunks = hmr2_mod.HMR2_STATS["chunks"] - chunks
    want = 4 * model.cfg.vit.depth
    print(f"phase 18: run_tracklets_from_crops on HMR 2.0 (ViT-H, "
          f"{model.cfg.vit.depth} blocks), 128 uint8 {S}^2 crops: "
          f"{chunks} chunk(s), vit_linear launches {launches} (want "
          f"{want} a chunk)")
    if chunks != 1 or launches != want:
        raise RuntimeError(f"one 128-crop chunk of HMR 2.0 made {chunks} "
                           f"chunks and {launches} vit_linear launches, not "
                           f"1 and {want}")
    bad = [k for k, v in out.items() if not np.isfinite(v).all()]
    if bad:
        raise RuntimeError(f"HMR 2.0 through the engine: non-finite {bad}")
    return launches


def phase18_vit_linear(card: str) -> dict:
    import torch.nn.functional as F
    from kernel_timing import device_ms
    from tepose_tpu_torch import kernels
    from tepose_tpu_torch.ops import vit_linear as VL
    from tepose_tpu_torch.utils.flops import H100_PEAK_FLOPS

    kernels.vit_library()
    build_s = kernels.BUILD_SECONDS["tepose_vit_gemm"]
    print(f"phase 18: vit_gemm_3xtf32 library built (or found) in "
          f"{build_s:.2f} s")
    launches = hmr2_chunk_launches()
    peak = H100_PEAK_FLOPS["NVIDIA H100 80GB HBM3"]["tf32"]
    dev = torch.device("cuda")
    res = {"build_s": build_s, "launches_per_hmr2_chunk": launches,
           "err": {}, "ms": {}}

    def rel(y, want):
        return float((y.double() - want).abs().max() / want.abs().max())

    def tf32(fn):
        def run():
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return fn()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return run

    for name, N, K, epi in VIT_SHAPES:
        for M in VIT_ROWS:
            g = torch.Generator(device=dev).manual_seed(M + N + K)
            x = torch.randn(M, K, device=dev, generator=g)
            w = torch.randn(N, K, device=dev, generator=g) * 0.02
            b = torch.randn(N, device=dev, generator=g) * 0.02
            r = torch.randn(M, N, device=dev, generator=g)
            kw = ({"gelu": True} if epi == "gelu" else
                  {"residual": r} if epi == "residual" else {})
            want = VL.vit_linear_reference(
                x.double(), w.double(), b.double(), gelu=epi == "gelu",
                residual=r.double() if epi == "residual" else None)
            kernel = lambda: VL.vit_linear(x, w, b, **kw)  # noqa: E731
            plain = lambda: VL.vit_linear_reference(x, w, b, **kw)  # noqa
            library = lambda: F.linear(x, w, b)  # noqa: E731
            e = {"kernel": rel(kernel(), want), "sgemm": rel(plain(), want),
                 "tf32": rel(tf32(plain)(), want)}
            torch.cuda.synchronize()
            res["err"][f"{name}.{M}"] = e
            bn = VL.block_n(M, N, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            print(f"phase 18: {name} M={M} N={N} K={K} ({epi}, tile 128 x "
                  f"{bn}): worst error from float64 kernel {e['kernel']:.3e}, "
                  f"cuBLAS float32 {e['sgemm']:.3e}, cuBLAS TF32 "
                  f"{e['tf32']:.3e}")
            if not e["kernel"] <= VIT_ERR_RATIO * e["sgemm"]:
                raise RuntimeError(f"vit_linear kernel at {name} M={M} is not "
                                   f"float32-accurate: {e}")
            if M != VIT_ROWS[0]:
                continue
            times = {kernel: [], plain: [], library: []}
            lib_tf32 = tf32(library)
            times[lib_tf32] = []
            for fn in (plain, library, lib_tf32, kernel, kernel, lib_tf32,
                       library, plain):
                times[fn] += device_ms(fn, launches=10, reps=5)
            ms = {k: float(np.median(times[fn])) for k, fn in
                  (("kernel", kernel), ("plain", plain),
                   ("library", library), ("library_tf32", lib_tf32))}
            flops = 2.0 * M * N * K
            ms["bound"] = flops / peak * 1e3
            ms["bound_3xtf32"] = 3 * ms["bound"]
            res["ms"][name] = ms
            print(f"phase 18: {name} M={M}: kernel {ms['kernel']:.4f} ms "
                  f"({flops / ms['kernel'] / 1e9:.1f} TFLOP/s, "
                  f"{ms['bound_3xtf32'] / ms['kernel']:.1%} of the 3xTF32 "
                  f"ceiling {ms['bound_3xtf32']:.4f} ms; TF32 bound "
                  f"{ms['bound']:.4f} ms); plain {ms['plain']:.4f} ms; "
                  f"library (cuBLAS float32) {ms['library']:.4f} ms; cuBLAS "
                  f"TF32 {ms['library_tf32']:.4f} ms [{card}]")
    return res


def serve_train_timings(card: str) -> None:
    """`python3 chip_smoke.py --timings`: phases 1, 5 and 7, and phase 8c
    on a freshly built training loop after one untimed segment; nothing
    else. The serving and training timings of the tree this script sits
    in: to compare two trees of the port on one card, put a copy of this
    script at each tree's root and run them in turns."""
    from tepose_tpu_torch.config import update_cfg
    from tepose_tpu_torch.train.run import build_train_loop

    phase1_build()
    p5 = phase5_engine()
    phase7_timings(p5, card)
    cfg = update_cfg(os.path.join(REPO, "configs",
                                  "repr_wopw_3dpw_model.yaml"))
    cfg.OUTPUT_DIR = os.path.join(REPO, "build", "chip_smoke_timings")
    cfg.TRAIN.END_EPOCH = 1
    loop, _ = build_train_loop(cfg, synthetic=True, smoke_iters=TRAIN_WINDOWS,
                               device="cuda")
    loop.train_epoch(0, 1)
    loop.segment_seconds.clear()
    train_timings(loop, card)


P15_DIR = os.path.join(REPO, "build", "chip_smoke_insta")
P15_VIDLEN, P15_WINDOWS = 8, 3     # a segment of 3 windows at SEQLEN 6
P15_SEGMENTS = 2                   # the first one warms up, the last is timed
P15_RATE_MB = 256                  # features through H5Writer and open_h5


def phase15_insta(card: str) -> dict:
    """InstaVariety without h5py: h5py is put in sys.modules as None for
    the whole phase. (a) `preprocess.insta.read_data` builds
    insta_train_db.h5 on the card from the golden's fabricated tfrecords
    (ResNet-50 from phase 11's seeds) through `data.h5.H5Writer`, read
    back through `data.h5.open_h5`: host arrays equal to the JAX builder's
    (tools/make_torch_insta_golden.py), features within 1e-4 of their
    magnitude; (b) `preprocess.pseudo_theta.main(--file_name insta_train)`
    on that file and on one holding the JAX builder's features (LBS
    launches > 0), the latter's thetas within 1e-5 of the largest |theta|
    of JAX's (a TF32 control must miss it); (c) `Insta`
    items against the JAX `Insta`'s; (d) `build_train_loop`
    without --synthetic, its 2D rows from that file, 3D and AMASS rows
    through `db_overrides`: segments of 3 windows, finite losses, ms a
    window; (e) `preprocess.mpii3d.read_test_data` on the committed MATLAB
    v7.3-style annot_data.mat against JAX's reader; (f) H5Writer's and
    open_h5's MB/s on the features."""
    import shutil

    import make_torch_insta_golden as ig
    import make_torch_preprocess_golden as pg
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.config import update_cfg
    from tepose_tpu_torch.data import h5
    from tepose_tpu_torch.data.datasets import Insta
    from tepose_tpu_torch.data.db import read_joblib
    from tepose_tpu_torch.data.synthetic import synthetic_3d_db
    from tepose_tpu_torch.preprocess import insta, mpii3d, pseudo_theta
    from tepose_tpu_torch.train.run import build_train_loop, close_loaders

    t_phase = time.perf_counter()
    saved_h5py = sys.modules.get("h5py")
    sys.modules["h5py"] = None
    try:
        golden = ig.load_golden()
        spec = golden["spec"]
        if spec != json.loads(json.dumps(ig.SPEC)):
            raise RuntimeError(f"the insta golden's spec {spec} is not "
                               f"make_torch_insta_golden.SPEC")
        mspec = dict(pg.FULL_SPEC, **{k: spec[k] for k in spec
                                      if k in pg.FULL_SPEC})
        setup = pg.port_setup(mspec, "cuda")
        sums = pg.weight_checksums(setup)
        if not np.allclose(sums, golden["weight_checksums"], rtol=1e-9,
                           atol=0):
            raise RuntimeError(f"weights rebuilt from the insta golden's "
                               f"seeds differ ({sums} vs "
                               f"{golden['weight_checksums']})")
        shutil.rmtree(P15_DIR, ignore_errors=True)
        folder = ig.fabricate_insta(os.path.join(P15_DIR, "raw"))
        if ig.input_checksums(folder) != golden["input_sha256"]:
            raise RuntimeError("the fabricated InstaVariety inputs differ "
                               "from the golden's")
        db_path = os.path.join(P15_DIR, "insta_train_db.h5")
        feat_bar = ig.FEATURE_RTOL * float(
            np.abs(golden["db/features"]).max())

        # (a) the builder on the card, the file read back without h5py
        t0 = time.perf_counter()
        insta.read_data(folder, db_path, backbone=setup["backbone"],
                        device="cuda", decode=ig.decode_png)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        with h5.open_h5(db_path) as f:
            got = {k: np.asarray(f[k]) for k in f}
        if sorted(got) != sorted(k[3:] for k in golden
                                 if k.startswith("db/")):
            raise RuntimeError(f"{db_path} holds {sorted(got)}")
        for k in ig.HOST_KEYS:
            want = golden[f"db/{k}"]
            if got[k].dtype != want.dtype or not np.array_equal(got[k],
                                                                 want):
                raise RuntimeError(f"{k} of the card's InstaVariety DB "
                                   f"differs from the JAX builder's")
        feat_dev = float(np.abs(got["features"]
                                - golden["db/features"]).max())
        n_rows = len(got["vid_name"])
        print(f"phase 15a: insta.read_data on cuda ({len(spec['videos'])} "
              f"shards, videos of {spec['videos']} frames, ResNet-50 on "
              f"224^2 crops) with h5py blocked -> {n_rows} rows of "
              f"{sorted(got)} in {build_s:.3f} s; read back by data.h5: "
              f"host arrays equal to the JAX builder's, features "
              f"{feat_dev:.3e} from its (bar {feat_bar:.3e})")
        if not feat_dev <= feat_bar:
            raise RuntimeError(f"InstaVariety features miss the golden: "
                               f"{feat_dev} > {feat_bar}")

        # (b) the pseudo-theta CLI on the card's h5 DB, and on one holding
        # the JAX builder's features, which alone can meet phase 11b's bar:
        # the card's features part from JAX's by up to 1e-4 of their
        # magnitude, and VIBE carries that into the thetas (VIBE and SMPL
        # from the seeds: there are no converted assets)
        same_dir = os.path.join(P15_DIR, "jax_features")
        os.makedirs(same_dir)
        with h5.H5Writer(os.path.join(same_dir, "insta_train_db.h5")) as w:
            for k in ("vid_name", "features"):
                w.append(k, golden[f"db/{k}"])
        loaders = pseudo_theta.load_vibe, pseudo_theta.load_smpl
        pseudo_theta.load_vibe = lambda path, device: setup["vibe"]
        pseudo_theta.load_smpl = lambda device: setup["smpl"]
        thetas, pse_s, pse_launches = {}, {}, {}
        try:
            for name, d in (("card", P15_DIR), ("jax", same_dir)):
                lbs.LAUNCHES = 0
                t0 = time.perf_counter()
                pseudo_theta.main(["--file_name", "insta_train", "--db_dir",
                                   d, "--vibe_batch_size",
                                   str(spec["vibe_batch"]), "--gpu", "0"])
                torch.cuda.synchronize()
                pse_s[name] = time.perf_counter() - t0
                pse_launches[name] = lbs.LAUNCHES
                thetas[name] = read_joblib(os.path.join(
                    d, "insta_train_pseudotheta.pt"))
        finally:
            pseudo_theta.load_vibe, pseudo_theta.load_smpl = loaders
        theta_dev = {k: float(np.abs(v - golden["pseudo_theta"]).max())
                     for k, v in thetas.items()}
        theta_bar = ig.THETA_RTOL * float(
            np.abs(golden["pseudo_theta"]).max())
        tf32_dev = float(np.abs(pseudo_thetas_tf32(
            golden["db/vid_name"], golden["db/features"], setup,
            spec["vibe_batch"]) - golden["pseudo_theta"]).max())
        _, counts = np.unique(got["vid_name"], return_counts=True)
        chunks = int(sum(-(-c // spec["vibe_batch"]) for c in counts))
        pse_ms = 1e3 * pse_s["card"] / chunks
        print(f"phase 15b: python -m tepose_tpu_torch.preprocess.pseudo_theta"
              f" --file_name insta_train on cuda -> {thetas['card'].shape} "
              f"in {pse_s['card']:.3f} s ({pse_ms:.1f} ms a chunk of <= "
              f"{spec['vibe_batch']} frames, {chunks} chunks, the h5 reads "
              f"and the file write included; {pse_s['jax']:.3f} s on the "
              f"JAX features' DB); lbs launches {pse_launches}; deviation "
              f"from the JAX golden: on the JAX builder's features "
              f"{theta_dev['jax']:.3e} (bar {theta_bar:.3e}, 1e-5 of the "
              f"largest |theta|; the TF32 control {tf32_dev:.3e}), on the "
              f"card's {theta_dev['card']:.3e} (their features differ by "
              f"{feat_dev:.3e}) [{card}]")
        if not tf32_dev > theta_bar:
            raise RuntimeError(f"the theta bar {theta_bar:.3e} does not tell "
                               f"TF32 ({tf32_dev:.3e}) from strict fp32")
        if min(pse_launches.values()) <= 0 or \
                not theta_dev["jax"] <= theta_bar or \
                not np.isfinite(thetas["card"]).all():
            raise RuntimeError(f"pseudo-theta on the InstaVariety DB: lbs "
                               f"launches {pse_launches}, deviation "
                               f"{theta_dev}")

        # (c) Insta items from the card's file and its pseudo-theta sidecar:
        # theta_pseu within the sidecar's own deviation from JAX's
        ds = Insta("x", spec["item_seqlen"], spec["item_vidlen"],
                   h5_path=db_path)
        if not isinstance(ds.db["features"], h5.H5Dataset) or \
                len(ds) != int(golden["n_items"]):
            raise RuntimeError(f"Insta over {db_path}: {len(ds)} items, "
                               f"features {type(ds.db['features'])}")
        item_dev = 0.0
        for i in spec["items"]:
            item = ds[i]
            for k in ig.item_keys():
                want, have = golden[f"item{i}/{k}"], np.asarray(item[k])
                if have.shape != want.shape:
                    raise RuntimeError(f"Insta item {i} {k}: shape "
                                       f"{have.shape} vs {want.shape}")
                bar = {"features": feat_bar,
                       "theta_pseu": theta_dev["card"]}.get(k, 0.0)
                d = float(np.abs(have.astype(np.float64) - want).max())
                if not d <= bar:
                    raise RuntimeError(f"Insta item {i} {k} is {d} from "
                                       f"the JAX Insta's (bar {bar})")
                if k == "features":
                    item_dev = max(item_dev, d)
        print(f"phase 15c: Insta(seqlen {spec['item_seqlen']}, vidlen "
              f"{spec['item_vidlen']}) over the card's file: {len(ds)} "
              f"items; items {spec['items']} against the JAX Insta's: "
              f"kp_2d, switch_id, vidlen_each equal, features "
              f"{item_dev:.3e}, theta_pseu within the sidecar's "
              f"{theta_dev['card']:.3e}")

        # (d) the training loop on the file: 2D rows from Insta, 3D and
        # AMASS rows through db_overrides, synthetic SMPL at full width
        cfg = update_cfg(os.path.join(REPO, "configs",
                                      "repr_wopw_3dpw_model.yaml"))
        cfg.OUTPUT_DIR = os.path.join(P15_DIR, "train")
        cfg.DATASET.VIDLEN = P15_VIDLEN
        cfg.TRAIN.DATASETS_2D = ["Insta"]
        cfg.TRAIN.DATASETS_3D = ["MPII3D"]
        cfg.TRAIN.DATASET_EVAL = "ThreeDPW"
        rs = np.random.RandomState(15)
        db3, pse3 = synthetic_3d_db(rs, videos=tuple(
            (P15_VIDLEN + 10, f"v{i}") for i in range(16)))
        amass = {"vid_name": np.array(["m"] * 400),
                 "theta": rs.randn(400, 82).astype(np.float32) * 0.2}
        loop, _ = build_train_loop(
            cfg, smoke_iters=P15_WINDOWS, smoke_verts=mspec["num_verts"],
            device="cuda", db_dir=P15_DIR,
            db_overrides={"mpii3d": (db3, pse3), "threedpw": (db3, pse3),
                          "amass": (amass, None)})
        try:
            part = loop.train_2d.dataset.parts[0]
            if not isinstance(part, Insta) or not isinstance(
                    part.db["features"], h5.H5Dataset):
                raise RuntimeError(f"the loop's 2D rows come from {part}")
            metrics = loop.train_epoch(0, P15_SEGMENTS)
        finally:
            close_loaders(loop)
        seg_s = list(loop.segment_seconds)
        win_ms = 1e3 * seg_s[-1] / P15_WINDOWS
        print(f"phase 15d: build_train_loop on cuda, not synthetic (batch "
              f"{loop.hp.n_2d} Insta + {loop.hp.n_3d} 3D rows, VIDLEN "
              f"{P15_VIDLEN}, 2x1024 GRUs, GCN 13/6, V={mspec['num_verts']}),"
              f" {P15_SEGMENTS} segments of {P15_WINDOWS} windows: "
              f"{win_ms:.2f} ms a window in the last (segments "
              f"{[round(t, 4) for t in seg_s]} s, host clock); gen_loss "
              f"{metrics['gen_loss']:.4f}, dis_loss "
              f"{metrics['dis_loss']:.4f} [{card}]")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"training on the InstaVariety DB gave "
                               f"{metrics}")

        # (e) the MPI-INF-3DHP test reader on the committed MATLAB file
        root = ig.write_mpii3d_test_set(os.path.join(P15_DIR, "mpii3d"))
        t0 = time.perf_counter()
        mdb = mpii3d.read_test_data(root, backbone=setup["backbone"],
                                    device="cuda")
        m_s = time.perf_counter() - t0
        mdb["img_name"] = np.array([os.path.relpath(p, root)
                                    for p in mdb["img_name"]])
        for k in ig.MPII3D_HOST_KEYS:
            want = golden[f"mpii3d/{k}"]
            if mdb[k].shape != want.shape or not np.array_equal(mdb[k],
                                                                want):
                raise RuntimeError(f"mpii3d test reader: {k} differs from "
                                   f"the JAX reader's")
        m_bar = ig.FEATURE_RTOL * float(
            np.abs(golden["mpii3d/features"]).max())
        m_dev = float(np.abs(mdb["features"]
                             - golden["mpii3d/features"]).max())
        print(f"phase 15e: mpii3d.read_test_data on the committed "
              f"annot_data.mat (MATLAB v7.3 header, deflate chunks) -> "
              f"{len(mdb['vid_name'])} rows in {m_s:.3f} s; host arrays "
              f"equal to the JAX reader's, features {m_dev:.3e} (bar "
              f"{m_bar:.3e})")
        if not m_dev <= m_bar:
            raise RuntimeError(f"mpii3d features miss the golden: {m_dev}")

        # (f) the writer and the reader on the features alone
        feats = got["features"]
        reps = max(1, (P15_RATE_MB << 20) // feats.nbytes)
        rate_path = os.path.join(P15_DIR, "rate.h5")
        t0 = time.perf_counter()
        with h5.H5Writer(rate_path) as w:
            for _ in range(reps):
                for s0 in range(0, len(feats), spec["vibe_batch"]):
                    w.append("features", feats[s0:s0 + spec["vibe_batch"]])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with h5.open_h5(rate_path) as f:
            d = f["features"]
            total = 0
            for s0 in range(0, len(d), spec["vibe_batch"]):
                total += d[s0:s0 + spec["vibe_batch"]].nbytes
        read_s = time.perf_counter() - t0
        mb = reps * feats.nbytes / 2 ** 20
        if total != reps * feats.nbytes:
            raise RuntimeError("the rate file read back short")
        os.remove(rate_path)
    finally:
        if saved_h5py is None:
            sys.modules.pop("h5py", None)
        else:
            sys.modules["h5py"] = saved_h5py
    res = {"card": card, "build_s": build_s, "rows": n_rows,
           "feature_deviation": feat_dev, "theta_deviation": theta_dev,
           "theta_bar": theta_bar, "theta_tf32_deviation": tf32_dev,
           "pseudo_s": pse_s, "pseudo_ms_per_chunk": pse_ms,
           "train_ms_per_window": win_ms, "segment_s": seg_s,
           "mpii3d_s": m_s, "writer_mb_s": mb / write_s,
           "reader_mb_s": mb / read_s,
           "seconds": time.perf_counter() - t_phase,
           "launches": {"pseudo_theta_insta": sum(pse_launches.values())}}
    print(f"phase 15f: H5Writer {res['writer_mb_s']:.1f} MB/s (appends of "
          f"{spec['vibe_batch']} rows of (N, 2048) float32, {mb:.1f} MB, "
          f"close with fsync and rename), open_h5 {res['reader_mb_s']:.1f} "
          f"MB/s (row slices of {spec['vibe_batch']}, page cache); phase 15 "
          f"took {res['seconds']:.1f} s [{card}]")
    print(json.dumps({"insta_timings": res}, default=str))
    return res


def main() -> None:
    if sys.argv[1:2] == ["--dp-worker"]:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: torch.cuda.is_available() is "
                             "False — this script needs a CUDA card")
        sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
        return dp_worker(sys.argv[2:])
    card = phase0_device()
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    if sys.argv[1:2] == ["--timings"]:
        return serve_train_timings(card)
    spent = {}

    def timed(n: int, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[n] = round(time.perf_counter() - t0, 1)
        return out

    timed(1, phase1_build)
    kern = timed(2, phase2_kernel, card)
    sl = timed(3, phase3_slice)
    timed(4, phase4_golden)
    p5 = timed(5, phase5_engine)
    p6 = timed(6, phase6_live, p5)
    p7 = timed(7, phase7_timings, p5, card)
    p8 = timed(8, phase8_train, card)
    p9 = timed(9, phase9_demo, card)
    p10 = timed(10, phase10_release, card, p5, p8)
    p11 = timed(11, phase11_preprocess, card)
    p12 = timed(12, phase12_parallel, card, sl, p6, p7)
    p13 = timed(13, phase13_bf16, card)
    p14 = timed(14, phase14_tuning, card)
    p15 = timed(15, phase15_insta, card)
    p16 = timed(16, phase16_bench, card)
    p17 = timed(17, phase17_vibe_demo, card)
    p18 = timed(18, phase18_vit_linear, card)
    print(f"seconds by phase: {json.dumps(spent)}")
    big = max(LBS_BATCHES)
    bound_ms, bound_by = kern["bound"][big]
    by_path = {"eval": sl["launches"], "engine": p5["launches"],
               "live": p6["launches"], "train_validation": p8["launches"],
               **p9["launches"], "verify_release": p10["launches"],
               **p11["launches"], **p12["launches"], **p13["launches"],
               **p14["launches"], **p15["launches"], **p16["launches"],
               **p17["launches"]}
    for B, r in {**p9["lbs"], **p11["lbs"]}.items():
        kern["device_ms"][B], kern["plain_ms"][B] = r["ms"], r["plain_ms"]
        kern["library_ms"][B] = r["library_ms"]
        kern["bound"][B] = (r["bound_ms"], r["bound_by"])
        kern["max_abs_err"] = max(kern["max_abs_err"], r["max_abs_err"])
    print(json.dumps({"kernels": [{
        "name": "lbs_skinning", "route": "cuda",
        "source": "tepose_tpu_torch/csrc/lbs_skinning.cu",
        "replaces": "tepose_tpu/ops/lbs_pallas.py:76",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["device_ms"][big], "plain_ms": kern["plain_ms"][big],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": kern["library_ms"][big],
        "library_call": "torch.einsum('jv,bjik,bvk->bvi', wT, "
                        "rel_tf[:, :, :3, :], homogeneous v_posed)",
        "shape": f"B={big} V={LBS_V} J=24",
        "device_ms_by_B": kern["device_ms"],
        "plain_ms_by_B": kern["plain_ms"],
        "library_ms_by_B": kern["library_ms"],
        "bound_ms_by_B": {B: b[0] for B, b in kern["bound"].items()},
        "share_of_bound_by_B": {B: kern["bound"][B][0] / ms
                                for B, ms in kern["device_ms"].items()},
        "host_us_per_call": kern["host_us"],
        "card": card}, {
        "name": "vit_linear", "route": "cuda",
        "source": "tepose_tpu_torch/csrc/vit_gemm_3xtf32.cu",
        "replaces": None,
        "launches_per_hmr2_chunk": p18["launches_per_hmr2_chunk"],
        "build_s": p18["build_s"], "ms_by_linear": p18["ms"],
        "err_by_shape": p18["err"], "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
