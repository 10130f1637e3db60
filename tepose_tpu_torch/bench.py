"""The port's speed on one CUDA card, in one JSON line:

  python -m tepose_tpu_torch.bench [--gpu 0|cpu] [--profile DIR]

Counterpart of `bench.py` (JAX). It measures the TePose live-stream path
(sliding windows with theta feedback) three ways, then training:

  1. the plain window loop (`plain_stream_scan`) and the lane-batched
     `fast_stream_scan` at B = 192 streams of 485 frames (480 windows), each
     under the port's eval tiers `float32` (strict, the port's default) and
     `tensorfloat32` (Hopper TF32), through `precision.tier_scope`, reps in
     turns. Both scans skin the mesh in every window (the CUDA LBS kernel
     at B = 192), so the SMPL forward is part of their time;
  2. `StreamingEngine.run_tracklets_from_crops` on 8 streams x 120 raw
     uint8 224 x 224 crops (upload, ResNet-50, VIBE bootstrap, scan,
     readback) with four engines in turns: `parity` (float32), float32
     with float16 outputs, `preset="serving"` and `preset="serving-joints"`;
     and the device-only figure: the crops already on the card, the engine's
     own `_features` and `_boot_and_scan`, outputs left on the card;
  3. `train.trainer.train_segment` (the GAN step of `python -m
     tepose_tpu_torch.train`: fast encoder, 13/6-scale GCN, Adam 5e-5 and
     Adam 1e-4 with weight decay 1e-4) at VIDLEN 126 in three tiers, in
     turns after 2 untimed calls each: float32 at batch 32 = 19 2D + 13 3D
     rows over 120 windows a call, bf16 compute (`TrainHyper(compute_dtype=
     "bfloat16")`) over 60, and configs/fast_train.yaml's batch 128 = 76 +
     52 in bf16 over 30.

Every time is host seconds of one call that ends in a device synchronise,
after warm-up calls; a figure is the median over the reps, with the
spread (slowest, fastest) beside it. Weights and data are random, from
seeds. The shapes are `bench.py`'s; none is a measured optimum of this
card. The engine keeps its own `crop_batch` default.

Prints ONE JSON line, `{"metric": "streaming_fps_per_chip", "value",
"unit", "vs_baseline", "extra"}`: `value` is the better of the two scans
at the `float32` tier, in frames (windows) per second; `vs_baseline` is
against `BASELINE_TARGET_FPS` (4 x the reference's ~30 FPS a stream).
Nothing is caught: a failing measurement, or any figure that is not
finite, ends the run with a non-zero exit and no line. On the CPU
(`--gpu cpu`) figures that need the card (MFU, the host-to-device rate,
clocks) are null.

MFU is FLOPs that the port runs, from `utils/flops.py`'s formulas, over
the card's dense peak for the tier timed (`flops.peak_flops_for`: 67
TFLOP/s float32 on the H100 SXM, 494.5 TF32, 989.5 bf16): the scan's
window is `fast_scan_window_flops` + `regressor_ief_flops` + `smpl_flops`
(the eager scan skins every window), the engine's call is
`streaming_flops_per_call`, a training window is `train_iter_flops` with
the regressor and discriminator forwards counted by `counted_flops`.

Keys of `bench.py`'s `extra` that this line renames or drops
(`RENAMED_EXTRA`); every other key keeps its name and meaning:
  end_to_end_crops_to_verts_fps_link_bound -> end_to_end_crops_to_verts_fps
  end_to_end_f16_outputs_fps_link_bound -> end_to_end_f16_outputs_fps
  end_to_end_serving_preset_fps_link_bound -> end_to_end_serving_preset_fps
  end_to_end_serving_joints_fps_link_bound -> end_to_end_serving_joints_fps
      the suffix named the TPU's remote link; here the path's host work is
      PCIe copies to and from pinned memory, part of what the user pays;
  host_link_MB_per_sec -> host_to_device_MB_per_sec
      a pinned 32 MiB host-to-device copy over PCIe, not the remote link;
  windows_scan_strict_f32_fps: dropped. The port's default tier is strict
      float32, so it is `windows_scan_fast_fps`.
Rewritten for the card with their keys kept: `precision_note`,
`serving_preset_note`, `link_bound_note`, `mfu_note`, `train_timing_note`,
`train_bf16_note`, `train_fast_note`; `peak_flops_assumed` is the card's
peak per tier. Added: `card` (nvidia-smi's name and power limit),
`sm_clock_mhz_start` / `_end`, `device`, `windows_scan_plain_tf32_fps`,
the spreads of every rate, `train_ms_per_window` and `lbs_launches` (the
LBS kernel's launches on each measured path).

The functions take the model, the shapes, the reps and the device, so a
test runs the whole bench at a tiny width on the CPU; the CLI runs
`FULL_MODEL`, `FULL_SHAPES` and `FULL_REPS`. `--profile DIR` wraps the
timed section in `utils.profiling.trace`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tepose_tpu_torch.models.backbone import FEAT_DIM, resnet50_init
from tepose_tpu_torch.models.gcn import MotionDiscriminator
from tepose_tpu_torch.models.smpl import SmplModel, synthetic_smpl_model
from tepose_tpu_torch.models.tepose import (
    TePose, TePoseConfig, Vibe, VibeConfig)
from tepose_tpu_torch.ops import lbs_skinning
from tepose_tpu_torch.parallel.mesh import upload
from tepose_tpu_torch.precision import device_scope, strict_f32, tier_scope
from tepose_tpu_torch.streaming.engine import StreamingEngine
from tepose_tpu_torch.streaming.fast_scan import (
    fast_stream_scan, plain_stream_scan)
from tepose_tpu_torch.train.loss import LossWeights
from tepose_tpu_torch.train.optim import make_optimizer
from tepose_tpu_torch.train.trainer import TrainHyper, train_segment
from tepose_tpu_torch.utils import flops as FL

BASELINE_TARGET_FPS = 120.0   # 4 x the reference's ~30 FPS a stream

SCAN_TIERS = ("float32", "tensorfloat32")   # the first is the default

RENAMED_EXTRA = {
    "end_to_end_crops_to_verts_fps_link_bound":
        "end_to_end_crops_to_verts_fps",
    "end_to_end_f16_outputs_fps_link_bound": "end_to_end_f16_outputs_fps",
    "end_to_end_serving_preset_fps_link_bound":
        "end_to_end_serving_preset_fps",
    "end_to_end_serving_joints_fps_link_bound":
        "end_to_end_serving_joints_fps",
    "host_link_MB_per_sec": "host_to_device_MB_per_sec",
    "windows_scan_strict_f32_fps": None,
}


@dataclasses.dataclass(frozen=True)
class BenchModel:
    """The measured models' widths: TePose, the bootstrap VIBE, SMPL."""

    tepose: TePoseConfig = TePoseConfig(seqlen=6, n_layers=2,
                                        hidden_size=1024)
    vibe: VibeConfig = VibeConfig(seqlen=16, n_layers=2, hidden_size=1024)
    num_verts: int = 6890


class TrainTier(NamedTuple):
    name: str
    iters: int                   # windows a segment call
    n_2d: int
    n_3d: int
    compute_dtype: Optional[str]


@dataclasses.dataclass(frozen=True)
class BenchShapes:
    streams: int = 192           # the scans' concurrent streams
    frames: int = 485            # frames a stream: 480 windows
    e2e_streams: int = 8
    e2e_frames: int = 120
    crop_size: int = 224
    train_vidlen: int = 126
    train_tiers: Tuple[TrainTier, ...] = (
        TrainTier("f32", 120, 19, 13, None),
        TrainTier("bf16", 60, 19, 13, "bfloat16"),
        TrainTier("fast", 30, 76, 52, "bfloat16"))


@dataclasses.dataclass(frozen=True)
class Reps:
    scan: int = 5                # timed calls of each scan variant
    e2e: int = 3                 # of each engine
    e2e_device: int = 8          # of the device-only engine call
    train: int = 4               # of each training tier
    burn: int = 1                # untimed calls of each inference variant
    train_burn: int = 2          # after prepare_training's warm-up call


FULL_MODEL, FULL_SHAPES, FULL_REPS = BenchModel(), BenchShapes(), Reps()


# ------------------------------------------------------------------ timing

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_turns(fns: Dict[str, Callable[[], object]], reps: int, burn: int,
                device) -> Tuple[Dict[str, List[float]], Dict[str, int]]:
    """Host seconds of each of `fns`' calls, each ending in a device
    synchronise, in turns: `burn` untimed rounds over all of them, then
    `reps` timed rounds. Also each one's LBS kernel launches over all its
    calls."""
    device = torch.device(device)
    secs = {k: [] for k in fns}
    launches = dict.fromkeys(fns, 0)
    for r in range(burn + reps):
        for name, fn in fns.items():
            before = lbs_skinning.LAUNCHES
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            dt = time.perf_counter() - t0
            launches[name] += lbs_skinning.LAUNCHES - before
            if r >= burn:
                secs[name].append(dt)
    return secs, launches


def median_spread(ts: List[float]) -> Tuple[float, float, float]:
    """(median, fastest, slowest) of the times `ts`."""
    return float(np.median(ts)), float(min(ts)), float(max(ts))


def _rate(work: float, ts: List[float]) -> Tuple[float, List[float]]:
    """`work` per second at the median time, and at the slowest and the
    fastest."""
    med, lo, hi = median_spread(ts)
    return work / med, [work / hi, work / lo]


def peak_share(flops_per_s: float, peak: Optional[float]) -> Optional[float]:
    return None if peak is None else flops_per_s / peak


def require_finite(name: str, t: torch.Tensor) -> None:
    if not torch.isfinite(t).all():
        raise RuntimeError(f"non-finite {name}")


# ------------------------------------------------------------------- setup

def setup(model: BenchModel, device) -> Tuple[TePose, SmplModel]:
    """TePose (seed 0) and the synthetic SMPL (seed 0) on `device`."""
    gen = TePose(model.tepose, generator=torch.Generator().manual_seed(0),
                 device=device)
    return gen.eval(), synthetic_smpl_model(0, model.num_verts, device=device)


def card_info(device) -> Dict:
    """The card's nvidia-smi name and power limit, its torch name and its
    SM clock now; "cpu" and nulls on the CPU."""
    from tepose_tpu_torch.tune_eval_batching import device_name

    device = torch.device(device)
    cuda = device.type == "cuda"
    return {"card": device_name(device), "device": str(device),
            "kind": torch.cuda.get_device_name(device) if cuda else None,
            "sm_clock_mhz_start": sm_clock_mhz(device)}


def sm_clock_mhz(device) -> Optional[int]:
    """The card's SM clock as nvidia-smi reads it, None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout
    return int(out.strip())


def host_to_device_mb_per_s(device, mib: int = 32,
                            reps: int = 5) -> Optional[float]:
    """MB/s (1e6 bytes) of a pinned `mib` MiB host-to-device copy, median
    over `reps` after one warm-up; None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    src = torch.empty(mib << 20, dtype=torch.uint8).pin_memory()
    dst = torch.empty_like(src, device=device)
    ts = []
    for r in range(reps + 1):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(device)
        if r:
            ts.append(time.perf_counter() - t0)
    return src.numel() / 1e6 / float(np.median(ts))


# ------------------------------------------------------------------- scans

def scan_inputs(streams: int, frames: int, seqlen: int, device):
    """The scans' features (streams, frames, 2048) from RandomState(0) x 0.1
    and an all-zero theta ring (streams, seqlen - 1, 85), on `device`."""
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(
        rng.randn(streams, frames, FEAT_DIM).astype(np.float32) * 0.1)
    return (feats.to(device),
            torch.zeros(streams, seqlen - 1, 85, device=device))


def measure_window_scans(gen: TePose, smpl: SmplModel, shapes: BenchShapes,
                         reps: Reps, device) -> Dict:
    """The plain and the fast scan under each of SCAN_TIERS, in turns.

    Returns their seconds a call ("plain_float32", ...), the windows a
    call, the LBS launches of each scan over all its calls and the last
    thetas (streams, windows, 85) of both scans at the default tier."""
    S = gen.cfg.seqlen
    W = shapes.frames - S + 1
    feats, theta0 = scan_inputs(shapes.streams, shapes.frames, S, device)
    scans = {"plain": plain_stream_scan, "fast": fast_stream_scan}
    thetas: Dict[str, torch.Tensor] = {}

    def variant(name: str, tier: str):
        def run():
            with tier_scope(tier):
                thetas[f"{name}_{tier}"] = scans[name](
                    gen, smpl, feats, theta0, W, outputs=("theta",))["theta"]
        return run

    fns = {f"{name}_{tier}": variant(name, tier)
           for tier in SCAN_TIERS for name in scans}
    secs, launches = timed_turns(fns, reps.scan, reps.burn, device)
    for name, t in thetas.items():
        require_finite(f"{name} scan thetas", t)
    return {"seconds": secs, "windows": W,
            "launches": {name: sum(v for k, v in launches.items()
                                   if k.startswith(name + "_"))
                         for name in scans},
            "theta": {name: thetas[f"{name}_{SCAN_TIERS[0]}"]
                      for name in scans}}


# ------------------------------------------------------------- end to end

def measure_end_to_end(gen: TePose, smpl: SmplModel, model: BenchModel,
                       shapes: BenchShapes, reps: Reps, device) -> Dict:
    """The engine from raw uint8 crops to outputs, four engines in turns,
    then the `parity` engine's device work alone. Returns seconds a call
    by engine ("f32", "f16", "serving", "joints", "device") and the LBS
    launches of all of them."""
    device = torch.device(device)
    n, frames, S = shapes.e2e_streams, shapes.e2e_frames, model.tepose.seqlen
    vibe = Vibe(model.vibe, generator=torch.Generator().manual_seed(1),
                device=device).eval()
    backbone = resnet50_init(torch.Generator().manual_seed(2), device).eval()

    def make(**kw) -> StreamingEngine:
        return StreamingEngine(smpl, gen, vibe, backbone,
                               window_bucket=frames, **kw)

    engines = {"f32": make(), "f16": make(output_dtype=torch.float16),
               "serving": make(preset="serving"),
               "joints": make(preset="serving-joints")}
    rng = np.random.RandomState(1)
    size = shapes.crop_size
    crops = [rng.randint(0, 256, (frames, 3, size, size)).astype(np.uint8)
             for _ in range(n)]
    outs: Dict[str, list] = {}

    def run(name: str):
        def go():
            outs[name] = engines[name].run_tracklets_from_crops(crops)
        return go

    secs, launches = timed_turns({k: run(k) for k in engines}, reps.e2e,
                                 reps.burn, device)
    for name, results in outs.items():
        for r in results:
            if not np.isfinite(r["theta"]).all():
                raise RuntimeError(f"non-finite {name} engine thetas")
    want = {"f32": np.float32, "f16": np.float16, "serving": np.float16}
    for name, dtype in want.items():
        if outs[name][0]["verts"].shape != (frames, model.num_verts, 3) or \
                outs[name][0]["verts"].dtype != dtype:
            raise RuntimeError(f"{name} engine verts: "
                               f"{outs[name][0]['verts'].shape} "
                               f"{outs[name][0]['verts'].dtype}")
    if "verts" in outs["joints"][0]:
        raise RuntimeError("the serving-joints engine returned vertices")

    # device work alone: crops already on the card, outputs left there
    engine = engines["f32"]
    crops_dev = upload(np.concatenate(crops), device)
    pseu = upload(engine._pseu_batch(n, [None] * n, range(n)), device)
    dev_out = {}

    def device_only():
        with device_scope():
            feats = engine._features(crops_dev).reshape(n, frames, FEAT_DIM)
            dev_out["out"] = engine._boot_and_scan(feats, pseu,
                                                   frames - S + 1)

    dsecs, dlaunches = timed_turns({"device": device_only}, reps.e2e_device,
                                   reps.burn, device)
    require_finite("device-only engine thetas", dev_out["out"]["theta"])
    return {"seconds": {**secs, **dsecs}, "frames": n * frames,
            "launches": sum(launches.values()) + dlaunches["device"]}


# --------------------------------------------------------------- training

def training_batch(hp: TrainHyper, num_iters: int, vidlen: int):
    """`bench.py`'s random batch: (batch_2d, batch_3d, amass windows), from
    RandomState(0)."""
    rng = np.random.RandomState(0)
    V, S, B = vidlen, hp.seqlen, hp.n_2d + hp.n_3d
    switch = np.zeros((hp.n_2d, 2, V), np.float32)
    switch[:, 0, :V // 2] = 1
    switch[:, 1, V // 2:] = 1
    batch_2d = {
        "features": rng.randn(hp.n_2d, 2, V, FEAT_DIM).astype(np.float32),
        "theta_pseu": rng.randn(hp.n_2d, 2, V, 85).astype(np.float32) * 0.1,
        "kp_2d": rng.randn(hp.n_2d, V, 49, 3).astype(np.float32),
        "switch_id": switch,
        "vidlen_each": np.full((hp.n_2d,), V, np.float32),
    }
    batch_3d = {
        "features": rng.randn(hp.n_3d, V, FEAT_DIM).astype(np.float32),
        "theta_pseu": rng.randn(hp.n_3d, V, 85).astype(np.float32) * 0.1,
        "kp_2d": rng.randn(hp.n_3d, V, 49, 3).astype(np.float32),
        "kp_3d": rng.randn(hp.n_3d, V, 49, 3).astype(np.float32),
        "theta": rng.randn(hp.n_3d, V, 85).astype(np.float32) * 0.1,
        "w_3d": np.ones((hp.n_3d, V), np.float32),
        "w_smpl": np.ones((hp.n_3d, V), np.float32),
        "vidlen_each": np.full((hp.n_3d,), V, np.float32),
    }
    amass = rng.randn(num_iters, B, S, 85).astype(np.float32) * 0.1
    return batch_2d, batch_3d, amass


def training_iter_flops(gen: TePose, disc: MotionDiscriminator,
                        smpl: SmplModel, hp: TrainHyper) -> float:
    """`flops.train_iter_flops` of one window at `hp`'s batch, with the
    regressor's train forward (2 rows a sample, no vertices) and one
    discriminator pass counted by `counted_flops` on the models."""
    device = smpl.v_template.device
    B, S, cfg = hp.n_2d + hp.n_3d, hp.seqlen, gen.cfg
    disc.eval()   # the count must not move the BN running statistics
    with torch.no_grad():
        reg = FL.counted_flops(gen.regressor, torch.zeros(
            2 * B, FEAT_DIM, device=device), smpl, compute_verts=False)
        dsc = FL.counted_flops(disc, torch.zeros(B, S, 72, device=device))
    disc.train()
    return FL.train_iter_flops(B, S, cfg.n_layers, cfg.hidden_size,
                               regressor_fwd=reg, disc_fwd=dsc)


class PreparedTraining(NamedTuple):
    run: Callable[[], None]                   # one segment call, read back
    finish: Callable[[List[float]], Dict]     # its seconds -> raw result


def prepare_training(model: BenchModel, hp: TrainHyper, num_iters: int,
                     vidlen: int, device, mode: str = "full",
                     ablate: Optional[str] = None) -> PreparedTraining:
    """Build one training segment at `hp` and warm it with one call.

    Fresh models (TePose seed 0 with the fast encoder, as `python -m
    tepose_tpu_torch.train` builds it; GCN seed 1), both Adam optimizers
    and `training_batch`'s data; `mode` and `ablate` are
    `train_segment`'s. `run()` is one call of `num_iters` windows, ending
    in its metrics' readback; `finish(seconds)` raises unless the last
    call's metrics are finite and returns the raw result."""
    device = torch.device(device)
    cfg = dataclasses.replace(model.tepose, fast_encoder=True)
    gen = TePose(cfg, generator=torch.Generator().manual_seed(0),
                 device=device)
    disc = MotionDiscriminator(
        generator=torch.Generator().manual_seed(1), device=device,
        num_gcn_scales=hp.num_gcn_scales, num_g3d_scales=hp.num_g3d_scales)
    smpl = synthetic_smpl_model(0, model.num_verts, device=device)
    gen_opt = make_optimizer("adam", gen, 5e-5)
    disc_opt = make_optimizer("adam", disc, 1e-4, weight_decay=1e-4)
    batch_2d, batch_3d, amass = training_batch(hp, num_iters, vidlen)
    draws = torch.Generator(device=device).manual_seed(0)
    iter_flops = training_iter_flops(gen, disc, smpl, hp)
    state: Dict[str, Dict[str, float]] = {}

    def run() -> None:
        state["metrics"] = train_segment(
            gen, disc, smpl, gen_opt, disc_opt, hp, LossWeights(), batch_2d,
            batch_3d, amass, draws, mode=mode, ablate=ablate)

    def finish(seconds: List[float]) -> Dict:
        bad = {k: v for k, v in state["metrics"].items()
               if not math.isfinite(v)}
        if bad:
            raise RuntimeError(f"non-finite training metrics {bad} "
                               f"(batch {hp.n_2d}+{hp.n_3d}, "
                               f"{hp.compute_dtype or 'float32'}, {mode})")
        return {"seconds": list(seconds), "iters": num_iters,
                "n_2d": hp.n_2d, "n_3d": hp.n_3d,
                "compute_dtype": hp.compute_dtype, "iter_flops": iter_flops}

    run()
    return PreparedTraining(run, finish)


def time_training(variants: Dict[str, tuple], model: BenchModel,
                  vidlen: int, reps: int, burn: int, device) -> Dict:
    """Prepare every variant (name -> (iters, TrainHyper, mode, ablate)),
    then time them in turns: `burn` untimed and `reps` timed calls each.
    Returns each one's raw result (`PreparedTraining.finish`)."""
    prepared = {name: prepare_training(model, hp, iters, vidlen, device,
                                       mode, ablate)
                for name, (iters, hp, mode, ablate) in variants.items()}
    secs, _ = timed_turns({k: p.run for k, p in prepared.items()}, reps,
                          burn, device)
    return {k: p.finish(secs[k]) for k, p in prepared.items()}


def measure_training_tiers(model: BenchModel, shapes: BenchShapes,
                           reps: Reps, device) -> Dict:
    """`shapes.train_tiers` in turns (`time_training`)."""
    S = model.tepose.seqlen
    variants = {t.name: (t.iters, TrainHyper(seqlen=S, n_2d=t.n_2d,
                                             n_3d=t.n_3d,
                                             compute_dtype=t.compute_dtype),
                         "full", None)
                for t in shapes.train_tiers}
    return time_training(variants, model, shapes.train_vidlen, reps.train,
                         reps.train_burn, device)


def train_figures(raw: Dict, kind: Optional[str]) -> Dict:
    """Windows/s (median and spread), ms a window, GFLOP a window and MFU
    over the peak of the card named `kind` (None: no MFU) for the tier's
    compute dtype, from a `time_training` result."""
    iters, batch = raw["iters"], raw["n_2d"] + raw["n_3d"]
    wps, spread = _rate(iters, raw["seconds"])
    peak = (FL.peak_flops_for(kind, raw["compute_dtype"] or "float32")
            if kind else None)
    return {"wps": wps, "wps_spread": spread, "ms_per_window": 1e3 / wps,
            "mfu": peak_share(raw["iter_flops"] * wps, peak),
            "gflops_per_iter": raw["iter_flops"] / 1e9,
            "samples_per_sec": wps * batch, "batch": batch,
            "n_2d": raw["n_2d"], "n_3d": raw["n_3d"],
            "reps": len(raw["seconds"])}


# ---------------------------------------------------------------- summary

def measure(model: BenchModel = FULL_MODEL, shapes: BenchShapes = FULL_SHAPES,
            reps: Reps = FULL_REPS, device="cuda:0",
            profile_dir: Optional[str] = None) -> Dict:
    """Every measurement of the line, raw (seconds, counts, outputs)."""
    from tepose_tpu_torch.utils.profiling import trace

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (use --gpu cpu for the host)")
    strict_f32()
    card = card_info(device)
    gen, smpl = setup(model, device)
    h2d = host_to_device_mb_per_s(device)
    with (trace(profile_dir, device) if profile_dir
          else contextlib.nullcontext()):
        scans = measure_window_scans(gen, smpl, shapes, reps, device)
        e2e = measure_end_to_end(gen, smpl, model, shapes, reps, device)
        train = measure_training_tiers(model, shapes, reps, device)
    card["sm_clock_mhz_end"] = sm_clock_mhz(device)
    return {"card": card, "host_to_device_MB_per_s": h2d, "scans": scans,
            "e2e": e2e, "train": train}


def scan_window_flops(model: BenchModel) -> float:
    """FLOPs of one window of the eager scan: the fast encoder with
    precomputed projections, the IEF head and the SMPL forward."""
    c = model.tepose
    return float(FL.fast_scan_window_flops(c.seqlen, c.n_layers,
                                           c.hidden_size)
                 + FL.regressor_ief_flops() + FL.smpl_flops(model.num_verts))


def summarize(model: BenchModel, shapes: BenchShapes, raw: Dict) -> Dict:
    """The JSON line's object from `measure`'s raw result."""
    kind = raw["card"]["kind"]
    peak = {t: FL.peak_flops_for(kind, t) if kind else None
            for t in ("float32", "tf32", "bfloat16")}
    c = model.tepose

    sc = raw["scans"]
    scan = {k: _rate(shapes.streams * sc["windows"], ts)
            for k, ts in sc["seconds"].items()}
    plain, fast = scan["plain_float32"][0], scan["fast_float32"][0]
    best = max(plain, fast)

    e2e = raw["e2e"]
    fps = {k: _rate(e2e["frames"], ts) for k, ts in e2e["seconds"].items()}
    call_flops = FL.streaming_flops_per_call(
        shapes.e2e_streams, shapes.e2e_frames, c.seqlen, c.n_layers,
        c.hidden_size, model.num_verts, shapes.crop_size)
    flops_per_frame = call_flops / e2e["frames"]

    tr = {k: train_figures(v, kind) for k, v in raw["train"].items()}
    f32, bf16, fastt = tr["f32"], tr["bf16"], tr["fast"]
    r1, r4 = (lambda v: None if v is None else round(v, 1),
              lambda v: None if v is None else round(v, 4))
    spread = lambda s: [round(x, 1) for x in s]   # noqa: E731

    return {
        "metric": "streaming_fps_per_chip",
        "value": round(best, 1),
        "unit": f"frames/sec ({shapes.streams} concurrent streams, "
                f"seqlen-{c.seqlen} windows, SMPL vertices every window)",
        "vs_baseline": round(best / BASELINE_TARGET_FPS, 2),
        "extra": {
            "card": raw["card"]["card"],
            "device": raw["card"]["device"],
            "sm_clock_mhz_start": raw["card"]["sm_clock_mhz_start"],
            "sm_clock_mhz_end": raw["card"]["sm_clock_mhz_end"],
            "end_to_end_device_compute_fps": r1(fps["device"][0]),
            "end_to_end_device_compute_fps_spread": spread(fps["device"][1]),
            "e2e_device_mfu": r4(peak_share(fps["device"][0] * flops_per_frame,
                                        peak["float32"])),
            "e2e_gflops_per_frame": round(flops_per_frame / 1e9, 3),
            "windows_scan_plain_fps": r1(plain),
            "windows_scan_plain_fps_spread": spread(
                scan["plain_float32"][1]),
            "windows_scan_fast_fps": r1(fast),
            "windows_scan_fast_fps_spread": spread(scan["fast_float32"][1]),
            "windows_scan_mfu": r4(peak_share(best * scan_window_flops(model),
                                          peak["float32"])),
            "windows_scan_tf32_fps": r1(scan["fast_tensorfloat32"][0]),
            "windows_scan_tf32_fps_spread": spread(
                scan["fast_tensorfloat32"][1]),
            "windows_scan_plain_tf32_fps": r1(
                scan["plain_tensorfloat32"][0]),
            "windows_scan_plain_tf32_fps_spread": spread(
                scan["plain_tensorfloat32"][1]),
            "precision_note": "the scans' fps, value and windows_scan_mfu "
                              "are the port's default eval tier, strict "
                              "float32 (TF32 off in cuBLAS and cuDNN); "
                              "*_tf32_fps are the tensorfloat32 tier "
                              "(Hopper TF32), whose drift from a float64 "
                              "run is in tepose_tpu_torch/"
                              "precision_sweep.json",
            "end_to_end_crops_to_verts_fps": r1(fps["f32"][0]),
            "end_to_end_crops_to_verts_fps_spread": spread(fps["f32"][1]),
            "end_to_end_f16_outputs_fps": r1(fps["f16"][0]),
            "end_to_end_f16_outputs_fps_spread": spread(fps["f16"][1]),
            "end_to_end_serving_preset_fps": r1(fps["serving"][0]),
            "end_to_end_serving_preset_fps_spread": spread(
                fps["serving"][1]),
            "end_to_end_serving_joints_fps": r1(fps["joints"][0]),
            "end_to_end_serving_joints_fps_spread": spread(fps["joints"][1]),
            "serving_preset_note": "StreamingEngine presets: 'serving' runs "
                                   "a bfloat16 ResNet-50 and float16 "
                                   "outputs (theta float32), "
                                   "'serving-joints' the same with theta "
                                   "and kp_3d only; f16_outputs is the "
                                   "parity engine with float16 outputs",
            "link_bound_note": "end_to_end_*_fps time whole engine calls: "
                               "the uint8 crops' upload and the outputs' "
                               "readback over PCIe through pinned memory "
                               "(host_to_device_MB_per_sec), the host's "
                               "launches and the device work; "
                               "end_to_end_device_compute_fps is the "
                               "parity engine's device work with the crops "
                               "already on the card",
            "train_windows_per_sec": r1(f32["wps"]),
            "train_windows_per_sec_spread": spread(f32["wps_spread"]),
            "train_ms_per_window": round(f32["ms_per_window"], 3),
            "train_mfu": r4(f32["mfu"]),
            "train_gflops_per_iter": round(f32["gflops_per_iter"], 1),
            "train_bf16_windows_per_sec": r1(bf16["wps"]),
            "train_bf16_windows_per_sec_spread": spread(bf16["wps_spread"]),
            "train_bf16_mfu": r4(bf16["mfu"]),
            "train_timing_note": f"median of {f32['reps']} calls a tier in "
                                 "turns (f32, bf16, fast), after a warm-up "
                                 "call and untimed calls of each",
            "train_bf16_note": "TrainHyper(compute_dtype='bfloat16'), "
                               "`train --precision bf16`: bf16 parameters "
                               "and inputs inside the step, float32 master "
                               "weights, optimizer state and statistics; "
                               "MFU over the bf16 peak",
            "train_fast_windows_per_sec": r1(fastt["wps"]),
            "train_fast_windows_per_sec_spread": spread(fastt["wps_spread"]),
            "train_fast_mfu": r4(fastt["mfu"]),
            "train_fast_samples_per_sec": round(fastt["samples_per_sec"], 0),
            "train_fast_note": "configs/fast_train.yaml's composition: "
                               f"batch {fastt['batch']} ({fastt['n_2d']} 2D "
                               f"+ {fastt['n_3d']} 3D) in bf16; samples/s = "
                               "windows/s x batch, against the f32 tier's "
                               f"windows/s x {f32['batch']}",
            "model_gflops_per_frame": {
                k: round(v / 1e9, 3) for k, v in FL.model_flops_per_frame(
                    c.seqlen, c.n_layers, c.hidden_size,
                    model.num_verts).items()},
            "peak_flops_assumed": peak,
            "mfu_note": "MFU = FLOPs the port runs (utils/flops.py's "
                        "formulas; the regressor and discriminator "
                        "forwards counted by counted_flops) / median wall "
                        "time / the card's dense peak for the tier timed "
                        "(peak_flops_assumed): float32 for the scans, the "
                        "engine and f32 training, bfloat16 for the bf16 "
                        "and fast tiers; null without a card",
            "train_note": f"train_segment, batch {f32['batch']} "
                          f"({f32['n_2d']} 2D + {f32['n_3d']} 3D), VIDLEN "
                          f"{shapes.train_vidlen}, seqlen {c.seqlen}, "
                          f"{c.n_layers} x {c.hidden_size} GRUs through the "
                          "fast encoder, GCN 13/6 scales, scheduled "
                          "sampling, both Adam steps every window",
            "host_to_device_MB_per_sec": r1(raw["host_to_device_MB_per_s"]),
            "end_to_end_note": f"{shapes.e2e_streams} streams x "
                               f"{shapes.e2e_frames} raw uint8 "
                               f"{shapes.crop_size} x {shapes.crop_size} "
                               "crops through run_tracklets_from_crops "
                               "(ResNet-50, VIBE bootstrap, fast scan, "
                               "SMPL); four engines in turns",
            "lbs_launches": {"bench_scan_plain": sc["launches"]["plain"],
                             "bench_scan_fast": sc["launches"]["fast"],
                             "bench_e2e": e2e["launches"]},
        },
    }


def check_finite(obj, allow_none: bool, path: str = "") -> None:
    """Raise ValueError at the first number in `obj` that is not finite,
    or at a null where `allow_none` is false."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            check_finite(v, allow_none, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            check_finite(v, allow_none, f"{path}[{i}]")
    elif obj is None:
        if not allow_none:
            raise ValueError(f"{path or 'value'} is null")
    elif isinstance(obj, float) and not math.isfinite(obj):
        raise ValueError(f"{path or 'value'} is {obj}")


def main(argv: Optional[list] = None, model: BenchModel = FULL_MODEL,
         shapes: BenchShapes = FULL_SHAPES, reps: Reps = FULL_REPS) -> Dict:
    from tepose_tpu_torch.config import gpu_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpu", default="0",
                    help="CUDA device index, or 'cpu' (null MFU and rates)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the timed section "
                         "to DIR")
    args = ap.parse_args(argv)
    device = torch.device(gpu_device(args.gpu))
    line = summarize(model, shapes, measure(model, shapes, reps, device,
                                            args.profile))
    check_finite(line, allow_none=device.type != "cuda")
    print(json.dumps(line, allow_nan=False), flush=True)
    return line


if __name__ == "__main__":
    main()
