"""The stage attribution behind the bench, on the card:

  python -m tepose_tpu_torch.bench_notes [--stages render,stage,...]
      [--gpu 0|cpu] [--profile DIR]

Counterpart of `tools/bench_notes.py` (JAX), with its `STAGES` and its
default selection (render, stage, chunk, scaling, breakdown):

  render           the native host rasterizer (`native.render_mesh`) on a
                   6,889-vertex sphere grid over a 1080p frame: three
                   person sizes, then 2 and 4 people. Host only; the port
                   has no numpy fallback, so none is timed;
  stage            the engine's stages at `bench`'s end-to-end shapes (8
                   streams x 120 frames), each timed alone and profiled
                   once (`utils.profiling.profile_device`): ResNet-50 over
                   the 960 uint8 crops at the engine's `crop_batch`, the
                   fast scan with the engine's four outputs, and with theta
                   only (the eager scan skins every window either way);
                   wall seconds, device busy seconds, idle share, kernels;
  chunk            ResNet-50 crops/s by the engine's `crop_batch` (8, 16,
                   32, 120, 480) on 960 device-resident crops, in turns;
  scaling          the training segment at batch 32, 64, 64 in bf16, 128,
                   and 128 in bf16 (configs/fast_train.yaml), 60 windows a
                   call, in turns (`bench.time_training`);
  breakdown        forward / backward / optimizer time of a training
                   window: `train_segment(mode=)` "forward", "grad" and
                   "full" built first, then timed in turns;
  breakdown_fast   the same at the fast tier (76 + 52 rows, bf16), with
                   `ablate="disc"` to split the discriminator from the
                   generator;
  knee             batch 128 bf16, 256 float32, 256 and 512 bf16 at
                   VIDLEN 30 (a window's work depends on the batch and
                   seqlen, not VIDLEN);
  components_fast  chained bf16 matmuls at the fast tier's GCN and GRU
                   shapes and at 4096^3, TFLOP/s from two chain lengths
                   (their difference cancels the call's fixed costs) and
                   the share of the card's bf16 peak: the ceiling those
                   shapes can reach on the tensor cores.

Every timed call ends in a device synchronise, after warm-up calls;
figures are medians. No failure is caught: a stage that raises, or a
figure that is not finite, ends the run with a non-zero exit. Prints one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tepose_tpu_torch import bench
from tepose_tpu_torch.models.backbone import FEAT_DIM, resnet50_init
from tepose_tpu_torch.models.tepose import Vibe
from tepose_tpu_torch.parallel.mesh import upload
from tepose_tpu_torch.precision import device_scope
from tepose_tpu_torch.streaming.engine import ENGINE_OUTPUTS, StreamingEngine
from tepose_tpu_torch.streaming.fast_scan import fast_stream_scan
from tepose_tpu_torch.train.trainer import TrainHyper
from tepose_tpu_torch.utils import flops as FL

STAGES = ("render", "stage", "chunk", "scaling", "breakdown",
          "breakdown_fast", "knee", "components_fast")
DEFAULT_STAGES = "render,stage,chunk,scaling,breakdown"

# the fast training tier's dominant matmul shapes (m, k, n): the GCN's
# channel mixes over N*T*V = 128*6*24 rows and the GRU steps over 128 rows
FAST_TIER_MATMULS = {
    "gcn_block2_mix_18432x832x128": (18432, 832, 128),
    "gcn_block3_mix_18432x1664x256": (18432, 1664, 256),
    "gru_step_128x1024x3072": (128, 1024, 3072),
    "gru_step_128x2133x3072": (128, 2133, 3072),
    "square_4096": (4096, 4096, 4096),
}


def _engine(model: bench.BenchModel, device) -> StreamingEngine:
    """A StreamingEngine over `bench.setup`'s models, VIBE (seed 1) and
    the ResNet-50 (seed 2)."""
    gen, smpl = bench.setup(model, device)
    vibe = Vibe(model.vibe, generator=torch.Generator().manual_seed(1),
                device=device).eval()
    backbone = resnet50_init(torch.Generator().manual_seed(2), device).eval()
    return StreamingEngine(smpl, gen, vibe, backbone)


def stage_breakdown(model: bench.BenchModel = bench.FULL_MODEL,
                    n_streams: int = 8, frames: int = 120,
                    crop_size: int = 224, reps: int = 6,
                    device="cuda:0") -> Dict:
    """Wall and device seconds of each engine stage at `bench`'s
    end-to-end shapes, each stage run alone."""
    from tepose_tpu_torch.utils.profiling import profile_device

    device = torch.device(device)
    engine = _engine(model, device)
    S = model.tepose.seqlen
    W = frames - S + 1
    rng = np.random.RandomState(1)
    crops = upload(rng.randint(0, 256, (n_streams * frames, 3, crop_size,
                                        crop_size)).astype(np.uint8), device)
    feats = torch.from_numpy(rng.randn(n_streams, frames, FEAT_DIM).astype(
        np.float32) * 0.1).to(device)
    pseu = torch.zeros(n_streams, S - 1, 85, device=device)
    outs = {}

    def scan(outputs):
        def run():
            with device_scope():
                outs[len(outputs)] = fast_stream_scan(
                    engine.tepose, engine.smpl, feats, pseu, W,
                    outputs=outputs)
        return run

    def backbone():
        with device_scope():
            outs["features"] = engine._features(crops)

    stages = {f"backbone_{len(crops)}_crops": backbone,
              "scan_full_outputs": scan(ENGINE_OUTPUTS),
              "scan_theta_only": scan(("theta",))}
    secs, launches = bench.timed_turns(stages, reps, 1, device)
    for key, out in outs.items():
        for name, t in ({"features": out} if key == "features"
                        else out).items():
            bench.require_finite(f"stage {name}", t)
    res = {"crop_batch": engine.crop_batch, "streams": n_streams,
           "frames": frames, "lbs_launches": sum(launches.values())}
    for name, fn in stages.items():
        prof = profile_device(fn) if device.type == "cuda" else None
        res[f"{name}_s"] = bench.median_spread(secs[name])[0]
        res[f"{name}_device_busy_s"] = (None if prof is None
                                        else prof["busy_ms"] / 1e3)
        res[f"{name}_idle_share"] = (None if prof is None
                                     else prof["idle_share"])
        res[f"{name}_kernels"] = None if prof is None else prof["kernels"]
    return res


def backbone_chunk_sweep(chunks: Sequence[int] = (8, 16, 32, 120, 480),
                         n_crops: int = 960, crop_size: int = 224,
                         reps: int = 3,
                         model: bench.BenchModel = bench.FULL_MODEL,
                         device="cuda:0") -> Dict[str, float]:
    """ResNet-50 crops/s (float32, the engine's `_features`) by
    `crop_batch`, on device-resident uint8 crops, in turns."""
    device = torch.device(device)
    engine = _engine(model, device)
    rng = np.random.RandomState(1)
    crops = upload(rng.randint(0, 256, (n_crops, 3, crop_size, crop_size))
                   .astype(np.uint8), device)

    def run(chunk):
        def go():
            engine.crop_batch = chunk
            with device_scope():
                engine._features(crops)
        return go

    secs, _ = bench.timed_turns({c: run(c) for c in chunks}, reps, 1, device)
    return {f"chunk{c}": n_crops / bench.median_spread(secs[c])[0]
            for c in chunks}


def _hp(n_2d: int, n_3d: int, dtype: Optional[str] = None,
        seqlen: int = 6) -> TrainHyper:
    return TrainHyper(seqlen=seqlen, n_2d=n_2d, n_3d=n_3d,
                      compute_dtype=dtype)


def _train_rows(res: Dict, kind: Optional[str]) -> Dict:
    return {k: bench.train_figures(v, kind) for k, v in res.items()}


def _kind(device) -> Optional[str]:
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else None)


def train_batch_scaling(num_iters: int = 60, vidlen: int = 126,
                        reps: int = 3, burn: int = 2,
                        model: bench.BenchModel = bench.FULL_MODEL,
                        device="cuda:0") -> Dict:
    """The training segment at batch 32, 64, 64 bf16, 128 and 128 bf16, in
    turns."""
    S = model.tepose.seqlen
    variants = {
        "batch32": (num_iters, _hp(19, 13, seqlen=S), "full", None),
        "batch64": (num_iters, _hp(38, 26, seqlen=S), "full", None),
        "batch64_bf16": (num_iters, _hp(38, 26, "bfloat16", S), "full",
                         None),
        "batch128": (num_iters, _hp(76, 52, seqlen=S), "full", None),
        "fast_train_b128_bf16": (num_iters, _hp(76, 52, "bfloat16", S),
                                 "full", None),
    }
    out = _train_rows(bench.time_training(variants, model, vidlen, reps,
                                          burn, device), _kind(device))
    out["note"] = ("wps counts windows (optimizer steps); samples_per_sec = "
                   "wps x batch; fast_train_b128_bf16 is configs/"
                   "fast_train.yaml's composition")
    return out


def train_batch_knee(num_iters: int = 60, vidlen: int = 30, reps: int = 3,
                     burn: int = 2,
                     model: bench.BenchModel = bench.FULL_MODEL,
                     device="cuda:0") -> Dict:
    """The batch curve past the fast tier's 128: 128 bf16, 256 float32,
    256 and 512 bf16, 60 % of each batch 2D rows, in turns."""
    S = model.tepose.seqlen

    def hp(b, dtype=None):
        n_2d = int(b * 0.6)   # the configs' DATA_2D_RATIO split
        return _hp(n_2d, b - n_2d, dtype, S)

    variants = {"batch128_bf16": hp(128, "bfloat16"),
                "batch256_f32": hp(256),
                "batch256_bf16": hp(256, "bfloat16"),
                "batch512_bf16": hp(512, "bfloat16")}
    out = _train_rows(bench.time_training(
        {k: (num_iters, h, "full", None) for k, h in variants.items()},
        model, vidlen, reps, burn, device), _kind(device))
    out["note"] = (f"VIDLEN {vidlen}: a window's work depends on the batch "
                   "and seqlen, not VIDLEN (windows are cut per call)")
    return out


def train_time_breakdown(hp: Optional[TrainHyper] = None,
                         with_disc_ablation: bool = False,
                         num_iters: int = 60, vidlen: int = 126,
                         reps: int = 5, burn: int = 2,
                         model: bench.BenchModel = bench.FULL_MODEL,
                         device="cuda:0") -> Dict:
    """Forward / backward / optimizer ms of a training window from
    `train_segment`'s modes, all built first and timed in turns.

    "forward" computes the losses only, "grad" also the gradients (kept
    alive by their sum of squares, one extra read of every gradient that
    lands in the backward's share), "full" is the training step. With
    `with_disc_ablation`, forward and grad again with the discriminator's
    passes replaced by zeros (`ablate="disc"`): the differences split the
    discriminator from the generator in situ."""
    hp = hp or _hp(19, 13, seqlen=model.tepose.seqlen)
    variants = {"forward": ("forward", None), "grad": ("grad", None),
                "full": ("full", None)}
    if with_disc_ablation:
        variants["forward_nodisc"] = ("forward", "disc")
        variants["grad_nodisc"] = ("grad", "disc")
    res = _train_rows(bench.time_training(
        {k: (num_iters, hp, m, ab) for k, (m, ab) in variants.items()},
        model, vidlen, reps, burn, device), _kind(device))
    ms = {k: v["ms_per_window"] for k, v in res.items()}
    out = {"batch": hp.n_2d + hp.n_3d,
           "compute_dtype": hp.compute_dtype or "float32",
           "forward_ms_per_iter": ms["forward"],
           "backward_ms_per_iter": ms["grad"] - ms["forward"],
           "optimizer_ms_per_iter": ms["full"] - ms["grad"],
           "full_ms_per_iter": ms["full"],
           "wps": {k: v["wps"] for k, v in res.items()}}
    if with_disc_ablation:
        out["disc_fwd_ms_per_iter"] = ms["forward"] - ms["forward_nodisc"]
        out["disc_bwd_ms_per_iter"] = ((ms["grad"] - ms["grad_nodisc"])
                                       - (ms["forward"]
                                          - ms["forward_nodisc"]))
        out["gen_fwd_ms_per_iter"] = ms["forward_nodisc"]
        out["gen_bwd_ms_per_iter"] = ms["grad_nodisc"] - ms["forward_nodisc"]
    return out


def sphere_mesh(nu: int = 83, nv: int = 83):
    """A 0.3 x 0.9 x 0.3 ellipsoid grid of nu * nv vertices and
    2 (nu - 1) nv faces, SMPL's size (6,890 / 13,776)."""
    u = np.linspace(0, np.pi, nu)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = np.stack([0.3 * np.sin(uu) * np.cos(vv), 0.9 * np.cos(uu),
                      0.3 * np.sin(uu) * np.sin(vv)],
                     -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu - 1), np.arange(nv), indexing="ij")
    a, b = i * nv + j, i * nv + (j + 1) % nv
    c, d = (i + 1) * nv + j, (i + 1) * nv + (j + 1) % nv
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)],
                     2).reshape(-1, 3).astype(np.int32)
    return verts, faces


def render_benchmark(reps: int = 8) -> Dict:
    """The native rasterizer's ms and frames/s on a 1080p frame: one person
    at three sizes (cam scale 0.15, 0.3 ~ a 330 x 960 px demo person, 0.7
    ~ frame-filling), then 2 and 4 typical people."""
    from tepose_tpu_torch.native import render_mesh

    verts, faces = sphere_mesh()
    frame = np.zeros((1080, 1920, 3), np.uint8)

    def time_ms(fn, n):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    out = {"mesh": f"{len(verts)} verts / {len(faces)} faces, 1080p"}
    for scale, label in [(0.15, "small_person"), (0.3, "typical_person"),
                         (0.7, "frame_filling_person")]:
        cam = np.array([scale, scale * 1.78, 0.0, 0.0], np.float32)
        ms = time_ms(lambda: render_mesh(verts, faces, cam, frame.copy()),
                     reps)
        out[f"native_{label}_ms"] = ms
        out[f"native_{label}_fps"] = 1e3 / ms
    for n_people in (2, 4):
        offs = np.linspace(-0.9, 0.9, n_people)

        def multi():
            img = frame.copy()
            for k in range(n_people):
                render_mesh(verts, faces, np.array(
                    [0.3, 0.55, offs[k] * 3, 0.0], np.float32), img)

        ms = time_ms(multi, max(reps * 3 // 4, 1))
        out[f"native_typical_{n_people}people_ms"] = ms
        out[f"native_typical_{n_people}people_fps"] = 1e3 / ms
    return out


def components_fast_tier(shapes: Dict[str, tuple] = FAST_TIER_MATMULS,
                         gflop_per_call: float = 100.0, reps: int = 6,
                         device="cuda:0") -> Dict:
    """bf16 TFLOP/s of chained matmuls at each (m, k, n) of `shapes`.

    Each chain step computes `c = (a + 1e-9 * (c @ b.T)) @ b`: two
    matmuls of 2 m k n FLOPs each, the next step's operand depending on
    the whole previous product, as the GRU's recurrence does. A chain of
    K steps (at least `gflop_per_call` GFLOP) and one of 2 K are timed;
    their difference cancels the call's fixed costs."""
    device = torch.device(device)
    peak = FL.peak_flops(device, torch.bfloat16)
    rng = np.random.RandomState(0)
    cd = torch.bfloat16

    def chain(a, b, length):
        def run():
            c = a @ b
            for _ in range(length):
                c = (a + (c @ b.T) * 1e-9) @ b
            return c
        return run

    dummy = torch.ones(4, dtype=cd, device=device)
    secs, _ = bench.timed_turns({"tiny": lambda: dummy + dummy}, reps, 1,
                                device)
    out = {"call_overhead_ms": 1e3 * bench.median_spread(secs["tiny"])[0]}
    ceilings = {}
    for name, (m, k, n) in shapes.items():
        flop_one = 2 * m * k * n
        K = max(8, int(round(gflop_per_call * 1e9 / flop_one)))
        a = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(device,
                                                                     cd)
        b = torch.from_numpy(rng.randn(k, n).astype(np.float32)).to(device,
                                                                     cd)
        secs, _ = bench.timed_turns({1: chain(a, b, K), 2: chain(a, b, 2 * K)},
                                    reps, 1, device)
        dt = (bench.median_spread(secs[2])[0]
              - bench.median_spread(secs[1])[0])
        if not dt > 0:
            raise RuntimeError(f"{name}: a chain of {2 * K} steps took no "
                               f"longer than one of {K} ({dt} s)")
        rate = 2 * flop_one * K / dt
        if peak is not None and rate > peak:
            raise RuntimeError(f"{name}: {rate / 1e12:.1f} TFLOP/s is over "
                               f"the card's bf16 peak {peak / 1e12:.1f}")
        ceilings[name] = {"tflops": rate / 1e12, "chain_len": K,
                          "share_of_bf16_peak": bench.peak_share(rate, peak)}
    out["matmul_shape_ceiling"] = ceilings
    out["peak_bf16_flops"] = peak
    return out


def run_stages(selected: Sequence[str], device) -> Dict:
    """The named stages, in `STAGES` order, the host-only render first."""
    device = torch.device(device)
    out = {"card": bench.card_info(device)}
    sel = set(selected)
    if "render" in sel:
        out["render_benchmark"] = render_benchmark()
    if "stage" in sel:
        out["stage_breakdown"] = stage_breakdown(device=device)
    if "chunk" in sel:
        out["backbone_chunk_sweep_crops_per_s"] = backbone_chunk_sweep(
            device=device)
    if "scaling" in sel:
        out["train_batch_scaling"] = train_batch_scaling(device=device)
    if "breakdown" in sel:
        out["train_time_breakdown"] = train_time_breakdown(device=device)
    if "breakdown_fast" in sel:
        out["train_time_breakdown_fast_tier"] = train_time_breakdown(
            hp=_hp(76, 52, "bfloat16"), with_disc_ablation=True,
            device=device)
    if "knee" in sel:
        out["train_batch_knee"] = train_batch_knee(device=device)
    if "components_fast" in sel:
        out["components_fast_tier"] = components_fast_tier(device=device)
    out["card"]["sm_clock_mhz_end"] = bench.sm_clock_mhz(device)
    return out


def main(argv: Optional[list] = None) -> Dict:
    from tepose_tpu_torch.config import gpu_device
    from tepose_tpu_torch.precision import strict_f32
    from tepose_tpu_torch.utils.profiling import trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default=DEFAULT_STAGES,
                    help=f"comma list from {STAGES}; breakdown_fast, knee "
                         "and components_fast are off by default")
    ap.add_argument("--gpu", default="0", help="CUDA device index, or 'cpu'")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to DIR")
    args = ap.parse_args(argv)
    selected = args.stages.split(",")
    bad = set(selected) - set(STAGES)
    if bad:
        ap.error(f"unknown stages {sorted(bad)}")
    device = torch.device(gpu_device(args.gpu))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_notes: no CUDA device (use --gpu cpu)")
    strict_f32()
    if args.profile:
        with trace(args.profile, device):
            out = run_stages(selected, device)
    else:
        out = run_stages(selected, device)
    bench.check_finite(out, allow_none=True)
    print(json.dumps(out, indent=1, allow_nan=False), flush=True)
    return out


if __name__ == "__main__":
    main()
