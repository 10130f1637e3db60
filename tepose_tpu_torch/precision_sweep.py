"""Precision sweep of the eval rollout on the card: accuracy and speed of
each tier of `precision.py` (float32, tensorfloat32, bfloat16).

Counterpart of `tools/precision_sweep.py` (JAX):

  python -m tepose_tpu_torch.precision_sweep [--full-vidlen] [--gpu 0|cpu]
      [--batch B] [--out tepose_tpu_torch/precision_sweep.json]

  * accuracy: the largest deviation of pred_j3d and of MPVPE from a
    float64 run of the port over a 61-window theta-feedback rollout
    (F = 66 frames, B = 2, full width: TePose 2 x 1024, VIBE 2 x 1024,
    6890 vertices); feedback compounds error, and the bar is 0.1 mm.
    `--full-vidlen` adds a 520-frame, B = 1 rollout (515 windows, the
    reference's longest eval video) for every tier. The float64 run skins
    through the plain einsum (`plain_skinning`): the kernel takes float32
    only;
  * speed: `eval_rollout` windows/s per tier at evaluate's 3dpw default
    batch (`--batch`, by default `evaluate.EVAL_BATCHING["3dpw"]` rows of
    SPEED_FRAMES frames),
    and `fast_stream_scan` windows/s at B = 192 over 485 frames for each
    tier the scan has (float32 and tensorfloat32: it has no bf16 tier).
    Host clock around work that ends in a synchronize, one untimed call a
    tier first, then the tiers in turns (in order, then reversed).

It writes the card's name and power limit, the 0.1 mm bar and a one-line
conclusion derived from the numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os.path as osp
import time
from typing import Iterator, Optional

import numpy as np
import torch

TIERS = ("float32", "tensorfloat32", "bfloat16")
SCAN_TIERS = ("float32", "tensorfloat32")
BAR_MM = 0.1
SCAN_SHAPE = (192, 485)     # streams, frames: the bench's scan shape
SPEED_FRAMES = 1024         # frames a row of the timed eval rollout
FULL_VIDLEN = 520           # frames: the reference's longest eval video
SPEED_REPS = 2
OUT_JSON = osp.join(osp.dirname(osp.abspath(__file__)),
                    "precision_sweep.json")


@contextlib.contextmanager
def plain_skinning() -> Iterator[None]:
    """SMPL skins through the plain einsum inside: the float64 oracle's
    mesh (the kernel takes float32 only), not a fallback of any path."""
    import tepose_tpu_torch.models.smpl as smpl_mod
    from tepose_tpu_torch.ops.lbs_skinning import lbs_skinning_reference

    saved = smpl_mod.lbs_skinning
    smpl_mod.lbs_skinning = lbs_skinning_reference
    try:
        yield
    finally:
        smpl_mod.lbs_skinning = saved


def tier_models(models, tier: str):
    """(smpl, gen, vibe, j_regressor, compute_dtype) of a tier or of the
    "float64" oracle, from float32 `models` (smpl, gen, vibe, jreg)."""
    smpl, gen, vibe, jreg = models
    if tier == "float64":
        return (copy.deepcopy(smpl).double(), copy.deepcopy(gen).double(),
                copy.deepcopy(vibe).double(), jreg.double(), None)
    if tier == "bfloat16":
        return (smpl, copy.deepcopy(gen).to(torch.bfloat16),
                copy.deepcopy(vibe).to(torch.bfloat16), jreg, torch.bfloat16)
    return smpl, gen, vibe, jreg, None


def rollout(models, tier: str, feats, pseu, tgt, device):
    """eval_rollout of one tier (or "float64") on numpy inputs."""
    from tepose_tpu_torch.eval.evaluator import eval_rollout
    from tepose_tpu_torch.precision import tier_scope

    smpl, gen, vibe, jreg, cd = models
    dt = torch.float64 if tier == "float64" else torch.float32
    x = [torch.from_numpy(a).to(device, dt) for a in (feats, pseu, tgt)]
    W = feats.shape[1] - gen.cfg.seqlen + 1
    with (plain_skinning() if tier == "float64"
          else contextlib.nullcontext()), \
            tier_scope("float32" if tier == "float64" else tier):
        out = eval_rollout(gen, vibe, smpl, *x, jreg, W, cd)
    return {k: out[k].double().cpu() for k in ("pred_j3d", "mpvpe")}


def measure_accuracy(device, S: int = 6, F: int = 66, B: int = 2,
                     tiers=TIERS, models=None):
    """Each tier's largest deviation (mm) from the float64 run of the port,
    over every frame of a B x F rollout; inputs drawn as the JAX tool draws
    them (SMPL seed 3, RandomState(0))."""
    from tepose_tpu_torch.tune_eval_batching import sweep_models

    smpl, gen, vibe, _ = models or sweep_models(device, smpl_seed=3)
    rng = np.random.RandomState(0)
    feats = rng.randn(B, F, 2048).astype(np.float32) * 0.2
    pseu = rng.randn(B, S - 1, 85).astype(np.float32) * 0.2
    tgt = rng.randn(B, F, 85).astype(np.float32) * 0.2
    jreg = rng.rand(17, smpl.num_verts).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    f32 = (smpl, gen, vibe, torch.as_tensor(jreg, device=device))
    ref = rollout(tier_models(f32, "float64"), "float64", feats, pseu, tgt,
                  device)
    res = {}
    for tier in tiers:
        out = rollout(tier_models(f32, tier), tier, feats, pseu, tgt, device)
        res[tier] = {
            "max_joint_dev_mm": 1e3 * float(
                (out["pred_j3d"] - ref["pred_j3d"]).abs().max()),
            "max_mpvpe_dev_mm": 1e3 * float(
                (out["mpvpe"] - ref["mpvpe"]).abs().max())}
        print(f"accuracy F={F} B={B}: {tier} joints "
              f"{res[tier]['max_joint_dev_mm']:.6g} mm, MPVPE "
              f"{res[tier]['max_mpvpe_dev_mm']:.6g} mm", flush=True)
    return res, {"S": S, "F": F, "B": B, "windows": F - S + 1}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_in_turns(fns: dict, device, reps: int = SPEED_REPS) -> dict:
    """Seconds per call of each function: one untimed call each, then
    `reps` turns, in order and reversed by turns; the median."""
    secs = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    sync(device)
    order = list(fns)
    for r in range(reps):
        for k in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            fns[k]()
            sync(device)
            secs[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in secs.items()}


def measure_speed(device, batch: int | None = None, models=None) -> dict:
    """eval_rollout windows/s per tier at `batch` rows (evaluate's 3dpw
    default if None) of SPEED_FRAMES frames, and fast_stream_scan
    windows/s per scan tier at SCAN_SHAPE."""
    from tepose_tpu_torch.evaluate import EVAL_BATCHING
    from tepose_tpu_torch.precision import tier_scope
    from tepose_tpu_torch.streaming.fast_scan import fast_stream_scan
    from tepose_tpu_torch.tune_eval_batching import sweep_models

    models = models or sweep_models(device)
    smpl, gen, _, jreg = models
    S = gen.cfg.seqlen
    rng = np.random.RandomState(0)
    B, T = batch or EVAL_BATCHING["3dpw"], SPEED_FRAMES
    feats = rng.randn(B, T, 2048).astype(np.float32) * 0.1
    pseu = np.zeros((B, S - 1, 85), np.float32)
    tgt = np.zeros((B, T, 85), np.float32)
    tgt[:, :, 0] = 1.0
    per_tier = {t: tier_models(models, t) for t in TIERS}
    secs = timed_in_turns({t: (lambda t=t: rollout(
        per_tier[t], t, feats, pseu, tgt, device)) for t in TIERS}, device)
    W = T - S + 1
    rollout_wps = {t: B * W / s for t, s in secs.items()}

    Bs, Fs = SCAN_SHAPE
    sfeats = torch.from_numpy(
        rng.randn(Bs, Fs, 2048).astype(np.float32) * 0.1).to(device)
    theta0 = torch.zeros(Bs, S - 1, 85, device=device)
    Ws = Fs - S + 1

    def scan(tier):
        with tier_scope(tier):
            fast_stream_scan(gen, smpl, sfeats, theta0, Ws,
                             outputs=("theta",))
    secs = timed_in_turns({t: (lambda t=t: scan(t)) for t in SCAN_TIERS},
                          device)
    scan_wps = {t: Bs * Ws / s for t, s in secs.items()}
    for name, wps in (("eval_rollout", rollout_wps),
                      ("fast_stream_scan", scan_wps)):
        for t, v in wps.items():
            print(f"speed: {name} {t}: {v:.1f} windows/s", flush=True)
    return {"eval_rollout_windows_per_sec": rollout_wps,
            "eval_rollout_shape": {"B": B, "T_pad": T, "windows": W},
            "fast_scan_windows_per_sec": scan_wps,
            "fast_scan_shape": {"B": Bs, "frames": Fs, "windows": Ws}}


def passes_bar(dev: dict) -> bool:
    return (dev["max_joint_dev_mm"] < BAR_MM
            and dev["max_mpvpe_dev_mm"] < BAR_MM)


def conclusion(acc: dict, speed: dict) -> str:
    """One line: which tiers meet the bar on the longest rollout measured,
    at what rollout speed against float32, and the default that follows."""
    wps = speed["eval_rollout_windows_per_sec"]
    parts = []
    for t, dev in acc.items():
        worst = max(dev["max_joint_dev_mm"], dev["max_mpvpe_dev_mm"])
        parts.append(f"{t} {'meets' if passes_bar(dev) else 'misses'} the "
                     f"{BAR_MM:g} mm bar (worst {worst:.3g} mm) at "
                     f"{wps[t] / wps['float32']:.2f}x float32's rollout "
                     f"windows/s")
    fastest_ok = max((t for t in acc if passes_bar(acc[t])),
                     key=lambda t: wps[t], default="none")
    return "; ".join(parts) + f" -> evaluate's default: {fastest_ok}"


def main(argv: Optional[list] = None) -> dict:
    from tepose_tpu_torch.config import gpu_device
    from tepose_tpu_torch.precision import strict_f32
    from tepose_tpu_torch.tune_eval_batching import device_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT_JSON)
    ap.add_argument("--full-vidlen", action="store_true",
                    help="also hold every tier to float64 on a 520-frame "
                         "(515-window) B = 1 rollout, the reference's "
                         "longest eval video")
    ap.add_argument("--gpu", default="0",
                    help="CUDA device index, or 'cpu'")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows of the timed eval rollout (default: "
                         "evaluate.EVAL_BATCHING['3dpw'])")
    args = ap.parse_args(argv)
    device = gpu_device(args.gpu)
    strict_f32()
    card = device_name(device)
    print(f"device: {card}", flush=True)
    acc, shapes = measure_accuracy(device)
    result = {"device": card, "accuracy_vs_f64_oracle": acc,
              "accuracy_shapes": shapes}
    longest = acc
    if args.full_vidlen:
        facc, fshapes = measure_accuracy(device, F=FULL_VIDLEN, B=1)
        result["full_vidlen_drift"] = {
            "accuracy_vs_f64_oracle": facc, "shapes": fshapes,
            "passes_bar": {t: passes_bar(d) for t, d in facc.items()}}
        longest = facc
    speed = measure_speed(device, args.batch)
    result.update(speed)
    result["fast_scan_tiers_absent"] = {
        "bfloat16": "the port's scan has no bf16 tier"}
    result["north_star_bar_mm"] = BAR_MM
    result["conclusion"] = conclusion(longest, speed)
    print(result["conclusion"])
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
