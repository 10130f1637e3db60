"""Measure evaluate's batching knobs on the card: MAX_B, and optionally a
length bucket, over a video-length distribution shaped like the eval sets.

Counterpart of `tools/tune_eval_batching.py` (JAX):

  python -m tepose_tpu_torch.tune_eval_batching [--dataset 3dpw|h36m]
      [--scale 1.0] [--batches 8 16 32 64 128]
      [--bucket_sizes 0 128 ...] [--points B64 B32_bucket128 ...]
      [--max_len 5000] [--gpu 0|cpu]
      [--out tepose_tpu_torch/eval_batching_sweep.json]

Each grid point is a plan (`evaluate.plan_eval_batches`) walked chunk by
chunk through `evaluate.rollout_chunk` (host padding, upload, the
full-width `eval_rollout` in strict float32 under `device_scope`, readback),
exactly as `run_eval` does; host metrics are per video and left out.
TePose seqlen 6 with 2 x 1024 GRUs, VIBE 16 with 2 x 1024 and
`add_linear`, the synthetic 6890-vertex SMPL and a 17-row regressor, all
random from seeds. The port compiles nothing, so what a plan trades is
window steps (one launch-bound window a step, whatever B) against padded
rows and device memory. Bucket 0 (the default, and evaluate's) is no
bucket: each chunk of the length-sorted videos pads to its longest video.

Per point: useful frames/s over a whole pass, the first call of each new
(B, T_pad) shape included (each pass starts from an emptied allocator
cache, as a fresh process does), the steady seconds without those first
calls, window steps, chunks, distinct shapes, the share of padded frame
slots filled, ms a window step, peak device memory and LBS launches.
Every point runs twice, in turns, the second pass with the grid order
rotated by half (host clocks spread widely between runs); points whose
plans are identical are measured once and name the point they share it
with. `best_row` picks the best of the measured rows, the one
`evaluate.EVAL_BATCHING` takes. `--out` merges the dataset's rows into a
JSON file in the JAX tool's schema, with the card's name and power limit
and the grid that was run.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import re
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

SEQLEN = 6
GRID_BATCHES = (8, 16, 32, 64, 128)
GRID_BUCKETS = (0,)          # 0: no bucket, as evaluate's default
SWEEP_JSON = osp.join(osp.dirname(osp.abspath(__file__)),
                      "eval_batching_sweep.json")
NOTE = ("useful frames/s of evaluate's rollout per plan (host padding, "
        "upload, eval_rollout in strict float32, readback; first call of "
        "each new shape included), two passes in turns on the named card; "
        "bucket null: each chunk of the length-sorted videos pads to its "
        "longest; evaluate.EVAL_BATCHING takes each dataset's best measured "
        "row (tune_eval_batching.best_row); 'grid' lists every point run.")


def video_lengths(dataset: str, scale: float, seed: int = 0,
                  max_len: int = 5000) -> np.ndarray:
    """Lengths shaped like the eval sets, equal to the JAX tool's (3DPW
    test: 60 videos of ~16..1300 frames; H36M val: 120 longer videos), `scale`
    times as many videos; `max_len` clips them (the tool's 5000)."""
    rs = np.random.RandomState(seed)
    if dataset == "h36m":
        n = int(120 * scale)
        lens = rs.lognormal(mean=7.3, sigma=0.5, size=n)  # ~1500 median
    else:
        n = int(60 * scale)
        lens = rs.lognormal(mean=6.2, sigma=0.7, size=n)  # ~500 median
    return np.clip(lens, 16, max_len).astype(int)


def sweep_models(device, smpl_seed: int = 0):
    """(smpl, gen, vibe, j_regressor) at full width on `device`, random
    from seeds as in the JAX tool (SMPL `smpl_seed`, TePose 0, VIBE 1,
    regressor 2)."""
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.models.tepose import (
        TePose, TePoseConfig, Vibe, VibeConfig)

    smpl = synthetic_smpl_model(seed=smpl_seed, device=device)
    gen = TePose(TePoseConfig(seqlen=SEQLEN, n_layers=2, hidden_size=1024),
                 generator=torch.Generator().manual_seed(0), device=device)
    vibe = Vibe(VibeConfig(seqlen=16, n_layers=2, hidden_size=1024,
                           add_linear=True),
                generator=torch.Generator().manual_seed(1), device=device)
    jreg = np.random.RandomState(2).rand(17, smpl.num_verts).astype(
        np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    return smpl, gen.eval(), vibe.eval(), torch.as_tensor(jreg, device=device)


def sweep_data(lengths, seed: int = 0) -> Dict[str, dict]:
    """One generated video a length, with what `make_eval_batch` reads."""
    rng = np.random.default_rng(seed)
    data = {}
    for i, n in enumerate(int(x) for x in lengths):
        theta = rng.standard_normal((n, 85), dtype=np.float32) * 0.1
        theta[:, :3] = [1.0, 0.0, 0.0]
        data[f"vid_{i:03d}"] = {
            "features": rng.standard_normal((n, 2048),
                                            dtype=np.float32) * 0.1,
            "theta_pseu": theta, "pose": theta[:, 3:75] * 2,
            "shape": theta[:, 75:] * 2}
    return data


def point_name(max_b: int, bucket: int | None) -> str:
    return f"B{max_b}" + (f"_bucket{bucket}" if bucket else "")


def parse_point(name: str) -> tuple:
    m = re.fullmatch(r"B(\d+)(?:_bucket(\d+))?", name)
    if m is None:
        raise SystemExit(f"grid point {name!r} is not B<MAX_B> or "
                         f"B<MAX_B>_bucket<bucket>")
    return int(m.group(1)), int(m.group(2) or 0) or None


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def run_pass(models, data: Dict[str, dict], plan: List[tuple],
             device) -> dict:
    """Walk `plan` once as `run_eval` does; host-clock seconds per call
    (each ends in its readback) and the pass's counts."""
    import tepose_tpu_torch.ops.lbs_skinning as lbs
    from tepose_tpu_torch.evaluate import rollout_chunk
    from tepose_tpu_torch.precision import device_scope

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    seen, first_s, total_s = set(), 0.0, 0.0
    launches = lbs.LAUNCHES
    with device_scope():
        for T_pad, chunk, B in plan:
            t0 = time.perf_counter()
            rollout_chunk(models, data, chunk, T_pad, B, device)
            dt = time.perf_counter() - t0
            total_s += dt
            if (B, T_pad) not in seen:
                seen.add((B, T_pad))
                first_s += dt
    return {"seconds": total_s, "steady_s": total_s - first_s,
            "first_call_s": first_s, "lbs_launches": lbs.LAUNCHES - launches,
            "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                               if cuda else None)}


def sweep(models, data: Dict[str, dict], points: List[tuple], device,
          log=print) -> Dict[str, dict]:
    """Every (max_b, bucket) of `points` (bucket None: no bucket), two
    passes in turns; rows by `point_name`."""
    from tepose_tpu_torch.evaluate import plan_eval_batches, rollout_chunk
    from tepose_tpu_torch.precision import device_scope

    lengths = {n: len(d["features"]) for n, d in data.items()}
    useful = sum(n for n in lengths.values() if n >= SEQLEN)
    plans, shared = {}, {}
    for max_b, bucket in points:
        name = point_name(max_b, bucket)
        plan = plan_eval_batches(lengths, SEQLEN, max_b, bucket)
        key = tuple((T, tuple(c), B) for T, c, B in plan)
        shared[name] = next((k for k, p in plans.items() if p[1] == key),
                            None)
        if shared[name] is None:
            plans[name] = (plan, key)
    first = next(iter(data))
    warm = {first: {k: v[:SEQLEN + 2] for k, v in data[first].items()}}
    with device_scope():
        rollout_chunk(models, warm, [first], SEQLEN + 2, 1, device)
    order = list(plans)
    turns = (order, order[len(order) // 2:] + order[:len(order) // 2])
    passes: Dict[str, list] = {name: [] for name in order}
    for i, turn in enumerate(turns):
        for name in turn:
            r = run_pass(models, data, plans[name][0], device)
            passes[name].append(r)
            log(f"pass {i + 1}: {name}: {useful / r['seconds']:.1f} useful "
                f"frames/s ({r['seconds']:.2f} s, steady "
                f"{r['steady_s']:.2f} s)")
    rows = {}
    for max_b, bucket in points:
        name = point_name(max_b, bucket)
        src = shared[name] or name
        plan, runs = plans[src][0], passes[src]
        fps = [useful / r["seconds"] for r in runs]
        steps = sum(T - SEQLEN + 1 for T, _, _ in plan)
        mem = [r["peak_memory_gb"] for r in runs]
        rows[name] = {
            "useful_fps": float(np.mean(fps)), "useful_fps_by_pass": fps,
            "seconds_by_pass": [r["seconds"] for r in runs],
            "steady_s": float(np.mean([r["steady_s"] for r in runs])),
            "steady_s_by_pass": [r["steady_s"] for r in runs],
            "first_call_s_by_pass": [r["first_call_s"] for r in runs],
            "window_steps": steps,
            "ms_per_step": 1e3 * float(np.mean([r["seconds"] for r in runs]))
            / steps,
            "chunks": len(plan),
            "programs": len({(B, T) for T, _, B in plan}),
            "frame_fill": useful / sum(T * B for T, _, B in plan),
            "peak_memory_gb": None if None in mem else max(mem),
            "lbs_launches": runs[0]["lbs_launches"],
            "max_batch": max_b, "bucket": bucket}
        if shared[name]:
            rows[name]["same_plan_as"] = shared[name]
    return rows


def best_row(rows: Dict[str, dict]) -> str:
    """The fastest row by mean useful frames/s. Rows whose faster pass
    reaches the fastest row's slower pass tie with it, and a tie goes to
    the smaller peak memory, then the faster mean, the smaller MAX_B and
    bucket, then the name (rows of one shared plan are equal)."""
    top = max(rows.values(), key=lambda r: r["useful_fps"])
    floor = min(top["useful_fps_by_pass"])
    ties = [n for n, r in rows.items()
            if max(r["useful_fps_by_pass"]) >= floor]
    return min(ties, key=lambda n: (rows[n]["peak_memory_gb"] or 0.0,
                                    -rows[n]["useful_fps"],
                                    rows[n]["max_batch"],
                                    rows[n]["bucket"] or 0, n))


def grid_points(args) -> List[tuple]:
    if args.points:
        return [parse_point(p) for p in args.points]
    return [(b, s or None) for s in args.bucket_sizes for b in args.batches]


def main(argv: Optional[list] = None) -> dict:
    from tepose_tpu_torch.config import gpu_device
    from tepose_tpu_torch.precision import strict_f32

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="3dpw", choices=["3dpw", "h36m"])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="videos as a share of the eval set's count")
    ap.add_argument("--batches", type=int, nargs="+",
                    default=list(GRID_BATCHES))
    ap.add_argument("--bucket_sizes", type=int, nargs="+",
                    default=list(GRID_BUCKETS),
                    help="length buckets in frames; 0 is none (each chunk "
                         "pads to its longest video)")
    ap.add_argument("--points", nargs="+", default=None,
                    help="run these points (B<MAX_B> or B<MAX_B>_bucket"
                         "<bucket>) instead of the grid")
    ap.add_argument("--max_len", type=int, default=5000,
                    help="clip video lengths to this many frames")
    ap.add_argument("--gpu", default="0",
                    help="CUDA device index, or 'cpu'")
    ap.add_argument("--out", default="",
                    help="merge this dataset's rows into a JSON file (the "
                         "committed one: " + SWEEP_JSON + ")")
    args = ap.parse_args(argv)
    points = grid_points(args)
    device = gpu_device(args.gpu)
    strict_f32()
    lengths = video_lengths(args.dataset, args.scale, max_len=args.max_len)
    print(f"{args.dataset}: {len(lengths)} videos, {int(lengths.sum())} "
          f"frames, median {int(np.median(lengths))}", flush=True)
    models = sweep_models(device)
    rows = sweep(models, sweep_data(lengths), points, device,
                 log=lambda s: print(s, flush=True))
    best = best_row(rows)
    for name, r in rows.items():
        print(f"{name}: {r['useful_fps']:.1f} useful frames/s (passes "
              f"{', '.join(f'{x:.1f}' for x in r['useful_fps_by_pass'])}), "
              f"steady {r['steady_s']:.2f} s, {r['window_steps']} window "
              f"steps, {r['programs']} shapes, fill {r['frame_fill']:.3f}, "
              f"peak memory {r['peak_memory_gb']} GB, lbs launches "
              f"{r['lbs_launches']}", flush=True)
    entry = {"device": device_name(device), "best": best, "results": rows,
             "grid": [point_name(*p) for p in points],
             "videos": len(lengths), "frames": int(lengths.sum()),
             "median_len": int(np.median(lengths)), "scale": args.scale,
             "max_len": args.max_len}
    print(f"best: {best}")
    print(json.dumps({"dataset": args.dataset, **entry}))
    if args.out:
        merged = {}
        if osp.isfile(args.out):
            with open(args.out) as f:
                merged = json.load(f)
        merged[args.dataset] = entry
        merged["_note"] = NOTE
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    return entry


if __name__ == "__main__":
    main()
