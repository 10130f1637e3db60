"""Benchmark evaluation CLI of the port.

Counterpart of the repository's `evaluate.py` (JAX):

  python -m tepose_tpu_torch.evaluate --dataset 3dpw \
      --cfg configs/repr_wopw_3dpw_model.yaml [--gpu 0|cpu]
  python -m tepose_tpu_torch.evaluate --synthetic --dataset 3dpw \
      --cfg configs/repr_wopw_3dpw_model.yaml      # generated data

Videos are sorted by length, cut into chunks of at most `--eval_batch`
videos, each chunk padded to its longest video, and evaluated through
`eval.evaluator.eval_rollout` (`plan_eval_batches`). The default batch
(`EVAL_BATCHING`) is the best measured row of the card's own sweep,
`tepose_tpu_torch/eval_batching_sweep.json`, written by
`python -m tepose_tpu_torch.tune_eval_batching`. The port compiles nothing,
so a new batch shape costs nothing and there is no reason to round lengths
or rows up; the rollout is launch-bound, a window costing about the same
whatever the batch, so a pass costs its window steps until the device
fills. `--eval_bucket N` rounds each video's length up to a multiple of N
frames and batches within those buckets (the JAX CLI's grouping).
`--precision` takes the
JAX CLI's spellings and maps each tier to the card's own arithmetic
(`precision.py`): `float32` (`highest`; the default, strict float32 with
TF32 off), `tensorfloat32` (`tf32`, `high`: Hopper TF32 in cuBLAS and
cuDNN) and `bfloat16` (`bf16`, `default`, `fast`: the TePose and VIBE
forward with bf16 parameters and inputs, SMPL, skinning and metrics in
float32). Unlike the JAX CLI, whose default is its TPU tensorfloat32 tier,
the port defaults to float32, its parity contract.
`--filter` slerp-smooths each video's rotations and rebuilds its mesh and
H36M J14 joints on the device (`filter_video_predictions`), `--plot`
saves the acceleration-error figure and `--render` / `--render_plain`
overlay each video's rebuilt mesh with the native rasterizer, as the JAX
CLI does. `--devices N|auto` evaluates each batch split over N devices
(`eval.evaluator.make_sharded_eval_rollout`, one process, one replica a
device), the batch rounded up to a multiple of N; with `--gpu cpu` the
devices are N copies of the CPU.
"""

from __future__ import annotations

import copy
import os.path as osp
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from tepose_tpu_torch.precision import eval_tier, strict_f32, tier_scope

# MAX_B by dataset: 3dpw's short videos and the long-video sets (h36m,
# mpii3d). Each is the best measured row of
# tepose_tpu_torch/eval_batching_sweep.json
# (`tune_eval_batching.best_row`); tests/test_torch_tuning.py holds the two
# equal.
EVAL_BATCHING = {"3dpw": 32, "long": 128}


def plan_eval_batches(lengths: Dict[str, int], seqlen: int, max_batch: int,
                      bucket: int | None = None,
                      n_devices: int = 1) -> List[tuple]:
    """The chunks of an eval pass, in the order `run_eval` walks them:
    (T_pad, names, B) for the videos of `lengths` (name -> frames) that
    hold at least one window. Without `bucket` the videos are sorted by
    length (ties in `lengths`' order) and cut into chunks of at most
    `max_batch`, each padded to its longest video. With `bucket` each video
    goes to its length rounded up to a multiple of `bucket`, buckets in
    ascending order, and each bucket splits into chunks of at most
    `max_batch` in `lengths`' order (the JAX CLI's chunks). A chunk has as
    many rows as videos, rounded up to a multiple of `n_devices` so the
    rows split evenly over a mesh. Rows are independent, so no video's
    output depends on the plan."""
    def padded(n):
        return -(-n // bucket) * bucket if bucket else n

    names = sorted((n for n, L in lengths.items() if L >= seqlen),
                   key=lambda n: padded(lengths[n]))
    groups: Dict[int, List[str]] = {}
    for n in names:
        groups.setdefault(padded(lengths[n]) if bucket else 0, []).append(n)
    plan = []
    for group in groups.values():
        for i in range(0, len(group), max_batch):
            chunk = group[i:i + max_batch]
            plan.append((max(padded(lengths[n]) for n in chunk), chunk,
                         -(-len(chunk) // n_devices) * n_devices))
    return plan


def rollout_chunk(models, data: Dict[str, dict], chunk: List[str],
                  T_pad: int, B: int, device, compute_dtype=None,
                  sharded=None) -> Dict[str, np.ndarray]:
    """One chunk of a plan through the rollout: the batch padded on the
    host, uploaded, rolled out over T_pad - S + 1 windows by
    `eval_rollout` (or `sharded`, a `make_sharded_eval_rollout` function)
    and read back. `models` is (smpl, gen, vibe, j_regressor or None).
    Returns pred_j3d, pred_theta and mpvpe as numpy arrays."""
    from tepose_tpu_torch.eval.evaluator import eval_rollout

    smpl, gen, vibe, jreg = models
    S = gen.cfg.seqlen
    W = T_pad - S + 1
    batch = make_eval_batch(data, chunk, S, T_pad, B)
    if sharded is not None:
        out = sharded(batch["feats"], batch["theta_pseu"],
                      batch["theta_gt"], W)
    else:
        x = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        out = eval_rollout(gen, vibe, smpl, x["feats"], x["theta_pseu"],
                           x["theta_gt"], jreg, W, compute_dtype)
    return {k: out[k].cpu().numpy()
            for k in ("pred_j3d", "pred_theta", "mpvpe")}


def synthetic_j_regressor(num_verts: int) -> np.ndarray:
    """The synthetic H36M J_regressor (17, V) of the JAX `evaluate.py`,
    drawn from the same RandomState stream."""
    rs = np.random.RandomState(7)
    j_regressor = (rs.rand(17, num_verts) ** 8).astype(np.float32)
    j_regressor /= j_regressor.sum(1, keepdims=True)
    return j_regressor


def build_models(cfg, synthetic: bool, device: torch.device | str):
    """(smpl, gen, vibe, j_regressor (17, V) tensor) on `device`.

    Synthetic runs draw TePose from `torch.Generator().manual_seed(0)` and
    VIBE from seed 1; otherwise both load converted checkpoints.
    """
    from tepose_tpu_torch.config import BASE_DATA_DIR
    from tepose_tpu_torch.models.smpl import (
        load_smpl_assets, synthetic_smpl_model)
    from tepose_tpu_torch.models.tepose import (
        TePose, TePoseConfig, Vibe, VibeConfig)
    from tepose_tpu_torch.weights import (
        load_checkpoint, state_dict_from_jax_tree)

    mcfg = TePoseConfig(seqlen=cfg.DATASET.SEQLEN,
                        n_layers=cfg.MODEL.TGRU.NUM_LAYERS,
                        hidden_size=cfg.MODEL.TGRU.HIDDEN_SIZE)
    vcfg = VibeConfig(seqlen=16, n_layers=2, hidden_size=1024,
                      add_linear=True)

    smpl_npz = osp.join(BASE_DATA_DIR, "smpl_neutral.npz")
    if osp.isfile(smpl_npz):
        smpl = load_smpl_assets(smpl_npz, device)
    elif synthetic:
        smpl = synthetic_smpl_model(seed=0, device=device)
    else:
        raise FileNotFoundError(
            f"{smpl_npz} not found — convert your licensed SMPL pkl with "
            "python -m tepose_tpu_torch.convert_smpl (or pass --synthetic "
            "for a smoke run)")

    gen = TePose(mcfg, generator=torch.Generator().manual_seed(0),
                 device=device)
    vibe = Vibe(vcfg, generator=torch.Generator().manual_seed(1),
                device=device)
    if not synthetic:
        if not osp.isfile(cfg.TRAIN.PRETRAINED):
            raise FileNotFoundError(
                f"{cfg.TRAIN.PRETRAINED} is not a pretrained model")
        trees, scalars = load_checkpoint(cfg.TRAIN.PRETRAINED)
        gen.load_state_dict(state_dict_from_jax_tree(trees["gen"]))
        if "performance" in scalars:
            print(f"Loaded checkpoint, performance "
                  f"{scalars['performance']:.2f}")
        vibe_npz = osp.join(BASE_DATA_DIR, "vibe_wo_3dpw.npz")
        if not osp.isfile(vibe_npz):
            raise FileNotFoundError(
                f"{vibe_npz} not found — convert the released VIBE "
                "checkpoint with python -m "
                "tepose_tpu_torch.convert_checkpoint --kind vibe")
        vibe.load_state_dict(
            state_dict_from_jax_tree(load_checkpoint(vibe_npz)[0]["gen"]))
    gen.eval()
    vibe.eval()

    jreg_path = osp.join(BASE_DATA_DIR, "J_regressor_h36m.npy")
    if osp.isfile(jreg_path):
        j_regressor = np.load(jreg_path).astype(np.float32)
    elif synthetic:
        j_regressor = synthetic_j_regressor(smpl.num_verts)
    else:
        raise FileNotFoundError(f"{jreg_path} missing")
    return smpl, gen, vibe, torch.as_tensor(j_regressor, device=device)


def synthetic_eval_data(num_videos=3, min_len=40, max_len=90, seed=0):
    """Generated eval videos, equal to the JAX `evaluate.py`'s."""
    rs = np.random.RandomState(seed)
    data = {}
    for i in range(num_videos):
        n = int(rs.randint(min_len, max_len))
        # valid_i: per-frame validity the mpii3d eval branch consumes; a
        # hole in the middle exercises the mask
        valid = np.ones((n, 1), np.int64)
        valid[n // 2:n // 2 + 3] = 0
        data[f"synthetic_vid_{i}"] = {
            "features": rs.randn(n, 2048).astype(np.float32) * 0.1,
            "joints3D": rs.randn(n, 49, 3).astype(np.float32) * 0.2,
            "theta_pseu": np.concatenate(
                [np.tile([1.0, 0, 0], (n, 1)),
                 rs.randn(n, 82) * 0.1], axis=1).astype(np.float32),
            "pose": (rs.randn(n, 72) * 0.2).astype(np.float32),
            "shape": (rs.randn(n, 10) * 0.2).astype(np.float32),
            "valid_i": valid,
        }
    return data


def make_eval_batch(data: Dict[str, dict], chunk: List[str], seqlen: int,
                    T_pad: int, B: int) -> Dict[str, np.ndarray]:
    """Pad the videos `chunk` into one batch of B rows and T_pad frames:
    feats (B, T_pad, 2048), theta_pseu (B, S-1, 85) and theta_gt
    (B, T_pad, 85) with the GT camera forced to [1, 0, 0]."""
    S = seqlen
    feats = np.zeros((B, T_pad, 2048), np.float32)
    pseu = np.zeros((B, S - 1, 85), np.float32)
    theta_gt = np.zeros((B, T_pad, 85), np.float32)
    for b, n in enumerate(chunk):
        d = data[n]
        L = len(d["features"])
        feats[b, :L] = d["features"]
        pseu[b] = d["theta_pseu"][:S - 1]
        theta_gt[b, :L, :3] = [1.0, 0.0, 0.0]
        theta_gt[b, :L, 3:75] = d["pose"][:L]
        theta_gt[b, :L, 75:] = d["shape"][:L]
    return {"feats": feats, "theta_pseu": pseu, "theta_gt": theta_gt}


def filter_video_predictions(smpl, pred_theta: np.ndarray,
                             j_regressor: torch.Tensor) -> np.ndarray:
    """`--filter` for one video: slerp-smooth the rotations of pred_theta
    (L, 85) (ratio 0.3, on the host), rebuild the SMPL mesh on `smpl`'s
    device and regress the H36M J14 joints (L, 14, 3) from it, as the JAX
    `evaluate.py` does (ref: evaluate.py:273-291)."""
    from tepose_tpu_torch.models.smpl import (
        H36M_TO_J14, regress_h36m_joints, smpl_forward)
    from tepose_tpu_torch.ops.geometry import batch_rodrigues
    from tepose_tpu_torch.ops.quaternion import smooth_rotmats_slerp

    dev = smpl.v_template.device
    L = len(pred_theta)
    theta = torch.from_numpy(np.ascontiguousarray(pred_theta,
                                                  np.float32)).to(dev)
    with torch.no_grad():
        rm = batch_rodrigues(theta[:, 3:75].reshape(-1, 3)).reshape(
            L, 24, 3, 3).cpu().numpy()
        rm = smooth_rotmats_slerp(rm, ratio=0.3)
        verts = smpl_forward(smpl, theta[:, 75:].contiguous(),
                             torch.from_numpy(rm).to(dev))["verts"]
        return regress_h36m_joints(verts, j_regressor,
                                   subset=H36M_TO_J14).cpu().numpy()


def eval_mesh(devices, device: torch.device | str):
    """The `parallel.mesh.Mesh` of `--devices`: None for 1 (or None), a
    given Mesh as it is, N CUDA devices (`auto`: every visible one) on a
    CUDA `device`, N copies of the CPU on the CPU."""
    from tepose_tpu_torch.parallel.mesh import Mesh, make_mesh

    if devices is None or isinstance(devices, Mesh):
        return devices
    cpu = torch.device(device).type == "cpu"
    if devices == "auto":
        devices = 1 if cpu else torch.cuda.device_count()
    n = int(devices)
    if n == 1:
        return None
    return make_mesh(devices=["cpu"] * n) if cpu else make_mesh(n)


def run_eval(cfg, args, synthetic: bool = False, *,
             device: torch.device | str, devices=None,
             precision: str = "float32",
             per_video: dict | None = None) -> Dict[str, float]:
    """Evaluate on `device`; returns the metric summary (mm) plus `frames`
    (poses evaluated) and `seconds` (wall time of the eval loop).
    `devices` (an int, "auto" or a `parallel.mesh.Mesh`, see `eval_mesh`)
    splits every batch over a mesh. `precision` is a `--precision`
    spelling; the tier's flags hold inside this call only. A
    `per_video` dict receives, per video name, the joints and MPVPE (m)
    that went into the metrics: {"pred_j3d": (L, K, 3), "mpvpe": (L,)}."""
    tier = eval_tier(precision)
    strict_f32()
    with tier_scope(tier):
        return _run_eval(cfg, args, synthetic, device, devices, tier,
                         per_video)


def _run_eval(cfg, args, synthetic, device, devices, tier, per_video):
    from tepose_tpu_torch.data.db import (
        eval_db_paths, key_eval_db_by_video, load_db, load_pseudotheta)
    from tepose_tpu_torch.data.kp_utils import convert_kps
    from tepose_tpu_torch.eval.evaluator import (
        EvalAccumulator, make_sharded_eval_rollout, spin49_to_eval_format)

    dataset = args.dataset
    if args.filter and dataset == "mpii3d":
        sys.exit("--filter is not supported for mpii3d: the slerp-smoothed "
                 "rebuild regresses J14 joints through the H36M J_regressor "
                 "(ref: evaluate.py:288-290), which mpii3d eval does not use")
    smpl, gen, vibe, j_regressor = build_models(cfg, synthetic, device)
    cd = torch.bfloat16 if tier == "bfloat16" else None
    if cd is not None:
        # bf16 copies: the cast training takes every step, taken once
        gen, vibe = copy.deepcopy(gen).to(cd), copy.deepcopy(vibe).to(cd)
    S = gen.cfg.seqlen
    jreg = j_regressor if dataset != "mpii3d" else None
    mesh = eval_mesh(devices, device)
    if mesh is not None:
        print(f"=> data-parallel eval over {mesh.size} devices: "
              f"{[str(d) for d in mesh.devices]}")
        sharded = make_sharded_eval_rollout(gen, vibe, smpl, jreg, mesh,
                                            cd)

    if synthetic:
        data = synthetic_eval_data()
    else:
        db_file, pse_file = eval_db_paths(dataset, cfg.TITLE, args.render)
        print(f"Load data from {db_file}")
        data = key_eval_db_by_video(load_db(db_file),
                                    load_pseudotheta(pse_file),
                                    target_action=args.seq,
                                    is_mpii3d=(dataset == "mpii3d"))

    # the card's default batch (EVAL_BATCHING): no compile to amortise, so
    # each chunk pads to its own rows and its longest video
    lengths = {n: len(d["features"]) for n, d in data.items()}
    plan = plan_eval_batches(
        lengths, S, getattr(args, "eval_batch", None)
        or EVAL_BATCHING["3dpw" if dataset == "3dpw" else "long"],
        getattr(args, "eval_bucket", None), 1 if mesh is None else mesh.size)

    acc = EvalAccumulator(dataset=dataset)
    tot_frames = 0
    t_start = time.time()
    for T_pad, chunk, B in plan:
        out = rollout_chunk((smpl, gen, vibe, jreg), data, chunk, T_pad,
                            B, device, cd,
                            sharded if mesh is not None else None)
        pred_j3d, pred_theta, mpvpe = (
            out[k] for k in ("pred_j3d", "pred_theta", "mpvpe"))

        for b, n in enumerate(chunk):
            d = data[n]
            L = lengths[n]
            pj = pred_j3d[b, :L]
            if args.filter:
                pj = filter_video_predictions(smpl, pred_theta[b, :L],
                                              j_regressor)
            tgt = d["joints3D"][:L].astype(np.float32)
            valid_map = None
            if dataset == "mpii3d":
                pj = spin49_to_eval_format(pj, "mpii3d")
                tgt = convert_kps(tgt, "spin", "mpii3d_test")
                vm = d["valid_i"][:L, 0].nonzero()[0]
                if vm.size == 0:
                    print(f"No valid frames in {n}. Continue")
                    continue
                valid_map = vm[vm < L]
            elif tgt.shape[1] == 49:
                tgt = convert_kps(tgt, "spin", "common")

            if args.plot:
                from tepose_tpu_torch.eval.metrics import plot_accel

                plot_accel(pj, tgt, f"./output/{dataset}_test_output",
                           name=args.seq or n)

            if args.render or args.render_plain:
                render_eval_video(dataset, n, d, pred_theta[b, :L], smpl,
                                  args, frame_start=args.frame)

            acc.add_video(
                pj, tgt,
                mpvpe=mpvpe[b, :L] if dataset == "3dpw" else None,
                valid_map=valid_map)
            if per_video is not None:
                per_video[n] = {"pred_j3d": pj, "mpvpe": mpvpe[b, :L]}
            tot_frames += L

    res = acc.summarize()
    dt = time.time() - t_start
    print(f"\nEvaluated total {tot_frames} poses in {dt:.1f}s "
          f"({tot_frames / max(dt, 1e-9):.1f} FPS) on {device}, {tier}")
    print({k: round(v, 4) for k, v in res.items()})
    res["frames"] = tot_frames
    res["seconds"] = dt
    return res


def render_eval_video(dataset, seq_name, d, pred_theta, smpl, args,
                      frame_start=0, num_frames_to_render=240):
    """Mesh overlay of an eval sequence with the native rasterizer, as the
    JAX `evaluate.py::_render_eval_video` (ref: evaluate.py:304-390): the
    mesh is rebuilt from pred_theta (L, 85) on `smpl`'s device; frames
    whose source image is missing, and every frame under --render_plain,
    render on a black 480 x 480 canvas."""
    import cv2

    from tepose_tpu_torch.config import BASE_DATA_DIR
    from tepose_tpu_torch.models.smpl import (
        hull_faces, load_smpl_faces, smpl_forward)
    from tepose_tpu_torch.native import render_mesh
    from tepose_tpu_torch.ops.geometry import batch_rodrigues
    from tepose_tpu_torch.streaming.demo_utils import (
        convert_crop_cam_to_orig_img, write_video)

    faces_path = osp.join(BASE_DATA_DIR, "smpl_neutral.npz")
    faces = (load_smpl_faces(faces_path) if osp.isfile(faces_path)
             else hull_faces(smpl))

    L = len(pred_theta)
    dev = smpl.v_template.device
    theta = torch.from_numpy(np.ascontiguousarray(pred_theta,
                                                  np.float32)).to(dev)
    with torch.no_grad():
        rm = batch_rodrigues(theta[:, 3:75].reshape(-1, 3)).reshape(
            L, 24, 3, 3)
        verts = smpl_forward(smpl, theta[:, 75:].contiguous(),
                             rm)["verts"].cpu().numpy()
    cams = pred_theta[:, :3]

    imgnames = d.get("imgname")
    bboxes = d.get("bbox")
    out_dir = f"./output/{dataset}_test_output"
    frames = []
    W_img = H_img = 480
    for i in range(min(L, num_frames_to_render)):
        fi = frame_start + i
        img = None
        if imgnames is not None and not args.render_plain:
            path = str(imgnames[min(fi, len(imgnames) - 1)])
            if osp.isfile(path):
                img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        if img is None:
            img = np.zeros((H_img, W_img, 3), np.uint8)
        h, w = img.shape[:2]
        if bboxes is not None and not args.render_plain:
            bb = bboxes[min(fi, len(bboxes) - 1)].copy()[None, :]
            bb[:, 2:] = bb[:, 2:] * 1.2
            cam4 = convert_crop_cam_to_orig_img(cams[i:i + 1], bb, w, h)[0]
        else:
            cam4 = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
        frames.append(render_mesh(verts[i], faces, cam4, img,
                                  color=(1.0, 1.0, 0.9)))
    tag = "_plain" if args.render_plain else ""
    safe = str(seq_name).split("/")[-1]
    out_path = osp.join(out_dir, "video",
                        f"tepose_{safe}{tag}_{frame_start}.mp4")
    write_video(frames, out_path, fps=25.0)
    print(f"Saving result video to {osp.abspath(out_path)}")
    return out_path


def main():
    from tepose_tpu_torch.config import gpu_device, parse_args

    synthetic = "--synthetic" in sys.argv
    if synthetic:
        sys.argv.remove("--synthetic")
    devices = None
    if "--devices" in sys.argv:
        i = sys.argv.index("--devices")
        if i + 1 >= len(sys.argv):
            raise SystemExit("--devices needs a value (an integer or 'auto')")
        devices = sys.argv[i + 1]
        del sys.argv[i:i + 2]
        if devices != "auto":
            try:
                devices = int(devices)
            except ValueError:
                raise SystemExit(f"--devices expects an integer or 'auto', "
                                 f"got {devices!r}")
    precision = "float32"
    if "--precision" in sys.argv:
        i = sys.argv.index("--precision")
        if i + 1 >= len(sys.argv):
            raise SystemExit("--precision needs a value")
        precision = sys.argv[i + 1]
        del sys.argv[i:i + 2]
        eval_tier(precision)
    cfg, _, args = parse_args()
    device = gpu_device(args.gpu)
    try:
        mesh = eval_mesh(devices, device)
    except ValueError as e:
        raise SystemExit(f"--devices {devices}: {e}")
    return run_eval(cfg, args, synthetic=synthetic, device=device,
                    devices=mesh, precision=precision)


if __name__ == "__main__":
    main()
