"""Benchmark evaluation CLI of the port.

Counterpart of the repository's `evaluate.py` (JAX):

  python -m tepose_tpu_torch.evaluate --dataset 3dpw \
      --cfg configs/repr_wopw_3dpw_model.yaml [--gpu 0|cpu]
  python -m tepose_tpu_torch.evaluate --synthetic --dataset 3dpw \
      --cfg configs/repr_wopw_3dpw_model.yaml      # generated data

Videos are bucketed by length, padded and evaluated in batches through
`eval.evaluator.eval_rollout`, with the same bucket and batch defaults as
the JAX CLI (`--eval_bucket`, `--eval_batch`). Matmuls and cuDNN run in
strict float32 (TF32 off); `--precision` accepts only `float32`.
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

import os.path as osp
import sys
import time
from typing import Dict, List

import numpy as np
import torch

def strict_f32() -> None:
    """Full float32 for matmuls and cuDNN (its GRUs included): TF32 keeps
    about three decimal digits, and the theta feedback compounds errors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
             device: torch.device | str, devices=None) -> Dict[str, float]:
    """Evaluate on `device`; returns the metric summary (mm) plus `frames`
    (poses evaluated) and `seconds` (wall time of the eval loop).
    `devices` (an int, "auto" or a `parallel.mesh.Mesh`, see `eval_mesh`)
    splits every batch over a mesh."""
    from tepose_tpu_torch.data.db import (
        eval_db_paths, key_eval_db_by_video, load_db, load_pseudotheta)
    from tepose_tpu_torch.data.kp_utils import convert_kps
    from tepose_tpu_torch.eval.evaluator import (
        EvalAccumulator, eval_rollout, make_sharded_eval_rollout,
        spin49_to_eval_format)

    strict_f32()
    dataset = args.dataset
    if args.filter and dataset == "mpii3d":
        sys.exit("--filter is not supported for mpii3d: the slerp-smoothed "
                 "rebuild regresses J14 joints through the H36M J_regressor "
                 "(ref: evaluate.py:288-290), which mpii3d eval does not use")
    smpl, gen, vibe, j_regressor = build_models(cfg, synthetic, device)
    S = gen.cfg.seqlen
    jreg = j_regressor if dataset != "mpii3d" else None
    mesh = eval_mesh(devices, device)
    if mesh is not None:
        print(f"=> data-parallel eval over {mesh.size} devices: "
              f"{[str(d) for d in mesh.devices]}")
        sharded = make_sharded_eval_rollout(gen, vibe, smpl, jreg, mesh)

    if synthetic:
        data = synthetic_eval_data()
    else:
        db_file, pse_file = eval_db_paths(dataset, cfg.TITLE, args.render)
        print(f"Load data from {db_file}")
        data = key_eval_db_by_video(load_db(db_file),
                                    load_pseudotheta(pse_file),
                                    target_action=args.seq,
                                    is_mpii3d=(dataset == "mpii3d"))

    # bucket videos by padded length (same defaults as the JAX CLI)
    names = [n for n in data if len(data[n]["features"]) >= S]
    lengths = {n: len(data[n]["features"]) for n in names}
    long_videos = dataset != "3dpw"
    bsz = getattr(args, "eval_bucket", None) or (256 if long_videos else 128)
    buckets: Dict[int, List[str]] = {}
    for n in names:
        buckets.setdefault(-(-lengths[n] // bsz) * bsz, []).append(n)

    acc = EvalAccumulator(dataset=dataset)
    tot_frames = 0
    t_start = time.time()
    # partial chunks pad to the next power of two, as in the JAX CLI
    MAX_B = getattr(args, "eval_batch", None) or (8 if long_videos else 32)
    for T_pad, vids in sorted(buckets.items()):
        W = T_pad - S + 1
        for i in range(0, len(vids), MAX_B):
            chunk = vids[i:i + MAX_B]
            B = 1 << max(len(chunk) - 1, 0).bit_length()
            if mesh is not None:
                # a multiple of the device count, so the rows split evenly
                # (pad rows are independent)
                B = -(-B // mesh.size) * mesh.size
                batch = make_eval_batch(data, chunk, S, T_pad, B)
                out = sharded(batch["feats"], batch["theta_pseu"],
                              batch["theta_gt"], W)
            else:
                batch = {k: torch.from_numpy(v).to(device) for k, v in
                         make_eval_batch(data, chunk, S, T_pad, B).items()}
                out = eval_rollout(gen, vibe, smpl, batch["feats"],
                                   batch["theta_pseu"], batch["theta_gt"],
                                   jreg, W)
            pred_j3d = out["pred_j3d"].cpu().numpy()
            pred_theta = out["pred_theta"].cpu().numpy()
            mpvpe = out["mpvpe"].cpu().numpy()

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
                tot_frames += L

    res = acc.summarize()
    dt = time.time() - t_start
    print(f"\nEvaluated total {tot_frames} poses in {dt:.1f}s "
          f"({tot_frames / max(dt, 1e-9):.1f} FPS) on {device}")
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
    if "--precision" in sys.argv:
        i = sys.argv.index("--precision")
        precision = sys.argv[i + 1] if i + 1 < len(sys.argv) else None
        if precision != "float32":
            raise SystemExit(
                f"--precision {precision!r}: the port evaluates in float32 "
                "only; a faster tier needs its own drift measurement")
        del sys.argv[i:i + 2]
    cfg, _, args = parse_args()
    device = gpu_device(args.gpu)
    try:
        mesh = eval_mesh(devices, device)
    except ValueError as e:
        raise SystemExit(f"--devices {devices}: {e}")
    return run_eval(cfg, args, synthetic=synthetic, device=device,
                    devices=mesh)


if __name__ == "__main__":
    main()
