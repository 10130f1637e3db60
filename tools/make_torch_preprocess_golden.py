#!/usr/bin/env python
"""Write the JAX golden that the port's offline DB building is held to.

The GPU host has no JAX, so this script runs the JAX builders here, on the
CPU: `tools/preprocess/threedpw.py::read_data` on a fabricated 3DPW test
split, and `tools/preprocess/pseudo_theta.py::pseudo_thetas_for_features`
on seeded features, with weights that the port rebuilds from seeds alone:

  * ResNet-50 and VIBE (2 x 1024) drawn by the port's own modules from
    `torch.Generator().manual_seed(...)`, exported with
    `tepose_tpu_torch.weights.jax_tree_from_state_dict`;
  * `synthetic_smpl_model(seed)` with 6890 vertices and the synthetic H36M
    regressor, equal element for element in both packages;
  * one reference-layout sequence pkl (`fabricate_3dpw`: two people, 24
    frames, camera rotations, a late start, an empty frame and frames with
    too few keypoints) and 240 x 320 uint8 frames from a numpy seed. The
    JAX builder reads the frames with cv2 from files, so they are written
    PNG-encoded (lossless) under the `.jpg` names `read_data` opens; the
    port gets the same frames from memory through `read_data(imread=...)`.

The file keeps the spec, the weights' checksums, the DB's arrays (image
names relative to the split's folder) and the (N, 85) pseudo-thetas of
videos of 500, 450 and 120 frames at VIBE batch 450: a full chunk and a
tail, an exact chunk, and a video shorter than a chunk. `chip_smoke.py`
phase 11 rebuilds the rest.

  python tools/make_torch_preprocess_golden.py      # writes GOLDEN_PATH

Only `jax_outputs`, `write_frame_files` and `main` import JAX or cv2, so
the rest can be imported on a host without them.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
import sys
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GOLDEN_PATH = osp.join(REPO, "tests", "golden", "torch_port_preprocess_f32.npz")

SEQ = "courtyard_fab_00"
# arrays the builder computes on the host from the same inputs: equal
HOST_KEYS = ("vid_name", "frame_id", "img_name", "joints2D", "bbox",
             "valid", "shape")
POSE_ATOL = 1e-4          # axis-angle after Rc @ R on the device
METRE_ATOL = 1e-4         # J14 joints, 0.1 mm (BASELINE.md:64)
FEATURE_RTOL = 1e-4       # of the features' largest magnitude (~1e3)
THETA_ATOL = 1e-6         # H100: strict fp32 1.2e-7, TF32 1.4e-5

# Full width: ResNet-50 on 224 x 224 crops (the extractor's defaults),
# SMPL with 6890 vertices, VIBE 2 x 1024 at seqlen 16 and batch 450
# (`tools/preprocess/pseudo_theta.py:96-97`).
FULL_SPEC = dict(num_verts=6890, smpl_seed=0, backbone_seed=2, vibe_seed=1,
                 vibe_n_layers=2, vibe_hidden_size=1024, frame_seed=4,
                 people=2, frames=24, height=240, width=320,
                 feature_seed=5, pseudo_lengths=[500, 450, 120],
                 vibe_batch=450)


def _rodrigues(v: np.ndarray) -> np.ndarray:
    """(3,) axis-angle -> (3, 3) rotation, float64."""
    theta = float(np.linalg.norm(v))
    k = v / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def fabricate_3dpw(root: str, spec: Dict) -> Tuple[str, Dict[str, np.ndarray]]:
    """A reference-layout 3DPW test split under `root`: one sequence pkl
    (`sequenceFiles/test/<SEQ>.pkl`), no image files. Returns the split's
    folder and its frames, RGB uint8 (H, W, 3), keyed by the paths the
    builder reads them from.

    Person 0 has no visible keypoint in its last frame (the detected
    interval ends early) and only five in frame 4 (the MIN_KP filter drops
    it); person 1 is invisible in its first three frames (the interval
    starts late). Camera rotations (randn x 0.3, about 0.5 rad) and poses
    x 0.2 keep Rc @ R far from pi, where `rotmat_to_angle_axis`
    branches."""
    rs = np.random.RandomState(spec["frame_seed"])
    T, H, W, P = spec["frames"], spec["height"], spec["width"], spec["people"]
    folder = osp.join(root, "3dpw")
    seq_dir = osp.join(folder, "sequenceFiles", "test")
    os.makedirs(seq_dir, exist_ok=True)
    frames = rs.randint(0, 256, (T, H, W, 3)).astype(np.uint8)
    cam = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    for t in range(T):
        cam[t, :3, :3] = _rodrigues(rs.randn(3) * 0.3)
        cam[t, :3, 3] = rs.randn(3)
    poses2d, poses, betas, valid = [], [], [], []
    for p in range(P):
        kp = np.zeros((T, 3, 18), np.float32)
        cx = W * (0.3 + 0.4 * p)
        kp[:, 0] = cx + rs.randn(T, 18) * W / 12
        kp[:, 1] = H / 2 + rs.randn(T, 18) * H / 6
        kp[:, 2] = 0.5 + 0.5 * rs.rand(T, 18)
        if p == 0:
            kp[-1, 2] = 0.0
            kp[4, 2, 5:] = 0.1
        else:
            kp[:3, 2] = 0.0
        poses2d.append(kp)
        poses.append((rs.randn(T, 72) * 0.2).astype(np.float32))
        betas.append((rs.randn(12) * 0.3).astype(np.float32))
        v = np.ones(T, np.float32)
        v[rs.randint(T)] = 0.0
        valid.append(v)
    data = {"poses": poses, "betas": betas, "poses2d": poses2d,
            "trans": [np.zeros((T, 3), np.float32)] * P,
            "cam_poses": cam, "campose_valid": valid,
            "img_frame_ids": np.arange(T)}
    with open(osp.join(seq_dir, f"{SEQ}.pkl"), "wb") as f:
        pickle.dump(data, f)
    img_dir = osp.join(folder, "imageFiles", SEQ)
    return folder, {osp.join(img_dir, f"image_{i:05d}.jpg"): frames[i]
                    for i in range(T)}


def write_frame_files(frames: Dict[str, np.ndarray]) -> None:
    """Each frame at its path, PNG-encoded whatever the name says: cv2
    picks the decoder from the bytes, so the JAX builder reads the frames
    back exactly."""
    import cv2

    for path, img in frames.items():
        os.makedirs(osp.dirname(path), exist_ok=True)
        ok, buf = cv2.imencode(".png", img[:, :, ::-1])
        if not ok:
            raise RuntimeError(f"cv2 could not encode {path}")
        with open(path, "wb") as f:
            f.write(buf.tobytes())


def port_setup(spec: Dict, device: torch.device | str) -> Dict:
    """The builders' models on `device`, rebuilt from `spec`."""
    from tepose_tpu_torch.evaluate import synthetic_j_regressor
    from tepose_tpu_torch.models.backbone import resnet50_init
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.models.tepose import Vibe, VibeConfig

    vcfg = VibeConfig(seqlen=16, n_layers=spec["vibe_n_layers"],
                      hidden_size=spec["vibe_hidden_size"], add_linear=True)
    return {
        "backbone": resnet50_init(
            torch.Generator().manual_seed(spec["backbone_seed"]),
            device).eval(),
        "vibe": Vibe(vcfg, device=device, generator=torch.Generator(
        ).manual_seed(spec["vibe_seed"])).eval(),
        "smpl": synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"],
                                     device=device),
        "jreg": synthetic_j_regressor(spec["num_verts"]),
        "spec": spec,
    }


def weight_checksums(setup: Dict) -> np.ndarray:
    """(sum, sum of |.|) in float64 over the backbone's and VIBE's
    state_dicts, to catch a change in the generator's stream."""
    sums = []
    for name in ("backbone", "vibe"):
        flat = np.concatenate([
            v.detach().cpu().numpy().astype(np.float64).ravel()
            for v in setup[name].state_dict().values()])
        sums += [flat.sum(), np.abs(flat).sum()]
    return np.asarray(sums)


def pseudo_inputs(spec: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame video names and (N, 2048) features of the pseudo-theta
    videos."""
    names = np.concatenate([np.array([f"pseudo_{i}"] * n) for i, n
                            in enumerate(spec["pseudo_lengths"])])
    rs = np.random.RandomState(spec["feature_seed"])
    return names, (rs.randn(len(names), 2048) * 0.5).astype(np.float32)


def port_outputs(setup: Dict, folder: str,
                 frames: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The port's 3DPW test DB (frames from memory) and pseudo-thetas on
    the setup's device."""
    from tepose_tpu_torch.preprocess import pseudo_theta, threedpw

    db = threedpw.read_data(folder, "test", backbone=setup["backbone"],
                            smpl=setup["smpl"], j_regressor=setup["jreg"],
                            device=setup["smpl"].v_template.device,
                            imread=frames.__getitem__)
    vid, feats = pseudo_inputs(setup["spec"])
    thetas = pseudo_theta.pseudo_thetas_for_features(
        vid, feats, setup["vibe"], setup["smpl"], setup["spec"]["vibe_batch"])
    return golden_outputs(db, thetas, folder)


def golden_outputs(db: Dict[str, np.ndarray], thetas: np.ndarray,
                   folder: str) -> Dict[str, np.ndarray]:
    """The DB's arrays with image names relative to `folder`, and the
    pseudo-thetas under "pseudo_theta"."""
    out = {k: np.asarray(v) for k, v in db.items()}
    out["img_name"] = np.array([osp.relpath(p, folder)
                                for p in db["img_name"]])
    out["pseudo_theta"] = np.asarray(thetas, np.float32)
    return out


def golden_deviation(got: Dict[str, np.ndarray],
                     golden: Dict) -> Dict[str, tuple]:
    """Raise unless the host arrays are equal; return {key: (max abs
    deviation, bar)} for the device-computed ones: pose, joints3D,
    features (bar FEATURE_RTOL of the golden's largest magnitude) and
    pseudo_theta."""
    for k in HOST_KEYS:
        if got[k].shape != golden[k].shape or not np.array_equal(
                got[k], golden[k]):
            raise ValueError(f"{k} differs from the golden's")
    bars = {"pose": POSE_ATOL, "joints3D": METRE_ATOL,
            "features": FEATURE_RTOL * float(np.abs(golden["features"]).max()),
            "pseudo_theta": THETA_ATOL}
    dev = {}
    for k, bar in bars.items():
        if got[k].shape != golden[k].shape or not np.isfinite(got[k]).all():
            raise ValueError(f"{k}: shape {got[k].shape} vs "
                             f"{golden[k].shape}, or non-finite values")
        dev[k] = (float(np.abs(got[k] - golden[k]).max()), bar)
    return dev


def jax_outputs(spec: Dict, workdir: str) -> Dict[str, np.ndarray]:
    """The JAX builders (strict float32, CPU) on the port's weights."""
    import jax

    from tepose_tpu.models.smpl import synthetic_smpl_model
    from tepose_tpu.models.tepose import VibeConfig
    from tepose_tpu_torch.weights import jax_tree_from_state_dict

    sys.path.insert(0, osp.join(REPO, "tools", "preprocess"))
    import threedpw
    from pseudo_theta import pseudo_thetas_for_features

    setup = port_setup(spec, "cpu")
    folder, frames = fabricate_3dpw(workdir, spec)
    write_frame_files(frames)
    smpl = synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"])
    backbone, vibe = (jax_tree_from_state_dict(setup[k].state_dict())
                      for k in ("backbone", "vibe"))
    vcfg = VibeConfig(seqlen=16, n_layers=spec["vibe_n_layers"],
                      hidden_size=spec["vibe_hidden_size"], add_linear=True)
    vid, feats = pseudo_inputs(spec)
    with jax.default_matmul_precision("float32"):
        db = threedpw.read_data(folder, "test", backbone=backbone, smpl=smpl,
                                j_regressor=setup["jreg"])
        thetas = pseudo_thetas_for_features(vid, feats, vibe, smpl, vcfg,
                                            spec["vibe_batch"])
    return golden_outputs(db, thetas, folder)


def load_golden(path: str = GOLDEN_PATH) -> Dict:
    with np.load(path, allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    golden["spec"] = json.loads(str(golden["spec"]))
    return golden


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        golden = jax_outputs(FULL_SPEC, tmp)
    golden["spec"] = np.asarray(json.dumps(FULL_SPEC, sort_keys=True))
    golden["weight_checksums"] = weight_checksums(port_setup(FULL_SPEC,
                                                             "cpu"))
    os.makedirs(osp.dirname(GOLDEN_PATH), exist_ok=True)
    tmp = GOLDEN_PATH + ".tmp.npz"
    np.savez_compressed(tmp, **golden)
    os.replace(tmp, GOLDEN_PATH)
    print(f"wrote {GOLDEN_PATH} ({osp.getsize(GOLDEN_PATH)} bytes): "
          + ", ".join(f"{k} {v.shape}" for k, v in golden.items()))


if __name__ == "__main__":
    main()
