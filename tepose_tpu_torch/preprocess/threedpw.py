"""Build 3DPW DBs (`3dpw_{train,val,test}_db.pt`).

Port of `tools/preprocess/threedpw.py` (ref:
lib/data_utils/threedpw_utils.py:46-188). Per sequence pkl and person:
camera-align the global orientation (Rc @ R), run SMPL over the whole track
for GT joints (train: 49-joint convention; test/val: H36M J14 via the
regressor), derive smooth bboxes from the 2D poses, convert 2D keypoints
'3dpw'->'common', extract ResNet features over the crops, and keep the frame
interval where detections exist; finally drop frames with < MIN_KP visible
keypoints. SMPL, its skinning kernel and ResNet-50 run on the device.

  python -m tepose_tpu_torch.preprocess.threedpw --dir data/3dpw
         [--set test] [--occ data/VOC2012] [--gpu 0|cpu]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np
import torch

from tepose_tpu_torch.config import gpu_device
from tepose_tpu_torch.data.db import save_db
from tepose_tpu_torch.data.kp_utils import perm_idxs
from tepose_tpu_torch.data.preprocess import FeatureExtractor
from tepose_tpu_torch.models.smpl import (
    H36M_TO_J14, regress_h36m_joints, smpl_forward)
from tepose_tpu_torch.ops.filters import (
    bbox_params_to_cxcywh, get_smooth_bbox_params)
from tepose_tpu_torch.ops.geometry import (
    batch_rodrigues, rotmat_to_angle_axis)
from tepose_tpu_torch.parallel.mesh import check_device
from tepose_tpu_torch.precision import device_scope
from tepose_tpu_torch.preprocess.common import (
    add_gpu_arg, concatenate_db, load_backbone,
    load_h36m_regressor, load_smpl)

VIS_THRESH = 0.3
MIN_KP = 6


def read_data(folder: str, split: str, occluders=None, backbone=None,
              smpl=None, j_regressor=None, mesh=None, *,
              device: torch.device | str = "cuda", imread=None):
    """The split's DB. `backbone` and `smpl` default to the converted
    assets loaded on `device`; `imread(path)` reads a frame as RGB uint8
    (default: OpenCV, see `FeatureExtractor.extract_from_images`); `mesh`
    (a `parallel.mesh.Mesh`) splits each feature batch over its devices."""
    device = torch.empty(0, device=device).device   # "cuda" -> cuda:<current>
    backbone = backbone if backbone is not None else load_backbone(device)
    smpl = smpl if smpl is not None else load_smpl(device=device)
    check_device(device, backbone=backbone, smpl=smpl)
    use_j14 = split in ("test", "validation", "val")
    if use_j14 and j_regressor is None:
        j_regressor = load_h36m_regressor()
    jreg = (torch.as_tensor(np.asarray(j_regressor, np.float32),
                            device=device) if use_j14 else None)
    extractor = FeatureExtractor(backbone, mesh=mesh)

    dataset = {k: [] for k in
               ("vid_name", "frame_id", "joints3D", "joints2D", "shape",
                "pose", "bbox", "img_name", "features", "valid")}

    seq_dir = osp.join(folder, "sequenceFiles", split)
    sequences = sorted(x.split(".")[0] for x in os.listdir(seq_dir))

    for seq in sequences:
        with open(osp.join(seq_dir, seq + ".pkl"), "rb") as f:
            data = pickle.load(f, encoding="latin1")
        img_dir = osp.join(folder, "imageFiles", seq)
        num_people = len(data["poses"])
        num_frames = len(data["img_frame_ids"])

        for p_id in range(num_people):
            pose = np.asarray(data["poses"][p_id], np.float32)      # (T, 72)
            shape = np.tile(np.asarray(data["betas"][p_id][:10],
                                       np.float32), (len(pose), 1))
            j2d = np.asarray(data["poses2d"][p_id],
                             np.float32).transpose(0, 2, 1)          # (T,18,3)
            cam_pose = np.asarray(data["cam_poses"], np.float32)
            valid = np.asarray(data["campose_valid"][p_id], np.float32)

            with device_scope():
                # camera-align global orientation: R <- Rc @ R
                # (ref: threedpw_utils.py:92-99)
                rotmat = batch_rodrigues(
                    torch.from_numpy(pose[:, :3]).to(device)).cpu().numpy()
                Rs = cam_pose[:len(pose), :3, :3] @ rotmat
                pose[:, :3] = rotmat_to_angle_axis(
                    torch.from_numpy(Rs).to(device)).cpu().numpy()

                # the whole track in one SMPL forward: one skinning launch
                # at B = the track's length
                out = smpl_forward(smpl, torch.from_numpy(shape).to(device),
                                   torch.from_numpy(pose).to(device),
                                   pose2rot=True)
                j3d = (regress_h36m_joints(out["verts"], jreg,
                                           subset=H36M_TO_J14)
                       if use_j14 else out["joints49"]).cpu().numpy()

            img_paths = np.array(
                [osp.join(img_dir, f"image_{i:05d}.jpg")
                 for i in range(num_frames)])

            bbox_params, t0, t1 = get_smooth_bbox_params(
                j2d, vis_thresh=VIS_THRESH, sigma=8)
            if len(bbox_params) == 0:
                continue
            # zeros-prefixed to frame 0 (reference surface); keep the
            # detected interval only
            bbox = bbox_params_to_cxcywh(bbox_params[t0:t1])

            # keypoints: visibility flags + '3dpw'->'common' + 2 zero slots
            # for neck/headtop (ref: threedpw_utils.py:139-146)
            j2d[:, :, 2] = (j2d[:, :, 2] > VIS_THRESH).astype(np.float32)
            perm = perm_idxs("3dpw", "common") + [0, 0]
            j2d = j2d[:, perm]
            j2d[:, 12:, 2] = 0.0

            sl = slice(t0, t1)
            augment = None
            if occluders:
                from tepose_tpu_torch.data.occlusion import (
                    occlude_with_objects)
                augment = lambda im: occlude_with_objects(im, occluders)
            feats = extractor.extract_from_images(img_paths[sl], bbox,
                                                  scale=1.3,
                                                  augment_fn=augment,
                                                  imread=imread)
            n = t1 - t0
            dataset["vid_name"].append(np.array([f"{seq}_{p_id}"] * n))
            dataset["frame_id"].append(np.arange(num_frames)[sl])
            dataset["img_name"].append(img_paths[sl])
            dataset["joints3D"].append(j3d[sl])
            dataset["joints2D"].append(j2d[sl])
            dataset["shape"].append(shape[sl])
            dataset["pose"].append(pose[sl])
            dataset["bbox"].append(bbox)
            dataset["valid"].append(valid[sl])
            dataset["features"].append(feats)
        print(f"{seq}: done")

    db = concatenate_db(dataset)
    # drop frames with too few visible keypoints (threedpw_utils.py:176-180)
    keep = np.where(
        (db["joints2D"][:, :, 2] > VIS_THRESH).sum(-1) > MIN_KP)[0]
    return {k: v[keep] for k, v in db.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="data/3dpw")
    ap.add_argument("--set", default="all",
                    choices=["all", "train", "validation", "test"])
    ap.add_argument("--db_dir", default=None)
    ap.add_argument("--occ", default="",
                    help="Pascal VOC root for occlusion-augmented *_occ DBs")
    add_gpu_arg(ap)
    args = ap.parse_args(argv)
    device = gpu_device(args.gpu)
    occluders = None
    if args.occ:
        from tepose_tpu_torch.data.occlusion import load_occluders
        occluders = load_occluders(args.occ)
    backbone, smpl = load_backbone(device), load_smpl(device=device)
    splits = (["validation", "test", "train"] if args.set == "all"
              else [args.set])
    for split in splits:
        db = read_data(args.dir, split, occluders=occluders,
                       backbone=backbone, smpl=smpl, device=device)
        name = {"validation": "3dpw_val", "test": "3dpw_test",
                "train": "3dpw_train"}[split]
        if occluders:
            name += "_occ"
        save_db(db, name, args.db_dir)


if __name__ == "__main__":
    main()
