"""Build Human3.6M DBs (`h36m_{train,test}_25fps[_tight]_db.pt`).

Port of `tools/preprocess/h36m.py` (ref: lib/data_utils/h36m_utils.py:
53-218). Per subject/sequence: load the Human36M annotation JSONs (camera
params + world joints), swap left/right joint triplets, project
world->cam->pixel, convert 'h36m'->'spin' (root at spin joint 39), smooth
keypoint-derived bboxes (0.9x tight / 1.1x occ variants), subsample
50->25 fps ([::2]), extract features on the device.

  python -m tepose_tpu_torch.preprocess.h36m --dir data/h36m [--set train]
         [--variant tight|occ] [--gpu 0|cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp

import numpy as np
import torch

from tepose_tpu_torch.config import gpu_device
from tepose_tpu_torch.data.db import save_db
from tepose_tpu_torch.data.kp_utils import convert_kps
from tepose_tpu_torch.data.preprocess import FeatureExtractor
from tepose_tpu_torch.ops.filters import get_smooth_bbox_params
from tepose_tpu_torch.preprocess.common import (
    add_gpu_arg, concatenate_db, load_backbone)

VIS_THRESH = 0.3


def world2cam(world, R, t):
    return (R @ world.T).T + t.reshape(1, 3)


def cam2pixel(cam, f, c):
    x = cam[:, 0] / cam[:, 2] * f[0] + c[0]
    y = cam[:, 1] / cam[:, 2] * f[1] + c[1]
    return np.stack([x, y, cam[:, 2]], axis=1)


def read_data(dataset_path: str, split: str = "train",
              variant: str = "tight", backbone=None, mesh=None, *,
              device: torch.device | str = "cuda"):
    """The split's DB; `backbone` defaults to the converted SPIN ResNet-50
    on `device`; `mesh` splits each feature batch over its devices."""
    extractor = FeatureExtractor(backbone if backbone is not None
                                 else load_backbone(device), mesh=mesh)
    bbox_expand = 0.9 if variant == "tight" else 1.1
    crop_scale = 1.0 if variant == "tight" else 1.2

    dataset = {k: [] for k in
               ("vid_name", "frame_id", "joints3D", "joints2D", "shape",
                "pose", "bbox", "img_name", "features")}

    subjects = [1, 5, 6, 7, 8] if split == "train" else [9, 11]
    annot_path = osp.join(dataset_path, "annotations")
    for subject in subjects:
        cam_file = osp.join(annot_path,
                            f"Human36M_subject{subject}_camera.json")
        if not osp.isfile(cam_file):
            print(f"skipping absent subject {subject}")
            continue
        with open(cam_file) as f:
            cameras = json.load(f)
        with open(osp.join(annot_path,
                           f"Human36M_subject{subject}_joint_3d.json")) as f:
            joints = json.load(f)

        seq_list = sorted(glob.glob(
            osp.join(dataset_path, "images", f"s_{subject:02d}*")))
        for seq in seq_list:
            seq_name = osp.basename(seq)
            act = str(int(seq_name.split("_act_")[-1][0:2]))
            subact = str(int(seq_name.split("_subact_")[-1][0:2]))
            cam = str(int(seq_name.split("_ca_")[-1][0:2]))

            img_paths = sorted(glob.glob(osp.join(seq, "*.jpg")))
            num_frames = len(img_paths)
            if num_frames < 1:
                continue
            cam_param = cameras[cam]
            R = np.array(cam_param["R"], np.float32)
            t = np.array(cam_param["t"], np.float32)
            f = np.array(cam_param["f"], np.float32)
            c = np.array(cam_param["c"], np.float32)

            j3ds = np.zeros((num_frames, 49, 3), np.float32)
            j2ds = np.zeros((num_frames, 49, 3), np.float32)
            for i in range(num_frames):
                jw = np.array(joints[act][subact][str(i)], np.float32)
                for l, r in ((1, 4), (2, 5), (3, 6)):  # swap left/right
                    jw[[l, r]] = jw[[r, l]]
                jc = world2cam(jw, R, t)
                jp = cam2pixel(jc, f, c)
                j3d = convert_kps((jc[None] / 1000), "h36m",
                                  "spin").reshape(-1, 3)
                j3ds[i] = j3d - j3d[39]  # root at spin 'hip'
                jp[:, 2] = 1.0
                j2ds[i] = convert_kps(jp[None], "h36m", "spin").reshape(-1, 3)

            bbox_params, t0, t1 = get_smooth_bbox_params(
                j2ds, vis_thresh=VIS_THRESH, sigma=8)
            if len(bbox_params) == 0:
                continue
            # zeros-prefixed to frame 0 (reference surface); keep the
            # detected interval only
            bbox_params = bbox_params[t0:t1]
            w = 150.0 / bbox_params[:, 2] * bbox_expand
            bbox = np.stack([bbox_params[:, 0], bbox_params[:, 1], w, w], 1)

            sl = slice(t0, t1)
            img_arr = np.array(img_paths)[sl][::2]  # 50 -> 25 fps
            bbox = bbox[::2]
            feats = extractor.extract_from_images(img_arr, bbox,
                                                  scale=crop_scale)
            dataset["vid_name"].append(
                np.array([f"{seq_name}_{subject}"] * num_frames)[sl][::2])
            dataset["frame_id"].append(np.arange(num_frames)[sl][::2])
            dataset["joints3D"].append(j3ds[sl][::2])
            dataset["joints2D"].append(j2ds[sl][::2])
            dataset["shape"].append(
                np.zeros((len(img_arr), 10), np.float32))
            dataset["pose"].append(np.zeros((len(img_arr), 72), np.float32))
            dataset["img_name"].append(img_arr)
            dataset["bbox"].append(bbox)
            dataset["features"].append(feats)
            print(f"{seq_name}: {len(img_arr)} frames")
    return concatenate_db(dataset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="data/h36m")
    ap.add_argument("--set", default="train")
    ap.add_argument("--variant", default="tight", choices=["tight", "occ"])
    ap.add_argument("--db_dir", default=None)
    add_gpu_arg(ap)
    args = ap.parse_args(argv)
    db = read_data(args.dir, args.set, args.variant,
                   device=gpu_device(args.gpu))
    suffix = "_tight" if args.variant == "tight" else "_occ"
    save_db(db, f"h36m_{args.set}_25fps{suffix}", args.db_dir)


if __name__ == "__main__":
    main()
