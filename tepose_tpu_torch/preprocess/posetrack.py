"""Build the PoseTrack DB (`posetrack_train_db.pt`).

Port of `tools/preprocess/posetrack.py` (ref:
lib/data_utils/posetrack_utils.py:36-184). Per annotation JSON and track:
collect labeled frames, reorder the 17 keypoints into the posetrack name
convention, derive square 0.8x bboxes from the annotation boxes, convert
keypoints 'posetrack'->'spin', and extract ResNet features on the device.

  python -m tepose_tpu_torch.preprocess.posetrack --dir data/posetrack
         [--set train] [--gpu 0|cpu]
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
from tepose_tpu_torch.preprocess.common import (
    add_gpu_arg, concatenate_db, load_backbone)

MIN_FRAMES = 8

# the annotation keypoint order of the PoseTrack JSONs
POSETRACK_ORIGINAL_KP = [
    "nose", "head_bottom", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]


def read_data(folder: str, split: str, backbone=None, mesh=None, *,
              device: torch.device | str = "cuda"):
    """The split's DB; `backbone` defaults to the converted SPIN ResNet-50
    on `device`; `mesh` splits each feature batch over its devices."""
    extractor = FeatureExtractor(backbone if backbone is not None
                                 else load_backbone(device), mesh=mesh)
    dataset = {k: [] for k in
               ("img_name", "joints2D", "bbox", "vid_name", "features")}

    files = sorted(glob.glob(osp.join(
        folder, "posetrack_data/annotations", split, "*.json")))
    for fname in files:
        with open(fname) as f:
            anns = json.load(f)
        images = [im for im in anns["images"] if im.get("is_labeled")]
        frame2img = {im["frame_id"]: im["file_name"] for im in images}
        imgid2img = {im["id"]: im["file_name"] for im in images}

        kp_names = anns["categories"][0]["keypoints"]
        idxs = [kp_names.index(h) for h in POSETRACK_ORIGINAL_KP
                if h in kp_names]

        track_ids = sorted({a["track_id"] for a in anns["annotations"]})
        for p_id in track_ids:
            annot = [(a["keypoints"], a["bbox"], a["image_id"])
                     for a in anns["annotations"]
                     if a["track_id"] == p_id
                     and np.count_nonzero(a["keypoints"]) != 0]
            if len(annot) < MIN_FRAMES:
                continue

            kp_2d = np.zeros((len(annot), 17, 3), np.float32)
            bbox = np.zeros((len(annot), 4), np.float32)
            img_paths = []
            ok = np.ones(len(annot), bool)
            for i, (kps, bb, image_id) in enumerate(annot):
                if bb[2] == 0 or bb[3] == 0:
                    ok[i] = False
                    continue
                kps = np.asarray(kps, np.float32).reshape(17, 3)[idxs]
                kps[:, 2] = 1.0
                kps[(kps[:, 0] == 0) & (kps[:, 1] == 0), 2] = 0.0
                kp_2d[i] = kps
                # xywh top-left -> square cxcywh * 0.8
                # (ref: posetrack_utils.py:113-123)
                cx = bb[0] + bb[2] / 2
                cy = bb[1] + bb[3] / 2
                side = max(bb[2], bb[3]) * 0.8
                bbox[i] = [cx, cy, side, side]
                img_paths.append(osp.join(folder, imgid2img.get(
                    image_id, frame2img.get(image_id, ""))))
            if ok.sum() < MIN_FRAMES:
                continue
            kp_2d = kp_2d[ok]
            bbox = bbox[ok]
            img_paths = [p for p, o in zip(img_paths, ok) if o]

            kp_2d = convert_kps(kp_2d, "posetrack", "spin")
            feats = extractor.extract_from_images(img_paths, bbox, scale=1.2)

            n = len(img_paths)
            vid = osp.splitext(osp.basename(fname))[0] + f"_{p_id}"
            dataset["vid_name"].append(np.array([vid] * n))
            dataset["img_name"].append(np.asarray(img_paths))
            dataset["joints2D"].append(kp_2d)
            dataset["bbox"].append(bbox)
            dataset["features"].append(feats)
    return concatenate_db(dataset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="data/posetrack")
    ap.add_argument("--set", default="train")
    ap.add_argument("--db_dir", default=None)
    add_gpu_arg(ap)
    args = ap.parse_args(argv)
    db = read_data(args.dir, args.set, device=gpu_device(args.gpu))
    save_db(db, f"posetrack_{args.set}", args.db_dir)


if __name__ == "__main__":
    main()
