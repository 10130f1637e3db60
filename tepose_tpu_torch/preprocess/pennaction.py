"""Build the PennAction DB (`pennaction_train_scale12_db.pt`).

Port of `tools/preprocess/pennaction.py` (ref:
lib/data_utils/penn_action_utils.py:65-140): per label .mat, 13 keypoints
remapped to the 14-joint common layout (slot 12 'neck' left empty, headtop
moved to slot 13), square keypoint-extent bboxes, ResNet features at scale
1.2 on the device. scipy.io is imported by `read_data`.

  python -m tepose_tpu_torch.preprocess.pennaction --dir data/penn_action
         [--gpu 0|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np
import torch

from tepose_tpu_torch.config import gpu_device
from tepose_tpu_torch.data.db import save_db
from tepose_tpu_torch.data.kp_utils import perm_idxs
from tepose_tpu_torch.data.preprocess import FeatureExtractor
from tepose_tpu_torch.preprocess.common import (
    add_gpu_arg, concatenate_db, load_backbone)


def read_data(folder: str, backbone=None, mesh=None, *,
              device: torch.device | str = "cuda"):
    """The DB; `backbone` defaults to the converted SPIN ResNet-50 on
    `device`; `mesh` splits each feature batch over its devices."""
    from scipy.io import loadmat

    extractor = FeatureExtractor(backbone if backbone is not None
                                 else load_backbone(device), mesh=mesh)
    dataset = {k: [] for k in
               ("img_name", "joints2D", "bbox", "vid_name", "features")}

    for fname in sorted(glob.glob(osp.join(folder, "labels", "*.mat"))):
        vid = loadmat(fname, squeeze_me=True)
        n = int(vid["nframes"])
        stem = osp.splitext(osp.basename(fname))[0]
        imgs = sorted(glob.glob(osp.join(folder, "frames", stem, "*.jpg")))
        if len(imgs) < n:
            n = len(imgs)

        kp13 = np.zeros((n, 13, 3), np.float32)
        kp13[:, :, 0] = np.asarray(vid["x"])[:n]
        kp13[:, :, 1] = np.asarray(vid["y"])[:n]
        kp13[:, :, 2] = np.asarray(vid["visibility"])[:n]
        kp13 = kp13[:, perm_idxs("pennaction", "common")]

        # 14-slot layout: joints 0..11, empty neck at 12, headtop at 13
        # (ref: penn_action_utils.py:90-94)
        kp_2d = np.zeros((n, 14, 3), np.float32)
        kp_2d[:, :12] = kp13[:, :-1]
        kp_2d[:, 13] = kp13[:, 12]

        bbox = np.zeros((n, 4), np.float32)
        for t in range(n):
            vis = kp_2d[t, :, 2] > 0
            pts = kp_2d[t, vis, :2] if vis.any() else kp_2d[t, :, :2]
            lo, hi = pts.min(0), pts.max(0)
            side = max(hi[0] - lo[0], hi[1] - lo[1])
            bbox[t] = [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, side, side]

        feats = extractor.extract_from_images(imgs[:n], bbox, scale=1.2)
        dataset["vid_name"].append(np.array([stem] * n))
        dataset["img_name"].append(np.asarray(imgs[:n]))
        dataset["joints2D"].append(kp_2d)
        dataset["bbox"].append(bbox)
        dataset["features"].append(feats)
    return concatenate_db(dataset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="data/penn_action")
    ap.add_argument("--db_dir", default=None)
    add_gpu_arg(ap)
    args = ap.parse_args(argv)
    db = read_data(args.dir, device=gpu_device(args.gpu))
    save_db(db, "pennaction_train_scale12", args.db_dir)


if __name__ == "__main__":
    main()
