"""Build MPI-INF-3DHP DBs (`mpii3d_{train,val}_scale*_db.pt`).

Port of `tools/preprocess/mpii3d.py` (ref: lib/data_utils/mpii3d_utils.py:
83-349). Train: subjects S1-S8, Seq1-2, cameras {0,1,2,4..8}; annot.mat
28-joint annotations converted 'mpii3d'->'spin' (root at spin joint 39),
videos split into new segments at frames with out-of-view joints. Test:
TS1-TS6 annot_data.mat (17-joint), 'mpii3d_test' ordering kept in
`valid_i`. scipy.io is imported by the train reader; the test reader's
MATLAB v7.3 files (HDF5 behind a 512-byte user block) are read by
`data.h5.open_h5`, without h5py; features are extracted on the device.

  python -m tepose_tpu_torch.preprocess.mpii3d --dir data/mpi_inf_3dhp
         [--set train] [--gpu 0|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np
import torch

from tepose_tpu_torch.config import gpu_device
from tepose_tpu_torch.data.db import save_db
from tepose_tpu_torch.data.h5 import open_h5
from tepose_tpu_torch.data.kp_utils import convert_kps
from tepose_tpu_torch.data.preprocess import FeatureExtractor
from tepose_tpu_torch.preprocess.common import (
    add_gpu_arg, concatenate_db, load_backbone)

W_TRAIN = H_TRAIN = 2048


def bbox_from_kp2d(kp: np.ndarray) -> np.ndarray:
    lo, hi = kp[:, :2].min(0), kp[:, :2].max(0)
    side = max(hi[0] - lo[0], hi[1] - lo[1]) * 1.2
    return np.array([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, side, side],
                    np.float32)


def read_train_data(dataset_path: str, backbone=None, mesh=None, *,
                    device: torch.device | str = "cuda"):
    """The train DB; `backbone` defaults to the converted SPIN ResNet-50
    on `device`; `mesh` splits each feature batch over its devices."""
    import scipy.io as sio

    extractor = FeatureExtractor(backbone if backbone is not None
                                 else load_backbone(device), mesh=mesh)
    dataset = {k: [] for k in
               ("vid_name", "frame_id", "joints3D", "joints2D", "bbox",
                "img_name", "features")}

    for user_i in range(1, 9):
        for seq_i in range(1, 3):
            seq_path = osp.join(dataset_path, f"S{user_i}", f"Seq{seq_i}")
            annot_file = osp.join(seq_path, "annot.mat")
            if not osp.isfile(annot_file):
                continue
            annot2 = sio.loadmat(annot_file)["annot2"]
            annot3 = sio.loadmat(annot_file)["annot3"]
            for vid_i in list(range(3)) + list(range(4, 9)):
                img_list = sorted(glob.glob(
                    osp.join(seq_path, f"video_{vid_i}", "*.jpg")))
                seg = 0
                frames, j2ds, j3ds, bboxes, names = [], [], [], [], []

                def flush():
                    nonlocal frames, j2ds, j3ds, bboxes, names
                    if len(frames) >= 8:
                        vid = (f"subj{user_i}_seq{seq_i}_vid{vid_i}"
                               f"_seg{seg}")
                        n = len(frames)
                        feats = extractor.extract_from_images(
                            names, np.stack(bboxes), scale=1.2)
                        dataset["vid_name"].append(np.array([vid] * n))
                        dataset["frame_id"].append(np.asarray(frames))
                        dataset["joints2D"].append(np.stack(j2ds))
                        dataset["joints3D"].append(np.stack(j3ds))
                        dataset["bbox"].append(np.stack(bboxes))
                        dataset["img_name"].append(np.asarray(names))
                        dataset["features"].append(feats)
                    frames, j2ds, j3ds, bboxes, names = [], [], [], [], []

                for i, img_i in enumerate(img_list):
                    j2d_raw = np.reshape(annot2[vid_i][0][i],
                                         (1, 28, 2))
                    j2d_raw = np.append(j2d_raw, np.ones((1, 28, 1)), axis=2)
                    j2d = convert_kps(j2d_raw, "mpii3d",
                                      "spin").reshape(-1, 3)
                    j3d_raw = np.reshape(annot3[vid_i][0][i],
                                         (1, 28, 3)) / 1000
                    j3d = convert_kps(j3d_raw, "mpii3d",
                                      "spin").reshape(-1, 3)
                    j3d = j3d - j3d[39]

                    # out-of-view joints start a new video segment
                    # (ref: mpii3d_utils.py:146-153)
                    inside = ((j2d[:, 0] >= 0) & (j2d[:, 0] < W_TRAIN)
                              & (j2d[:, 1] >= 0) & (j2d[:, 1] < H_TRAIN))
                    if inside.sum() < len(j2d):
                        flush()
                        seg += 1
                        continue
                    nz = j2d[~np.all(j2d == 0, axis=1)]
                    frames.append(i)
                    j2ds.append(j2d.astype(np.float32))
                    j3ds.append(j3d.astype(np.float32))
                    bboxes.append(bbox_from_kp2d(nz))
                    names.append(img_i)
                flush()
                print(f"S{user_i}/Seq{seq_i}/video_{vid_i} done")
    return concatenate_db(dataset)


def read_test_data(dataset_path: str, backbone=None, mesh=None, *,
                   device: torch.device | str = "cuda"):
    """The test (val) DB, as `read_train_data`."""
    extractor = FeatureExtractor(backbone if backbone is not None
                                 else load_backbone(device), mesh=mesh)
    dataset = {k: [] for k in
               ("vid_name", "frame_id", "joints3D", "joints2D", "bbox",
                "img_name", "features", "valid_i")}

    for subj in range(1, 7):
        seq_path = osp.join(dataset_path, "mpi_inf_3dhp_test_set",
                            f"TS{subj}")
        annot_file = osp.join(seq_path, "annot_data.mat")
        if not osp.isfile(annot_file):
            continue
        with open_h5(annot_file) as m:
            annot2 = np.array(m["annot2"])       # (T, 1, 17, 2)
            annot3 = np.array(m["univ_annot3"])  # (T, 1, 17, 3)
            valid = np.array(m["valid_frame"]).reshape(-1)

        frames, j2ds, j3ds, bboxes, names, valids = [], [], [], [], [], []
        for i in range(len(annot2)):
            img_path = osp.join(seq_path, "imageSequence",
                                f"img_{i + 1:06d}.jpg")
            j2d_raw = annot2[i, 0][None]
            j2d_raw = np.append(j2d_raw, np.ones((1, 17, 1)), axis=2)
            j2d = convert_kps(j2d_raw, "mpii3d_test",
                              "spin").reshape(-1, 3)
            j3d_raw = annot3[i, 0][None] / 1000
            j3d = convert_kps(j3d_raw, "mpii3d_test",
                              "spin").reshape(-1, 3)
            nz = j2d[~np.all(j2d == 0, axis=1)]
            if len(nz) == 0:
                continue
            frames.append(i)
            j2ds.append(j2d.astype(np.float32))
            j3ds.append(j3d.astype(np.float32))
            bboxes.append(bbox_from_kp2d(nz))
            names.append(img_path)
            valids.append([float(valid[i])])
        n = len(frames)
        if n == 0:
            continue
        feats = extractor.extract_from_images(names, np.stack(bboxes),
                                              scale=1.2)
        dataset["vid_name"].append(np.array([f"subj{subj}_seg0"] * n))
        dataset["frame_id"].append(np.asarray(frames))
        dataset["joints2D"].append(np.stack(j2ds))
        dataset["joints3D"].append(np.stack(j3ds))
        dataset["bbox"].append(np.stack(bboxes))
        dataset["img_name"].append(np.asarray(names))
        dataset["features"].append(feats)
        dataset["valid_i"].append(np.asarray(valids, np.float32))
        print(f"TS{subj}: {n} frames")
    return concatenate_db(dataset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="data/mpi_inf_3dhp")
    ap.add_argument("--set", default="train", choices=["train", "val"])
    ap.add_argument("--db_dir", default=None)
    add_gpu_arg(ap)
    args = ap.parse_args(argv)
    device = gpu_device(args.gpu)
    if args.set == "train":
        db = read_train_data(args.dir, device=device)
        save_db(db, "mpii3d_train_scale12", args.db_dir)
    else:
        db = read_test_data(args.dir, device=device)
        save_db(db, "mpii3d_val_scale12", args.db_dir)


if __name__ == "__main__":
    main()
