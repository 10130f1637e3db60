"""Build the AMASS real-motion DB (`amass_train_db.pt`).

Port of `tools/preprocess/amass.py` (ref: lib/data_utils/amass_utils.py:
32-151): reads SMPL-H `poses` npz files per corpus/subject/action, keeps
the 24 SMPL-relevant joints (23 body + the left-hand root standing in for
both hands), drops clips < 60 frames, and stores theta = [pose(72),
shape(10)] per frame with video names. Host only.

  python -m tepose_tpu_torch.preprocess.amass --dir data/amass
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from tepose_tpu_torch.data.db import save_db

# SMPL-H pose has 52 joints x 3; SMPL uses the first 22 body joints + joint
# 37 (left hand) duplicated conventionally into the 23th slot
# (ref: amass_utils.py:32-37)
JOINTS_TO_USE = np.array([
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 37])
JOINTS_TO_USE = np.arange(0, 156).reshape(-1, 3)[JOINTS_TO_USE].reshape(-1)

ALL_SEQUENCES = [
    "ACCAD", "BioMotionLab_NTroje", "CMU", "EKUT", "Eyes_Japan_Dataset",
    "HumanEva", "KIT", "MPI_HDM05", "MPI_Limits", "MPI_mosh", "SFU",
    "SSM_synced", "TCD_handMocap", "TotalCapture", "Transitions_mocap",
]


def read_single_sequence(folder: str, seq_name: str, min_frames: int = 60):
    thetas, vid_names = [], []
    for subject in sorted(os.listdir(folder)):
        subj_dir = osp.join(folder, subject)
        if not osp.isdir(subj_dir):
            continue
        for action in sorted(x for x in os.listdir(subj_dir)
                             if x.endswith(".npz")):
            if action.endswith("shape.npz"):
                continue
            data = np.load(osp.join(subj_dir, action))
            if "poses" not in data:
                continue
            pose = data["poses"][:, JOINTS_TO_USE]
            if pose.shape[0] < min_frames:
                continue
            shape = np.repeat(data["betas"][:10][None], pose.shape[0], axis=0)
            thetas.append(np.concatenate([pose, shape], axis=1))
            vid_names.append(np.array(
                [f"{seq_name}_{subject}_{action[:-4]}"] * pose.shape[0]))
    if not thetas:
        return None, None
    return (np.concatenate(thetas).astype(np.float32),
            np.concatenate(vid_names))


def read_data(folder: str, sequences=None):
    sequences = sequences or ALL_SEQUENCES
    db = {"theta": [], "vid_name": []}
    for seq in sequences:
        seq_dir = osp.join(folder, seq)
        if not osp.isdir(seq_dir):
            print(f"skipping absent corpus {seq}")
            continue
        thetas, names = read_single_sequence(seq_dir, seq)
        if thetas is None:
            continue
        print(f"{seq}: {thetas.shape[0]} frames")
        db["theta"].append(thetas)
        db["vid_name"].append(names)
    return {k: np.concatenate(v) for k, v in db.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="data/amass")
    ap.add_argument("--db_dir", default=None)
    args = ap.parse_args(argv)
    db = read_data(args.dir)
    save_db(db, "amass_train", args.db_dir)


if __name__ == "__main__":
    main()
