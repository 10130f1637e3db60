"""Dataset classes producing fixed-shape numpy items for the trainer.

A copy of the datasets of `tepose_tpu/data/datasets.py` (`Dataset3D`,
`Dataset2D`, `Insta`, `AMASS`, the named wrappers, `MultipleDatasets`,
`ThreeDPW_TEST`, `Human36M_VAL`, `CropDataset` on the port's g++-built
`native.crop_normalize`, and `FeatureDataset`), pinned equal to them by
tests/test_torch_train_loop.py and tests/test_torch_host.py. Items match the batch spec
`train.trainer.assemble_window` reads:

  3D item: features (VIDLEN, 2048), theta/theta_pseu (VIDLEN, 85),
           kp_2d (VIDLEN, 49, 3), kp_3d (VIDLEN, nj, 3), w_smpl/w_3d (VIDLEN,),
           vidlen_each (), index ()
  2D item: features (2, VIDLEN, 2048), theta_pseu (2, VIDLEN, 85),
           kp_2d (VIDLEN, 49, 3), switch_id (2, VIDLEN), vidlen_each ()
  AMASS item: theta (seqlen, 85)

Numpy only; `h5py` is imported only to read Insta's HDF5 file, and the
joblib DBs are read without joblib (`data.db.read_joblib`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from tepose_tpu_torch.data import kp_utils
from tepose_tpu_torch.data.chunking import (
    combine_into_chunks, pack_clip_channels, split_into_videos,
    split_into_videos_val)
from tepose_tpu_torch.data.db import (
    load_db, load_pseudotheta, read_joblib, train_db_paths)
from tepose_tpu_torch.data.transforms import normalize_2d_kp, transform_keypoints

DUMMY_CAM = np.array([1.0, 0.0, 0.0], np.float32)


def _get_sequence(data: np.ndarray, start: int, end: int,
                  seqlen: int) -> np.ndarray:
    if start != end:
        return data[start:end + 1]
    return np.repeat(data[start:start + 1], seqlen, axis=0)


class Dataset3D:
    """Whole-video items from a 3D dataset DB (ref: dataset_3d.py:35-343)."""

    def __init__(self, load_opt: str, split: str, seqlen: int, vidlen: int,
                 dataset_name: str, db_dir: Optional[str] = None,
                 db: Optional[Dict] = None,
                 psetheta: Optional[np.ndarray] = None):
        self.load_opt = load_opt
        self.split = split
        self.seqlen = seqlen
        self.dataset_name = dataset_name
        if db is None:
            db_file, pse_file = train_db_paths(load_opt, dataset_name, split,
                                               db_dir)
            db = load_db(db_file)
            psetheta = load_pseudotheta(pse_file)
        self.db = db
        self.psetheta = np.asarray(psetheta, np.float32)

        if split == "train":
            self.vidlen = vidlen
            self.vid_indices, self.video_lens = split_into_videos(
                self.db["vid_name"], seqlen, 1, vidlen)
        else:
            self.vid_indices, lens = split_into_videos_val(
                self.db["vid_name"], seqlen, 1)
            self.vidlen = max(lens)

    def __len__(self) -> int:
        return len(self.vid_indices) // 2

    def num_eval_joints(self) -> int:
        if self.split == "train":
            return 49
        return 17 if self.dataset_name == "mpii3d" else 14

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        start = self.vid_indices[index * 2]
        end = self.vid_indices[index * 2 + 1]
        n = end - start + 1
        is_train = self.split == "train"
        seq = lambda d: _get_sequence(d, start, end, self.seqlen)

        # keypoint conversion per dataset (ref: dataset_3d.py:179-195)
        kp_2d = seq(self.db["joints2D"]).astype(np.float32)
        if self.dataset_name == "3dpw":
            kp_2d = kp_utils.convert_kps(kp_2d, "common", "spin")
        kp_3d = seq(self.db["joints3D"]).astype(np.float32)
        if not is_train:
            if self.dataset_name == "mpii3d":
                kp_3d = kp_utils.convert_kps(kp_3d, "spin", "mpii3d_test")
            elif self.dataset_name == "h36m":
                kp_3d = kp_utils.convert_kps(kp_3d, "spin", "common")
            elif kp_3d.shape[1] == 49:
                # 3dpw val DBs store 14-joint common targets; accept 49-joint
                # spin DBs too by reducing here
                kp_3d = kp_3d[:, 25:39]

        # supervision masks (ref: dataset_3d.py:208-233)
        if self.dataset_name == "3dpw":
            pose = seq(self.db["pose"]).astype(np.float32)
            shape = seq(self.db["shape"]).astype(np.float32)
            w_smpl = np.ones(self.vidlen, np.float32)
            w_3d = np.ones(self.vidlen, np.float32)
        elif self.dataset_name == "h36m":
            if not is_train:
                pose = np.zeros((n, 72), np.float32)
                shape = np.zeros((n, 10), np.float32)
                w_smpl = np.zeros(self.vidlen, np.float32)
            else:
                pose = seq(self.db["pose"]).astype(np.float32)
                shape = seq(self.db["shape"]).astype(np.float32)
                w_smpl = (np.zeros if self.load_opt == "repr_wpw_3dpw_model"
                          else np.ones)(self.vidlen).astype(np.float32)
            w_3d = np.ones(self.vidlen, np.float32)
        else:  # mpii3d: no SMPL labels
            pose = np.zeros((n, 72), np.float32)
            shape = np.zeros((n, 10), np.float32)
            w_smpl = np.zeros(self.vidlen, np.float32)
            w_3d = np.ones(self.vidlen, np.float32)

        bbox = seq(self.db["bbox"]).astype(np.float32)
        kp_2d[..., :2] = normalize_2d_kp(
            transform_keypoints(kp_2d[..., :2], bbox))

        pse = seq(self.psetheta)
        theta_pseu = np.concatenate(
            [np.tile(DUMMY_CAM, (n, 1)), pse[:, 3:75], pse[:, 75:]], axis=1)
        theta = np.concatenate(
            [np.tile(DUMMY_CAM, (n, 1)), pose, shape], axis=1)

        def pad(x, shape_tail):
            out = np.zeros((self.vidlen,) + shape_tail, np.float32)
            out[:n] = x[:self.vidlen]
            return out

        features = pad(seq(self.db["features"]).astype(np.float32), (2048,))
        kp2 = np.ones((self.vidlen, 49, 3), np.float32)
        kp2[:n] = kp_2d[:self.vidlen]
        item = {
            "features": features,
            "theta": pad(theta, (85,)),
            "theta_pseu": pad(theta_pseu, (85,)),
            "kp_2d": kp2,
            "kp_3d": pad(kp_3d, (kp_3d.shape[1], 3)),
            "w_smpl": w_smpl,
            "w_3d": w_3d,
            "index": np.float32(index),
            "vidlen_each": np.float32(n),
        }
        if not is_train and self.dataset_name == "mpii3d":
            item["valid"] = self.db["valid_i"][start:end + 1][-1].astype(
                np.float32)
        elif not is_train:
            # 3dpw/h36m val: all windows valid (ref: dataset_3d.py:303-316)
            item["valid"] = np.ones(1, np.float32)
        return item


class Dataset2D:
    """Packed 2-channel clip items from a 2D dataset DB
    (ref: dataset_2d.py:35-192)."""

    def __init__(self, load_opt: str, seqlen: int, vidlen: int,
                 dataset_name: str, db_dir: Optional[str] = None,
                 db: Optional[Dict] = None,
                 psetheta: Optional[np.ndarray] = None):
        self.load_opt = load_opt
        self.seqlen = seqlen
        self.vidlen = vidlen
        self.dataset_name = dataset_name
        if db is None:
            db_file, pse_file = train_db_paths(load_opt, dataset_name,
                                               "train", db_dir)
            db = load_db(db_file)
            psetheta = load_pseudotheta(pse_file)
        self.db = db
        self.psetheta = np.asarray(psetheta, np.float32)
        self.vid_indices = combine_into_chunks(self.db["vid_name"], seqlen,
                                               vidlen)

    def __len__(self) -> int:
        return len(self.vid_indices)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        clips = self.vid_indices[index]
        S, V = self.seqlen, self.vidlen
        seq = lambda d, s, e: _get_sequence(d, s, e, S)

        lengths = [e - s + 1 for s, e in clips]
        layout, switch_id, total = pack_clip_channels(lengths, S, V)

        features = np.zeros((2, V, 2048), np.float32)
        theta_pseu = np.zeros((2, V, 85), np.float32)
        kp_parts: List[np.ndarray] = []
        bbox_parts: List[np.ndarray] = []
        has_bbox = self.db.get("bbox") is not None
        for k, ((s, e), (ch, off)) in enumerate(zip(clips, layout)):
            ln = e - s + 1
            features[ch, off:off + ln] = seq(self.db["features"], s, e)
            pse = seq(self.psetheta, s, e)
            theta_pseu[ch, off:off + ln, 3:] = pse[:, 3:]
            theta_pseu[ch, off:off + ln, 0] = 1.0
            # active-timeline keypoints: first clip full, later clips minus
            # the first seqlen-1 overlap frames (ref: dataset_2d.py:118-127).
            # Direct slices, NOT _get_sequence: its start==end repeat branch
            # would emit seqlen rows where one belongs for a later clip of
            # exactly seqlen frames (s_kp == e), shifting every following
            # clip's keypoints off their timeline slots — a silent-data-
            # corruption bug the reference's get_sequence shares.
            s_kp = s if k == 0 else s + S - 1
            kp_parts.append(np.asarray(self.db["joints2D"][s_kp:e + 1]))
            if has_bbox:
                bbox_parts.append(np.asarray(self.db["bbox"][s_kp:e + 1]))

        kp_2d = np.concatenate(kp_parts, axis=0).astype(np.float32)
        if self.dataset_name != "posetrack":
            kp_2d = kp_utils.convert_kps(kp_2d, self.dataset_name, "spin")
        if has_bbox:
            bbox = np.concatenate(bbox_parts, axis=0).astype(np.float32)
            kp_2d[..., :2] = normalize_2d_kp(
                transform_keypoints(kp_2d[..., :2], bbox))
        else:
            # insta keypoints are stored in 224-crop coords already: no bbox
            # transform, just [-1,1] normalisation (ref: insta.py:96-97 vs
            # dataset_2d.py:139-151)
            kp_2d[..., :2] = normalize_2d_kp(kp_2d[..., :2])

        kp2 = np.ones((V, 49, 3), np.float32)
        kp2[:kp_2d.shape[0]] = kp_2d[:V]

        return {
            "features": features,
            "theta_pseu": theta_pseu,
            "kp_2d": kp2,
            "switch_id": switch_id,
            "vidlen_each": np.float32(total),
        }


class Insta(Dataset2D):
    """InstaVariety from HDF5, same 2-channel packing (ref: insta.py:31-111).

    The h5 file stores per-frame arrays under keys vid_name / features /
    joints2D (insta 25-joint format).
    """

    def __init__(self, load_opt: str, seqlen: int, vidlen: int,
                 h5_path: Optional[str] = None,
                 db: Optional[Dict] = None,
                 psetheta: Optional[np.ndarray] = None):
        if db is None:
            import os.path as osp

            import h5py

            from tepose_tpu_torch.config import TePose_DB_DIR
            path = h5_path or osp.join(TePose_DB_DIR, "insta_train_db.h5")
            f = h5py.File(path, "r")
            db = {
                "vid_name": np.asarray(f["vid_name"]),
                "features": f["features"],   # lazy h5 dataset
                "joints2D": f["joints2D"],
                "bbox": f["bbox"] if "bbox" in f else None,
            }
            # pseudo-thetas live in a sidecar joblib like the other datasets
            # (ref: pseudo_theta.py writes insta_train_pseudotheta.pt);
            # only look for the sidecar when the path follows the *_db.h5
            # convention — replace() on any other name is a no-op and would
            # read the h5 file itself
            pse_path = (path[:-len("_db.h5")] + "_pseudotheta.pt"
                        if path.endswith("_db.h5") else None)
            if psetheta is None:
                if pse_path and osp.isfile(pse_path):
                    psetheta = read_joblib(pse_path)
                elif "theta_pseu" in f:
                    psetheta = np.asarray(f["theta_pseu"])
                else:
                    psetheta = np.zeros((len(db["vid_name"]), 85), np.float32)
        super().__init__(load_opt, seqlen, vidlen, "insta", db=db,
                         psetheta=psetheta)


class AMASS:
    """Real-motion theta chunks for the discriminator (ref: amass.py:26-59).

    One item = (seqlen, 85) with dummy cam [1,0,0] and the DB's pose+shape.
    """

    def __init__(self, seqlen: int, db: Optional[Dict] = None,
                 db_dir: Optional[str] = None):
        self.seqlen = seqlen
        if db is None:
            import os.path as osp

            from tepose_tpu_torch.config import TePose_DB_DIR
            db = load_db(osp.join(db_dir or TePose_DB_DIR,
                                  "amass_train_db.pt"))
        self.db = db
        from tepose_tpu_torch.data.chunking import split_into_chunks
        self.vid_indices = split_into_chunks(self.db["vid_name"], seqlen,
                                             seqlen)

    def __len__(self) -> int:
        return len(self.vid_indices)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        start, end = self.vid_indices[index]
        thetas = self.db["theta"][start:end + 1].astype(np.float32)
        cam = np.tile(DUMMY_CAM, (thetas.shape[0], 1))
        return {"theta": np.concatenate([cam, thetas], axis=1)}


# thin named wrappers (ref: threedpw.py / mpii3d.py / h36m.py / posetrack.py)


def ThreeDPW(load_opt, split, seqlen, vidlen, **kw):
    return Dataset3D(load_opt, split, seqlen, vidlen, "3dpw", **kw)


def MPII3D(load_opt, split, seqlen, vidlen, **kw):
    return Dataset3D(load_opt, split, seqlen, vidlen, "mpii3d", **kw)


def Human36M(load_opt, split, seqlen, vidlen, **kw):
    return Dataset3D(load_opt, split, seqlen, vidlen, "h36m", **kw)


def PoseTrack(load_opt, seqlen, vidlen, **kw):
    return Dataset2D(load_opt, seqlen, vidlen, "posetrack", **kw)


class MultipleDatasets:
    """Uniform-sampling concat: each __getitem__ draws from a random member
    dataset (`tepose_tpu/data/datasets.py::MultipleDatasets`; ref:
    loaders.py:24-58, which the reference bypasses for plain
    concatenation)."""

    def __init__(self, datasets, make_same_len: bool = True, seed: int = 0):
        self.datasets = list(datasets)
        self.make_same_len = make_same_len
        self.max_len = max(len(d) for d in self.datasets)
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        if self.make_same_len:
            return self.max_len * len(self.datasets)
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, index: int):
        if self.make_same_len:
            ds = self.datasets[index // self.max_len]
            return ds[int(self._rng.randint(len(ds)))]
        for ds in self.datasets:
            if index < len(ds):
                return ds[index]
            index -= len(ds)
        raise IndexError(index)


def ThreeDPW_TEST(load_opt, seqlen, vidlen=520, **kw):
    """Full-video 3DPW test items (ref: threedpw_test.py:33)."""
    return Dataset3D(load_opt, "val", seqlen, vidlen, "3dpw", **kw)


def Human36M_VAL(load_opt, seqlen, vidlen=520, **kw):
    """Full-video H36M validation items (ref: h36m_val.py:33)."""
    return Dataset3D(load_opt, "val", seqlen, vidlen, "h36m", **kw)


class CropDataset:
    """Per-frame bbox crops for the demo feature extractor
    (`tepose_tpu/data/datasets.py::CropDataset`; ref: dataset_demo.py:29-75).
    frames: a list of RGB arrays, or a callable frame_idx -> array; bboxes
    (T, 4) cxcywh. Items are ImageNet-normalised (3, S, S) float32 crops
    from the native library (`native.crop_normalize`)."""

    def __init__(self, frames, bboxes: np.ndarray, frame_ids=None,
                 scale: float = 1.2, crop_size: int = 224):
        self.frames = frames
        self.bboxes = np.asarray(bboxes, np.float32)
        self.frame_ids = (np.arange(len(self.bboxes))
                          if frame_ids is None else np.asarray(frame_ids))
        self.scale = scale
        self.crop_size = crop_size

    def __len__(self) -> int:
        return len(self.bboxes)

    def __getitem__(self, idx: int) -> np.ndarray:
        from tepose_tpu_torch.native import crop_normalize

        frame = (self.frames(int(self.frame_ids[idx]))
                 if callable(self.frames)
                 else self.frames[int(self.frame_ids[idx])])
        return crop_normalize(frame, self.bboxes[idx:idx + 1],
                              self.crop_size, self.scale)[0]


class FeatureDataset:
    """Sliding seqlen-windows over a precomputed feature track
    (`tepose_tpu/data/datasets.py::FeatureDataset`; ref:
    dataset_demo.py:78-108)."""

    def __init__(self, features: np.ndarray, seqlen: int):
        self.features = np.asarray(features, np.float32)
        self.seqlen = seqlen

    def __len__(self) -> int:
        return max(0, len(self.features) - self.seqlen + 1)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.features[idx:idx + self.seqlen]
