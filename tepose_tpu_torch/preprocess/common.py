"""Shared plumbing for the offline DB builders.

Port of `tools/preprocess/common.py`. Every builder writes a dict of
per-frame arrays {vid_name, frame_id, img_name, joints2D, joints3D, pose,
shape, bbox, valid, features} to `<TEPOSE_DB_DIR>/<name>_db.pt`, through
`data.db.save_db` (a plain pickle, which joblib also reads). The weights
are the converted checkpoints that `python -m
tepose_tpu_torch.convert_checkpoint` and `convert_smpl` write.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict

import numpy as np
import torch

from tepose_tpu_torch.config import BASE_DATA_DIR
from tepose_tpu_torch.models.backbone import ResNet50
from tepose_tpu_torch.models.smpl import SmplModel, load_smpl_assets
from tepose_tpu_torch.weights import load_checkpoint, state_dict_from_jax_tree


def add_gpu_arg(ap) -> None:
    ap.add_argument("--gpu", default="0",
                    help="CUDA device index to run on, or 'cpu' for the "
                         "host (plain kernels)")


def load_backbone(device: torch.device | str) -> ResNet50:
    """The SPIN ResNet-50 from the converted checkpoint, on `device`."""
    path = osp.join(BASE_DATA_DIR, "spin_model_checkpoint.npz")
    if not osp.isfile(path):
        raise FileNotFoundError(
            f"{path} missing — convert spin_model_checkpoint.pth.tar with "
            "python -m tepose_tpu_torch.convert_checkpoint --kind spin")
    model = ResNet50(device=device)
    model.load_state_dict(state_dict_from_jax_tree(
        load_checkpoint(path)[0]["backbone"]))
    return model.eval()


def load_smpl(gender: str = "neutral", *,
              device: torch.device | str) -> SmplModel:
    path = osp.join(BASE_DATA_DIR, f"smpl_{gender}.npz")
    if not osp.isfile(path):
        raise FileNotFoundError(
            f"{path} missing — convert your SMPL pkl with "
            "python -m tepose_tpu_torch.convert_smpl")
    return load_smpl_assets(path, device)


def load_h36m_regressor() -> np.ndarray:
    path = osp.join(BASE_DATA_DIR, "J_regressor_h36m.npy")
    if not osp.isfile(path):
        raise FileNotFoundError(f"{path} missing")
    return np.load(path).astype(np.float32)


def concatenate_db(dataset: Dict[str, list]) -> Dict[str, np.ndarray]:
    return {k: np.concatenate(v) for k, v in dataset.items() if len(v)}
