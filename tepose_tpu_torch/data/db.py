"""Eval-DB access: joblib `.pt` dictionaries + pseudo-theta files.

A copy of the eval-DB readers of `tepose_tpu/data/db.py` (`eval_db_paths`,
`load_db`, `load_pseudotheta`, `key_eval_db_by_video`), pinned equal to them
by tests/test_torch_eval.py; the training-DB paths come with the training
slice. The DBs are plain joblib pickles of numpy arrays; joblib is imported
only to read one, so synthetic runs do not need it.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, Optional

import numpy as np

from tepose_tpu_torch.config import TePose_DB_DIR


def eval_db_paths(dataset: str, title: str, render: bool = False,
                  db_dir: Optional[str] = None):
    """Benchmark-eval DB paths (ref: evaluate.py:146-166)."""
    d = db_dir or TePose_DB_DIR
    if dataset == "3dpw":
        opt = "_all" if render else ""
        stem = f"3dpw_test{opt}"
    elif dataset == "h36m":
        if title == "repr_wpw_h36m_mpii3d_model":
            stem = "h36m_test_25fps_nosmpl"
        else:  # repr_wopw_h36m_model
            stem = "h36m_test_front_25fps_tight_nosmpl"
    elif dataset == "mpii3d":
        stem = "mpii3d_val_scale12"
    else:
        raise ValueError(f"unknown eval dataset {dataset!r}")
    return osp.join(d, f"{stem}_db.pt"), osp.join(d, f"{stem}_pseudotheta.pt")


def load_db(db_file: str) -> Dict[str, np.ndarray]:
    if not osp.isfile(db_file):
        raise FileNotFoundError(f"{db_file} does not exist — run the "
                                "preprocessing tools (tools/preprocess) or "
                                "point TEPOSE_DB_DIR at your DB directory")
    import joblib

    return joblib.load(db_file)


def load_pseudotheta(pse_file: str) -> np.ndarray:
    if not osp.isfile(pse_file):
        raise FileNotFoundError(f"{pse_file} does not exist — generate it "
                                "with tools/pseudo_theta.py")
    import joblib

    return joblib.load(pse_file)


def key_eval_db_by_video(db: Dict[str, np.ndarray], psetheta: np.ndarray,
                         target_action: str = "",
                         is_mpii3d: bool = False) -> Dict[str, Dict]:
    """Group an eval DB into per-video dicts with validity masking and the
    pseudo-theta camera forced to [1, 0, 0] (ref: evaluate.py:171-207)."""
    pse = psetheta.copy()
    pse[:, :3] = np.array([1.0, 0.0, 0.0], pse.dtype)

    out: Dict[str, Dict] = {}
    for name in np.unique(db["vid_name"]):
        if target_action and target_action not in str(name):
            continue
        sel = db["vid_name"] == name
        if "valid" in db:
            valids = db["valid"][sel].astype(bool)
        else:
            valids = np.ones(int(sel.sum()), bool)
        entry = {
            "features": db["features"][sel][valids],
            "joints3D": db["joints3D"][sel][valids],
            "vid_name": db["vid_name"][sel][valids],
            "imgname": db["img_name"][sel][valids]
            if "img_name" in db else None,
            "bbox": db["bbox"][sel][valids] if "bbox" in db else None,
            "theta_pseu": pse[sel][valids],
        }
        n = int(valids.sum())
        if is_mpii3d:
            entry["pose"] = np.zeros((n, 72), np.float32)
            entry["shape"] = np.zeros((n, 10), np.float32)
            entry["valid_i"] = db["valid_i"][sel][valids]
        else:
            entry["pose"] = db["pose"][sel][valids]
            entry["shape"] = db["shape"][sel][valids]
        out[str(name)] = entry
    return out
