"""Generate pseudo-theta files (`<name>_pseudotheta.pt`) by running the
pretrained VIBE over every video's stored features.

Port of `pseudo_thetas_for_features` and `main` of
`tools/preprocess/pseudo_theta.py` (ref: lib/data_utils/pseudo_theta.py:
39-121): per video, features go through VIBE in 450-frame chunks (the last
partial chunk re-reads the last 450 frames and keeps only its tail); the
output is a flat (N, 85) theta array in the DB's frame order. VIBE and its
SMPL (the skinning kernel at B = the chunk's length) run on the device.

  python -m tepose_tpu_torch.preprocess.pseudo_theta --file_name 3dpw_test
         [--vibe_batch_size 450] [--vibe_ckpt data/base_data/vibe_w_3dpw.npz]
         [--gpu 0|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os.path as osp

import numpy as np
import torch

from tepose_tpu_torch.config import BASE_DATA_DIR, TePose_DB_DIR, gpu_device
from tepose_tpu_torch.data.chunking import group_video_indices
from tepose_tpu_torch.data.db import read_joblib, write_db
from tepose_tpu_torch.data.h5 import open_h5
from tepose_tpu_torch.models.smpl import SmplModel
from tepose_tpu_torch.models.tepose import Vibe, VibeConfig
from tepose_tpu_torch.preprocess.common import (
    add_gpu_arg, load_smpl)
from tepose_tpu_torch.streaming.engine import (
    check_device, device_scope, upload)
from tepose_tpu_torch.weights import load_checkpoint, state_dict_from_jax_tree


def pseudo_thetas_for_features(vid_names: np.ndarray, features, vibe: Vibe,
                               smpl: SmplModel,
                               batch_size: int = 450) -> np.ndarray:
    """(N, 85) pseudo thetas for a frame-level DB. `features` is an (N,
    2048) array or an HDF5 dataset, read one video at a time. The chunks
    are queued back to back on the device and read back once."""
    device = smpl.v_template.device
    check_device(device, vibe=vibe, smpl=smpl)

    def run_chunk(chunk: np.ndarray) -> torch.Tensor:
        return vibe(upload(chunk[None], device), smpl)["theta"][0]

    thetas = []
    with device_scope():
        for idx in group_video_indices(vid_names):
            feats = np.asarray(features[idx[0]:idx[-1] + 1], np.float32)
            n = len(feats)
            for k in range(n // batch_size):
                thetas.append(run_chunk(feats[batch_size * k:
                                              batch_size * (k + 1)]))
            if n % batch_size != 0:
                k = n // batch_size
                tail = feats[max(0, n - batch_size):]
                out = run_chunk(tail)
                thetas.append(out[k * batch_size - n:])
        return torch.cat(thetas).cpu().numpy()


def load_vibe(path: str, device: torch.device | str) -> Vibe:
    """The converted VIBE checkpoint (2 x 1024, seqlen 16, add_linear)."""
    if not osp.isfile(path):
        raise FileNotFoundError(
            f"{path} missing — convert the released VIBE checkpoint with "
            "python -m tepose_tpu_torch.convert_checkpoint --kind vibe")
    vibe = Vibe(VibeConfig(seqlen=16, n_layers=2, hidden_size=1024,
                           add_linear=True),
                generator=torch.Generator(), device=device)
    vibe.load_state_dict(state_dict_from_jax_tree(
        load_checkpoint(path)[0]["gen"]))
    return vibe.eval()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--file_name", required=True,
                    help="DB stem, e.g. 3dpw_test or h36m_train_25fps_occ")
    ap.add_argument("--vibe_batch_size", type=int, default=450)
    ap.add_argument("--vibe_ckpt",
                    default=osp.join(BASE_DATA_DIR, "vibe_w_3dpw.npz"))
    ap.add_argument("--db_dir", default=None)
    add_gpu_arg(ap)
    args = ap.parse_args(argv)
    device = gpu_device(args.gpu)

    d = args.db_dir or TePose_DB_DIR
    db_file = osp.join(d, args.file_name + "_db.pt")
    with contextlib.ExitStack() as stack:
        if osp.isfile(db_file):
            db = read_joblib(db_file)
        elif args.file_name == "insta_train":
            db = stack.enter_context(
                open_h5(osp.join(d, args.file_name + "_db.h5")))
        else:
            raise FileNotFoundError(db_file)

        vibe = load_vibe(args.vibe_ckpt, device)
        smpl = load_smpl(device=device)
        thetas = pseudo_thetas_for_features(
            np.asarray(db["vid_name"]), db["features"], vibe, smpl,
            args.vibe_batch_size)
    out_file = osp.join(d, args.file_name + "_pseudotheta.pt")
    write_db(thetas, out_file)
    print(f"wrote {out_file}: {thetas.shape}")


if __name__ == "__main__":
    main()
